"""Optimise simulation parameters from a loss on the card, adversarial
style: the port of the JAX package's ``examples/densityopt/densityopt.py``.

A fleet of supershape producers renders parameter samples fanned out over
duplex CTRL channels; a discriminator on the card scores rendered against
target images; the sampling distribution over shape parameters updates by
score-function gradient (the renderer is not differentiable). ``shape_id``
round-trips through the producers to re-associate images with their
samples. The samples come from a ``torch.Generator`` on the distribution's
device seeded with the reference's key seed (0); ``--device cpu`` runs it
all on the host.

Run: ``python -m blendjax_torch.examples.densityopt.densityopt --iters 10``
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--instances", type=int, default=2)
    ap.add_argument("--samples", type=int, default=8, help="per iteration")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--target-m", type=float, default=3.0)
    ap.add_argument("--init-m", type=float, default=7.0)
    ap.add_argument(
        "--device", default="cuda",
        help="'cuda' (the default; raises without a card) or 'cpu'",
    )
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from blendjax_torch.data import RemoteStream
    from blendjax_torch.device import device_flag
    from blendjax_torch.launcher import PythonProducerLauncher
    from blendjax_torch.models import Discriminator
    from blendjax_torch.producer.sim import SupershapeScene
    from blendjax_torch.train.score import GaussianSimParams, chunk_across
    from blendjax_torch.transport import PairChannel

    device = device_flag(args.device)
    script = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "supershape_producer.py"
    )

    # Target distribution: "real" images rendered locally at target params
    # (the reference draws its target set the same way, from known params).
    target_scene = SupershapeScene(seed=123)
    rng = np.random.default_rng(0)

    def target_batch(n):
        imgs = []
        for _ in range(n):
            m = args.target_m + rng.normal() * 0.1
            target_scene.set_params([m, 1.0, 1.0, 1.0], shape_id=0)
            imgs.append(target_scene.render())
        return np.stack(imgs)

    def on_device(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    disc = Discriminator(features=(16, 32)).init_params(0).to(device)
    # optax.adam's defaults
    opt = torch.optim.Adam(disc.parameters(), lr=1e-3, betas=(0.9, 0.999),
                           eps=1e-8)

    def disc_step(real, fake):
        lr = disc(real)
        lf = disc(fake)
        loss = (
            F.binary_cross_entropy_with_logits(lr, torch.ones_like(lr))
            + F.binary_cross_entropy_with_logits(lf, torch.zeros_like(lf))
        )
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    @torch.no_grad()
    def fake_scores(fake):
        # the simulator wants fakes classified REAL: per-sample BCE vs 1
        logits = disc(fake)
        return F.binary_cross_entropy_with_logits(
            logits, torch.ones_like(logits), reduction="none"
        ).reshape(-1)

    sim = GaussianSimParams(
        mu=[args.init_m], log_sigma=[np.log(0.5)], learning_rate=0.15,
        device=device,
    )
    gen = torch.Generator(device=sim.device).manual_seed(0)
    history = []
    with PythonProducerLauncher(
        script=script,
        num_instances=args.instances,
        named_sockets=["DATA", "CTRL"],
        seed=0,
    ) as launcher:
        remotes = [
            PairChannel(a, bind=False)
            for a in launcher.addresses["CTRL"]
        ]
        stream = RemoteStream(
            launcher.addresses["DATA"], timeoutms=30_000, copy_arrays=True
        )
        images_iter = iter(stream)
        next_id = 0
        try:
            for it in range(args.iters):
                theta = sim.sample(gen, args.samples).cpu().numpy()
                ids = list(range(next_id, next_id + args.samples))
                next_id += args.samples
                # fan the samples out across instances
                for remote, th_chunk, id_chunk in zip(
                    remotes,
                    chunk_across(list(theta), args.instances),
                    chunk_across(ids, args.instances),
                ):
                    for th, sid in zip(th_chunk, id_chunk):
                        remote.send(
                            shape_params=np.array(
                                [th[0], 1.0, 1.0, 1.0], np.float32
                            ),
                            shape_id=sid,
                        )
                # one render per sample, re-associated by shape_id
                by_id = {}
                while len(by_id) < args.samples:
                    item = next(images_iter)
                    if item["shape_id"] in ids:
                        by_id[item["shape_id"]] = item["image"]
                fake = on_device(np.stack([by_id[i] for i in ids]))
                real = on_device(target_batch(args.samples))
                dloss = disc_step(real, fake)
                losses = fake_scores(fake)
                mean_loss = sim.update(theta, losses)
                mu = float(sim.mu[0])
                history.append({"mu": mu, "d_loss": float(dloss),
                                "sim_loss": mean_loss})
                print(
                    f"iter {it}: mu={mu:.3f} "
                    f"(target {args.target_m}) d_loss={float(dloss):.4f} "
                    f"sim_loss={mean_loss:.4f}"
                )
        finally:
            for r in remotes:
                r.close()
    return {"history": history}


if __name__ == "__main__":
    main()
