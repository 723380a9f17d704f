"""Transformer training on a live producer stream: the port of the JAX
package's ``examples/datagen/train_transformer.py``.

:class:`~blendjax_torch.models.StreamFormer` (a patch-embedding transformer
regressing the same cube corners as ``CubeRegressor``) trains on streamed
raw frames over a mesh: the batch over ``data`` and, with a ``seq`` axis,
exact ring attention rotating K/V blocks around the ranks
(``blendjax_torch.parallel.ring``; Ulysses via ``--sp-mode ulysses``). The
attention runs the port's hand-written flash kernels (K4a-c): the sm90
variants for bf16 at head dim 64 or 128, the generic ``flash_attention.cu``
otherwise (the default ``--dim 128 --heads 4`` has head dim 32); with
``--device cpu``, their plain versions.

One process per card. On one card the mesh (``data=-1`` resolves to
``data=1``) lives on a process group of world size 1 that the example opens
(NCCL; gloo with ``--device cpu``) and closes; under ``torchrun`` the mesh
spans the group's ranks. On the card the step is captured as one CUDA graph
on every mesh, a sequence-parallel one too (the sequence split and gather,
Ulysses' all-to-alls or the ring's permutes inside the graph); on the CPU
and on a gloo group it runs eagerly.

Run on one card:

    python -m blendjax_torch.examples.datagen.train_transformer --steps 20

Sequence parallelism over two cards:

    torchrun --nproc_per_node 2 -m blendjax_torch.examples.datagen.train_transformer \\
        --steps 4 --mesh data=1,seq=2 --shape 64 64
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time


def parse_mesh(spec: str) -> dict:
    """'data=2,seq=2' -> {'data': 2, 'seq': 2} ('data=-1' fills with the
    remaining ranks)."""
    out = {}
    for part in spec.split(","):
        name, _, n = part.partition("=")
        out[name.strip()] = int(n)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--instances", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--shape", nargs=2, type=int, default=[128, 128])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--mesh", default="data=-1",
                    help="mesh axes over the ranks of the process group "
                    "(one per card), e.g. data=2,seq=2")
    ap.add_argument("--patch", type=int, default=16)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--sp-mode", choices=["ring", "ulysses"],
                    default="ring")
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize blocks (memory for FLOPs)")
    ap.add_argument(
        "--device", default="cuda",
        help="'cuda' (the default; raises without a card) or 'cpu' (the "
        "kernels' plain versions, gloo collectives, eager steps)",
    )
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.device import device_flag
    from blendjax_torch.launcher import PythonProducerLauncher
    from blendjax_torch.models import StreamFormer
    from blendjax_torch.parallel import create_mesh
    from blendjax_torch.parallel.mesh import init_group, mesh_shape
    from blendjax_torch.train import (
        CapturedStep,
        corner_loss,
        make_mesh_supervised_step,
        make_train_state,
    )
    from blendjax_torch.train.mesh_driver import warm_up_groups

    device = device_flag(args.device)
    h, w = args.shape
    result: dict = {"losses": []}
    with tempfile.TemporaryDirectory() as store:
        opened = init_group(device, store_dir=store)
        try:
            mesh = create_mesh(
                parse_mesh(args.mesh),
                devices="cpu" if device.type == "cpu" else None)
            shape = mesh_shape(mesh)
            model = StreamFormer(
                patch=args.patch, dim=args.dim, depth=args.depth,
                num_heads=args.heads, num_outputs=16, attn_backend="flash",
                image_shape=(h, w), use_ring=shape.get("seq", 1) > 1,
                mesh=mesh, sp_mode=args.sp_mode, remat=args.remat,
            ).init_params(0)
            state = make_train_state(model, device=device, mesh=mesh)

            def loss_fn(model, b):
                pred = model(b["image"])
                return corner_loss(pred.reshape(-1, 8, 2), b["xy"],
                                   image_shape=(h, w))

            step = make_mesh_supervised_step(state, mesh, loss_fn=loss_fn)
            # one graph on the card (eager on the CPU and over gloo); the
            # communicators exist before the capture
            warm_up_groups(mesh, list(shape))
            step = CapturedStep(step, mesh=mesh)
            result["step"] = step
            producer = os.path.join(
                os.path.dirname(os.path.abspath(__file__)),
                "cube_producer.py")
            seed = 1000 * dist.get_rank()
            with PythonProducerLauncher(
                script=producer,
                num_instances=args.instances,
                named_sockets=["DATA"],
                seed=seed,
                instance_args=[["--shape", str(h), str(w)]] * args.instances,
            ) as launcher:
                with StreamDataPipeline(
                    launcher.addresses["DATA"], batch_size=args.batch,
                    device=device, mesh=mesh,
                ) as pipe:
                    t0, n = time.perf_counter(), 0
                    for i, batch in enumerate(pipe):
                        if i >= args.steps:
                            break
                        state, metrics = step(
                            state, {"image": batch["image"],
                                    "xy": batch["xy"]}
                        )
                        n += args.batch  # the global batch
                        if i % 5 == 0:
                            loss = float(metrics["loss"])
                            result["losses"].append(loss)
                            print(f"step {i}: loss={loss:.5f}")
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    dt = time.perf_counter() - t0
                    result.update(images=n, seconds=dt, img_s=n / dt,
                                  mesh=shape, seq_gaps=pipe.seq_gaps)
                    print(
                        f"{n / dt:.1f} images/sec over mesh "
                        f"{shape} ({n} images in {dt:.1f}s)"
                    )
        finally:
            if opened:
                dist.destroy_process_group()
    return result


if __name__ == "__main__":
    main()
