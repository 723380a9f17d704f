"""Smallest end-to-end program of the port.

The counterpart of the JAX package's ``examples/datagen/minimal.py``:
launch two cube producers, iterate batches and print their shapes. The
batches arrive as tensors already on the card (``--device cpu`` keeps them
on the host). Under ``torchrun`` with several ranks it splits each global
batch of 8 over the mesh ``{"data": -1}``, as the reference splits it over
its devices: each rank launches producers of its own and prints its rows
(4 of each batch at two ranks).

Run: ``python -m blendjax_torch.examples.datagen.minimal``
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--device", default="cuda",
        help="where the batches land: 'cuda' (the default; raises without "
        "a card) or 'cpu'",
    )
    args = ap.parse_args(argv)

    from blendjax_torch.device import device_flag
    from blendjax_torch.examples.datagen.train import data_mesh

    device = device_flag(args.device)
    mesh, opened = data_mesh(device)
    try:
        return _stream(device, mesh)
    finally:
        if opened:
            import torch.distributed as dist

            dist.destroy_process_group()


def _stream(device, mesh) -> dict:
    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.launcher import PythonProducerLauncher

    producer = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "cube_producer.py")
    # each rank's producers draw frames of their own
    seed = 10 if mesh is None else 10 + 1000 * mesh.get_rank()
    shapes = []
    with PythonProducerLauncher(
        script=producer, num_instances=2, named_sockets=["DATA"], seed=seed
    ) as launcher:
        with StreamDataPipeline(
            launcher.addresses["DATA"],
            # batch 8 = the reference benchmark's batch; on a mesh each
            # rank takes its rows of every global batch
            batch_size=8, device=device, launcher=launcher, mesh=mesh,
        ) as pipe:
            for i, batch in enumerate(pipe):
                shapes.append(tuple(batch["image"].shape))
                print(
                    f"batch {i}: image{tuple(batch['image'].shape)} "
                    f"xy{tuple(batch['xy'].shape)} on "
                    f"{batch['image'].device}"
                )
                if i == 4:
                    break
    return {"shapes": shapes}


if __name__ == "__main__":
    main()
