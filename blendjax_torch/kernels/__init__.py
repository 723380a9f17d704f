"""Hand-written CUDA kernels of the port, their plain twins and launch counts.

:data:`KERNELS` lists every kernel with the TPU kernel it replaces, so
``chip_smoke.py`` and ``PERF.md`` can account for each one.
"""

from blendjax_torch.kernels.decode import (
    decode_scatter,
    decode_scatter_plain,
    decode_spatial,
    decode_spatial_plain,
)

KERNELS = {
    "decode_spatial": {
        "wrapper": decode_spatial,
        "plain": decode_spatial_plain,
        "route": "cuda",
        "source": "blendjax_torch/kernels/csrc/decode_spatial.cu",
        "replaces": "blendjax/ops/tiles.py:1185",
    },
    "decode_scatter": {
        "wrapper": decode_scatter,
        "plain": decode_scatter_plain,
        "route": "cuda",
        "source": "blendjax_torch/kernels/csrc/decode_scatter.cu",
        "replaces": "blendjax/ops/tiles.py:1116",
    },
}


def launch_counts() -> dict:
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0


__all__ = [
    "KERNELS",
    "decode_scatter",
    "decode_scatter_plain",
    "decode_spatial",
    "decode_spatial_plain",
    "launch_counts",
    "reset_launch_counts",
]
