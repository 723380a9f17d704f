"""Hand-written CUDA kernels of the port, their plain twins and launch counts.

:data:`KERNELS` lists every kernel with the TPU kernel it replaces, so
``chip_smoke.py`` and ``PERF.md`` can account for each one.
"""

from blendjax_torch.kernels.attention import (
    FlashAttention,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_plain,
    flash_attention_fwd,
    flash_attention_fwd_plain,
    bwd_variant,
    fwd_variant,
)
from blendjax_torch.kernels.decode import (
    decode_scatter,
    decode_scatter_plain,
    decode_spatial,
    decode_spatial_plain,
)
from blendjax_torch.kernels.image import gamma_normalize, gamma_normalize_plain

_FLASH_SOURCE = "blendjax_torch/kernels/csrc/flash_attention.cu"
# the main-path (sm90) variants of the forward and of the two backward
# kernels; f32 and other inputs take _FLASH_SOURCE
_FLASH_FWD_SOURCE = "blendjax_torch/kernels/csrc/flash_fwd_sm90.cu"
_FLASH_BWD_SOURCE = "blendjax_torch/kernels/csrc/flash_bwd_sm90.cu"
# local_attention(backend="flash") reaches the JAX library's kernels here
_FLASH_CALL = "blendjax/ops/attention.py:157"
_FLASH_LIB = "jax/experimental/pallas/ops/tpu/flash_attention.py"

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
    "gamma_normalize": {
        "wrapper": gamma_normalize,
        "plain": gamma_normalize_plain,
        "route": "cuda",
        "source": "blendjax_torch/kernels/csrc/gamma_normalize.cu",
        "replaces": "blendjax/ops/image.py:70",
    },
    "flash_attention_fwd": {
        "wrapper": flash_attention_fwd,
        "plain": flash_attention_fwd_plain,
        "route": "cuda",
        "source": _FLASH_FWD_SOURCE,
        "replaces": f"{_FLASH_CALL} ({_FLASH_LIB}:758)",
    },
    "flash_attention_bwd_dkv": {
        "wrapper": flash_attention_bwd_dkv,
        "plain": flash_attention_bwd_dkv_plain,
        "route": "cuda",
        "source": _FLASH_BWD_SOURCE,
        "replaces": f"{_FLASH_CALL} ({_FLASH_LIB}:1121)",
    },
    "flash_attention_bwd_dq": {
        "wrapper": flash_attention_bwd_dq,
        "plain": flash_attention_bwd_dq_plain,
        "route": "cuda",
        "source": _FLASH_BWD_SOURCE,
        "replaces": f"{_FLASH_CALL} ({_FLASH_LIB}:1456)",
    },
}


def launch_counts() -> dict:
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}


def variant_counts() -> dict:
    """Launches by variant of each kernel that has variants."""
    return {name: dict(k["wrapper"].launches_by_variant)
            for name, k in KERNELS.items()
            if hasattr(k["wrapper"], "launches_by_variant")}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0
        for variant in getattr(k["wrapper"], "launches_by_variant", {}):
            k["wrapper"].launches_by_variant[variant] = 0


def add_launches(counts: dict, variants: dict) -> None:
    """Add the launches a CUDA graph captured, on each replay: a replay
    launches those kernels without running their wrappers."""
    for name, n in counts.items():
        KERNELS[name]["wrapper"].launches += n
    for name, by in variants.items():
        table = KERNELS[name]["wrapper"].launches_by_variant
        for variant, n in by.items():
            table[variant] += n


__all__ = [
    "FlashAttention",
    "KERNELS",
    "bwd_variant",
    "flash_attention",
    "flash_attention_bwd_dkv",
    "flash_attention_bwd_dkv_plain",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_dq_plain",
    "flash_attention_fwd",
    "flash_attention_fwd_plain",
    "fwd_variant",
    "decode_scatter",
    "decode_scatter_plain",
    "decode_spatial",
    "decode_spatial_plain",
    "gamma_normalize",
    "gamma_normalize_plain",
    "add_launches",
    "launch_counts",
    "reset_launch_counts",
    "variant_counts",
]
