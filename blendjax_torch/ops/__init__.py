"""Ops of the port: the tile-delta codec (``tiles``), image casts and
gamma normalize (``image``), augmentation (``augment``) and local
attention (``attention``).

The attention names resolve on first use, so that a producer importing
the numpy host half of ``tiles`` does not import torch."""

_ATTENTION = (
    "FLASH_BLOCK",
    "FLASH_RESIDUAL_BYTES",
    "NEG_INF",
    "auto_picks_flash",
    "flash_block_sizes",
    "flash_supported",
    "local_attention",
    "reference_attention",
    "scores_residual_bytes",
)


def __getattr__(name):
    if name in _ATTENTION:
        from blendjax_torch.ops import attention

        return getattr(attention, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = list(_ATTENTION)
