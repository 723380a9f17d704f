"""Observability (the port of ``blendjax/obs``, in part): so far only the
stamp stripping that replay needs (:mod:`blendjax_torch.obs.lineage`)."""

from blendjax_torch.obs.lineage import strip_stamps

__all__ = ["strip_stamps"]
