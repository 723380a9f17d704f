"""Ulysses sequence parallelism: two all-to-alls around a local attention
(port of ``blendjax/parallel/ulysses.py``).

The sequence dim of (B, T, H, D) is sharded over the ``seq`` axis. An
all-to-all re-shards each of q, k, v to the head-sharded layout
(B, T, H/n, D): split the heads n ways, send chunk ``j`` to rank ``j``,
concatenate the received sequence blocks in rank (= sequence) order.
Attention then runs locally over the whole sequence for this rank's
heads, through :func:`blendjax_torch.ops.attention.local_attention`: with
``backend="flash"`` that is the flash kernels K4a (forward) and K4b/K4c
(backward, through their ``autograd.Function``). The inverse all-to-all
brings the output back to (B, T/n, H, D). Backward runs the same two
all-to-alls the other way (:func:`~blendjax_torch.parallel.collectives.all_to_all`).

Trade-off against ring attention (both exact): Ulysses moves q, k, v and o
once each and needs ``num_heads % n == 0``; ring moves k and v n-1 times
and keeps the sequence sharded through the softmax.

:data:`calls` counts this rank's calls that ran a local attention, and
:data:`flash_calls` those that took the flash kernels (each such call
launches K4a once, and its backward K4b and K4c once each). They count as
the kernels' launches do (:func:`blendjax_torch.kernels.counting.count_call`):
a call inside a CUDA graph's warm-up or capture counts nothing, and each
replay of the graph adds the calls it holds, so a captured step reads the
same counts per step call as an eager one.
"""

from __future__ import annotations

from blendjax_torch.kernels.counting import count_call, register_counter
from blendjax_torch.parallel.mesh import axis_names, mesh_shape

calls = 0
flash_calls = 0


def _add_calls(n: int) -> None:
    global calls
    calls += n


def _add_flash_calls(n: int) -> None:
    global flash_calls
    flash_calls += n


register_counter("ulysses.calls", _add_calls)
register_counter("ulysses.flash_calls", _add_flash_calls)


def reset_counts() -> None:
    global calls, flash_calls
    calls = flash_calls = 0


def ulysses_attention(q, k, v, mesh, axis: str = "seq", causal: bool = False,
                      scale: float | None = None,
                      batch_axis: str | None = "data",
                      backend: str = "auto"):
    """Exact multi-head attention over this rank's (B, T/n, H, D) sequence
    block of ``axis`` (``n = mesh`` size of ``axis``). ``H % n`` must be 0.
    ``backend`` picks the local attention after the all-to-all, whose
    ``auto`` policy sees the post-all-to-all shape (B, T, H/n, D).
    ``batch_axis`` names the batch's axis (rows are per rank in the port:
    each rank passes its own). Without ``axis`` on the mesh this is the
    local attention of the whole tensors."""
    from blendjax_torch.ops import attention as A
    from blendjax_torch.parallel.collectives import all_to_all

    del batch_axis  # the rank's rows are its own
    d = q.shape[-1]
    scale = scale if scale is not None else d**-0.5
    if axis not in axis_names(mesh):
        return A.local_attention(q, k, v, causal=causal, scale=scale,
                                 backend=backend)
    n = mesh_shape(mesh)[axis]
    h = q.shape[2]
    if h % n:
        raise ValueError(
            f"ulysses needs num_heads ({h}) divisible by the {axis!r} axis "
            f"size ({n}); use ring_attention otherwise")
    # head-scatter / sequence-gather: (B, T/n, H, D) -> (B, T, H/n, D)
    qg, kg, vg = (all_to_all(x, mesh, axis, split_dim=2, concat_dim=1)
                  for x in (q, k, v))
    count_call("ulysses.calls")
    if backend == "flash" or (backend == "auto"
                              and A.auto_picks_flash(qg, kg)):
        count_call("ulysses.flash_calls")
    o = A.local_attention(qg, kg, vg, causal=causal, scale=scale,
                          backend=backend)
    # sequence-scatter / head-gather back to (B, T/n, H, D)
    return all_to_all(o, mesh, axis, split_dim=1, concat_dim=2)


__all__ = ["reset_counts", "ulysses_attention"]
