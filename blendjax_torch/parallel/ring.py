"""Ring attention: exact attention over a sequence sharded across ranks
(port of ``blendjax/parallel/ring.py``).

The sequence dim of (B, T, H, D) is sharded over the ``seq`` axis. Each
rank keeps its query block; the key/value blocks travel around the ring
(``batch_isend_irecv`` through
:func:`~blendjax_torch.parallel.collectives._permute`, in their own dtype)
while a streaming softmax accumulates the exact result in f32, as the
reference's ``_ring_attention_local``: scores summed in f32, running max
and sum in f32, ``p`` cast to ``v``'s dtype before the second product.
The reference computes this body with einsums outside any kernel, and so
does the port (``torch.einsum`` on upcast operands).

Point-to-point sends carry no gradient, so :class:`_RingAttention` writes
the backward out: it runs the ring again from the saved log-sum-exp,
accumulating ``dq`` locally while each block's ``dk``/``dv`` partial sums
travel with that block and arrive home after ``n`` hops. With no ``seq``
axis on the mesh it is plain exact attention
(:func:`~blendjax_torch.ops.attention.reference_attention`).
"""

from __future__ import annotations

import torch

from blendjax_torch.ops.attention import NEG_INF, reference_attention
from blendjax_torch.parallel.collectives import _permute
from blendjax_torch.parallel.mesh import axes_index, axis_names, mesh_shape


def _scores(q, k_blk, scale, causal, q_pos, k_pos):
    """f32 scores (B, H, Tq, Tk) and the mask of entries kept (or None)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float()) * scale
    if not causal:
        return s, None
    keep = q_pos[:, None] >= k_pos[None, :]
    return torch.where(keep[None, None], s, torch.full_like(s, NEG_INF)), keep


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, scale):
        n = mesh_shape(mesh)[axis]
        my = axes_index(mesh, axis)
        b, tq, h, d = q.shape
        tk = k.shape[1]
        dev = q.device
        q_pos = my * tq + torch.arange(tq, device=dev)
        o = torch.zeros((b, h, tq, d), dtype=torch.float32, device=dev)
        m = torch.full((b, h, tq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, tq), dtype=torch.float32, device=dev)
        k_cur, v_cur = k.contiguous(), v.contiguous()
        for i in range(n):
            src = (my - i) % n  # the block held arrived from rank my - i
            k_pos = src * tk + torch.arange(tk, device=dev)
            s, _keep = _scores(q, k_cur, scale, causal, q_pos, k_pos)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # fully masked rows: exp(NEG_INF - NEG_INF) would be 1
            p = torch.exp(s - m_new[..., None])
            p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
            corr = torch.exp(m - m_new)
            corr = torch.where(m <= NEG_INF / 2, torch.zeros_like(corr), corr)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(v.dtype).float(), v_cur.float())
            m = m_new
            if i < n - 1:
                k_cur = _permute(k_cur, mesh, axis, 1)
                v_cur = _permute(v_cur, mesh, axis, 1)
        out = (o / torch.clamp(l, min=1e-30)[..., None]).permute(0, 2, 1, 3)
        out = out.to(q.dtype)
        lse = m + torch.log(torch.clamp(l, min=1e-30))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (mesh, axis, causal, scale, n, my)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis, causal, scale, n, my = ctx.args
        b, tq, h, d = q.shape
        tk = k.shape[1]
        dev = q.device
        q_pos = my * tq + torch.arange(tq, device=dev)
        do_f = do.float().permute(0, 2, 1, 3)  # (B, H, Tq, D)
        q_f = q.float().permute(0, 2, 1, 3)
        delta = (do_f * out.float().permute(0, 2, 1, 3)).sum(dim=-1)
        dq = torch.zeros((b, h, tq, d), dtype=torch.float32, device=dev)
        k_cur, v_cur = k.contiguous(), v.contiguous()
        dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=dev)
        dv_cur = torch.zeros(v.shape, dtype=torch.float32, device=dev)
        for i in range(n):
            src = (my - i) % n
            k_pos = src * tk + torch.arange(tk, device=dev)
            s, keep = _scores(q, k_cur, scale, causal, q_pos, k_pos)
            p = torch.exp(s - lse[..., None])
            if keep is not None:
                p = torch.where(keep[None, None], p, torch.zeros_like(p))
            dv_cur = dv_cur + torch.einsum(
                "bhqk,bhqd->bkhd", p.to(v.dtype).float(), do_f)
            dp = torch.einsum("bhqd,bkhd->bhqk", do_f, v_cur.float())
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhqk,bkhd->bhqd", ds,
                                   k_cur.float()) * scale
            dk_cur = dk_cur + torch.einsum("bhqk,bhqd->bkhd", ds, q_f) * scale
            if n > 1:
                # the block's partial sums travel with it: after n hops
                # they are home
                if i < n - 1:
                    k_cur = _permute(k_cur, mesh, axis, 1)
                    v_cur = _permute(v_cur, mesh, axis, 1)
                dk_cur = _permute(dk_cur, mesh, axis, 1)
                dv_cur = _permute(dv_cur, mesh, axis, 1)
        return (dq.permute(0, 2, 1, 3).to(q.dtype), dk_cur.to(k.dtype),
                dv_cur.to(v.dtype), None, None, None, None)


def ring_attention(q, k, v, mesh, axis: str = "seq", causal: bool = False,
                   scale: float | None = None,
                   batch_axis: str | None = "data"):
    """Exact multi-head attention over this rank's (B, T/n, H, D) sequence
    block of ``axis``; the output is this rank's block of the result, in
    the input dtype. ``batch_axis`` names the batch's axis (the rank's rows
    are its own)."""
    del batch_axis
    d = q.shape[-1]
    scale = scale if scale is not None else d**-0.5
    if axis not in axis_names(mesh):
        return reference_attention(q, k, v, causal=causal, scale=scale)
    return _RingAttention.apply(q, k, v, mesh, axis, bool(causal),
                                float(scale))


__all__ = ["reference_attention", "ring_attention"]
