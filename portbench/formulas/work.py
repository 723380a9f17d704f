"""Frozen copies of the hand-written kernels' work counts.

Copied from ``blendjax_torch/kernels/work.py`` so that a change to a
kernel or to its declared work cannot move the yardstick. FLOPs count two
per multiply-add; bytes count each input read once and each output
written once.
"""

from __future__ import annotations


def causal_pairs(tq: int, tk: int) -> int:
    """The (q, k) pairs a top-left aligned causal mask keeps."""
    tq, tk = int(tq), int(tk)
    full = max(tq - tk, 0)
    rows = tq - full
    return rows * (rows + 1) // 2 + full * tk


def attention_work(b, tq, tk, h, d, elem, causal: bool = False) -> dict:
    """``{kernel: (flops, bytes)}`` of one call of each flash kernel (K4a
    forward, K4b dK/dV, K4c dQ): FLOPs 4, 8 and 6 x B*H*pairs*D; bytes in
    ``elem``-byte elements, lse and di f32 (B, H, Tq)."""
    qb, kb, stat = b * tq * h * d * elem, b * tk * h * d * elem, b * h * tq * 4
    pairs = causal_pairs(tq, tk) if causal else tq * tk
    mnk = b * h * pairs * d
    return {
        "fwd": (4 * mnk, qb + 2 * kb + qb + stat),
        "bwd_dkv": (8 * mnk, 2 * qb + 2 * kb + 2 * stat + 2 * kb),
        "bwd_dq": (6 * mnk, 2 * qb + 2 * kb + 2 * stat + qb),
    }


def decode_work(n: int, ttc: int, idx_numel: int, valid: int,
                out_numel: int) -> tuple:
    """K1 and K2: the ``n`` reference tiles of ``ttc`` bytes, the int32
    indices, the ``valid`` changed tiles they name, and the uint8 output.
    Returns ``(flops, bytes)``."""
    return 0, n * ttc + idx_numel * 4 + valid * ttc + out_numel
