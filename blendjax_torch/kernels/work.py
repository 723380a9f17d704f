"""The work each hand-written kernel does per launch: ``(flops, bytes)``.

One formula per kernel, shared by the wrappers (each declares its launch's
work from its arguments' shapes, and :func:`~blendjax_torch.kernels.counting.count_launch`
adds it to a capture's tally, which the device ledger reads) and by
``chip_smoke.py`` (the bound of each kernel). The kernels launch through
``ctypes``, so neither ``torch.utils.flop_counter.FlopCounterMode`` nor
the profiler's operator names see them; their declared work is how the
ledger counts them.

- FLOPs count the products of the attention kernels, two per
  multiply-add, as ``FlopCounterMode`` counts matrix products; the decode
  and gamma kernels declare none (``FlopCounterMode`` counts no
  elementwise work either).
- Bytes: each input read once and each output written once.

A causal attention call counts the (q, k) pairs its mask keeps (row ``i``
attends columns ``0..i``, top-left aligned), the work the call needs. The
decode kernels' declared bytes read every changed-tile slot of ``idx``;
what one call's data needs (the slots that are not sentinels) is passed
as ``valid`` by a caller that has it on the host.
"""

from __future__ import annotations


def causal_pairs(tq: int, tk: int) -> int:
    """The (q, k) pairs a top-left aligned causal mask keeps."""
    tq, tk = int(tq), int(tk)
    full = max(tq - tk, 0)  # rows that see every column
    rows = tq - full
    # rows 0 .. rows-1 see 1 .. rows columns
    return rows * (rows + 1) // 2 + full * tk


def attention_work(b, tq, tk, h, d, elem, causal: bool = False) -> dict:
    """``{kernel: (flops, bytes)}`` of one call of each flash kernel:
    FLOPs 4 (forward: q k^T and p v), 8 (dK/dV: q k^T again, do v^T,
    p^T do, ds^T q) and 6 (dQ: q k^T, do v^T, ds k) x B*H*pairs*D, where
    pairs is Tq*Tk (or :func:`causal_pairs`); bytes each input read once
    and each output written once, in ``elem``-byte elements (lse and di
    are f32 (B, H, Tq))."""
    qb, kb, stat = b * tq * h * d * elem, b * tk * h * d * elem, b * h * tq * 4
    pairs = causal_pairs(tq, tk) if causal else tq * tk
    mnk = b * h * pairs * d
    return {
        "flash_attention_fwd": (4 * mnk, qb + 2 * kb + qb + stat),
        "flash_attention_bwd_dkv": (8 * mnk,
                                    2 * qb + 2 * kb + 2 * stat + 2 * kb),
        "flash_attention_bwd_dq": (6 * mnk, 2 * qb + 2 * kb + 2 * stat + qb),
    }


def decode_work(n: int, ttc: int, idx_numel: int, valid: int,
                out_numel: int) -> tuple:
    """K1 and K2: the ``n`` reference tiles of ``ttc`` bytes, the int32
    indices, the ``valid`` changed tiles they name, and the uint8 output."""
    return 0, n * ttc + idx_numel * 4 + valid * ttc + out_numel


def gamma_work(numel: int, out_elem: int) -> tuple:
    """K3: ``numel`` uint8 in, ``numel`` elements of ``out_elem`` bytes out."""
    return 0, numel + numel * out_elem


__all__ = ["attention_work", "causal_pairs", "decode_work", "gamma_work"]
