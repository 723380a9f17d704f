"""Published peaks of the cards the benchmark runs on.

NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit: 989 TFLOP/s in bf16 and 3.35 TB/s of HBM3. A card set
below 700 W runs slower under load; the harness prints the card's power
limit beside every run.
"""

from __future__ import annotations

#: substring of ``torch.cuda.get_device_name()`` -> (bf16 FLOP/s, bytes/s)
PEAKS = (
    ("H100 PCIe", 756e12, 2.0e12),
    ("H100 NVL", 835e12, 3.9e12),
    ("H100", 989e12, 3.35e12),
)


def peaks(card: str) -> tuple:
    """``(bf16 FLOP/s, HBM bytes/s)`` of ``card``; an unknown card raises,
    since a share of the wrong peak reads as a plausible number."""
    for key, flops, bw in PEAKS:
        if key in card:
            return flops, bw
    raise ValueError(f"no published peak for {card!r}")
