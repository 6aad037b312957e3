"""Published peaks by card name (NVIDIA data sheets, dense, no sparsity):
bf16 tensor FLOP/s and device-memory bytes/s.  The first key found in the
card's name wins."""

from __future__ import annotations

PEAKS = (("H100 PCIe", 756e12, 2.0e12), ("H100 NVL", 835e12, 3.9e12),
         ("H200", 989e12, 4.8e12), ("H100", 989e12, 3.35e12))


def peaks(card: str) -> tuple[float, float]:
    """``(bf16 FLOP/s, bytes/s)`` of the card called ``card``."""
    for key, flops, rate in PEAKS:
        if key in card:
            return flops, rate
    raise KeyError(f"no published peaks for card {card!r}")
