"""Model FLOPs from shapes: two per multiply-add of every convolution
and linear layer; elementwise work is not counted."""

from __future__ import annotations


def trunk_macs(h: int, w: int, c: int, layers) -> tuple[int, int]:
    """Multiply-adds of a conv trunk of ``layers`` ``(features, kernel,
    stride)`` on one ``h x w x c`` input, and its flattened output
    width."""
    macs = 0
    for feats, k, s in layers:
        h, w = (h - k) // s + 1, (w - k) // s + 1
        macs += h * w * feats * k * k * c
        c = feats
    return macs, h * w * c


def dueling_heads_macs(features: int, head: int, actions: int) -> int:
    return features * head * 2 + head * actions + head

