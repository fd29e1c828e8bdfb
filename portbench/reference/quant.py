"""Symmetric integer quantization in float32, as the served models state
it: weights per output channel, activations per tensor, round half to
even, values clipped to ``[-qmax - 1, qmax]``."""

from __future__ import annotations

import torch

__all__ = ["QWeight", "quantize_weight", "qlinear"]

_QMAX = {8: 127.0, 4: 7.0}


class QWeight:
    """Integer-valued float32 weight (in, out) and its (1, out) scale."""

    def __init__(self, w: torch.Tensor, bits: int):
        w = w.to(torch.float32)
        qmax = _QMAX[bits]
        self.scale = torch.clamp(w.abs().amax(dim=0, keepdim=True),
                                 min=1e-8) / qmax
        self.values = torch.clamp(torch.round(w / self.scale), -qmax - 1,
                                  qmax)


def quantize_weight(w: torch.Tensor, bits: int = 8) -> QWeight:
    return QWeight(w, bits)


def qlinear(x: torch.Tensor, w: QWeight) -> torch.Tensor:
    """``x @ w`` with ``x`` quantized to int8 over the whole tensor; the
    integer product summed in float32, then both scales."""
    x = x.to(torch.float32)
    s = torch.clamp(x.abs().max(), min=1e-8) / 127.0
    xq = torch.clamp(torch.round(x / s), -128.0, 127.0)
    return (xq @ w.values) * s * w.scale
