"""Symmetric int8/int4 quantization (bit-exact port of
``repro.core.quantize``: ``abs_max_scale`` and ``quantize``).

Scale-only, zero-point-free, per-tensor or per-channel.  ``torch.round``
rounds half to even exactly like ``jnp.round``; the ``x / scale``
division, the clip to ``[-qmax - 1, qmax]`` and the ``1e-8`` floor are
kept as the reference writes them, so values and scales match bit for
bit.  ``fake_quant`` (QAT) waits for the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

__all__ = ["QTensor", "abs_max_scale", "quantize"]

Granularity = Literal["per_tensor", "per_channel"]

_QMAX = {8: 127.0, 4: 7.0}


@dataclasses.dataclass
class QTensor:
    """Integer values (int8 storage, also for 4-bit) plus their f32 scale."""
    values: torch.Tensor
    scale: torch.Tensor
    bits: int = 8


def abs_max_scale(x: torch.Tensor, bits: int = 8,
                  granularity: Granularity = "per_channel",
                  axis: int = -1) -> torch.Tensor:
    """Scale such that the abs-max of ``x`` maps to the integer max."""
    qmax = _QMAX[bits]
    if granularity == "per_tensor":
        amax = x.abs().max()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    return torch.clamp(amax, min=1e-8) / qmax


def quantize(x: torch.Tensor, bits: int = 8,
             granularity: Granularity = "per_channel",
             axis: int = -1, scale: torch.Tensor | None = None) -> QTensor:
    """Symmetric round-to-nearest-even quantization of a float tensor."""
    if scale is None:
        scale = abs_max_scale(x, bits, granularity, axis)
    qmax = _QMAX[bits]
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax).to(torch.int8)
    return QTensor(q, scale.to(torch.float32), bits)
