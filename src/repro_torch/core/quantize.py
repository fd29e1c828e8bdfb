"""Symmetric int8/int4 quantization (bit-exact port of
``repro.core.quantize``: ``abs_max_scale`` and ``quantize``).

Scale-only, zero-point-free, per-tensor or per-channel.  ``torch.round``
rounds half to even exactly like ``jnp.round``; the ``x / scale``
division, the clip to ``[-qmax - 1, qmax]`` and the ``1e-8`` floor are
kept as the reference writes them.  The scale is the reference's as it
runs: under ``jit`` XLA turns its ``amax / qmax`` into a product with the
f32 reciprocal of ``qmax`` (:func:`scale_from_amax`), so values and
scales match the jitted reference bit for bit (a true division differs
in the last ulp of ~5% of the scales).

``fake_quant`` (QAT) is quantize-dequantize with a straight-through
gradient.  Its backward reproduces what JAX's autodiff gives the
reference: through ``jnp.clip`` (a max and a min) the gradient is 1
strictly inside the range, 0 outside, and **0.5 where the value sits
exactly on either bound** (JAX splits a tie of max/min evenly between its
operands), and the multiply / divide by the scale are transposed in the
reference's order, ``((g * scale) * c) / scale``.  A ``torch.clamp``
straight-through estimator would give 1 at the bound, and the abs-max
element of a channel lands exactly on ``qmax`` often.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

__all__ = ["QTensor", "abs_max_scale", "scale_from_amax", "quantize",
           "dequantize", "fake_quant"]

Granularity = Literal["per_tensor", "per_channel"]

_QMAX = {8: 127.0, 4: 7.0}
# the f32 reciprocals XLA multiplies by in place of ``/ qmax``
_RECIP = {bits: float(np.float32(1.0) / np.float32(q))
          for bits, q in _QMAX.items()}


@dataclasses.dataclass
class QTensor:
    """Integer values (int8 storage, also for 4-bit) plus their f32 scale."""
    values: torch.Tensor
    scale: torch.Tensor
    bits: int = 8

    def dequantize(self) -> torch.Tensor:
        return self.values.to(torch.float32) * self.scale


def abs_max_scale(x: torch.Tensor, bits: int = 8,
                  granularity: Granularity = "per_channel",
                  axis: int = -1) -> torch.Tensor:
    """Scale such that the abs-max of ``x`` maps to the integer max."""
    if granularity == "per_tensor":
        amax = x.abs().max()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    return scale_from_amax(amax, bits)


def scale_from_amax(amax: torch.Tensor, bits: int = 8,
                    floor: float = 1e-8) -> torch.Tensor:
    """``max(amax, floor) * f32(1 / qmax)``: what the jitted reference
    computes for its ``max(amax, floor) / qmax``."""
    return torch.clamp(amax, min=floor) * _RECIP[bits]


def quantize(x: torch.Tensor, bits: int = 8,
             granularity: Granularity = "per_channel",
             axis: int = -1, scale: torch.Tensor | None = None) -> QTensor:
    """Symmetric round-to-nearest-even quantization of a float tensor."""
    if scale is None:
        scale = abs_max_scale(x, bits, granularity, axis)
    qmax = _QMAX[bits]
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax).to(torch.int8)
    return QTensor(q, scale.to(torch.float32), bits)


def dequantize(q: QTensor) -> torch.Tensor:
    return q.dequantize()


class _FakeQuant(torch.autograd.Function):
    """``round(clip(x / scale, -qmax - 1, qmax)) * scale`` with the scale
    taken from ``x`` without gradient; backward as the module docstring
    says."""

    @staticmethod
    def forward(ctx, x, scale, qmax):
        t = x / scale
        lo, hi = -qmax - 1.0, qmax
        clipped = torch.clamp(t, lo, hi)
        ctx.save_for_backward(scale, (t > lo) & (t < hi),
                              (t == lo) | (t == hi))
        return torch.round(clipped) * scale

    @staticmethod
    def backward(ctx, g):
        scale, inside, tie = ctx.saved_tensors
        c = inside.to(g.dtype) + 0.5 * tie.to(g.dtype)
        return (g * scale) * c / scale, None, None


def fake_quant(x: torch.Tensor, bits: int = 8,
               granularity: Granularity = "per_channel",
               axis: int = -1, scale: torch.Tensor | None = None
               ) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient (QAT): the
    forward equals quantize -> dequantize bit for bit, the backward passes
    gradients through the rounding and the clip (with the reference's tie
    rule at the bounds).  ``scale`` given (a tensor-parallel shard's, from
    the whole tensor's amax) replaces the one taken from ``x``."""
    if scale is None:
        scale = abs_max_scale(x.detach(), bits, granularity, axis)
    return _FakeQuant.apply(x, scale, _QMAX[bits])
