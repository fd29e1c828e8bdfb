"""QuantLinear: the projection layer (port of ``repro.core.linear``).

===============  ==========================================================
``dense``        plain bf16 matmul (the "no paper" baseline)
``qat``          f32 matmul over fake-quantized operands (training mode;
                 straight-through gradients, serves what it trains)
``w8a8_nibble``  int8 activations x int8 weights through the nibble planes:
                 ``X.W = (X_hi.W) << 4 + X_lo.W``
``w4a8_nibble``  int8 activations x int4-valued weights (same product)
``lut``          int8 x int8 by selection from tables of pre-scaled
                 weights (the paper's LUT-array design)
===============  ==========================================================

Two backends for the integer modes: ``"torch"`` is the reference's
``"xla"`` formula (``linear.py:154-160``: plane-concatenated integer
product, or the LUT selection formula, then the scales applied outside),
and ``"cuda"`` is its ``"pallas"`` routing (``linear.py:144-152``: one
``ops.quant_matmul`` call; the nibble kernel runs the epilogue itself,
the LUT kernel returns int32 and the epilogue below applies it).  All apply
``acc.float() * x_scale * w_scale`` and then the cast, in that order, so
every route is bit-identical to the others.  ``dense`` and ``qat`` are
plain products that the reference leaves to XLA, so both backends run
``torch.matmul``.

Weights are stored ``(in, out)`` like the reference.  Serving quantizes
each weight once (:func:`prepare_quantized`) - the values are a pure
function of the weight, identical to quantizing on every call - and keeps
the int8 copy N-major, the layout the kernels read.
"""

from __future__ import annotations

import torch

from repro_torch.core import quantize as q
from repro_torch.kernels import ops
from repro_torch.kernels.lut_matmul import lut_matmul_plain
from repro_torch.kernels.nibble_matmul import nibble_matmul_plain

__all__ = ["linear_init", "linear_apply", "prepare_quantized",
           "weight_bits"]

_INT_MODES = ("w8a8_nibble", "w4a8_nibble", "lut")   # int8 activations


def linear_init(in_dim: int, out_dim: int, *, generator: torch.Generator,
                device, dtype=torch.bfloat16) -> dict:
    """He-style init, weights stored (in_dim, out_dim)."""
    scale = (2.0 / (in_dim + out_dim)) ** 0.5
    w = torch.randn((in_dim, out_dim), generator=generator, device=device,
                    dtype=torch.float32) * scale
    return {"w": w.to(dtype)}


def weight_bits(mode: str) -> int:
    return 4 if mode == "w4a8_nibble" else 8


def _quantize_weight(w: torch.Tensor, bits: int):
    """Per-output-channel symmetric quantization (``quantize.py:79``):
    returns the int8 values N-major (out, in) and the (1, out) scale."""
    wq = q.quantize(w.to(torch.float32), bits=bits,
                    granularity="per_channel", axis=0)
    return wq.values.t().contiguous(), wq.scale.reshape(1, -1)


def prepare_quantized(params: dict, mode: str) -> None:
    """Quantize one linear's weight for ``mode`` once, in place (adds
    ``qt{bits}`` (out, in) int8 and ``s{bits}`` (1, out) f32)."""
    if mode in _INT_MODES:
        bits = weight_bits(mode)
        params[f"qt{bits}"], params[f"s{bits}"] = _quantize_weight(
            params["w"], bits)


def _weight(params: dict, bits: int):
    """(K, N) int8 weight view and its (1, N) scale: the prepared copy, or
    quantized now when the weight was never prepared."""
    if f"qt{bits}" in params:
        qt, s = params[f"qt{bits}"], params[f"s{bits}"]
    else:
        qt, s = _quantize_weight(params["w"], bits)
    return qt.t(), s


def linear_apply(params: dict, x: torch.Tensor, *, mode: str = "dense",
                 backend: str = "torch") -> torch.Tensor:
    """Apply the projection; the output dtype follows ``x``."""
    w = params["w"]
    if mode == "dense":
        return torch.matmul(x, w.to(x.dtype))
    if mode == "qat":
        xq = q.fake_quant(x.to(torch.float32), bits=8, axis=-1)
        wq = q.fake_quant(w.to(torch.float32), bits=8, axis=0)
        return torch.matmul(xq, wq).to(x.dtype)
    if mode not in _INT_MODES:
        raise NotImplementedError(f"quant mode {mode!r} is not ported")

    x_qt = q.quantize(x.to(torch.float32), bits=8, granularity="per_tensor")
    w_q, w_scale = _weight(params, weight_bits(mode))
    if backend == "cuda" and mode != "lut":
        return ops.quant_matmul(x_qt.values, w_q, x_scale=x_qt.scale,
                                w_scale=w_scale, out_dtype=x.dtype)
    if backend == "cuda":
        matmul = lambda a, b: ops.quant_matmul(a, b, w_format="lut")
    elif backend == "torch":
        matmul = lut_matmul_plain if mode == "lut" else nibble_matmul_plain
    else:
        raise ValueError(f"quant_backend must be 'torch' or 'cuda', got "
                         f"{backend!r}")
    acc = matmul(x_qt.values, w_q)
    out = acc.to(torch.float32) * x_qt.scale * w_scale
    return out.to(x.dtype)
