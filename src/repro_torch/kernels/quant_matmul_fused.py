"""Quantize, nibble matmul, dequantize (port of
``repro.kernels.quant_matmul_fused``): bf16/f32 activations in,
``out_dtype`` out.

The per-row symmetric int8 quantization is a prologue in PyTorch (an
abs-max reduction and a rounding pass); the product and the scale fold
run in the nibble kernel with its ``(acc * x_scale) * w_scale`` epilogue
(``ops.quant_matmul``), so the int32 accumulator never reaches memory.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantize import scale_from_amax

__all__ = ["quantize_rows", "quant_matmul_fused"]


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization: (x_q int8, x_scale f32 (M, 1)),
    the scale multiplied by the f32 reciprocal of 127, as the jitted
    reference computes its ``amax / 127.0``."""
    x = x.to(torch.float32)
    x_scale = scale_from_amax(x.abs().amax(dim=-1, keepdim=True))
    x_q = torch.clamp(torch.round(x / x_scale), -128, 127).to(torch.int8)
    return x_q, x_scale


def quant_matmul_fused(x: torch.Tensor, w_q: torch.Tensor,
                       w_scale: torch.Tensor, *,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """float (..., K) x int8 (K, N) with a (1, N) or scalar f32 scale ->
    ``out_dtype`` (..., N): :func:`quantize_rows`, then the nibble
    kernel's scaled product (its plain version for CPU tensors)."""
    from repro_torch.kernels.ops import quant_matmul  # ops imports this
    lead = x.shape[:-1]
    x_q, x_scale = quantize_rows(x.reshape(-1, x.shape[-1]))
    out = quant_matmul(x_q, w_q, x_scale=x_scale, w_scale=w_scale,
                       w_format="int8", out_dtype=out_dtype)
    return out.reshape(*lead, out.shape[-1])
