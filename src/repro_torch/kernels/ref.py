"""Plain oracles for the matmul kernels (port of ``repro.kernels.ref``).

Integer products run as float64 matmuls: every partial sum of an
int8 x int8 product over K <= 2**20 is an integer below 2**53, so the
float64 result is exact and independent of summation order, and it runs
on the CPU and the card alike (CUDA has no int32 matmul).
"""

from __future__ import annotations

import torch

from repro_torch.core.nibble import split_nibbles_signed, unpack_int4

__all__ = ["int_dot", "nibble_matmul_ref", "nibble_matmul_w4_ref",
           "lut_matmul_ref", "quant_dequant_matmul_ref",
           "nibble_planes_ref"]


def int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer (..., K) x (K, N) -> int32 (..., N)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)) \
        .to(torch.int32)


def nibble_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 (M,K) x int8 (K,N) -> int32 (M,N), exact."""
    return int_dot(x_q, w_q)


def nibble_matmul_w4_ref(x_q: torch.Tensor,
                         w_packed: torch.Tensor) -> torch.Tensor:
    """int8 (M,K) x packed-int4 (K, N//2) -> int32 (M,N), exact."""
    return int_dot(x_q, unpack_int4(w_packed))


def lut_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Same product as :func:`nibble_matmul_ref`: the LUT path changes
    the dataflow (a table of k * W, then a select), not the
    mathematics."""
    return nibble_matmul_ref(x_q, w_q)


def quant_dequant_matmul_ref(x: torch.Tensor, w_q: torch.Tensor,
                             w_scale) -> torch.Tensor:
    """Quantize, nibble product, dequantize: ``x`` float (M, K) quantized
    per row to symmetric int8 (scale ``max(amax, 1e-8) / 127``, rounded
    half to even), the exact int32 product with ``w_q`` int8 (K, N),
    then f32 times the row scale times ``w_scale`` ((1, N) or a
    scalar).  Returns f32 (M, N)."""
    amax = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8)
    x_scale = amax / 127.0
    x_q = torch.clamp(torch.round(x / x_scale), -128, 127).to(torch.int8)
    acc = nibble_matmul_ref(x_q, w_q)
    return acc.to(torch.float32) * x_scale \
        * torch.as_tensor(w_scale, dtype=torch.float32, device=x.device)


def nibble_planes_ref(x_q: torch.Tensor) -> tuple:
    """The (lo, hi) int8 planes the kernels split activations into:
    ``x_q == hi * 16 + lo``, lo in [0, 16), hi in [-8, 8)."""
    lo, hi = split_nibbles_signed(x_q)
    return lo.to(torch.int8), hi.to(torch.int8)
