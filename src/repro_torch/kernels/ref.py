"""Plain oracles for the matmul kernels (port of ``repro.kernels.ref``).

Integer products run as float64 matmuls: every partial sum of an
int8 x int8 product over K <= 2**20 is an integer below 2**53, so the
float64 result is exact and independent of summation order, and it runs
on the CPU and the card alike (CUDA has no int32 matmul).
"""

from __future__ import annotations

import torch

from repro_torch.core.nibble import unpack_int4

__all__ = ["int_dot", "nibble_matmul_ref", "nibble_matmul_w4_ref"]


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

