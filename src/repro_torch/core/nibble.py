"""Nibble decomposition, the precompute logic and int4 packing (bit-exact
port of ``repro.core.nibble``).

* **signed** split (what int8 inference uses): ``x = hi * 16 + lo`` with
  ``lo`` the unsigned low nibble in ``[0, 16)`` and ``hi`` the
  arithmetically shifted high nibble in ``[-8, 8)``;
* **unsigned** split (the paper's convention): both nibbles in
  ``[0, 16)``;
* the precompute logic (PL, the paper's Fig. 2(b)): ``k * A`` for a
  nibble ``k`` as a fixed sum of shifted copies of ``A``, no multiplier;
* int4 storage: two signed nibbles per byte, low nibble = even column.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["split_nibbles_unsigned", "split_nibbles_signed",
           "combine_nibbles", "pl_scale", "pl_recipe_table",
           "pl_adder_count", "pl_scale_reference", "numpy_pl_scale",
           "pack_int4", "unpack_int4"]


def split_nibbles_unsigned(x: torch.Tensor):
    """(lo, hi) int32 planes of unsigned 8-bit values, both in [0, 16)."""
    x = x.to(torch.int32) & 0xFF
    return x & 0xF, (x >> 4) & 0xF


def split_nibbles_signed(x: torch.Tensor):
    """(lo, hi) int32 planes with ``x == hi * 16 + lo``; exact for int8."""
    x = x.to(torch.int32)
    lo = x & 0xF
    return lo, (x - lo) >> 4


def combine_nibbles(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Inverse of the splits: ``hi * 16 + lo`` in int32."""
    return hi.to(torch.int32) * 16 + lo.to(torch.int32)


# The sixteen PL recipes: the shift amounts of the terms ``A << s`` whose
# sum is ``k * A`` (the set bits of k; add-only, no Booth subtraction).
_PL_RECIPES: list[tuple[int, ...]] = [
    (), (0,), (1,), (1, 0), (2,), (2, 0), (2, 1), (2, 1, 0),
    (3,), (3, 0), (3, 1), (3, 1, 0), (3, 2), (3, 2, 0), (3, 2, 1),
    (3, 2, 1, 0),
]


def pl_recipe_table() -> list[tuple[int, ...]]:
    """The sixteen shift-and-add configurations (Fig. 2(b))."""
    return list(_PL_RECIPES)


def pl_adder_count(k: int) -> int:
    """Two-input additions the PL block performs for nibble ``k``: a
    recipe of m shifted terms needs m - 1 adders (shifts are wiring)."""
    return max(0, len(_PL_RECIPES[k & 0xF]) - 1)


def pl_scale(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``k * a`` through the precompute logic: ``k`` (nibbles in [0, 16),
    broadcastable against ``a``) gates the four terms ``a << bit``, which
    are summed in int32 (shifts, ands and adds; no general multiply of
    the operands)."""
    a = a.to(torch.int32)
    k = k.to(torch.int32)
    out = torch.zeros(torch.broadcast_shapes(a.shape, k.shape),
                      dtype=torch.int32, device=a.device)
    for bit in range(4):
        gate = (k >> bit) & 1          # is the (a << bit) term in the recipe?
        out = out + gate * (a << bit)  # gate is 0/1: an add of a shifted term
    return out


def pl_scale_reference(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain-multiply oracle for :func:`pl_scale` (tests only)."""
    return (a.to(torch.int32) * (k.to(torch.int32) & 0xF)).to(torch.int32)


def numpy_pl_scale(a: np.ndarray, k: int) -> np.ndarray:
    """NumPy mirror of the recipe dataflow, used by exhaustive tests."""
    out = np.zeros_like(a, dtype=np.int64)
    for shift in _PL_RECIPES[k & 0xF]:
        out = out + (a.astype(np.int64) << shift)
    return out


def pack_int4(w: torch.Tensor) -> torch.Tensor:
    """Pack signed int4 values ([-8, 8)) pairwise along the last axis into
    int8 bytes ``(hi << 4) | lo``; the last dimension must be even."""
    if w.shape[-1] % 2:
        raise ValueError("pack_int4: last dimension must be even")
    lo = w[..., 0::2].to(torch.int32) & 0xF
    hi = w[..., 1::2].to(torch.int32) & 0xF
    packed = (hi << 4) | lo
    return ((packed + 128) % 256 - 128).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: int8 values in [-8, 8), last axis
    doubled (shift, mask and sign-extend; no multiplier)."""
    p = packed.to(torch.int32) & 0xFF
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    lo = lo - ((lo >> 3) << 4)
    hi = hi - ((hi >> 3) << 4)
    out = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)
    return out.to(torch.int8)
