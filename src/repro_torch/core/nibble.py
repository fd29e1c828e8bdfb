"""Nibble decomposition and int4 packing (bit-exact port of
``repro.core.nibble``).

* **signed** split (what int8 inference uses): ``x = hi * 16 + lo`` with
  ``lo`` the unsigned low nibble in ``[0, 16)`` and ``hi`` the
  arithmetically shifted high nibble in ``[-8, 8)``;
* **unsigned** split (the paper's convention): both nibbles in
  ``[0, 16)``;
* int4 storage: two signed nibbles per byte, low nibble = even column.
"""

from __future__ import annotations

import torch

__all__ = ["split_nibbles_unsigned", "split_nibbles_signed",
           "combine_nibbles", "pack_int4", "unpack_int4"]


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
