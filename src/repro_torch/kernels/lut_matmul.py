"""LUT-array multiplier: the CUDA kernel and its plain version.

Port of ``repro.kernels.lut_matmul.lut_matmul_pallas``, the paper's
LUT-based design: the sixteen scaled copies ``v * w`` of every weight are
precomputed (a low table over unsigned nibble values and a high table
over signed ones with the ``<< 4`` folded in) and the activation's two
nibble patterns select among them; :func:`lut_matmul_plain` computes that
selection with tensors.  The kernel (``csrc/lut_matmul.cu``) applies the
same identity with the roles swapped, as the paper's design tables the
operand that is shared: at decode that is the activation, so it builds the
two int16 tables of the activation rows in shared memory and the weight's
nibbles select.  :func:`lut_plan` chooses its row tile and its split of K.
Both return the exact int32 product, equal to the nibble kernel's; the
dequant epilogue stays with the caller.

:func:`lut_matmul` dispatches on the device of ``x_q``: the plain version
for CPU tensors, the kernel for CUDA tensors (no fallback).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import int_dot

__all__ = ["lut_matmul", "lut_matmul_plain", "lut_matmul_cuda", "lut_plan",
           "LutPlan", "lut_launches"]

lut_launches = 0          # kernel launches by lut_matmul_cuda

BLOCK_COLS = 256          # columns per block: BN in csrc/lut_matmul.cu
BLOCKS_PER_SM = 8         # split K until the grid holds about this many


def lut_matmul_plain(x_q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 (..., K) x int8 (K, N) -> exact int32 (..., N) by the reference's
    selection formula: each activation is rebuilt from its nibble patterns
    through the two 16-entry scale tables (``lut_matmul_xla``), then
    contracted with the weight (exact float64 product, see ``ref``)."""
    v = torch.arange(16, dtype=torch.int32, device=x_q.device)
    lo_scale = v                                  # unsigned low nibble
    hi_scale = v - ((v >> 3) << 4)                # signed high nibble
    x = x_q.to(torch.int32)
    sel_lo = lo_scale[(x & 0xF).long()]
    sel_hi = hi_scale[((x >> 4) & 0xF).long()]
    x_rec = sel_lo + (sel_hi << 4)                # == x_q, via selection
    return int_dot(x_rec, w)


class LutPlan(NamedTuple):
    rows: int             # row tile of a block: 4, 8 or 16
    k_chunk: int          # K range of one split, a multiple of 256 // rows
    grid: tuple[int, int, int]   # (row tiles, column blocks, splits)


@functools.lru_cache(maxsize=256)
def lut_plan(m: int, n: int, k: int, sms: int = 132) -> LutPlan:
    """The kernel's launch for an (m, k) x (k, n) product on a card with
    ``sms`` SMs.  The row tile is the smallest of 4, 8, 16 that holds m
    (capped at 16); the block's K tile is ``256 // rows``.  K is split in
    whole tiles until the grid holds about ``BLOCKS_PER_SM * sms`` blocks:
    split s covers ``[s * k_chunk, min(k, (s + 1) * k_chunk))``, and no
    split is empty."""
    rows = 4 if m <= 4 else 8 if m <= 8 else 16
    k_tile = 256 // rows
    row_tiles, col_blocks = _cdiv(m, rows), _cdiv(n, BLOCK_COLS)
    want = max(1, BLOCKS_PER_SM * sms // (row_tiles * col_blocks))
    k_chunk = _cdiv(_cdiv(k, want), k_tile) * k_tile
    return LutPlan(rows, k_chunk, (row_tiles, col_blocks, _cdiv(k, k_chunk)))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib():
    fn = _build.library("lut_matmul").lut_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def lut_matmul_cuda(x_q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/lut_matmul.cu`` on CUDA tensors (same contract as
    :func:`lut_matmul_plain`).  The kernel reads the weight N-major: a
    ``w`` that is the transpose view of a contiguous (N, K) tensor (the
    layout serving prepares once) is used without a copy."""
    global lut_launches
    if x_q.device.type != "cuda" or w.device != x_q.device:
        raise ValueError("lut_matmul_cuda takes CUDA tensors on one device")
    if x_q.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {x_q.dtype} and "
                        f"{w.dtype}")
    if x_q.ndim != 2 or w.ndim != 2 or x_q.shape[1] != w.shape[0]:
        raise ValueError(f"shapes {tuple(x_q.shape)} x {tuple(w.shape)} "
                         f"do not contract")
    m, k = x_q.shape
    n = w.shape[1]
    x_q = x_q.contiguous()
    wt = w.t().contiguous()                       # (N, K), usually a view
    out = torch.empty((m, n), dtype=torch.int32, device=x_q.device)
    if m and n:
        if k == 0:
            return out.zero_()
        plan = lut_plan(m, n, k, _sm_count(x_q.device.index))
        err = _lib()(x_q.data_ptr(), wt.data_ptr(), out.data_ptr(), m, n, k,
                     plan.rows, plan.k_chunk,
                     torch.cuda.current_stream(x_q.device).cuda_stream)
        _build.check(err, "lut_matmul")
        lut_launches += 1
    return out


def lut_matmul(x_q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """LUT-selection matmul: plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    if x_q.device.type == "cpu":
        return lut_matmul_plain(x_q, w)
    return lut_matmul_cuda(x_q, w)
