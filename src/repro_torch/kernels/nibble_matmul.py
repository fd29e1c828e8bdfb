"""Plane-fused nibble matmul: the CUDA kernel and its plain version.

Port of ``repro.kernels.nibble_matmul.fused_nibble_matmul_pallas``.  The
kernel (``csrc/nibble_matmul.cu``) splits the int8 activation tile into
its nibble planes ``lo = x & 0xF`` and ``hi << 4 = x - lo`` and runs both
planes against one shared weight fragment on int8 tensor cores, with
int32 accumulation and an optional ``(acc * x_scale) * w_scale`` epilogue.
It streams the weight through a ring of shared-memory stages and splits K
across blocks; :func:`nibble_plan` chooses its row tile and its split.
:func:`nibble_matmul_plain` computes the same function with tensors.

:func:`fused_nibble_matmul` dispatches on the device of ``x_q``: the
plain version for CPU tensors, the kernel for CUDA tensors (no fallback).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.nibble import split_nibbles_signed, unpack_int4
from repro_torch.kernels import _build
from repro_torch.kernels.lut_matmul import _cdiv, _sm_count
from repro_torch.kernels.ref import int_dot

__all__ = ["fused_nibble_matmul", "nibble_matmul_plain",
           "nibble_matmul_cuda", "nibble_plan", "NibblePlan", "launches"]

launches = 0        # kernel launches by nibble_matmul_cuda


def nibble_matmul_plain(x_q, w, x_scale=None, w_scale=None, *,
                        w_packed: bool = False, out_dtype=None):
    """``x_q``: int8 (M, K); ``w``: int8 (K, N) or packed int4 (K, N//2).
    Unscaled: exact int32 (M, N).  With ``x_scale`` (M, 1) and
    ``w_scale`` (1, N) f32: ``(acc * x_scale) * w_scale`` cast to
    ``out_dtype`` (bf16 by default).  The single-pass plane concatenation
    ``[lo | hi<<4] @ [W; W]`` of the reference."""
    if w_packed:
        w = unpack_int4(w)
    lo, hi = split_nibbles_signed(x_q)
    x_cat = torch.cat([lo, hi << 4], dim=-1).to(torch.int8)
    w_cat = torch.cat([w, w], dim=0)
    acc = int_dot(x_cat, w_cat)
    if x_scale is None and w_scale is None:
        return acc if out_dtype is None else acc.to(out_dtype)
    out = acc.to(torch.float32) * x_scale * w_scale
    return out.to(torch.bfloat16 if out_dtype is None else out_dtype)


_OUT_DTYPES = (torch.int32, torch.bfloat16, torch.float32)   # by out_kind

BLOCK_COLS = 64           # output columns per block: BN in the .cu
K_TILE = 128              # K bytes per pipeline stage: BK in the .cu
BLOCKS_PER_SM = 4         # split K until the grid holds about this many
MAX_SPLITS = 8            # the splits of a tile form one block cluster


class NibblePlan(NamedTuple):
    rows: int             # row tile: 8 (both planes in one MMA), 16 or 64
    k_chunk: int          # K range of one split, a multiple of K_TILE
    grid: tuple[int, int, int]   # (row tiles, column blocks, splits)


@functools.lru_cache(maxsize=256)
def nibble_plan(m: int, n: int, k: int, sms: int = 132) -> NibblePlan:
    """The kernel's launch for an (m, k) x (k, n) product on a card with
    ``sms`` SMs.  The row tile is 8 rows for m <= 8, 16 for m <= 16, else
    64 (as many tiles as m needs).  K is split in whole ``K_TILE`` tiles
    until the grid holds about ``BLOCKS_PER_SM * sms`` blocks, into at most
    ``MAX_SPLITS`` splits (one block cluster per output tile): split s
    covers ``[s * k_chunk, min(k, (s + 1) * k_chunk))``, and no split is
    empty."""
    rows = next((r for r in (8, 16) if m <= r), 64)
    row_tiles, col_blocks = _cdiv(m, rows), _cdiv(n, BLOCK_COLS)
    want = min(MAX_SPLITS,
               max(1, BLOCKS_PER_SM * sms // (row_tiles * col_blocks)))
    k_chunk = _cdiv(_cdiv(k, want), K_TILE) * K_TILE
    return NibblePlan(rows, k_chunk, (row_tiles, col_blocks,
                                      _cdiv(k, k_chunk)))


def _lib():
    fn = _build.library("nibble_matmul").nibble_matmul
    if fn.argtypes is None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, i64, ptr, i64, ptr] + [i32] * 7 \
            + [ptr]
        fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    if not t.is_contiguous():
        t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _scale(s, size: int, device):
    """An f32 scale broadcastable to a row (M, 1) or a column (1, N) of
    ``size`` values, as the kernel reads it: ``(tensor, stride)`` with
    ``s[i * stride]`` the scale of index i (stride 0 for one value);
    ``(None, 0)`` for no scale (a scale of 1)."""
    if s is None:
        return None, 0
    if not isinstance(s, torch.Tensor):
        s = torch.as_tensor(s, dtype=torch.float32, device=device)
    if s.dtype is not torch.float32 or s.device != device:
        s = s.to(device=device, dtype=torch.float32)
    count = s.numel()
    if count == 1:
        return s, 0
    if count != size:
        raise ValueError(f"scale of shape {tuple(s.shape)} does not "
                         f"broadcast to length {size}")
    if s.is_contiguous():
        return s, 1
    s = s.reshape(size)                       # a view: broadcast is stride 0
    return s, s.stride(0)


def nibble_matmul_cuda(x_q, w, x_scale=None, w_scale=None, *,
                       w_packed: bool = False, out_dtype=None):
    """Launch ``csrc/nibble_matmul.cu`` on CUDA tensors (same contract as
    :func:`nibble_matmul_plain`).  The kernel reads the weight N-major:
    a ``w`` that is the transpose view of a contiguous (N, K) tensor (the
    layout serving prepares once) is read in place; any other layout is
    transposed here.  Scales are read in place too, broadcast ones
    included (by stride); :func:`nibble_plan` picks the row tile and the
    split of K."""
    global launches
    dev = x_q.device
    if dev.type != "cuda" or w.device != dev:
        raise ValueError("nibble_matmul_cuda takes CUDA tensors on one "
                         "device")
    if x_q.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {x_q.dtype} and "
                        f"{w.dtype}")
    if x_q.ndim != 2 or w.ndim != 2 or x_q.shape[1] != w.shape[0]:
        raise ValueError(f"shapes {tuple(x_q.shape)} x {tuple(w.shape)} "
                         f"do not contract")
    m, k = x_q.shape
    n = 2 * w.shape[1] if w_packed else w.shape[1]
    pad = (-k) % 16                              # zero K padding is exact
    if pad:
        x_q, wt = F.pad(x_q, (0, pad)), F.pad(w.t(), (0, pad))
    elif w.stride() == (1, k) and w.data_ptr() % 16 == 0:
        wt = w            # the transpose of a row-major (N, K): read in place
    else:
        wt = _aligned(w.t())
    if not x_q.is_contiguous() or x_q.data_ptr() % 16:
        x_q = _aligned(x_q)
    if x_scale is None and w_scale is None:
        kind, dtype = 0, torch.int32
    else:
        dtype = torch.bfloat16 if out_dtype is None else out_dtype
        kind = 1 if dtype == torch.bfloat16 else 2
    xs, xs_stride = _scale(x_scale, m, dev)
    ws, ws_stride = _scale(w_scale, n, dev)
    out = torch.empty((m, n), dtype=_OUT_DTYPES[kind], device=dev)
    if m and n:
        if k == 0:
            out.zero_()
        else:
            plan = nibble_plan(m, n, k + pad, _sm_count(dev.index))
            err = _lib()(x_q.data_ptr(), wt.data_ptr(),
                         None if xs is None else xs.data_ptr(), xs_stride,
                         None if ws is None else ws.data_ptr(), ws_stride,
                         out.data_ptr(), m, n, k + pad, int(w_packed), kind,
                         plan.rows, plan.k_chunk,
                         # torch.cuda.current_stream(dev).cuda_stream,
                         # without building a Stream object per call
                         torch._C._cuda_getCurrentRawStream(dev.index))
            _build.check(err, "nibble_matmul")
            launches += 1
    if kind == 0:
        return out if out_dtype is None else out.to(out_dtype)
    return out if out.dtype == dtype else out.to(dtype)


def fused_nibble_matmul(x_q, w, x_scale=None, w_scale=None, *,
                        w_packed: bool = False, out_dtype=None):
    """The one entry point behind every nibble design: plain version for
    CPU tensors, the CUDA kernel for CUDA tensors."""
    if x_q.device.type == "cpu":
        return nibble_matmul_plain(x_q, w, x_scale, w_scale,
                                   w_packed=w_packed, out_dtype=out_dtype)
    return nibble_matmul_cuda(x_q, w, x_scale, w_scale, w_packed=w_packed,
                              out_dtype=out_dtype)
