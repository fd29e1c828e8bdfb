"""Plane-fused nibble matmul: the CUDA kernel and its plain version.

Port of ``repro.kernels.nibble_matmul.fused_nibble_matmul_pallas``.  The
kernel (``csrc/nibble_matmul.cu``) splits the int8 activation tile into
its nibble planes ``lo = x & 0xF`` and ``hi << 4 = x - lo`` and runs both
planes against one shared weight fragment on int8 tensor cores, with
int32 accumulation and an optional ``(acc * x_scale) * w_scale`` epilogue.
:func:`nibble_matmul_plain` computes the same function with tensors.

:func:`fused_nibble_matmul` dispatches on the device of ``x_q``: the
plain version for CPU tensors, the kernel for CUDA tensors (no fallback).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.nibble import split_nibbles_signed, unpack_int4
from repro_torch.kernels import _build
from repro_torch.kernels.ref import int_dot

__all__ = ["fused_nibble_matmul", "nibble_matmul_plain",
           "nibble_matmul_cuda", "launches"]

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


def _lib():
    lib = _build.library("nibble_matmul")
    fn = lib.nibble_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def nibble_matmul_cuda(x_q, w, x_scale=None, w_scale=None, *,
                       w_packed: bool = False, out_dtype=None):
    """Launch ``csrc/nibble_matmul.cu`` on CUDA tensors (same contract as
    :func:`nibble_matmul_plain`).  The kernel reads the weight N-major:
    a ``w`` that is the transpose view of a contiguous (N, K) tensor (the
    layout serving prepares once) is used without a copy; any other
    layout is transposed here."""
    global launches
    if x_q.device.type != "cuda" or w.device != x_q.device:
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
    wt = w.t()                                   # (N or N/2, K)
    pad = (-k) % 16                              # zero K padding is exact
    x_q = F.pad(x_q, (0, pad)) if pad else x_q
    wt = F.pad(wt, (0, pad)) if pad else wt
    x_q, wt = _aligned(x_q), _aligned(wt)
    scaled = x_scale is not None or w_scale is not None
    if not scaled:
        kind, dtype = 0, torch.int32
        xs = ws = None
    else:
        dtype = torch.bfloat16 if out_dtype is None else out_dtype
        kind = 1 if dtype == torch.bfloat16 else 2
        xs = _aligned(torch.broadcast_to(
            torch.ones((), device=x_q.device) if x_scale is None
            else x_scale.to(torch.float32).reshape(-1, 1), (m, 1)))
        ws = _aligned(torch.broadcast_to(
            torch.ones((), device=x_q.device) if w_scale is None
            else w_scale.to(torch.float32).reshape(1, -1), (1, n)))
    out = torch.empty((m, n), dtype=_OUT_DTYPES[kind],
                      device=x_q.device)
    if m and n:
        err = _lib()(x_q.data_ptr(), wt.data_ptr(),
                     None if xs is None else xs.data_ptr(),
                     None if ws is None else ws.data_ptr(),
                     out.data_ptr(), m, n, k + pad, int(w_packed), kind,
                     torch.cuda.current_stream(x_q.device).cuda_stream)
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
