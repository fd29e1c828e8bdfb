"""Public entry points for the kernels (port of ``repro.kernels.ops``).

``quant_matmul`` is the single dispatch path for every quantized matmul:
leading dims are flattened, the weight format and the optional dequant
epilogue are arguments.  ``flash_mha`` is differentiable (an autograd
function over the flash forward and backward) and ``paged_flash_decode``
wraps the decode kernel, both in the reference's layouts.  Every wrapper
runs its plain version for CPU tensors and its CUDA kernel for CUDA
tensors; ragged shapes are masked inside the kernels instead of padded to
a 128 grid, and head dims are zero-padded only as far as the kernels need
(the results are the same).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (
    flash_attention_bwd,
    flash_attention_fwd,
    paged_decode_attention,
)
from repro_torch.kernels.lut_matmul import lut_matmul
from repro_torch.kernels.nibble_matmul import fused_nibble_matmul

__all__ = ["quant_matmul", "flash_mha", "paged_flash_decode", "W_FORMATS"]

W_FORMATS = ("int8", "int4_packed", "lut")


def _row_scale(s, m, device):
    """Scalar / (M,) / (M,1) scale -> f32 (M, 1)."""
    s = torch.as_tensor(s, dtype=torch.float32, device=device).reshape(-1, 1)
    return torch.broadcast_to(s, (m, 1))


def _col_scale(s, n, device):
    """Scalar / (N,) / (1,N) scale -> f32 (1, N)."""
    s = torch.as_tensor(s, dtype=torch.float32, device=device).reshape(1, -1)
    return torch.broadcast_to(s, (1, n))


def quant_matmul(x_q: torch.Tensor, w: torch.Tensor, *, x_scale=None,
                 w_scale=None, w_format: str = "int8",
                 out_dtype=None) -> torch.Tensor:
    """``x_q``: int8 (..., K).  ``w``: int8 (K, N) for "int8" and "lut",
    packed int4 (K, N//2) for "int4_packed".  Unscaled -> exact int32
    (..., N); with scales (``x_scale`` broadcastable to (M, 1), ``w_scale``
    to (1, N)) the result is ``(acc * x_scale) * w_scale`` in
    ``out_dtype`` (bf16 by default), an epilogue the nibble kernel runs
    itself.  "lut" runs the LUT-selection kernel, whose result is exact
    int32; the reference's epilogue follows it here: with scales,
    ``(float(acc) * x_scale) * w_scale`` in f32, cast to ``out_dtype``
    (bf16 by default); with no scales and an ``out_dtype``, the cast
    alone."""
    if w_format not in W_FORMATS:
        raise ValueError(f"w_format must be one of {W_FORMATS}: {w_format}")
    lead = x_q.shape[:-1]
    mat = x_q.reshape(-1, x_q.shape[-1])
    m = mat.shape[0]
    packed = w_format == "int4_packed"
    n = 2 * w.shape[1] if packed else w.shape[1]
    scaled = x_scale is not None or w_scale is not None
    if w_format == "lut":
        out = lut_matmul(mat, w)
        if scaled:
            out = out.to(torch.float32)
            if x_scale is not None:
                out = out * _row_scale(x_scale, m, out.device)
            if w_scale is not None:
                out = out * _col_scale(w_scale, n, out.device)
            out = out.to(torch.bfloat16 if out_dtype is None else out_dtype)
        elif out_dtype is not None:
            out = out.to(out_dtype)
        return out.reshape(*lead, n)
    if scaled and mat.device.type == "cpu":
        # the plain version broadcasts (M, 1) and (1, N); the kernel reads
        # a scale in place, broadcast or not, and a missing one as 1
        ones = torch.ones((), dtype=torch.float32, device=mat.device)
        x_scale = _row_scale(ones if x_scale is None else x_scale, m,
                             mat.device)
        w_scale = _col_scale(ones if w_scale is None else w_scale, n,
                             mat.device)
    out = fused_nibble_matmul(mat, w, x_scale, w_scale, w_packed=packed,
                              out_dtype=out_dtype)
    return out.reshape(*lead, n)


class _FlashMHA(torch.autograd.Function):
    """The reference's ``custom_vjp`` over both flash passes: the forward
    saves q, k, v, o and the row log-sum-exp; the backward forms
    ``dmat = rowsum(do * o)`` in f32, runs the flash backward and casts
    dq / dk / dv (dk and dv already summed onto the KV heads) to the input
    dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, softcap, group):
        o, lse = flash_attention_fwd(q, k, v, scale=scale, causal=causal,
                                     window=window, softcap=softcap,
                                     group=group)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(scale=scale, causal=causal, window=window,
                        softcap=softcap, group=group)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dmat = torch.sum(do.to(torch.float32) * o.to(torch.float32), dim=-1)
        dq, dk, dv = flash_attention_bwd(q, k, v, lse, do, dmat, **ctx.opts)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def flash_mha(q, k, v, scale, causal=True, window=0, softcap=0.0, group=1):
    """Flash attention over flat head-major layouts: q (B*H, Sq, d), k/v
    (B*KVH, Sk, d/dv), heads ordered (kv_head, group) so head ``bh`` reads
    K/V row ``bh // group``.  Returns o (B*H, Sq, dv); differentiable in
    q, k and v (the backward runs the flash backward kernels)."""
    return _FlashMHA.apply(q, k, v, scale, causal, window, softcap, group)


def paged_flash_decode(q, k_pool, v_pool, table, q_pos, *, scale, window=0,
                       softcap=0.0):
    """Single-token decode attention against a paged KV cache.  ``q``:
    (B, 1, H, d) with heads ordered (kv_head, group); pools (num_pages,
    page_size, KVH, d/dv); ``table`` (B, max_pages) int32; ``q_pos`` (B,).
    Returns (B, 1, H, dv)."""
    b, s, h, d = q.shape
    if s != 1:
        raise ValueError(f"paged decode takes one query per slot, got S={s}")
    kvh = k_pool.shape[2]
    dv = v_pool.shape[-1]
    o = paged_decode_attention(q.reshape(b, kvh, h // kvh, d), k_pool,
                               v_pool, table, q_pos, scale=scale,
                               window=window, softcap=softcap)
    return o.reshape(b, 1, h, dv)
