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

Each entry point also knows its cost from its arguments' shapes alone
(:func:`costed`): a static walk (``staticcheck.flops``) sets
:data:`cost_hook`, and the entry points hand it their calls, so a stage's
count is the same whichever implementation runs it.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lut_matmul as _lm
from repro_torch.kernels import nibble_matmul as _nm
from repro_torch.kernels.flash_attention import (
    flash_attention_bwd,
    flash_attention_fwd,
    paged_decode_attention,
)
from repro_torch.kernels.nibble_matmul import fused_nibble_matmul
from repro_torch.kernels.quant_matmul_fused import quant_matmul_fused

__all__ = ["quant_matmul", "nibble_matmul", "nibble_matmul_w4", "lut_matmul",
           "quant_matmul_fused", "flash_mha", "paged_flash_decode",
           "W_FORMATS", "LAUNCH_COUNTERS", "launch_counts",
           "add_launch_counts", "costed", "tensor_bytes"]

W_FORMATS = ("int8", "int4_packed", "lut")

# every wrapper's launch counter, ``(module, attribute)``.  A wrapper
# counts in Python, which a CUDA graph's replay does not run, so whoever
# replays a graph adds the counts its capture recorded
# (``serve.engine._CapturedStage``)
LAUNCH_COUNTERS = tuple((mod, name) for mod, names in (
    (_nm, ("launches",)),
    (_lm, ("lut_launches",)),
    (_fa, ("fwd_launches", "paged_launches", "bwd_dq_launches",
           "bwd_dkv_launches", "fwd_f32_launches", "paged_f32_launches",
           "bwd_f32_dq_launches", "bwd_f32_dkv_launches"))) for name in names)


def launch_counts() -> list[int]:
    """The counters of :data:`LAUNCH_COUNTERS`, in order."""
    return [getattr(mod, name) for mod, name in LAUNCH_COUNTERS]


def add_launch_counts(delta) -> None:
    """Add ``delta`` (one int per counter of :data:`LAUNCH_COUNTERS`)."""
    for (mod, name), d in zip(LAUNCH_COUNTERS, delta):
        setattr(mod, name, getattr(mod, name) + d)


# None unless a static walk runs; then a costed entry point returns
# ``cost_hook(fn, cost, args, kwargs)``, which must run ``fn(*args,
# **kwargs)`` and return its result (``staticcheck.flops``)
cost_hook = None


def tensor_bytes(*ts) -> int:
    """Bytes of the tensors among ``ts`` (anything else counts 0)."""
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def costed(cost):
    """Mark ``fn`` as an entry point whose work ``cost(*args, **kwargs)``
    gives from shapes alone, as ``(int_macs, float_macs, bytes,
    padding_macs)``: the MACs of its products, the bytes of its operands
    and result, each read or written once, and the MACs it runs beyond
    its work (zero rows a fixed-shape call pads with; 0 for the
    kernels).  Outside a walk a call pays one ``is None`` check, so a
    captured graph replays unchanged."""
    def wrap(fn):
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            if cost_hook is None:
                return fn(*args, **kwargs)
            return cost_hook(fn, cost, args, kwargs)
        return entry
    return wrap


def _quant_matmul_cost(x_q, w, *, x_scale=None, w_scale=None,
                       w_format="int8", out_dtype=None):
    """The nibble formats count each product twice, once per activation
    plane (the reference's plane-concatenated K); ``lut`` once."""
    k = x_q.shape[-1]
    m = x_q.numel() // max(k, 1)
    n = 2 * w.shape[1] if w_format == "int4_packed" else w.shape[1]
    if out_dtype is None:
        scaled = x_scale is not None or w_scale is not None
        out_dtype = torch.bfloat16 if scaled else torch.int32
    planes = 1 if w_format == "lut" else 2
    out = m * n * out_dtype.itemsize
    return (planes * m * n * k, 0,
            tensor_bytes(x_q, w, x_scale, w_scale) + out, 0)


def _row_scale(s, m, device):
    """Scalar / (M,) / (M,1) scale -> f32 (M, 1)."""
    s = torch.as_tensor(s, dtype=torch.float32, device=device).reshape(-1, 1)
    return torch.broadcast_to(s, (m, 1))


def _col_scale(s, n, device):
    """Scalar / (N,) / (1,N) scale -> f32 (1, N)."""
    s = torch.as_tensor(s, dtype=torch.float32, device=device).reshape(1, -1)
    return torch.broadcast_to(s, (1, n))


@costed(_quant_matmul_cost)
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
        out = _lm.lut_matmul(mat, w)
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


# The seed entry points: thin shims over quant_matmul.  The reference's
# ``bm``, ``bn``, ``bk``, ``unroll_passes`` and ``interpret`` are Pallas
# tiling and interpreter knobs with no meaning for the CUDA kernels, which
# plan their own tiles (``nibble_plan``, ``lut_plan``), so they are not
# taken.  ``quant_matmul_fused`` (per-row int8 quantization, then the
# nibble kernel with its epilogue) lives in ``kernels.quant_matmul_fused``.

def nibble_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 (..., K) x int8 (K, N) -> exact int32 (..., N): the paper's
    kernel."""
    return quant_matmul(x_q, w_q, w_format="int8")


def nibble_matmul_w4(x_q: torch.Tensor,
                     w_packed: torch.Tensor) -> torch.Tensor:
    """int8 (..., K) x packed int4 (K, N//2) -> exact int32 (..., N)."""
    return quant_matmul(x_q, w_packed, w_format="int4_packed")


def lut_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 (..., K) x int8 (K, N) -> exact int32 (..., N) by LUT
    selection."""
    return quant_matmul(x_q, w_q, w_format="lut")


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


def _flash_mha_cost(q, k, v, *args, **kwargs):
    """Every (query, key) pair of the square: the plain version's work
    and the analytic model's (the causal mask is not subtracted)."""
    bh, sq, d = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    out = bh * sq * dv * q.element_size()
    return 0, bh * sq * sk * (d + dv), tensor_bytes(q, k, v) + out, 0


@costed(_flash_mha_cost)
def flash_mha(q, k, v, scale, causal=True, window=0, softcap=0.0, group=1):
    """Flash attention over flat head-major layouts: q (B*H, Sq, d), k/v
    (B*KVH, Sk, d/dv), heads ordered (kv_head, group) so head ``bh`` reads
    K/V row ``bh // group``.  Returns o (B*H, Sq, dv); differentiable in
    q, k and v (the backward runs the flash backward kernels)."""
    return _FlashMHA.apply(q, k, v, scale, causal, window, softcap, group)


def _paged_decode_cost(q, k_pool, v_pool, table, q_pos, **kwargs):
    """Over the table's full width x page size, the padded ``kv_len`` of
    ``analytic_macs``: the rows the table names, whatever ``q_pos`` holds
    (the values are never read)."""
    b, _, h, d = q.shape
    ps, kvh, dv = k_pool.shape[1], k_pool.shape[2], v_pool.shape[-1]
    rows = b * table.shape[1] * ps
    pages = rows * kvh * (d * k_pool.element_size()
                          + dv * v_pool.element_size())
    out = b * h * dv * q.element_size()
    return (0, rows * h * (d + dv),
            tensor_bytes(q, table, q_pos) + pages + out, 0)


@costed(_paged_decode_cost)
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
