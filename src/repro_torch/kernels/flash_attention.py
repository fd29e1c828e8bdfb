"""Flash attention forward and backward, paged decode: CUDA kernels +
plain versions.

Ports of ``repro.kernels.flash_attention.flash_attention_fwd_pallas``,
``flash_attention_bwd_pallas`` and ``paged_decode_attention_pallas``.
Each entry point takes q, k, v (and do) all in bf16 or all in f32, as
the reference does, and has a route per dtype:

* bf16: the forward (``csrc/flash_attention.cu``), the backward
  (``csrc/flash_attention_bwd.cu``: a dq kernel and a dk/dv kernel) and
  paged decode (``csrc/paged_decode.cu``: split over the cache by
  :func:`paged_plan`, the splits summed in a thread-block cluster) on
  bf16 tensor cores (``mma.sync``);
* f32: SIMT kernels (``csrc/attention_f32.cu``) that compute the
  reference's f32 function: no rounding of p before PV or of ds before
  the dq / dk products.

All run an online softmax in f32 with the finite ``-1e30`` mask sentinel
and cast ``p`` to the value dtype before the PV product; the backward
recomputes ``p`` from the saved log-sum-exp with the reference's casts.
The plain versions compute the same functions densely over all keys (no
blocking), so kernel and plain agree to float rounding, not bit for bit.

Head dims: the kernels take d, dv <= 256.  The wrappers zero-pad them (the
flash kernels to their instance's width ``bwd_width(d, dv)``, paged decode
and the SIMT kernels to multiples of 8, which copies no pool at any config
of the repo: paged decode zero-fills its instance's missing columns in its
loads) and slice the outputs back; zero columns change neither ``q . k``
nor the log-sum-exp, and give zero output columns.  The reference pads to
128 instead, to the same effect.

Dispatch is by device: plain version for CPU tensors, kernel for CUDA
tensors (no fallback).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lut_matmul import _cdiv, _sm_count

__all__ = ["flash_attention_fwd", "flash_attention_fwd_plain",
           "flash_attention_fwd_cuda", "paged_decode_attention",
           "paged_decode_attention_plain", "paged_decode_attention_cuda",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_bwd_cuda", "fwd_launches", "paged_launches",
           "bwd_dq_launches", "bwd_dkv_launches", "fwd_f32_launches",
           "paged_f32_launches", "bwd_f32_dq_launches",
           "bwd_f32_dkv_launches", "bwd_width", "attn_dtype", "pad_heads",
           "paged_plan", "PagedPlan"]

NEG_INF = -1e30
MAX_HEAD_DIM = 256          # the kernels' widest instance
BWD_WIDTHS = (64, 128, 256)  # head widths of the tensor-core instances
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# launches by the wrappers, per kernel: the bf16 routes ...
fwd_launches = 0            # flash_attention_fwd_cuda (tensor cores)
paged_launches = 0          # paged_decode_attention_cuda
bwd_dq_launches = 0         # flash_attention_bwd_cuda, dq kernel
bwd_dkv_launches = 0        # the same, dk/dv kernel
# ... and the f32 routes (csrc/attention_f32.cu)
fwd_f32_launches = 0
paged_f32_launches = 0
bwd_f32_dq_launches = 0
bwd_f32_dkv_launches = 0


def _softmax_pv(s, v, out_dtype):
    """Masked scores (..., Sk) f32 and values -> (o, lse), the reference
    kernel's finish: ``acc / max(l, 1e-30)`` with ``p`` in ``v.dtype``."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    acc = torch.matmul(p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return (acc / l_safe).to(out_dtype), (m + torch.log(l_safe))[..., 0]


def flash_attention_fwd_plain(q, k, v, *, scale, causal=True, window=0,
                              softcap=0.0, group=1):
    """q: (BH, Sq, d); k/v: (BKV, Sk, d/dv) with BH = BKV * group, query
    head ``bh`` reading K/V row ``bh // group``.  Returns (o (BH, Sq, dv)
    in q.dtype, lse (BH, Sq) f32)."""
    kk, vv = _kv_rows(k, v, q.shape[0], group)
    s, _ = _scores(q, kk, scale=scale, causal=causal, window=window,
                   softcap=softcap)
    return _softmax_pv(s, vv, q.dtype)


def _kv_rows(k, v, bh, group):
    """K/V rows of every query head: head ``bh`` reads row ``bh // group``."""
    rows = torch.arange(bh, device=k.device) // group
    return k[rows], v[rows]


def _scores(q, kk, *, scale, causal, window, softcap):
    """Masked f32 scores (BH, Sq, Sk) and the raw scaled ones (before
    softcap and mask), the reference's ``_recompute_p`` order."""
    sq, sk = q.shape[1], kk.shape[1]
    s_raw = torch.matmul(q.to(torch.float32),
                         kk.to(torch.float32).transpose(1, 2)) * scale
    s = torch.tanh(s_raw / softcap) * softcap if softcap else s_raw
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= (qp - kp) < window
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), s_raw


def _check_heads(d, dv):
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"head dims d={d}, dv={dv} must be <= "
                         f"{MAX_HEAD_DIM} for the kernel")


def pad_heads(t, width):
    """Zero-pad the last dim of ``t`` to ``width`` (no copy when it is
    already that wide)."""
    extra = width - t.shape[-1]
    return torch.nn.functional.pad(t, (0, extra)) if extra else t


def _round8(n):
    return -(-n // 8) * 8


def bwd_width(d, dv):
    """Head width of the tensor-core instance for head dims d, dv (the
    backward's and the bf16 forward's): the narrowest of ``BWD_WIDTHS``
    that holds both (the wrappers zero-pad q, k, v and do to it)."""
    need = max(d, dv)
    for width in BWD_WIDTHS:
        if need <= width:
            return width
    raise ValueError(f"head dims d={d}, dv={dv} must be <= "
                     f"{BWD_WIDTHS[-1]} for the kernel")


def _fn(lib_name, sym, n_ptr, n_int_before, n_float, n_int_after):
    fn = getattr(_build.library(lib_name), sym)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int_before
                       + [ctypes.c_float] * n_float
                       + [ctypes.c_int] * n_int_after + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def attn_dtype(*ts):
    """The one dtype of the attention operands ``ts`` (q, k, v and do):
    bf16 or f32, each dtype with its own route.  A mix, or another dtype,
    raises ``TypeError``."""
    dtypes = {t.dtype for t in ts}
    if len(dtypes) != 1 or not dtypes <= set(KERNEL_DTYPES):
        raise TypeError(f"q, k, v (and do) must be all bf16 or all f32, "
                        f"got {[t.dtype for t in ts]}")
    return dtypes.pop()


def _cuda_operands(*ts):
    """(dtype, contiguous operands) of CUDA tensors of one kernel dtype."""
    for t in ts:
        if t.device.type != "cuda":
            raise TypeError(f"CUDA tensors expected, got {t.dtype} on "
                            f"{t.device}")
    return attn_dtype(*ts), [t.contiguous() for t in ts]


def _stream(t):
    # torch.cuda.current_stream(dev).cuda_stream, without building a
    # Stream object per call
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def flash_attention_fwd_cuda(q, k, v, *, scale, causal=True, window=0,
                             softcap=0.0, group=1):
    """Launch the forward (same contract as the plain version; head dims
    <= 256).  bf16: ``csrc/flash_attention.cu`` on tensor cores, heads
    zero-padded to the instance width ``bwd_width(d, dv)``.  f32: ``csrc/attention_f32.cu``, heads zero-padded to multiples of
    8."""
    global fwd_launches, fwd_f32_launches
    dtype, (q, k, v) = _cuda_operands(q, k, v)
    bh, sq, d_in = q.shape
    bkv, sk, dv_in = v.shape
    if bh != bkv * group or k.shape[:2] != (bkv, sk) or k.shape[2] != d_in:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} and group {group} disagree")
    _check_heads(d_in, dv_in)
    if dtype == torch.bfloat16:
        d = dv = bwd_width(d_in, dv_in)
    else:
        d, dv = _round8(d_in), _round8(dv_in)
    q, k, v = pad_heads(q, d), pad_heads(k, d), pad_heads(v, dv)
    o = torch.empty((bh, sq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    if bh and sq:
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr())
        opts = (float(scale), float(softcap), int(bool(causal)), int(window),
                _stream(q))
        if dtype == torch.bfloat16:
            fn = _fn("flash_attention", "flash_attention_fwd", 5, 5, 2, 2)
            err = fn(*ptrs, bh, sq, sk, d, group, *opts)
            fwd_launches += 1
        else:
            fn = _fn("attention_f32", "flash_attention_fwd_f32", 5, 6, 2, 2)
            err = fn(*ptrs, bh, sq, sk, d, dv, group, *opts)
            fwd_f32_launches += 1
        _build.check(err, "flash_attention_fwd")
    return o[..., :dv_in], lse


def flash_attention_fwd(q, k, v, *, scale, causal=True, window=0,
                        softcap=0.0, group=1):
    """Flash forward: plain version on CPU tensors, kernel on CUDA."""
    impl = (flash_attention_fwd_plain if q.device.type == "cpu"
            else flash_attention_fwd_cuda)
    return impl(q, k, v, scale=scale, causal=causal, window=window,
                softcap=softcap, group=group)


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

def flash_attention_bwd_plain(q, k, v, lse, do, dmat, *, scale, causal=True,
                              window=0, softcap=0.0, group=1):
    """Gradients of the flash forward, densely over all keys.  ``lse``:
    the forward's (BH, Sq) f32 log-sum-exp; ``dmat``: (BH, Sq) f32
    ``rowsum(do * o)``.  Returns f32 (dq (BH, Sq, d), dk (BKV, Sk, d),
    dv (BKV, Sk, dv)), dk/dv summed over each KV head's group.  Casts as
    the reference kernels: ``do`` in ``v.dtype`` for dp, ``ds`` rounded to
    ``k.dtype`` / ``q.dtype`` before the dq / dk products, ``p`` in f32
    for the dv product."""
    bh, sq, d = q.shape
    bkv, sk, dv = v.shape
    kk, vv = _kv_rows(k, v, bh, group)
    s, s_raw = _scores(q, kk, scale=scale, causal=causal, window=window,
                       softcap=softcap)
    p = torch.exp(s - lse[..., None])
    f32 = torch.float32
    do32 = do.to(f32)
    dp = torch.matmul(do.to(v.dtype).to(f32), vv.to(f32).transpose(1, 2))
    ds = p * (dp - dmat[..., None])
    if softcap:
        t = torch.tanh(s_raw / softcap)
        ds = ds * (1.0 - t * t)
    ds = ds * scale
    dq = torch.matmul(ds.to(k.dtype).to(f32), kk.to(f32))
    dv_h = torch.matmul(p.transpose(1, 2), do32)
    dk_h = torch.matmul(ds.to(q.dtype).to(f32).transpose(1, 2), q.to(f32))
    return (dq, dk_h.reshape(bkv, group, sk, d).sum(1),
            dv_h.reshape(bkv, group, sk, dv).sum(1))


def flash_attention_bwd_cuda(q, k, v, lse, do, dmat, *, scale, causal=True,
                             window=0, softcap=0.0, group=1):
    """Launch the backward's dq and dk/dv kernels (same contract as the
    plain version; f32 lse/dmat, head dims <= 256).  bf16 q/k/v/do:
    ``csrc/flash_attention_bwd.cu`` on tensor cores, heads zero-padded to
    the instance's width; f32: ``csrc/attention_f32.cu``, heads
    zero-padded to multiples of 8."""
    global bwd_dq_launches, bwd_dkv_launches
    global bwd_f32_dq_launches, bwd_f32_dkv_launches
    dtype, (q, k, v, do) = _cuda_operands(q, k, v, do)
    bh, sq, d = q.shape
    bkv, sk, dv = v.shape
    if (bh != bkv * group or k.shape != (bkv, sk, d)
            or do.shape != (bh, sq, dv)):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, do {tuple(do.shape)} and "
                         f"group {group} disagree")
    if dtype == torch.bfloat16:
        wq = wv = bwd_width(d, dv)
    else:
        _check_heads(d, dv)
        wq, wv = _round8(d), _round8(dv)
    lse, dmat = (t.to(device=q.device, dtype=torch.float32).contiguous()
                 for t in (lse, dmat))
    if lse.shape != (bh, sq) or dmat.shape != (bh, sq):
        raise ValueError(f"lse {tuple(lse.shape)} / dmat "
                         f"{tuple(dmat.shape)} must be {(bh, sq)}")
    dq = torch.empty((bh, sq, wq), dtype=torch.float32, device=q.device)
    dk = torch.empty((bkv, sk, wq), dtype=torch.float32, device=q.device)
    dvo = torch.empty((bkv, sk, wv), dtype=torch.float32, device=q.device)
    if not (bh and sq and sk):
        return dq.zero_()[..., :d], dk.zero_()[..., :d], dvo.zero_()[..., :dv]
    q, k = pad_heads(q, wq), pad_heads(k, wq)
    v, do = pad_heads(v, wv), pad_heads(do, wv)
    ptrs = [t.data_ptr() for t in (q, k, v, do, lse, dmat)]
    opts = [float(scale), float(softcap), int(bool(causal)), int(window),
            _stream(q)]
    if dtype == torch.bfloat16:
        shape = [bh, sq, sk, wq, group]
        lib, suffix = "flash_attention_bwd", ""
    else:
        shape = [bh, sq, sk, wq, wv, group]
        lib, suffix = "attention_f32", "_f32"
    n = len(shape)
    fn = _fn(lib, "flash_attention_bwd_dq" + suffix, 7, n, 2, 2)
    _build.check(fn(*ptrs, dq.data_ptr(), *shape, *opts),
                 "flash_attention_bwd_dq")
    fn = _fn(lib, "flash_attention_bwd_dkv" + suffix, 8, n, 2, 2)
    _build.check(fn(*ptrs, dk.data_ptr(), dvo.data_ptr(), *shape, *opts),
                 "flash_attention_bwd_dkv")
    if dtype == torch.bfloat16:
        bwd_dq_launches += 1
        bwd_dkv_launches += 1
    else:
        bwd_f32_dq_launches += 1
        bwd_f32_dkv_launches += 1
    return dq[..., :d], dk[..., :d], dvo[..., :dv]


def flash_attention_bwd(q, k, v, lse, do, dmat, *, scale, causal=True,
                        window=0, softcap=0.0, group=1):
    """Flash backward: plain version on CPU tensors, kernels on CUDA."""
    impl = (flash_attention_bwd_plain if q.device.type == "cpu"
            else flash_attention_bwd_cuda)
    return impl(q, k, v, lse, do, dmat, scale=scale, causal=causal,
                window=window, softcap=softcap, group=group)


# ---------------------------------------------------------------------------
# Paged decode
# ---------------------------------------------------------------------------

def paged_decode_attention_plain(q, k_pool, v_pool, table, q_pos, *, scale,
                                 window=0, softcap=0.0):
    """q: (B, KVH, G, d); pools: (P, page_size, KVH, d/dv); table:
    (B, max_pages) int32; q_pos: (B,) int32.  Returns (B, KVH, G, dv)."""
    b, kvh, g, d = q.shape
    _, ps, _, dv = v_pool.shape
    mp = table.shape[1]
    idx = table.long()
    kk = k_pool[idx].reshape(b, mp * ps, kvh, d)
    vv = v_pool[idx].reshape(b, mp * ps, kvh, dv)
    s = torch.einsum("bhgd,bkhd->bhgk", q.to(torch.float32),
                     kk.to(torch.float32)) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    kp = torch.arange(mp * ps, device=q.device)[None, :]
    qp = q_pos.to(torch.int64)[:, None]
    mask = kp <= qp
    if window:
        mask &= (qp - kp) < window
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    o, _ = _softmax_pv(s, vv.permute(0, 2, 1, 3), q.dtype)
    return o


PAGED_TILE = 64           # cache positions per block tile (16 a warp)
PAGED_HEADS = 16          # query heads per chunk: the MMA's 16 rows
PAGED_BLOCKS_PER_SM = 2   # split until the grid holds about this many
PAGED_MAX_SPLITS = 8      # the splits of one chunk form one block cluster


class PagedPlan(NamedTuple):
    n_split: int          # blocks per (slot, KV head, head chunk)
    span: int             # cache positions per split, a multiple of 64
    grid: tuple[int, int, int]   # (splits, B x KVH, head chunks)


@functools.lru_cache(maxsize=256)
def paged_plan(capacity: int, b: int, kvh: int, g: int,
               sms: int = 132) -> PagedPlan:
    """The bf16 paged kernel's launch for a table of ``capacity`` cache
    positions a slot (max_pages x page_size), ``b`` slots, ``kvh`` KV heads
    and ``g`` query heads per KV head on a card with ``sms`` SMs: host-known
    shapes only, never q_pos, so planning reads nothing from the device.
    The cache is split into whole ``PAGED_TILE`` tiles until the grid holds
    about ``PAGED_BLOCKS_PER_SM * sms`` blocks, into at most
    ``PAGED_MAX_SPLITS`` splits (one cluster per chunk): split s covers
    positions ``[s * span, min(capacity, (s + 1) * span))``, and no split
    is empty."""
    chunks = _cdiv(g, PAGED_HEADS)
    tiles = max(1, _cdiv(capacity, PAGED_TILE))
    want = min(PAGED_MAX_SPLITS, tiles,
               max(1, _cdiv(PAGED_BLOCKS_PER_SM * sms, b * kvh * chunks)))
    span_tiles = _cdiv(tiles, want)
    n_split = _cdiv(tiles, span_tiles)
    return PagedPlan(n_split, span_tiles * PAGED_TILE,
                     (n_split, b * kvh, chunks))


def paged_decode_attention_cuda(q, k_pool, v_pool, table, q_pos, *, scale,
                                window=0, softcap=0.0):
    """Launch paged decode (same contract as the plain version; head dims
    <= 256, padded to multiples of 8; any group size G; one launch).
    bf16: ``csrc/paged_decode.cu``, split over the cache as
    :func:`paged_plan` says; q and the pools are read in place (16-byte
    aligned, as every allocation is).  f32: ``csrc/attention_f32.cu``."""
    global paged_launches, paged_f32_launches
    dtype, (q, k_pool, v_pool) = _cuda_operands(q, k_pool, v_pool)
    b, kvh, g, d_in = q.shape
    _, ps, _, dv_in = v_pool.shape
    _check_heads(d_in, dv_in)
    d, dv = _round8(d_in), _round8(dv_in)
    q, k_pool = pad_heads(q, d), pad_heads(k_pool, d)
    v_pool = pad_heads(v_pool, dv)
    table = table.to(device=q.device, dtype=torch.int32).contiguous()
    q_pos = q_pos.to(device=q.device, dtype=torch.int32).contiguous()
    o = torch.empty((b, kvh, g, dv), dtype=q.dtype, device=q.device)
    if not (b and kvh and g):
        return o[..., :dv_in]
    args = [q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            table.data_ptr(), q_pos.data_ptr(), o.data_ptr(), b, kvh, g, d,
            dv, ps, table.shape[1], float(scale), float(softcap),
            int(window)]
    if dtype == torch.bfloat16:
        if any(p % 16 for p in args[:3]):
            raise ValueError("paged decode reads q and the pools in place "
                             "by 16-byte copies: they must be 16-byte "
                             "aligned")
        if k_pool.shape[0] * ps * kvh >= 2 ** 31:
            raise ValueError("paged decode indexes pool rows in 32 bits")
        plan = paged_plan(table.shape[1] * ps, b, kvh, g,
                          _sm_count(q.device.index))
        fn = _fn("paged_decode", "paged_decode_attention", 6, 7, 2, 3)
        _build.check(fn(*args, plan.n_split, plan.span, _stream(q)),
                     "paged_decode_attention")
        paged_launches += 1
    else:
        fn = _fn("attention_f32", "paged_decode_attention_f32", 6, 7, 2, 1)
        _build.check(fn(*args, _stream(q)), "paged_decode_attention_f32")
        paged_f32_launches += 1
    return o[..., :dv_in]


def paged_decode_attention(q, k_pool, v_pool, table, q_pos, *, scale,
                           window=0, softcap=0.0):
    """Paged decode: plain version on CPU tensors, kernel on CUDA."""
    impl = (paged_decode_attention_plain if q.device.type == "cpu"
            else paged_decode_attention_cuda)
    return impl(q, k_pool, v_pool, table, q_pos, scale=scale, window=window,
                softcap=softcap)
