"""Grouped-query attention (self- and cross-attention) and multi-head
latent attention (port of ``repro.models.attention``).

One implementation of each serves the full-sequence forward, prefill (K/V,
or MLA's latents, handed back for the cache), context prefill (a prompt
suffix against cached prefix rows, for the prefix cache) and decode
(queries against a dense per-slot slab or shared page pools addressed
through a page table).  Queries are grouped as (KV-heads x group), so head
``h`` reads KV head ``h // G``.  A cross-attention (the encoder-decoder's
decoder) takes its K/V from the encoder output, has no RoPE and no cache.

The int8 KV cache (``kv_cache_dtype="int8"``) stores K and V as symmetric
int8 per (token, head) with f32 scales ``k_scale`` / ``v_scale`` of shape
``(..., KVH, 1)`` beside them; a decode step scatters the quantized rows
and dequantizes what it attends in f32, cast to the activations' dtype,
through ``attention_core`` (the paged-decode kernel reads bf16 pools only,
so it never runs under int8, as in the reference).  MLA caches stay bf16.

Cache writes are in place: the port updates the slab / pool tensors it is
given (the reference returns new arrays; the values are the same) and
returns the same dict, which saves a copy of every cache per step.
"""

from __future__ import annotations

import torch

from repro_torch.core.linear import linear_apply, linear_init
from repro_torch.core.quantize import scale_from_amax
from repro_torch.kernels.ops import flash_mha, paged_flash_decode
from repro_torch.models.layers import apply_rope, fixed_bmm, rms_norm, \
    rms_norm_init, rope

__all__ = ["attn_init", "attn_apply", "attn_heads", "attention_core", "init_kv_cache",
           "init_paged_kv_cache", "mla_init", "mla_apply", "mla_latent",
           "mla_heads", "init_mla_cache", "init_paged_mla_cache",
           "scatter_cache_rows",
           "scatter_paged_rows", "scatter_prefill_rows", "gather_pages",
           "mirror_paged_rows"]

_NEG_INF = -2.0 ** 30


# ---------------------------------------------------------------------------
# Cache row writes
# ---------------------------------------------------------------------------

def scatter_cache_rows(buf, new, index):
    """Write ``new`` (B, S_new, ...) into ``buf`` (B, L, ...) at ``index``,
    in place.  ``index`` is a scalar (every sequence at one offset) or a
    (B,) vector of per-slot offsets.  Multi-row vector writes clip each
    row's target to the last slab row, as the reference does."""
    new = new.to(buf.dtype)
    index = torch.as_tensor(index, device=buf.device)
    b, s = new.shape[:2]
    if index.ndim == 0:
        start = int(index)
        buf[:, start:start + s] = new
        return buf
    rows = torch.arange(b, device=buf.device)[:, None]
    pos = torch.clamp(index.long()[:, None]
                      + torch.arange(s, device=buf.device)[None, :],
                      0, buf.shape[1] - 1)
    buf[rows, pos] = new
    return buf


def scatter_paged_rows(pool, new, table, index):
    """Write decode rows per slot through the page table, in place: row
    ``index[b] + j`` of slot ``b`` lands at ``(table[b, pos // page_size],
    pos % page_size)``; multi-row positions clip to the table's range."""
    ps = pool.shape[1]
    b, s = new.shape[:2]
    index = torch.broadcast_to(
        torch.as_tensor(index, device=pool.device).reshape(-1).long(), (b,))
    pos = torch.clamp(index[:, None]
                      + torch.arange(s, device=pool.device)[None, :],
                      0, table.shape[1] * ps - 1)
    page = torch.gather(table.long(), 1, pos // ps)
    pool[page, pos % ps] = new.to(pool.dtype)
    return pool


def mirror_paged_rows(src, dst, table, index, s: int):
    """Copy the rows a step of ``s`` tokens a slot wrote through ``table``
    at ``index`` (where :func:`scatter_paged_rows` put them) from pool
    ``src`` into its copy ``dst`` on another device, in place: a data
    row's writes reach every copy of the pools."""
    ps = src.shape[1]
    b = table.shape[0]
    index = torch.broadcast_to(
        torch.as_tensor(index, device=src.device).reshape(-1).long(), (b,))
    pos = torch.clamp(index[:, None]
                      + torch.arange(s, device=src.device)[None, :],
                      0, table.shape[1] * ps - 1)
    page = torch.gather(table.to(src.device).long(), 1, pos // ps)
    rows = src[page, pos % ps]
    dst[page.to(dst.device), (pos % ps).to(dst.device)] = rows.to(dst.device)
    return dst


def gather_pages(pool, table):
    """(num_pages, page_size, ...) through (B, max_pages) -> (B, max_pages
    * page_size, ...): per-slot contiguous caches (the plain decode path)."""
    b, mp = table.shape
    g = pool[table.long()]
    return g.reshape(b, mp * pool.shape[1], *pool.shape[2:])


def scatter_prefill_rows(pool, new, row, start):
    """Write a prefilled segment ``new`` (1, S, ...) for global positions
    ``start + [0, S)`` through one slot's table ``row`` (max_pages,), in
    place.  Row-granular, so a copy-on-write tail page keeps its cached
    rows below ``start``.  Positions past the slot's budget clamp to the
    last logical row (pad-token garbage, on the row's trailing entry).
    ``start`` may be a 0-d tensor: it is data, never read on the host."""
    ps = pool.shape[1]
    s = new.shape[1]
    pos = torch.clamp(torch.as_tensor(start, device=pool.device)
                      + torch.arange(s, device=pool.device),
                      0, row.shape[0] * ps - 1)
    page = row.long()[pos // ps]
    pool[page, pos % ps] = new[0].to(pool.dtype)
    return pool


def _splice_context(ctx, new, context_start):
    """Fixed-length prefix splice: position ``j`` takes the cached row
    ``ctx[:, j]`` below ``context_start`` and the fresh row ``new[:, j -
    context_start]`` at or above it.  The buffer keeps ``new``'s length,
    so the attention downstream has the shape of an uncached prefill; with
    ``context_start == 0`` it returns ``new``'s values bit for bit.  The
    shift is a gather by index, so ``context_start`` stays a tensor."""
    s = new.shape[1]
    j = torch.arange(s, device=new.device)
    start = torch.as_tensor(context_start, device=new.device)
    shifted = new[:, (j - start) % s]
    is_ctx = (j < start).reshape((1, s) + (1,) * (new.ndim - 2))
    return torch.where(is_ctx, ctx[:, :s].to(new.dtype), shifted)


# ---------------------------------------------------------------------------
# Plain attention core
# ---------------------------------------------------------------------------

def _attend_block(q, k, v, q_pos, k_pos, *, scale, causal, window, softcap):
    """q: (B,Sq,KVH,G,D); k/v: (B,Sk,KVH,Dk/Dv) -> (B,Sq,KVH,G,Dv) f32.
    Both products are ``fixed_bmm``s over entries (kv head, slot), kv
    heads outermost: each entry's sums run in an order fixed by its
    shape, never by how many heads or slots share the call."""
    b, sq, kvh, g, d = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    qb = q.to(torch.float32).permute(2, 0, 3, 1, 4).reshape(kvh * b, g * sq, d)
    kb = k.to(torch.float32).permute(2, 0, 3, 1).reshape(kvh * b, d, sk)
    logits = fixed_bmm(qb, kb).reshape(kvh, b, g, sq, sk) * scale
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    dq = q_pos[None, :, None, :, None]
    dk = k_pos[None, :, None, None, :]
    mask = torch.ones((), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (dk <= dq)
    if window:
        mask = mask & (dq - dk < window)
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(v.dtype).to(torch.float32)
    vb = v.to(torch.float32).permute(2, 0, 1, 3).reshape(kvh * b, sk, dv)
    out = fixed_bmm(probs.reshape(kvh * b, g * sq, sk), vb)
    return out.reshape(kvh, b, g, sq, dv).permute(1, 3, 0, 2, 4)


def attention_core(q, k, v, q_pos, k_pos, *, scale, causal=True, window=0,
                   softcap=0.0):
    """q: (B,Sq,H,Dk) grouped against k/v: (B,Sk,KVH,.); f32 math, output
    in v.dtype.  Every row of the output is a function of that row's
    inputs alone: no head or slot beside it in the call changes its sum
    order (``_attend_block``), so attending a subset of the heads gives
    those heads' rows of the whole call bit for bit.  (The reference
    chunks long query axes to bound memory; every chunk scores against
    all keys, so rows are unchanged.)"""
    b, sq, h, dk = q.shape
    kvh = k.shape[2]
    dv = v.shape[-1]
    qg = q.reshape(b, sq, kvh, h // kvh, dk)
    out = _attend_block(qg, k, v, q_pos, k_pos, scale=scale, causal=causal,
                        window=window, softcap=softcap)
    return out.reshape(b, sq, h, dv).to(v.dtype)


def _flash_local(q, k, v, *, scale, window, softcap):
    """Head-major flatten -> flash forward -> restore (heads ordered
    (kv_head, group), so flat head ``bh`` reads K/V row ``bh // group``)."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    dv = v.shape[-1]
    qf = q.reshape(b, s, kvh, g, d).permute(0, 2, 3, 1, 4) \
        .reshape(b * kvh * g, s, d)
    kf = k.permute(0, 2, 1, 3).reshape(b * kvh, s, d)
    vf = v.permute(0, 2, 1, 3).reshape(b * kvh, s, dv)
    of = flash_mha(qf, kf, vf, scale, True, window, softcap, g)
    return of.reshape(b, kvh, g, s, dv).permute(0, 3, 1, 2, 4) \
        .reshape(b, s, h, dv)


# ---------------------------------------------------------------------------
# The GQA layer
# ---------------------------------------------------------------------------

def attn_init(cfg, *, generator, device) -> dict:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(generator=generator, device=device)
    p = {"wq": linear_init(d, h * hd, **kw),
         "wk": linear_init(d, kvh * hd, **kw),
         "wv": linear_init(d, kvh * hd, **kw),
         "wo": linear_init(h * hd, d, **kw)}
    if cfg.qk_norm:
        p["q_norm"] = rms_norm_init(hd, device)
        p["k_norm"] = rms_norm_init(hd, device)
    return p


KV_CACHE_DTYPES = ("bf16", "int8")

_INT8_PREFIX_MSG = ("prefix caching over the int8 KV cache is unsupported: "
                    "cached rows would be dequantized while a solo prefill "
                    "attends full-precision rows, breaking the bit-match "
                    "contract")


def _kv_cache(cfg, shape, device) -> dict:
    """K/V leaves of ``shape`` (rows, row, KVH, hd): bf16, or int8 values
    with per-(token, head) f32 scales under ``kv_cache_dtype="int8"``."""
    if cfg.kv_cache_dtype not in KV_CACHE_DTYPES:
        raise NotImplementedError(f"kv_cache_dtype {cfg.kv_cache_dtype!r}: "
                                  f"the KV cache is one of {KV_CACHE_DTYPES}")
    if cfg.kv_cache_dtype == "int8":
        kw = dict(dtype=torch.int8, device=device)
        sk = dict(dtype=torch.float32, device=device)
        return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw),
                "k_scale": torch.zeros(shape[:3] + (1,), **sk),
                "v_scale": torch.zeros(shape[:3] + (1,), **sk)}
    kw = dict(dtype=torch.bfloat16, device=device)
    return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}


def init_kv_cache(cfg, batch: int, max_len: int, device) -> dict:
    return _kv_cache(cfg, (batch, max_len, cfg.n_kv_heads, cfg.head_dim),
                     device)


def init_paged_kv_cache(cfg, num_pages: int, page_size: int, device) -> dict:
    return _kv_cache(cfg, (num_pages, page_size, cfg.n_kv_heads,
                           cfg.head_dim), device)


def _q8_heads(t):
    """Symmetric int8 per (token, head): t (B, S, KVH, D) -> (q int8,
    scale f32 (B, S, KVH, 1)), the reference's formula as it runs: under
    ``jit`` XLA turns its ``amax / 127`` into a product with the f32
    reciprocal of 127 (``scale_from_amax``), bit for bit the reference's."""
    t = t.to(torch.float32)
    scale = scale_from_amax(t.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(t / scale), -128, 127).to(torch.int8)
    return q, scale


def _quantized(k, v) -> dict:
    kq, ks = _q8_heads(k)
    vq, vs = _q8_heads(v)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def _dequant(q, scale, dtype):
    return (q.to(torch.float32) * scale).to(dtype)


def attn_apply(params, cfg, x, *, positions, kind: str = "full",
               cache: dict | None = None, cache_index=None,
               kv_source=None, causal: bool = True,
               return_cache: bool = False, page_table=None,
               context_start=None):
    """Returns (out, new_cache): :func:`attn_heads`, then ``wo``."""
    out, new_cache = attn_heads(
        params, cfg, x, positions=positions, kind=kind, cache=cache,
        cache_index=cache_index, kv_source=kv_source, causal=causal,
        return_cache=return_cache, page_table=page_table,
        context_start=context_start)
    return linear_apply(params["wo"], out, mode=cfg.quant_mode,
                        backend=cfg.quant_backend), new_cache


def attn_heads(params, cfg, x, *, positions, kind: str = "full",
               cache: dict | None = None, cache_index=None,
               kv_source=None, causal: bool = True,
               return_cache: bool = False, page_table=None,
               context_start=None, x_amax=None, kv_amax=None):
    """The attention block up to ``wo``: returns (heads (B, S, H * hd),
    new_cache).  Under tensor parallelism each shard runs it with its
    share of the heads (``cfg`` holding the shard's ``n_heads`` and
    ``n_kv_heads``, ``params`` its ``wq``/``wk``/``wv`` columns, ``cache``
    its pools) and ``wo`` runs row-parallel; its ``attention_core`` rows
    equal the unsharded call's bit for bit, on a shared device or on
    distinct ones (a row does not depend on the heads beside it).

    ``cache=None``: K/V from ``x`` (forward / prefill; prefill hands the
    post-RoPE K/V back, quantized under the int8 KV cache), or from ``kv_source`` for a cross-attention (no RoPE,
    keys at ``[0, S_kv)``, never causal).  ``causal=False`` makes a
    self-attention bidirectional (the encoder).  With ``cache``: the new
    rows are written at ``cache_index`` (scalar or (B,) per slot) and the
    queries attend the cache; with ``page_table`` the cache is shared page
    pools, and under ``attn_impl="flash"`` a one-token step over bf16
    pools runs the paged-decode kernel, which walks the table itself.
    The flash forward runs for causal self-attention without a cache
    only; the encoder, cross-attention and every cache read attend in
    ``attention_core``, as in the reference.

    Context prefill (the prefix cache): ``cache`` + ``page_table`` +
    ``context_start``.  ``x`` is a prompt suffix whose queries sit at
    ``positions`` = ``context_start + [0, S)``; the cached rows are
    gathered through the table and spliced below the fresh K/V at the
    buffer length S (``_splice_context``), and the plain
    ``attention_core`` attends them, as in the reference (the flash
    kernel is not used here).  The pools are not written: the suffix K/V
    come back as ``new_cache`` for the caller to scatter.  Refused over
    the int8 KV cache (the reference's rule).

    ``x_amax`` / ``kv_amax``: the batch-wide amax of ``x`` and of
    ``kv_source`` over data rows (int modes; ``linear.rows_amax``)."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mode, backend = cfg.quant_mode, cfg.quant_backend

    q = linear_apply(params["wq"], x, mode=mode, backend=backend,
                     x_amax=x_amax).reshape(b, s, h, hd)
    kv_in = x if kv_source is None else kv_source
    kv_kw = dict(mode=mode, backend=backend,
                 x_amax=x_amax if kv_source is None else kv_amax)
    sk_new = kv_in.shape[1]
    k = linear_apply(params["wk"], kv_in, **kv_kw) \
        .reshape(b, sk_new, kvh, hd)
    v = linear_apply(params["wv"], kv_in, **kv_kw) \
        .reshape(b, sk_new, kvh, hd)
    if cfg.qk_norm:
        q = rms_norm(params["q_norm"], q, cfg.norm_eps)
        k = rms_norm(params["k_norm"], k, cfg.norm_eps)

    if kv_source is None:              # no RoPE on cross-attention
        theta = cfg.rope_theta_local if kind == "local" else cfg.rope_theta
        sin, cos = rope(positions, hd, theta)
        q = apply_rope(q, sin, cos).to(x.dtype)
        k = apply_rope(k, sin, cos).to(x.dtype)

    scale = cfg.attn_scale or (1.0 / hd ** 0.5)
    window = cfg.sliding_window if kind == "local" else 0
    softcap = cfg.attn_logit_softcap
    is_causal_self = causal and kv_source is None

    new_cache = cache
    paged_kernel = False
    if cache is not None and context_start is not None:
        if "k_scale" in cache:
            raise NotImplementedError(_INT8_PREFIX_MSG)
        k_full = _splice_context(gather_pages(cache["k"], page_table), k,
                                 context_start)
        v_full = _splice_context(gather_pages(cache["v"], page_table), v,
                                 context_start)
        k_pos = torch.broadcast_to(torch.arange(s, device=x.device)[None, :],
                                   (b, s))
        if return_cache:
            new_cache = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
    elif cache is not None:
        quant_kv = "k_scale" in cache
        writes = _quantized(k, v) if quant_kv else {"k": k, "v": v}
        for key, val in writes.items():
            if page_table is None:
                scatter_cache_rows(cache[key], val, cache_index)
            else:
                scatter_paged_rows(cache[key], val, page_table, cache_index)
        paged_kernel = (page_table is not None and cfg.attn_impl == "flash"
                        and not quant_kv and is_causal_self and s == 1)

        def read(key):            # per-slot rows in position order
            return (cache[key] if page_table is None
                    else gather_pages(cache[key], page_table))

        if quant_kv:
            k_full = _dequant(read("k"), read("k_scale"), x.dtype)
            v_full = _dequant(read("v"), read("v_scale"), x.dtype)
        elif not paged_kernel:
            k_full, v_full = read("k"), read("v")
        length = (cache["k"].shape[1] if page_table is None
                  else page_table.shape[1] * cache["k"].shape[1])
        k_pos = torch.broadcast_to(
            torch.arange(length, device=x.device)[None, :], (b, length))
    else:
        k_full, v_full = k, v
        k_pos = positions if kv_source is None else torch.broadcast_to(
            torch.arange(sk_new, device=x.device)[None, :], (b, sk_new))
        if return_cache:
            new_cache = (_quantized(k, v) if cfg.kv_cache_dtype == "int8"
                         else {"k": k.to(torch.bfloat16),
                               "v": v.to(torch.bfloat16)})

    if paged_kernel:
        out = paged_flash_decode(q, cache["k"], cache["v"], page_table,
                                 positions[:, -1], scale=scale,
                                 window=window, softcap=softcap)
    elif cfg.attn_impl == "flash" and cache is None and is_causal_self:
        out = _flash_local(q, k, v, scale=scale, window=window,
                           softcap=softcap)
    else:
        out = attention_core(q, k_full, v_full, positions, k_pos,
                             scale=scale, causal=is_causal_self,
                             window=window, softcap=softcap)
    return out.reshape(b, s, h * hd), new_cache


# ---------------------------------------------------------------------------
# Multi-head latent attention (deepseek-v3)
# ---------------------------------------------------------------------------

def mla_init(cfg, *, generator, device) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    d_nope, d_rope, d_v = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kw = dict(generator=generator, device=device)
    return {"wq_a": linear_init(d, r_q, **kw),
            "q_a_norm": rms_norm_init(r_q, device),
            "wq_b": linear_init(r_q, h * (d_nope + d_rope), **kw),
            "wkv_a": linear_init(d, r_kv + d_rope, **kw),
            "kv_a_norm": rms_norm_init(r_kv, device),
            "wkv_b": linear_init(r_kv, h * (d_nope + d_v), **kw),
            "wo": linear_init(h * d_v, d, **kw)}


def init_mla_cache(cfg, batch: int, max_len: int, device) -> dict:
    """MLA caches the compressed latent and the shared rope key:
    ``kv_lora_rank + qk_rope_dim`` values a token, bf16 whatever
    ``kv_cache_dtype`` says (as in the reference)."""
    kw = dict(dtype=torch.bfloat16, device=device)
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), **kw),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), **kw)}


def init_paged_mla_cache(cfg, num_pages: int, page_size: int, device) -> dict:
    """Paged dual of :func:`init_mla_cache`: latent and rope-key pools."""
    kw = dict(dtype=torch.bfloat16, device=device)
    return {"c_kv": torch.zeros((num_pages, page_size, cfg.kv_lora_rank),
                                **kw),
            "k_rope": torch.zeros((num_pages, page_size, cfg.qk_rope_dim),
                                  **kw)}


def mla_latent(params, cfg, x, *, positions, cache=None, cache_index=None,
               return_cache: bool = False, page_table=None,
               context_start=None, x_amax=None):
    """MLA's latent part, which has no head axis (under tensor
    parallelism it runs once per distinct device): ``wq_a`` with
    ``q_a_norm``, and ``wkv_a`` with ``kv_a_norm`` and the rope key.  It
    writes the new latents ``c_kv`` and rope keys ``k_rope`` into the
    cache (slab or pools) and reads back every row, or splices them below
    a context prefill's cached rows.  Returns (latents, new_cache):
    ``latents`` is what :func:`mla_heads` takes (``q_a``, the attended
    ``c_kv`` and ``k_rope`` rows, their positions, the rope tables, and
    whether a cache was read).  ``x_amax``: the batch-wide amax of ``x``
    over data rows (int modes)."""
    b, s, _ = x.shape
    r_kv, d_rope = cfg.kv_lora_rank, cfg.qk_rope_dim
    kw = dict(mode=cfg.quant_mode, backend=cfg.quant_backend, x_amax=x_amax)

    q_a = rms_norm(params["q_a_norm"], linear_apply(params["wq_a"], x, **kw),
                   cfg.norm_eps)
    sin, cos = rope(positions, d_rope, cfg.rope_theta)
    kv_a = linear_apply(params["wkv_a"], x, **kw)
    c_kv = rms_norm(params["kv_a_norm"], kv_a[..., :r_kv], cfg.norm_eps)
    k_rope_new = apply_rope(kv_a[..., r_kv:].reshape(b, s, 1, d_rope),
                            sin, cos).to(x.dtype).reshape(b, s, d_rope)

    new_cache = cache
    if cache is not None and context_start is not None:
        c_kv_f = _splice_context(gather_pages(cache["c_kv"], page_table),
                                 c_kv, context_start)
        k_rope_f = _splice_context(gather_pages(cache["k_rope"], page_table),
                                   k_rope_new, context_start)
        k_pos = torch.broadcast_to(torch.arange(s, device=x.device)[None, :],
                                   (b, s))
        if return_cache:
            new_cache = {"c_kv": c_kv.to(torch.bfloat16),
                         "k_rope": k_rope_new.to(torch.bfloat16)}
    elif cache is not None:
        if page_table is not None:
            for key, val in (("c_kv", c_kv), ("k_rope", k_rope_new)):
                scatter_paged_rows(cache[key], val, page_table, cache_index)
            c_kv_f = gather_pages(cache["c_kv"], page_table)
            k_rope_f = gather_pages(cache["k_rope"], page_table)
        else:
            c_kv_f = scatter_cache_rows(cache["c_kv"], c_kv, cache_index)
            k_rope_f = scatter_cache_rows(cache["k_rope"], k_rope_new,
                                          cache_index)
        sk = c_kv_f.shape[1]
        k_pos = torch.broadcast_to(torch.arange(sk, device=x.device)[None, :],
                                   (b, sk))
    else:
        c_kv_f, k_rope_f, k_pos = c_kv, k_rope_new, positions
        if return_cache:
            new_cache = {"c_kv": c_kv.to(torch.bfloat16),
                         "k_rope": k_rope_new.to(torch.bfloat16)}
    latents = {"q_a": q_a, "c_kv": c_kv_f, "k_rope": k_rope_f,
               "k_pos": k_pos, "sin": sin, "cos": cos,
               "cached": cache is not None}
    return latents, new_cache


def mla_heads(params, cfg, latents: dict, *, positions, q_amax=None,
              kv_amax=None):
    """MLA's head part, the counterpart of :func:`attn_heads`: ``wq_b``
    and ``wkv_b`` over ``cfg.n_heads`` heads (under tensor parallelism a
    shard's config holds its share, its ``wq_b`` / ``wkv_b`` those heads'
    columns), K and V re-expanded from the latents (at decode over every
    cached row), then ``attention_core``, or the flash forward under
    ``attn_impl="flash"`` without a cache.  Returns the heads before
    ``wo``, (B, S, H * v_head_dim).  ``q_amax`` / ``kv_amax``: the
    batch-wide amaxes of ``q_a`` and of the attended ``c_kv`` rows over
    data rows (int modes)."""
    q_a = latents["q_a"]
    b, s, _ = q_a.shape
    h = cfg.n_heads
    d_nope, d_rope, d_v = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    mode, backend = cfg.quant_mode, cfg.quant_backend
    dtype = q_a.dtype

    q = linear_apply(params["wq_b"], q_a, mode=mode, backend=backend,
                     x_amax=q_amax).reshape(b, s, h, d_nope + d_rope)
    q_nope, q_rope = q[..., :d_nope], q[..., d_nope:]
    q_rope = apply_rope(q_rope, latents["sin"], latents["cos"]).to(dtype)

    c_kv_f, k_rope_f = latents["c_kv"], latents["k_rope"]
    sk = c_kv_f.shape[1]
    kv = linear_apply(params["wkv_b"], c_kv_f, mode=mode, backend=backend,
                      x_amax=kv_amax).reshape(b, sk, h, d_nope + d_v)
    k_nope, v = kv[..., :d_nope], kv[..., d_nope:]
    k_rope_b = torch.broadcast_to(k_rope_f[:, :, None, :].to(dtype),
                                  (b, sk, h, d_rope))
    q_full = torch.cat([q_nope, q_rope], dim=-1).to(dtype)
    k_full = torch.cat([k_nope, k_rope_b], dim=-1).to(dtype)

    scale = 1.0 / (d_nope + d_rope) ** 0.5
    if cfg.attn_impl == "flash" and not latents["cached"]:
        out = _flash_local(q_full, k_full, v, scale=scale, window=0,
                           softcap=0.0)
    else:
        out = attention_core(q_full, k_full, v, positions,
                             latents["k_pos"], scale=scale, causal=True)
    return out.reshape(b, s, h * d_v)


def mla_apply(params, cfg, x, *, positions, cache=None, cache_index=None,
              return_cache: bool = False, page_table=None,
              context_start=None):
    """Returns (out, new_cache); the modes of :func:`attn_apply`:
    :func:`mla_latent`, :func:`mla_heads`, then ``wo``.  The caches hold
    latents ``c_kv`` and rope keys ``k_rope``; every branch re-expands K
    and V from the latents through ``wkv_b`` (at decode over every
    gathered row).  Paged decode gathers the pages back into position
    order, as the reference does: the paged-decode kernel does not run on
    MLA layers."""
    latents, new_cache = mla_latent(
        params, cfg, x, positions=positions, cache=cache,
        cache_index=cache_index, return_cache=return_cache,
        page_table=page_table, context_start=context_start)
    out = mla_heads(params, cfg, latents, positions=positions)
    return linear_apply(params["wo"], out, mode=cfg.quant_mode,
                        backend=cfg.quant_backend), new_cache
