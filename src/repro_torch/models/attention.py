"""Grouped-query attention (port of the GQA path of
``repro.models.attention``; MLA, cross-attention, prefix-cache splicing
and the int8 KV cache wait for later slices).

One implementation serves the full-sequence forward, prefill (K/V handed
back for the cache) and decode (queries against a dense per-slot slab or
shared page pools addressed through a page table).  Queries are grouped
as (KV-heads x group), so head ``h`` reads KV head ``h // G``.

Cache writes are in place: the port updates the slab / pool tensors it is
given (the reference returns new arrays; the values are the same) and
returns the same dict, which saves a copy of every cache per step.
"""

from __future__ import annotations

import torch

from repro_torch.core.linear import linear_apply, linear_init
from repro_torch.kernels.ops import flash_mha, paged_flash_decode
from repro_torch.models.layers import apply_rope, rms_norm, rms_norm_init, rope

__all__ = ["attn_init", "attn_apply", "attention_core", "init_kv_cache",
           "init_paged_kv_cache", "scatter_cache_rows",
           "scatter_paged_rows", "gather_pages"]

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


def gather_pages(pool, table):
    """(num_pages, page_size, ...) through (B, max_pages) -> (B, max_pages
    * page_size, ...): per-slot contiguous caches (the plain decode path)."""
    b, mp = table.shape
    g = pool[table.long()]
    return g.reshape(b, mp * pool.shape[1], *pool.shape[2:])


# ---------------------------------------------------------------------------
# Plain attention core
# ---------------------------------------------------------------------------

def _attend_block(q, k, v, q_pos, k_pos, *, scale, causal, window, softcap):
    """q: (B,Sq,KVH,G,D); k/v: (B,Sk,KVH,Dk/Dv) -> (B,Sq,KVH,G,Dv) f32."""
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    dq = q_pos[:, None, None, :, None]
    dk = k_pos[:, None, None, None, :]
    mask = torch.ones((), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (dk <= dq)
    if window:
        mask = mask & (dq - dk < window)
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd",
                        probs.to(v.dtype).to(torch.float32),
                        v.to(torch.float32))


def attention_core(q, k, v, q_pos, k_pos, *, scale, causal=True, window=0,
                   softcap=0.0):
    """q: (B,Sq,H,Dk) grouped against k/v: (B,Sk,KVH,.); f32 math, output
    in v.dtype.  (The reference chunks long query axes to bound memory;
    every chunk scores against all keys, so rows are unchanged.)"""
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


def _check_kv_dtype(cfg):
    if cfg.kv_cache_dtype != "bf16":
        raise NotImplementedError("only the bf16 KV cache is ported")


def init_kv_cache(cfg, batch: int, max_len: int, device) -> dict:
    _check_kv_dtype(cfg)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def init_paged_kv_cache(cfg, num_pages: int, page_size: int, device) -> dict:
    _check_kv_dtype(cfg)
    shape = (num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def attn_apply(params, cfg, x, *, positions, kind: str = "full",
               cache: dict | None = None, cache_index=None,
               return_cache: bool = False, page_table=None):
    """Returns (out, new_cache).  ``cache=None``: K/V from ``x`` (forward
    / prefill; prefill hands the post-RoPE K/V back).  With ``cache``: the
    new rows are written at ``cache_index`` (scalar or (B,) per slot) and
    the queries attend the cache; with ``page_table`` the cache is shared
    page pools, and under ``attn_impl="flash"`` a one-token step runs the
    paged-decode kernel, which walks the table itself."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mode, backend = cfg.quant_mode, cfg.quant_backend

    q = linear_apply(params["wq"], x, mode=mode, backend=backend) \
        .reshape(b, s, h, hd)
    k = linear_apply(params["wk"], x, mode=mode, backend=backend) \
        .reshape(b, s, kvh, hd)
    v = linear_apply(params["wv"], x, mode=mode, backend=backend) \
        .reshape(b, s, kvh, hd)
    if cfg.qk_norm:
        q = rms_norm(params["q_norm"], q, cfg.norm_eps)
        k = rms_norm(params["k_norm"], k, cfg.norm_eps)

    theta = cfg.rope_theta_local if kind == "local" else cfg.rope_theta
    sin, cos = rope(positions, hd, theta)
    q = apply_rope(q, sin, cos).to(x.dtype)
    k = apply_rope(k, sin, cos).to(x.dtype)

    scale = cfg.attn_scale or (1.0 / hd ** 0.5)
    window = cfg.sliding_window if kind == "local" else 0
    softcap = cfg.attn_logit_softcap

    new_cache = cache
    paged_kernel = False
    if cache is not None and page_table is not None:
        _check_kv_dtype(cfg)
        for key, val in (("k", k), ("v", v)):
            scatter_paged_rows(cache[key], val, page_table, cache_index)
        paged_kernel = cfg.attn_impl == "flash" and s == 1
        if not paged_kernel:
            k_full = gather_pages(cache["k"], page_table)
            v_full = gather_pages(cache["v"], page_table)
        sk_total = page_table.shape[1] * cache["k"].shape[1]
        k_pos = torch.broadcast_to(
            torch.arange(sk_total, device=x.device)[None, :], (b, sk_total))
    elif cache is not None:
        _check_kv_dtype(cfg)
        k_full = scatter_cache_rows(cache["k"], k, cache_index)
        v_full = scatter_cache_rows(cache["v"], v, cache_index)
        length = k_full.shape[1]
        k_pos = torch.broadcast_to(
            torch.arange(length, device=x.device)[None, :], (b, length))
    else:
        k_full, v_full, k_pos = k, v, positions
        if return_cache:
            new_cache = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}

    if paged_kernel:
        out = paged_flash_decode(q, cache["k"], cache["v"], page_table,
                                 positions[:, -1], scale=scale,
                                 window=window, softcap=softcap)
    elif cfg.attn_impl == "flash" and cache is None:
        out = _flash_local(q, k, v, scale=scale, window=window,
                           softcap=softcap)
    else:
        out = attention_core(q, k_full, v_full, positions, k_pos,
                             scale=scale, causal=True, window=window,
                             softcap=softcap)
    out = linear_apply(params["wo"], out.reshape(b, s, h * hd), mode=mode,
                       backend=backend)
    return out, new_cache
