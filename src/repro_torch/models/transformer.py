"""Model assembly for attention-only stacks (port of
``repro.models.transformer``).

Parameters are a dict ``{"embed", "layers", "final_norm"[, "lm_head"]}``
where ``layers`` is the fully unrolled list of per-layer dicts (the
reference stacks the repeated blocks on a leading ``n_blocks`` axis for
``lax.scan``; :func:`load_jax_params` unstacks them).  Caches are a list
with one ``{"k", "v"}`` dict per layer: dense per-slot slabs
``(B, max_len, KVH, hd)`` or shared page pools ``(num_pages, page_size,
KVH, hd)``.

Entry points: :func:`forward` (full-sequence training logits,
differentiable; under ``cfg.remat`` each layer is recomputed in the
backward pass), :func:`prefill` (logits at ``logits_index`` plus the
caches, grown to ``max_len``; with ``ctx_*`` a prompt suffix against
cached prefix rows) and :func:`decode_step` (tokens against the caches at
per-slot positions).  Training mode never writes a cache.  The page-pool
helpers below serve the engine's prefix cache (row scatter, the
copy-on-write page copy) and its host tier (page payloads to and from
CPU tensors).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.linear import linear_init, prepare_quantized
from repro_torch.models.attention import (
    attn_apply,
    attn_init,
    init_kv_cache,
    init_paged_kv_cache,
    scatter_prefill_rows,
)
from repro_torch.models.layers import (
    embed_apply,
    embed_init,
    embed_logits,
    mlp_apply,
    mlp_init,
    rms_norm,
    rms_norm_init,
)

__all__ = ["model_init", "load_jax_params", "prepare_params", "forward",
           "prefill", "decode_step", "init_caches", "init_paged_caches",
           "merge_slot_caches", "merge_slot_paged_caches",
           "scatter_prefill_paged_caches", "copy_paged_cache_page",
           "extract_cache_pages", "insert_cache_pages"]


def _check_supported(cfg: ModelConfig) -> None:
    for spec in cfg.layer_specs:
        if spec.mixer != "attn" or spec.attn_kind == "mla" \
                or spec.ffn != "mlp":
            raise NotImplementedError(
                f"{cfg.name}: only attention + MLP layers are ported "
                f"(got {spec})")


def _linears(params: dict):
    for layer in params["layers"]:
        yield from (layer["attn"][n] for n in ("wq", "wk", "wv", "wo"))
        yield from (layer["mlp"][n] for n in ("gate", "up", "down"))


def prepare_params(params: dict, cfg: ModelConfig) -> dict:
    """Quantize every projection weight once for ``cfg.quant_mode`` (a
    no-op for ``dense``).  Serving folds this constant instead of
    re-quantizing each weight on every call; the values are the same."""
    for lin in _linears(params):
        prepare_quantized(lin, cfg.quant_mode)
    return params


def model_init(cfg: ModelConfig, *, seed: int = 0,
               device="cuda") -> dict:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` (the
    reference's init rules: He-scaled projections, 0.02 embedding, zero
    norm gains), quantized once for ``cfg.quant_mode``."""
    _check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=gen, device=device)
    layers = []
    for _ in cfg.layer_specs:
        layers.append({
            "mixer_norm": rms_norm_init(cfg.d_model, device),
            "attn": attn_init(cfg, **kw),
            "ffn_norm": rms_norm_init(cfg.d_model, device),
            "mlp": mlp_init(cfg.d_model, cfg.d_ff, **kw),
        })
    params = {"embed": embed_init(cfg.vocab_size, cfg.d_model, **kw),
              "layers": layers,
              "final_norm": rms_norm_init(cfg.d_model, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(cfg.d_model, cfg.vocab_size, **kw)
    return prepare_params(params, cfg)


def load_jax_params(tree, cfg: ModelConfig, *, device="cuda") -> dict:
    """The weight bridge: the reference ``model_init`` pytree with numpy
    leaves (bf16 leaves passed through float32) -> this package's params,
    so both packages compute the same function.  Projection and embedding
    weights come back as bf16 (exact: they were bf16), norm gains as f32;
    the stacked block axis is unrolled into the layer list."""
    _check_supported(cfg)
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: (torch.as_tensor(v, device=device).to(
                torch.float32 if k == "scale" else torch.bfloat16)
                if not isinstance(v, dict) else conv(v))
                for k, v in node.items()}
        raise TypeError(f"unexpected node {type(node)}")

    stack = tree["stack"]
    per_block = [conv(p) for p in stack["prefix"]]
    blocks = stack["blocks"]
    for i in range(cfg.n_blocks):
        for j in range(len(cfg.block_pattern)):
            per_block.append(_index_tree(conv(blocks[str(j)]), i))
    per_block += [conv(p) for p in stack["suffix"]]
    params = {"embed": conv(tree["embed"]), "layers": per_block,
              "final_norm": conv(tree["final_norm"])}
    if "lm_head" in tree:
        params["lm_head"] = conv(tree["lm_head"])
    return prepare_params(params, cfg)


def _index_tree(node: dict, i: int) -> dict:
    return {k: _index_tree(v, i) if isinstance(v, dict) else v[i]
            for k, v in node.items()}


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------

def _layer_apply(p, cfg: ModelConfig, spec, x, *, positions, cache=None,
                 cache_index=None, mode="train", page_table=None,
                 context_start=None):
    """One pre-norm attention + MLP layer; returns (x, new_cache)."""
    h = rms_norm(p["mixer_norm"], x, cfg.norm_eps)
    out, c = attn_apply(p["attn"], cfg, h, positions=positions,
                        kind=spec.attn_kind, cache=cache,
                        cache_index=cache_index,
                        return_cache=(mode == "prefill"),
                        page_table=page_table, context_start=context_start)
    x = x + out
    h = rms_norm(p["ffn_norm"], x, cfg.norm_eps)
    x = x + mlp_apply(p["mlp"], h, act=cfg.act, quant_mode=cfg.quant_mode,
                      quant_backend=cfg.quant_backend)
    return x, c


def _stack_apply(params, cfg: ModelConfig, x, *, positions, caches=None,
                 cache_index=None, mode="train", page_table=None,
                 context_start=None):
    """Returns (x, new_caches); caches only for prefill / decode.  In
    training with ``cfg.remat`` every layer runs under a non-reentrant
    checkpoint: only its input is kept, the rest is recomputed in the
    backward pass (the reference's ``jax.checkpoint`` per block)."""
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    new_caches = []
    for li, (p, spec) in enumerate(zip(params["layers"], cfg.layer_specs)):
        if remat:
            x, c = checkpoint(
                lambda x_, p_=p, s_=spec: _layer_apply(
                    p_, cfg, s_, x_, positions=positions),
                x, use_reentrant=False)
        else:
            x, c = _layer_apply(p, cfg, spec, x, positions=positions,
                                cache=None if caches is None else caches[li],
                                cache_index=cache_index, mode=mode,
                                page_table=page_table,
                                context_start=context_start)
        new_caches.append(c)
    return x, (new_caches if mode in ("prefill", "decode") else None)


def _logits(params, cfg: ModelConfig, x):
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return embed_logits(params["embed"], x)
    # untied head: a plain bf16 matmul, as the reference leaves it to XLA
    return torch.matmul(x, params["lm_head"]["w"].to(x.dtype)) \
        .to(torch.float32)


def _embed(params, cfg, tokens):
    return embed_apply(params["embed"], tokens,
                       scale_by_sqrt_dim=cfg.emb_scale_by_sqrt_dim)


def forward(params, cfg: ModelConfig, tokens):
    """Training logits.  tokens: (B, S) int.  Returns ``(logits (B, S, V)
    f32, aux)``; ``aux`` is the MoE auxiliary loss, 0 for the attention-only
    stacks ported here.  Differentiable with respect to every float leaf
    of ``params``."""
    x = _embed(params, cfg, tokens)
    b, s, _ = x.shape
    pos = torch.broadcast_to(torch.arange(s, device=x.device)[None, :],
                             (b, s))
    x, _ = _stack_apply(params, cfg, x, positions=pos, mode="train")
    return _logits(params, cfg, x), torch.zeros((), dtype=torch.float32,
                                                device=x.device)


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens, *, max_len: int | None = None,
            logits_index=None, ctx_caches=None, ctx_table=None,
            ctx_start=None):
    """Run the prompt; returns (logits (B, 1, V), caches).
    ``logits_index`` (scalar or (B,)) picks the position whose logits are
    returned (default: the last), so a prompt zero-padded to a fixed slot
    budget returns its real last token's logits.  With ``max_len`` the
    caches are zero-grown to that length.

    Context prefill: with ``ctx_caches`` (the page pools), ``ctx_table``
    (the slot's (1, max_pages) table row) and ``ctx_start`` (an int or a
    0-d tensor), ``tokens`` is the uncached suffix of a prompt whose first
    ``ctx_start`` rows sit in the pools.  Queries run at ``ctx_start + [0,
    S)`` against the cached rows spliced below the fresh ones; the
    returned caches hold the suffix rows only.  ``ctx_start == 0`` gives
    the plain prefill's values through ``attention_core``."""
    x = _embed(params, cfg, tokens)
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)[None, :]
    if ctx_start is not None:
        pos = pos + torch.as_tensor(ctx_start, device=x.device)
    pos = torch.broadcast_to(pos, (b, s))
    x, caches = _stack_apply(params, cfg, x, positions=pos, mode="prefill",
                             caches=ctx_caches, page_table=ctx_table,
                             context_start=ctx_start)
    if logits_index is None:
        x_last = x[:, -1:]
    else:
        idx = torch.broadcast_to(
            torch.as_tensor(logits_index, device=x.device).reshape(-1).long(),
            (b,))
        x_last = x[torch.arange(b, device=x.device), idx][:, None]
    logits = _logits(params, cfg, x_last)
    if max_len is not None and max_len > s:
        caches = [{k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, max_len - s))
                   for k, v in c.items()} for c in caches]
    return logits, caches


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token, caches, index, *,
                page_table=None):
    """One decode step.  token: (B, S) int (classically S == 1); ``index``
    is the cache position of ``token[:, 0]``, a scalar or (B,) per-slot
    vector.  With ``page_table`` (B, max_pages) the caches are page pools.
    Caches are updated in place.  Returns (logits (B, S, V), caches)."""
    x = _embed(params, cfg, token)
    b, s = x.shape[0], token.shape[1]
    index = torch.as_tensor(index, device=x.device).to(torch.int64)
    pos = (torch.broadcast_to(index.reshape(-1, 1), (b, 1))
           + torch.arange(s, device=x.device)[None, :])
    x, caches = _stack_apply(params, cfg, x, positions=pos, caches=caches,
                             cache_index=index, mode="decode",
                             page_table=page_table)
    return _logits(params, cfg, x), caches


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                device="cuda") -> list:
    """Per-layer decode caches: dense slabs, or page pools when
    ``cfg.cache_mode == "paged"`` (auto pool: capacity parity with the
    dense slab plus the trash page)."""
    device = resolve_device(device)
    if cfg.cache_mode == "paged":
        ps = cfg.page_size
        if ps < 1:
            raise ValueError(f"page_size must be >= 1, got {ps}")
        if max_len % ps:
            raise ValueError(f"max_len {max_len} must be a multiple of "
                             f"page_size {ps}")
        num_pages = cfg.num_pages or batch * (max_len // ps) + 1
        return init_paged_caches(cfg, batch, num_pages, ps, device=device)
    return [init_kv_cache(cfg, batch, max_len, device)
            for _ in cfg.layer_specs]


def init_paged_caches(cfg: ModelConfig, batch: int, num_pages: int,
                      page_size: int, *, device="cuda") -> list:
    """One shared ``(num_pages, page_size, KVH, hd)`` pool per layer."""
    device = resolve_device(device)
    return [init_paged_kv_cache(cfg, num_pages, page_size, device)
            for _ in cfg.layer_specs]


def merge_slot_caches(big: list, one: list, slot: int) -> list:
    """Copy a batch-1 cache (same max_len) into slot ``slot``, in place."""
    for b_c, s_c in zip(big, one):
        for key in b_c:
            b_c[key][slot] = s_c[key][0].to(b_c[key].dtype)
    return big


def merge_slot_paged_caches(big: list, one: list, slot: int, pages) -> list:
    """Copy a prefilled batch-1 cache (length a whole number of pages) into
    the pools at page ids ``pages[:n]``, in place.  Entries past the
    request's pages point at the trash page, so pad rows land there."""
    del slot                      # pools are shared; the table routes slots
    pages = torch.as_tensor(pages, device=big[0]["k"].device).long()
    for b_c, s_c in zip(big, one):
        for key in b_c:
            ps = b_c[key].shape[1]
            s = s_c[key].shape[1]
            if s % ps:
                raise ValueError(f"prefill cache length {s} is not a whole "
                                 f"number of pages (page_size {ps})")
            n_p = s // ps
            rows = s_c[key][0].reshape(n_p, ps, *s_c[key].shape[2:])
            b_c[key][pages[:n_p]] = rows.to(b_c[key].dtype)
    return big


def scatter_prefill_paged_caches(big: list, one: list, slot: int, row,
                                 start) -> list:
    """Row-granular dual of :func:`merge_slot_paged_caches` for the prefix
    cache: write a context-prefilled suffix cache (rows for positions
    ``start + [0, S)``) through one slot's table ``row`` into the pools,
    in place.  Shared prefix pages below ``start`` are never touched."""
    del slot                      # pools are shared; the row routes the slot
    row = torch.as_tensor(row, device=big[0]["k"].device)
    for b_c, s_c in zip(big, one):
        for key in b_c:
            scatter_prefill_rows(b_c[key], s_c[key], row, start)
    return big


def copy_paged_cache_page(caches: list, src, dst) -> list:
    """Copy pool page ``src`` onto ``dst`` in every pool, in place (the
    copy-on-write primitive: a shared tail page is duplicated into the
    slot's private page before its first write).  ``src`` and ``dst`` may
    be 0-d tensors, so the copy is data, not shape, or (G,) vectors of
    pairs (a wave's lanes; every source is read before any write); the
    no-COW default ``0, 0`` rewrites the trash page with itself."""
    dev = caches[0]["k"].device
    src = torch.as_tensor(src, device=dev).reshape(-1).long()
    dst = torch.as_tensor(dst, device=dev).reshape(-1).long()
    for c in caches:
        for pool in c.values():
            pool.index_copy_(0, dst, pool.index_select(0, src))
    return caches


def _pad_pages(pages, pad_to):
    """Page ids padded with the trash page (0) to ``pad_to`` entries, so
    every host-tier copy has one shape."""
    pages = list(pages)
    return pages + [0] * max(0, (pad_to or 0) - len(pages))


def extract_cache_pages(caches: list, pages, pad_to: int | None = None
                        ) -> list:
    """Copy pool pages ``pages`` of every layer's K and V to host memory
    in one transfer: one payload per page, a CPU tensor ``(2 * n_layers,
    page_size, KVH, hd)`` (layer-major, K then V).  With
    :func:`insert_cache_pages` a page round-trips bit for bit (swap-out and
    prefix demotion).  ``pad_to`` pads the gather with the trash page, so
    every call has one shape; the padded rows are dropped."""
    pages = list(pages)
    dev = caches[0]["k"].device
    idx = torch.as_tensor(_pad_pages(pages, pad_to), device=dev)
    rows = torch.stack([pool[idx] for c in caches for pool in c.values()],
                       dim=1).cpu()
    return [rows[j].clone() for j in range(len(pages))]


def insert_cache_pages(caches: list, pages, payloads, pad_to: int | None = None
                       ) -> list:
    """Write host payloads (from :func:`extract_cache_pages`) into pool
    pages ``pages``, in place, in one transfer (swap-in and prefix
    promotion).  ``pad_to`` pads with zero rows written onto the trash
    page, which no query attends."""
    pages = list(pages)
    if len(pages) != len(payloads):
        raise ValueError(f"{len(pages)} pages but {len(payloads)} payloads")
    padded = _pad_pages(pages, pad_to)
    dev = caches[0]["k"].device
    rows = torch.stack(list(payloads))
    if len(padded) > len(pages):
        rows = torch.cat([rows, rows.new_zeros(
            (len(padded) - len(pages),) + tuple(rows.shape[1:]))])
    rows = rows.to(dev).transpose(0, 1)
    idx = torch.as_tensor(padded, device=dev)
    pools = [pool for c in caches for pool in c.values()]
    for i, pool in enumerate(pools):
        pool[idx] = rows[i].to(pool.dtype)
    return caches
