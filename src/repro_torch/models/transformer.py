"""Model assembly (port of ``repro.models.transformer``): stacks of
layers, each a mixer (GQA or MLA attention, or the Mamba2 SSD mixer), in
an encoder-decoder's decoder a cross-attention over the encoder output,
then an MLP, an MoE block or no FFN (mamba2's blocks).

Parameters are a dict ``{"embed", "layers", "final_norm"[, "lm_head"][,
"encoder"]}`` where ``layers`` is the fully unrolled list of per-layer
dicts ``{"mixer_norm", "attn" | "mamba"[, "cross_norm", "cross"][,
"ffn_norm", "mlp" | "moe"]}`` (the reference stacks the repeated blocks
on a leading ``n_blocks`` axis for ``lax.scan``; :func:`load_jax_params`
unstacks them) and an encoder-decoder's ``encoder`` is ``{"layers",
"norm"}``, its own stack of ``n_enc_layers`` attention + MLP layers.
Caches are a list with one dict per decoder layer: ``{"k", "v"}`` for
GQA layers (``{"k", "v", "k_scale", "v_scale"}`` under the int8 KV
cache), ``{"c_kv", "k_rope"}`` (latents and rope keys) for MLA layers,
as dense per-slot slabs ``(B, max_len, ...)`` or shared page pools
``(num_pages, page_size, ...)``; ``{"conv", "ssm"}`` for mamba layers,
the per-slot recurrent state ``(B, ...)`` in either mode (it has no
sequence axis).  A cross-attention keeps no cache: every decode step
projects K/V from ``enc_out`` again, as the reference does.

Entry points: :func:`encode` (the encoder over stub frame embeddings),
:func:`forward` (full-sequence training logits and the summed MoE aux
loss, differentiable; a VLM's patch embeddings are prepended, an
encoder-decoder's frames run through the encoder first; under
``cfg.remat`` each layer is recomputed in the backward pass),
:func:`prefill` (logits at ``logits_index`` plus the caches, the
sequence leaves grown to ``max_len``, and the encoder output; with
``ctx_*`` a prompt suffix against cached prefix rows) and
:func:`decode_step` (tokens against the caches at per-slot positions,
cross-attending ``enc_out`` where given).  Training mode never writes a
cache.  The page-pool helpers below serve the engine's prefix cache (row
scatter, the copy-on-write page copy) and its host tier (page payloads
to and from CPU tensors, each pool's bytes as they are); they take every
sequence pool as it comes, of any key, row shape and dtype, and leave
the recurrent state alone.

Tensor parallelism: ``prefill`` and ``decode_step`` take the ``Shards``
of ``distributed.sharding.shard_params`` (one parameter tree per model
shard) and caches from :func:`init_shard_caches` or ``shard_caches`` (one
cache list per shard), and run every layer over the shards: the norms
and residual adds replicated; each GQA attention block (self-, cross- and
the encoder's) on its shard's heads and pools, or replicated where the kv
heads do not divide the shards; MLA's latent part once per device into
that device's whole latent pools, its heads split by query heads; each
mamba mixer on its shard's SSD heads and state, the gated norm whole
(``mamba.mamba_cols_shards``), or replicated; the column-parallel
projections on their shard's columns and ``wo`` /
``down`` row-parallel; MoE blocks expert-parallel
(``moe.moe_apply_shards``); the embedding and head vocab-parallel.  A
VLM's patches are prepended on every device and an encoder-decoder's
encoder runs over the shards the same way.  The logits (and an
``enc_out``) come back whole on shard 0's device.  Work that is
replicated runs once per distinct device; shards that share a device
share its replicated tensors.  The page helpers act on every shard, and
a host payload keeps the unsharded layout (the shards' heads
concatenated in shard order, a replicated pool once), so the host tiers
hold the same bytes at any ``tp``.

A data axis (``Shards`` of ``dp`` rows, FSDP pieces per entry): each
layer's weights are gathered at use (``sharding.gather_rows``), the
batch splits over ``slot_rows`` data rows and each row runs the path
above on its slots (a batch-1 prefill runs on row 0).  The rows meet
where the unsplit batch does: every integer projection quantizes with
the max of all rows' amaxes, the MoE block runs once over the whole
batch on row 0, and the final norm and head run over the rows' hidden
states gathered in slot order on row 0.  Dense slabs and mamba state
are split by slot; the paged pools are whole on every row, one copy
per distinct device, and a decode step's pool rows are mirrored into
the other copies.

Training over the mesh (:func:`forward_rows`, and :func:`forward` over
``Shards``): the same per-layer path in training mode (differentiable,
per-layer remat with each layer's weight gather inside the checkpoint,
the encoder's frames and a VLM's patches split by row), but every row
keeps its own slots to the end: the MoE block takes the reference's
mesh semantics (``moe.moe_apply_mesh``: each row routes its own tokens)
and each row's head runs on its own hidden states, vocabulary-parallel.
This is the layout the reference's training step gets from its ambient
mesh: batch on the data rows and, where the KV heads divide the model
axis, heads on it (its ``_flash_self_attention`` runs the flash kernel
per shard in exactly this layout, so it has no module of its own here).
The reference's ``ambient_mesh`` / ``maybe_shard`` have no counterpart:
they ask GSPMD to place values, and the port places them itself, each
tensor on the entry that computes it.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.linear import linear_apply, linear_apply_row, \
    linear_init, prepare_quantized, rows_amax
from repro_torch.distributed.collectives import all_gather, broadcast, \
    gathered_bytes, per_device
from repro_torch.kernels.ops import add_launch_counts, launch_counts
from repro_torch.distributed.sharding import MLA_CACHE_KEYS, \
    SEQ_CACHE_KEYS, Shards, gather_rows, slot_rows, ssm_segments
from repro_torch.models.attention import (
    KV_CACHE_DTYPES,
    attn_apply,
    attn_heads,
    attn_init,
    init_kv_cache,
    init_mla_cache,
    init_paged_kv_cache,
    init_paged_mla_cache,
    mla_apply,
    mla_heads,
    mla_init,
    mla_latent,
    mirror_paged_rows,
    scatter_prefill_rows,
)
from repro_torch.models.mamba import (
    init_mamba_cache,
    mamba_apply,
    mamba_cols_shards,
    mamba_heads,
    mamba_init,
    mamba_step,
    ssm_dims,
)
from repro_torch.models.layers import (
    bf16_matmul,
    embed_apply,
    embed_init,
    embed_logits,
    mlp_apply,
    mlp_hidden,
    mlp_init,
    rms_norm,
    rms_norm_init,
    vocab_parallel_embed,
    vocab_parallel_logits,
)
from repro_torch.models.moe import moe_apply, moe_apply_mesh, \
    moe_apply_shards, moe_init

__all__ = ["model_init", "load_jax_params", "unstack_jax_tree",
           "prepare_params", "encode",
           "forward", "forward_rows", "prefill", "decode_step",
           "init_caches",
           "init_paged_caches",
           "merge_slot_caches", "merge_slot_paged_caches",
           "scatter_prefill_paged_caches", "copy_paged_cache_page",
           "extract_cache_pages", "insert_cache_pages", "init_shard_caches",
           "sequence_pools", "cache_bytes", "decode_gather_bytes"]


def _check_supported(cfg: ModelConfig) -> None:
    """Refuse what the reference does not run either: layers other than
    an attention (GQA or MLA) or mamba mixer with an MLP, an MoE block or
    no FFN, and a KV cache other than bf16 or int8."""
    for spec in cfg.layer_specs:
        if spec.mixer not in ("attn", "mamba") \
                or spec.ffn not in ("mlp", "moe", "none"):
            raise NotImplementedError(
                f"{cfg.name}: {spec} is not ported: layers are an "
                f"attention (GQA or MLA) or mamba mixer with an MLP, an MoE "
                f"block or no FFN")
    if cfg.kv_cache_dtype not in KV_CACHE_DTYPES:
        raise NotImplementedError(f"kv_cache_dtype {cfg.kv_cache_dtype!r}: "
                                  f"the KV cache is one of {KV_CACHE_DTYPES}")


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder's stack: ``n_enc_layers`` attention + MLP layers."""
    return cfg.replace(n_layers=cfg.n_enc_layers,
                       block_pattern=(LayerSpec(),), prefix_pattern=(),
                       suffix_pattern=())


_ATTN_LINEARS = {"mla": ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo"),
                 "gqa": ("wq", "wk", "wv", "wo")}


def _linears(params: dict):
    """Every projection the quant modes run, the encoder's included:
    attention and cross-attention, the mamba mixer's ``in_proj`` and
    ``out_proj``, MLP and the shared expert (the bf16 expert stacks stay
    bf16, as in the reference)."""
    for layer in params["layers"] + params.get("encoder", {}).get(
            "layers", []):
        if "attn" in layer:
            attn = layer["attn"]
            yield from (attn[n] for n in _ATTN_LINEARS[
                "mla" if "wkv_b" in attn else "gqa"])
        else:
            yield from (layer["mamba"][n] for n in ("in_proj", "out_proj"))
        if "cross" in layer:
            yield from (layer["cross"][n] for n in _ATTN_LINEARS["gqa"])
        if "mlp" in layer:
            ffn = layer["mlp"]
        else:
            ffn = layer.get("moe", {}).get("shared")
        if ffn is not None:
            yield from (ffn[n] for n in ("gate", "up", "down"))


def prepare_params(params: dict, cfg: ModelConfig) -> dict:
    """Quantize every projection weight once for ``cfg.quant_mode`` (a
    no-op for ``dense``).  Serving folds this constant instead of
    re-quantizing each weight on every call; the values are the same."""
    for lin in _linears(params):
        prepare_quantized(lin, cfg.quant_mode)
    return params


def _layer_init(cfg: ModelConfig, spec, *, cross: bool, generator,
                device) -> dict:
    kw = dict(generator=generator, device=device)
    layer = {"mixer_norm": rms_norm_init(cfg.d_model, device)}
    if spec.mixer == "mamba":
        layer["mamba"] = mamba_init(cfg, **kw)
    else:
        layer["attn"] = (mla_init if spec.attn_kind == "mla"
                         else attn_init)(cfg, **kw)
    if cross:
        layer["cross_norm"] = rms_norm_init(cfg.d_model, device)
        layer["cross"] = attn_init(cfg, **kw)
    if spec.ffn != "none":
        layer["ffn_norm"] = rms_norm_init(cfg.d_model, device)
        if spec.ffn == "moe":
            layer["moe"] = moe_init(cfg, **kw)
        else:
            layer["mlp"] = mlp_init(cfg.d_model, cfg.d_ff, **kw)
    return layer


def model_init(cfg: ModelConfig, *, seed: int = 0,
               device="cuda") -> dict:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` (the
    reference's init rules: He-scaled projections and expert stacks, 0.02
    embedding and f32 router, zero norm gains; the mamba mixer's as in
    ``mamba_init``; an encoder-decoder's decoder layers carry a
    cross-attention and its encoder a stack of its own), quantized once
    for ``cfg.quant_mode``."""
    _check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=gen, device=device)
    layers = [_layer_init(cfg, spec, cross=cfg.is_encdec, **kw)
              for spec in cfg.layer_specs]
    params = {"embed": embed_init(cfg.vocab_size, cfg.d_model, **kw),
              "layers": layers,
              "final_norm": rms_norm_init(cfg.d_model, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(cfg.d_model, cfg.vocab_size, **kw)
    if cfg.is_encdec:
        params["encoder"] = {
            "layers": [_layer_init(cfg, spec, cross=False, **kw)
                       for spec in _enc_cfg(cfg).layer_specs],
            "norm": rms_norm_init(cfg.d_model, device)}
    return prepare_params(params, cfg)


# leaves the reference keeps in f32: norm gains, the MoE router and the
# mamba mixer's per-head A, D and dt-bias
_F32_LEAVES = ("scale", "router", "A_log", "D", "dt_bias")


def unstack_jax_tree(tree, cfg: ModelConfig, leaf) -> dict:
    """The reference's pytree in this package's layout: the stacked block
    axis unrolled into the layer list (an expert stack stays whole per
    layer), every array leaf passed through ``leaf(name, array)`` first
    (``name`` is its key).  The weight bridge below casts there; a test
    maps the reference's gradients with an identity ``leaf``."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) if isinstance(v, dict) else leaf(k, v)
                    for k, v in node.items()}
        raise TypeError(f"unexpected node {type(node)}")

    def unstack(stack, c):
        layers = [conv(p) for p in stack["prefix"]]
        blocks = [conv(stack["blocks"][str(j)])
                  for j in range(len(c.block_pattern))] if c.n_blocks else []
        for i in range(c.n_blocks):
            layers += [_index_tree(blk, i) for blk in blocks]
        return layers + [conv(p) for p in stack["suffix"]]

    out = {"embed": conv(tree["embed"]),
           "layers": unstack(tree["stack"], cfg),
           "final_norm": conv(tree["final_norm"])}
    if "lm_head" in tree:
        out["lm_head"] = conv(tree["lm_head"])
    if "encoder" in tree:
        out["encoder"] = {
            "layers": unstack(tree["encoder"]["stack"], _enc_cfg(cfg)),
            "norm": conv(tree["encoder"]["norm"])}
    return out


def load_jax_params(tree, cfg: ModelConfig, *, device="cuda") -> dict:
    """The weight bridge: the reference ``model_init`` pytree with numpy
    leaves (bf16 leaves passed through float32) -> this package's params,
    so both packages compute the same function.  Projection, embedding and
    expert weights and the mamba conv come back as bf16 (exact: they were
    bf16), norm gains, the MoE router and the mamba mixer's ``A_log``,
    ``D`` and ``dt_bias`` as f32 (the reference keeps them f32); the layout
    is :func:`unstack_jax_tree`'s."""
    _check_supported(cfg)
    device = resolve_device(device)
    params = unstack_jax_tree(
        tree, cfg, lambda k, v: torch.as_tensor(v, device=device).to(
            torch.float32 if k in _F32_LEAVES else torch.bfloat16))
    return prepare_params(params, cfg)


def _index_tree(node: dict, i: int) -> dict:
    return {k: _index_tree(v, i) if isinstance(v, dict) else v[i]
            for k, v in node.items()}


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------

def _layer_apply(p, cfg: ModelConfig, spec, x, *, positions, cache=None,
                 cache_index=None, enc_out=None, causal=True, mode="train",
                 page_table=None, context_start=None):
    """One pre-norm layer: attention (GQA or MLA) or the mamba mixer, the
    cross-attention over ``enc_out`` where the layer has one and
    ``enc_out`` is given, then an MLP, an MoE block or no FFN; returns
    (x, new_cache, aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(p["mixer_norm"], x, cfg.norm_eps)
    if spec.mixer == "mamba":
        if mode == "decode":
            out, c = mamba_step(p["mamba"], cfg, h, cache)
        else:
            out, c = mamba_apply(p["mamba"], cfg, h,
                                 return_cache=(mode == "prefill"))
    else:
        kw = dict(positions=positions, cache=cache, cache_index=cache_index,
                  return_cache=(mode == "prefill"), page_table=page_table,
                  context_start=context_start)
        if spec.attn_kind == "mla":
            out, c = mla_apply(p["attn"], cfg, h, **kw)
        else:
            out, c = attn_apply(p["attn"], cfg, h, kind=spec.attn_kind,
                                causal=causal, **kw)
    x = x + out
    if "cross" in p and enc_out is not None:
        h = rms_norm(p["cross_norm"], x, cfg.norm_eps)
        out, _ = attn_apply(p["cross"], cfg, h, positions=positions,
                            kv_source=enc_out, causal=False)
        x = x + out
    if spec.ffn == "none":
        return x, c, aux
    h = rms_norm(p["ffn_norm"], x, cfg.norm_eps)
    if spec.ffn == "moe":
        out, aux = moe_apply(p["moe"], cfg, h)
    else:
        out = mlp_apply(p["mlp"], h, act=cfg.act, quant_mode=cfg.quant_mode,
                        quant_backend=cfg.quant_backend)
    return x + out, c, aux


def _stack_apply(params, cfg: ModelConfig, x, *, positions, caches=None,
                 cache_index=None, enc_out=None, causal=True, mode="train",
                 page_table=None, context_start=None):
    """Returns (x, new_caches, total aux loss); caches only for prefill /
    decode.  ``params["layers"]`` runs in ``cfg.layer_specs`` order (the
    decoder's, or with ``_enc_cfg`` the encoder's).  In training with
    ``cfg.remat`` every layer runs under a non-reentrant checkpoint: only
    its input is kept, the rest is recomputed in the backward pass (the
    reference's ``jax.checkpoint`` per block)."""
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    new_caches = []
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li, (p, spec) in enumerate(zip(params["layers"], cfg.layer_specs)):
        if remat:
            x, c, aux = checkpoint(
                lambda x_, p_=p, s_=spec: _layer_apply(
                    p_, cfg, s_, x_, positions=positions, enc_out=enc_out,
                    causal=causal),
                x, use_reentrant=False)
        else:
            x, c, aux = _layer_apply(
                p, cfg, spec, x, positions=positions,
                cache=None if caches is None else caches[li],
                cache_index=cache_index, enc_out=enc_out, causal=causal,
                mode=mode, page_table=page_table,
                context_start=context_start)
        total_aux = total_aux + aux
        new_caches.append(c)
    return x, (new_caches if mode in ("prefill", "decode") else None), \
        total_aux


def _logits(params, cfg: ModelConfig, x):
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return embed_logits(params["embed"], x)
    # untied head: a bf16 product, as the reference leaves it to XLA
    return bf16_matmul(x, params["lm_head"]["w"].to(x.dtype)) \
        .to(torch.float32)


# ---------------------------------------------------------------------------
# The stack over the mesh (tensor parallelism and a data axis)
# ---------------------------------------------------------------------------
#
# Every function below takes nested lists ``[d][m]``: data row ``d``'s
# model shard ``m`` (one row without a data axis).  A row runs its own
# slots; within a row the residual stream is replicated over the shards.
# The rows meet where the reference's batch-wide values meet: the int
# modes' per-tensor activation scale (``rows_amax``), the MoE block's
# routing and capacity (``_moe_rows``) and the head (``_logits_rows``).

def _row_split(t, rows: int) -> list:
    """``t``'s leading (batch) axis in ``rows`` equal parts; a scalar, a
    0-d tensor or None repeated."""
    if not isinstance(t, torch.Tensor) or t.ndim == 0 or rows == 1:
        return [t] * rows
    n = t.shape[0] // rows
    return [t[d * n:(d + 1) * n] for d in range(rows)]


def _shard_locals(devices, **tensors) -> list:
    """Per shard, the step's host-authored inputs (positions, cache
    index, page table, context start) on its device; non-tensors and
    ``None`` as they are."""
    per = {k: broadcast(v, devices) if isinstance(v, torch.Tensor)
           else [v] * len(devices) for k, v in tensors.items()}
    return [{k: per[k][i] for k in tensors} for i in range(len(devices))]


def _row_locals(params: Shards, rows: int, **tensors) -> list:
    """:func:`_shard_locals` per data row, each row taking its slots'
    part of every batch-leading input."""
    split = {k: _row_split(v, rows) for k, v in tensors.items()}
    return [_shard_locals(params.row_devices(d),
                          **{k: v[d] for k, v in split.items()})
            for d in range(rows)]


def _devs(xs) -> list:
    return [[x.device for x in row] for row in xs]


def _at(t, d, i):
    return None if t is None else t[d][i]


def _rows_row_parallel(ws, xs, cfg) -> list:
    """A row-parallel projection per data row (``linear_apply_row`` over
    the row's shards), the int modes' amax over every row's slices."""
    amax = rows_amax(xs, cfg.quant_mode)
    return [linear_apply_row(ws[d], xs[d], mode=cfg.quant_mode,
                             backend=cfg.quant_backend,
                             x_amax=None if amax is None else amax[d])
            for d in range(len(xs))]


def _rows_replicated(ws, xs, cfg) -> list:
    """A whole projection over a replicated input, once per distinct
    device of each row, the int modes' amax over every row's input."""
    amax = rows_amax(xs, cfg.quant_mode)
    devs = _devs(xs)
    return [per_device(devs[d], lambda i: linear_apply(
        ws[d][i], xs[d][i], mode=cfg.quant_mode, backend=cfg.quant_backend,
        x_amax=_at(amax, d, i))) for d in range(len(xs))]


def _tp_attn(ps, cfg, layout, spec, hs, *, loc, caches, mode, causal):
    """The self-attention block over the mesh: per shard over its heads
    (each shard's ``attention_core`` call alone, as on a card of its own)
    then ``wo`` row-parallel, or replicated once per device where the
    heads do not divide.  MLA's latent part (no head axis) runs once per
    device and writes that device's pools.  Returns (outs, caches)."""
    rows = range(len(hs))
    devs = _devs(hs)
    amax = rows_amax(hs, cfg.quant_mode)

    def kw(d, i):
        return dict(positions=loc[d][i]["positions"],
                    cache=_at(caches, d, i),
                    cache_index=loc[d][i]["cache_index"],
                    return_cache=(mode == "prefill"),
                    page_table=loc[d][i]["page_table"],
                    context_start=loc[d][i]["context_start"])

    def wo(d):
        return [p["attn"]["wo"] for p in ps[d]]

    if spec.attn_kind == "mla":
        lat = [per_device(devs[d], lambda i: mla_latent(
            ps[d][i]["attn"], cfg, hs[d][i], x_amax=_at(amax, d, i),
            **kw(d, i))) for d in rows]
        q_amax, kv_amax = (rows_amax([[lt[0][k] for lt in lat[d]]
                                      for d in rows], cfg.quant_mode)
                           for k in ("q_a", "c_kv"))

        def heads(d, i, c):
            return mla_heads(ps[d][i]["attn"], c, lat[d][i][0],
                             positions=loc[d][i]["positions"],
                             q_amax=_at(q_amax, d, i),
                             kv_amax=_at(kv_amax, d, i))

        if layout.mla_heads:
            mcfg = layout.mla_cfg(cfg)
            outs = _rows_row_parallel(
                [wo(d) for d in rows],
                [[heads(d, i, mcfg) for i in range(len(ps[d]))]
                 for d in rows], cfg)
        else:
            outs = _rows_replicated(
                [wo(d) for d in rows],
                [per_device(devs[d], lambda i: heads(d, i, cfg))
                 for d in rows], cfg)
        return outs, [[c for _, c in lat[d]] for d in rows]
    akw = dict(kind=spec.attn_kind, causal=causal)
    if layout.heads:
        scfg = layout.shard_cfg(cfg)
        res = [[attn_heads(p["attn"], scfg, hs[d][i], x_amax=_at(amax, d, i),
                           **akw, **kw(d, i)) for i, p in enumerate(ps[d])]
               for d in rows]
        project = _rows_row_parallel
    else:
        res = [per_device(devs[d], lambda i: attn_heads(
            ps[d][i]["attn"], cfg, hs[d][i], x_amax=_at(amax, d, i), **akw,
            **kw(d, i))) for d in rows]
        project = _rows_replicated
    outs = project([wo(d) for d in rows],
                   [[o for o, _ in res[d]] for d in rows], cfg)
    return outs, [[c for _, c in res[d]] for d in rows]


def _tp_mamba(ps, cfg, layout, hs, *, caches, mode):
    """The mamba mixer over the mesh: each shard on its SSD heads with the
    gated norm whole and ``out_proj`` row-parallel
    (``mamba.mamba_cols_shards``), or replicated once per device where
    the heads do not divide.  Returns (outs, caches)."""
    rows = range(len(hs))
    amax = rows_amax(hs, cfg.quant_mode)
    out_proj = [[p["mamba"]["out_proj"] for p in ps[d]] for d in rows]
    if layout.ssm_heads:
        res = [mamba_cols_shards(
            [p["mamba"] for p in ps[d]], cfg, hs[d], layout, mode=mode,
            caches=None if caches is None else caches[d],
            x_amax=None if amax is None else amax[d]) for d in rows]
        return (_rows_row_parallel(out_proj, [c for c, _ in res], cfg),
                [cs for _, cs in res])
    devs = _devs(hs)
    res = [per_device(devs[d], lambda i: mamba_heads(
        ps[d][i]["mamba"], cfg, hs[d][i], mode=mode,
        cache=_at(caches, d, i), x_amax=_at(amax, d, i))) for d in rows]
    return (_rows_replicated(out_proj, [[n for n, _ in res[d]] for d in rows],
                             cfg),
            [[c for _, c in res[d]] for d in rows])


def _tp_cross(ps, cfg, layout, hs, *, loc, enc_outs) -> list:
    """The cross-attention over ``enc_outs`` (one per entry): per shard
    over its heads then ``wo`` row-parallel, or replicated."""
    rows = range(len(hs))
    devs = _devs(hs)
    amax = rows_amax(hs, cfg.quant_mode)
    kv_amax = rows_amax(enc_outs, cfg.quant_mode)

    def heads(d, i, c):
        return attn_heads(ps[d][i]["cross"], c, hs[d][i],
                          positions=loc[d][i]["positions"],
                          kv_source=enc_outs[d][i], causal=False,
                          x_amax=_at(amax, d, i),
                          kv_amax=_at(kv_amax, d, i))[0]

    wo = [[p["cross"]["wo"] for p in ps[d]] for d in rows]
    if layout.heads:
        scfg = layout.shard_cfg(cfg)
        return _rows_row_parallel(
            wo, [[heads(d, i, scfg) for i in range(len(ps[d]))]
                 for d in rows], cfg)
    return _rows_replicated(
        wo, [per_device(devs[d], lambda i: heads(d, i, cfg)) for d in rows],
        cfg)


def _moe_rows(ps, cfg, layout, hs, train: bool = False):
    """The MoE block over the mesh; returns (outputs ``[d][m]``, aux).
    Serving: its routing, capacity and drop order span every token of the
    call, so with several data rows their inputs are gathered in slot
    order onto data row 0's entries, the block runs there once over the
    whole batch (``moe.moe_apply_shards``, bit for bit the unsplit call)
    and each row takes its slots' outputs back.  Training (``train``,
    where the experts divide the shards): the reference's mesh semantics,
    each row on its own tokens (``moe.moe_apply_mesh``)."""
    if train and layout.experts:
        return moe_apply_mesh([[p["moe"] for p in row] for row in ps], cfg,
                              hs, layout)
    if len(hs) == 1:
        outs, aux = moe_apply_shards([p["moe"] for p in ps[0]], cfg, hs[0],
                                     layout)
        return [outs], aux
    rows = range(len(hs))
    devs = _devs(hs)
    whole = per_device(devs[0], lambda i: torch.cat(
        [hs[d][i] if d == 0 else _to_row(hs[d][i], devs[0][i])
         for d in rows]))
    outs, aux = moe_apply_shards([p["moe"] for p in ps[0]], cfg, whole,
                                 layout)
    n = hs[0][0].shape[0]
    return [per_device(devs[d], lambda i: outs[i][d * n:(d + 1) * n]
                       if d == 0 else _to_row(outs[i][d * n:(d + 1) * n],
                                              devs[d][i]))
            for d in rows], aux


def _to_row(t, dev):
    """``t`` on an entry of another data row on ``dev`` (a counted move
    where the two are distinct cards)."""
    return broadcast(t, [t.device, dev], src=0, axis="data")[1]


def _tp_layer_apply(ps: list, cfg: ModelConfig, layout, spec, xs: list, *,
                    loc: list, caches, mode: str, causal: bool = True,
                    enc_outs=None, train: bool = False):
    """One pre-norm layer over the mesh: ``ps[d][m]`` entry ``(d, m)``'s
    parameter dict, ``xs[d]`` row ``d``'s residual stream (replicated over
    its shards), ``caches[d][m]`` one cache dict per entry (or None),
    ``enc_outs[d][m]`` the encoder output for a cross-attention (or
    None).  Returns (xs, per-entry new caches, the MoE aux loss or None);
    ``train``: the MoE block takes the training step's mesh semantics."""
    rows = range(len(xs))
    devs = _devs(xs)

    def norm(key, xs):
        return [per_device(devs[d], lambda i: rms_norm(
            ps[d][i][key], xs[d][i], cfg.norm_eps)) for d in rows]

    def add(xs, outs):
        return [per_device(devs[d], lambda i: xs[d][i] + outs[d][i])
                for d in rows]

    if spec.mixer == "mamba":
        outs, cs = _tp_mamba(ps, cfg, layout, norm("mixer_norm", xs),
                             caches=caches, mode=mode)
    else:
        outs, cs = _tp_attn(ps, cfg, layout, spec, norm("mixer_norm", xs),
                            loc=loc, caches=caches, mode=mode,
                            causal=causal)
    xs = add(xs, outs)
    if "cross" in ps[0][0] and enc_outs is not None:
        xs = add(xs, _tp_cross(ps, cfg, layout, norm("cross_norm", xs),
                               loc=loc, enc_outs=enc_outs))
    if spec.ffn == "none":
        return xs, cs, None
    hs = norm("ffn_norm", xs)
    if spec.ffn == "moe":
        outs, aux = _moe_rows(ps, cfg, layout, hs, train)
        return add(xs, outs), cs, aux
    amax = rows_amax(hs, cfg.quant_mode)
    act = dict(act=cfg.act, quant_mode=cfg.quant_mode,
               quant_backend=cfg.quant_backend)

    def hidden(d, i):
        return mlp_hidden(ps[d][i]["mlp"], hs[d][i], x_amax=_at(amax, d, i),
                          **act)

    down = [[p["mlp"]["down"] for p in ps[d]] for d in rows]
    if layout.ffn:
        outs = _rows_row_parallel(
            down, [[hidden(d, i) for i in range(len(ps[d]))] for d in rows],
            cfg)
    else:
        outs = _rows_replicated(
            down, [per_device(devs[d], lambda i: hidden(d, i)) for d in rows],
            cfg)
    return add(xs, outs), cs, None


def _mirror_pool_writes(cs: list, loc: list, s: int) -> None:
    """Paged pools are whole on every data row, one copy per distinct
    device: the rows each data row wrote this step are copied into the
    other copies, so every copy holds every page (a prefix page one row
    wrote may be read by another row's slot).  Rows sharing a device
    share one copy, and nothing is copied."""
    for m in range(len(cs[0])):
        for key in cs[0][m]:
            if key not in _SEQ_CACHE_KEYS:
                continue
            copies = list(_unique(c[m][key] for c in cs))
            if len(copies) < 2:
                continue
            for d, c in enumerate(cs):
                for dst in copies:
                    if dst is not c[m][key]:
                        mirror_paged_rows(c[m][key], dst,
                                          loc[d][m]["page_table"],
                                          loc[d][m]["cache_index"], s)


def _tp_stack_apply(layer_params, cfg: ModelConfig, layout, xs: list, *,
                    loc, caches=None, mode: str, causal: bool = True,
                    enc_outs=None, train: bool = False):
    """A stack over the mesh (``layer_params(li)``: layer ``li``'s
    parameter dicts ``[d][m]``, gathered at use, in ``cfg.layer_specs``
    order, the decoder's or with ``_enc_cfg`` the encoder's); returns
    (xs, per-entry caches as lists ``[d][m]``, the summed MoE aux loss or
    None).  A decode step through page tables mirrors each row's pool
    writes into the other rows' copies on other devices.  ``train``: the
    training step's semantics, and under ``cfg.remat`` with grads on each
    layer, its weights' gather included, runs under a non-reentrant
    checkpoint (recomputed in the backward pass, as :func:`_stack_apply`
    does)."""
    per_entry = [[[] for _ in row] for row in xs]
    mirror = (mode == "decode" and len(xs) > 1
              and loc[0][0]["page_table"] is not None)
    remat = train and cfg.remat and torch.is_grad_enabled()
    shape = [len(row) for row in xs]
    total_aux = None
    for li, spec in enumerate(cfg.layer_specs):
        def run(*flat, li=li, spec=spec):
            it = iter(flat)
            rows = [[next(it) for _ in range(n)] for n in shape]
            out, cs, aux = _tp_layer_apply(
                layer_params(li), cfg, layout, spec, rows, loc=loc,
                caches=None if caches is None else [[c[li] for c in row]
                                                    for row in caches],
                mode=mode, causal=causal, enc_outs=enc_outs, train=train)
            return [x for row in out for x in row], cs, aux

        flat = [x for row in xs for x in row]
        if remat:
            flat, cs, aux = checkpoint(run, *flat, use_reentrant=False)
        else:
            flat, cs, aux = run(*flat)
        it = iter(flat)
        xs = [[next(it) for _ in range(n)] for n in shape]
        if aux is not None:
            total_aux = aux if total_aux is None else total_aux + aux
        if mirror and spec.mixer != "mamba":
            _mirror_pool_writes(cs, loc, xs[0][0].shape[1])
        for lst_row, c_row in zip(per_entry, cs):
            for lst, c in zip(lst_row, c_row):
                lst.append(c)
    return xs, per_entry, total_aux


def _layers_at_use(params: Shards, cfg: ModelConfig, rows: int, stack,
                   train: bool = False):
    """``layer_params`` for :func:`_tp_stack_apply`: layer ``li`` of
    ``stack(tree)`` per entry ``[d][m]``, gathered at use
    (``sharding.gather_rows``); an MoE block for data row 0 only, which
    runs it over the whole batch (``train`` with expert-split stacks:
    every row, each on its own tokens)."""
    mode = cfg.quant_mode
    moe_rows = rows if train and params.layout.experts else 1

    def layer(li):
        if params.fsdp is None or moe_rows == rows:
            return gather_rows(params, lambda t: stack(t)[li], rows, mode)
        ps = gather_rows(params, lambda t: {
            k: v for k, v in stack(t)[li].items() if k != "moe"}, rows, mode)
        if "moe" in stack(params.fsdp)[li]:
            moe = gather_rows(params, lambda t: stack(t)[li]["moe"], 1,
                              mode)[0]
            for p, m in zip(ps[0], moe):
                p["moe"] = m
        return ps

    return layer


def _tp_embed(params: Shards, cfg: ModelConfig, tokens, rows: int) -> list:
    """Each row's tokens embedded on its entries ``[d][m]`` (vocab-
    parallel where the vocab divides the shards)."""
    scale = cfg.emb_scale_by_sqrt_dim
    embs = gather_rows(params, lambda t: t["embed"], rows, cfg.quant_mode)
    out = []
    for d, tok in enumerate(_row_split(tokens, rows)):
        devs = params.row_devices(d)
        toks = broadcast(tok, devs)
        if params.layout.vocab:
            out.append(vocab_parallel_embed(embs[d], toks,
                                            scale_by_sqrt_dim=scale))
        else:
            out.append(per_device(devs, lambda i: embed_apply(
                embs[d][i], toks[i], scale_by_sqrt_dim=scale)))
    return out


def _logits_rows(params: Shards, cfg: ModelConfig, xs: list):
    """f32 logits, whole, on entry (0, 0)'s device: the rows' final
    hidden states gathered in slot order onto data row 0's entries, then
    the final norm and the head once over the whole batch (so the head's
    bf16 product sees the unsplit batch's shape)."""
    devs = params.row_devices(0)
    if len(xs) > 1:
        xs = [per_device(devs, lambda i: torch.cat(
            [row[i].to(devs[i]) for row in xs]))]
    keys = ("final_norm", "embed") if cfg.tie_embeddings \
        else ("final_norm", "lm_head")
    ps = gather_rows(params, lambda t: {k: t[k] for k in keys}, 1,
                     cfg.quant_mode)[0]
    if not params.layout.vocab:
        return _logits(ps[0], cfg, xs[0][0])
    hs = per_device(devs, lambda i: rms_norm(ps[i]["final_norm"], xs[0][i],
                                             cfg.norm_eps))
    tied = cfg.tie_embeddings
    heads = [p["embed"] if tied else p["lm_head"] for p in ps]
    return vocab_parallel_logits(heads, hs, tied=tied)[0]


def _tp_encode(params: Shards, cfg: ModelConfig, frames, rows: int,
               train: bool = False) -> list:
    """:func:`encode` over the mesh (the decoder's head and MLP split,
    bidirectional attention, each row on its slots' frames): the encoder
    output per entry ``[d][m]``, once per device of a row (``train``:
    per-layer remat, as in :func:`forward`)."""
    ecfg = _enc_cfg(cfg)
    b, s, _ = frames.shape
    pos = torch.broadcast_to(
        torch.arange(s, device=frames.device)[None, :], (b, s))
    loc = _row_locals(params, rows, positions=pos, cache_index=None,
                      page_table=None, context_start=None)
    xs = [broadcast(f, params.row_devices(d))
          for d, f in enumerate(_row_split(frames, rows))]
    xs, _, _ = _tp_stack_apply(
        _layers_at_use(params, cfg, rows, lambda t: t["encoder"]["layers"],
                       train),
        ecfg, params.layout, xs, loc=loc, mode="train", causal=False,
        train=train)
    norms = gather_rows(params, lambda t: t["encoder"]["norm"], rows,
                        cfg.quant_mode)
    return [per_device(params.row_devices(d), lambda i: rms_norm(
        norms[d][i], xs[d][i], cfg.norm_eps)) for d in range(rows)]


def encode(params, cfg: ModelConfig, frames):
    """The encoder over stub-frontend frame embeddings (B, S_enc, D):
    bidirectional self-attention (with RoPE, in ``attention_core``) + MLP
    layers, then the encoder's final norm."""
    b, s, _ = frames.shape
    pos = torch.broadcast_to(torch.arange(s, device=frames.device)[None, :],
                             (b, s))
    x, _, _ = _stack_apply(params["encoder"], _enc_cfg(cfg), frames,
                           positions=pos, causal=False, mode="train")
    return rms_norm(params["encoder"]["norm"], x, cfg.norm_eps)


def _embed_inputs(params, cfg, tokens, extra_embeds=None):
    """Token embeddings, a VLM's patch embeddings (B, P, D) prepended."""
    x = embed_apply(params["embed"], tokens,
                    scale_by_sqrt_dim=cfg.emb_scale_by_sqrt_dim)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


def forward(params, cfg: ModelConfig, tokens, *, extra_embeds=None,
            frames=None):
    """Training logits.  tokens: (B, S) int.  Returns ``(logits (B, S', V)
    f32, aux)``; ``aux`` is the MoE auxiliary loss summed over the MoE
    layers (0 without one).  A VLM's ``extra_embeds`` (B, P, D) are
    prepended (S' = P + S); an encoder-decoder's ``frames`` (B, S_enc, D)
    run through the encoder first and every decoder layer cross-attends
    its output.  Differentiable with respect to every float leaf of
    ``params``.  Over ``Shards`` (:func:`forward_rows`): the logits whole
    on entry (0, 0)'s device."""
    if isinstance(params, Shards):
        parts, aux = forward_rows(params, cfg, tokens,
                                  extra_embeds=extra_embeds, frames=frames)
        dev = params.devices[0]
        rows = [all_gather(row, devices=params.row_devices(d))[0]
                if params.layout.vocab else row[0]
                for d, row in enumerate(parts)]
        return torch.cat([r if d == 0 else _to_row(r, dev)
                          for d, r in enumerate(rows)]), aux
    enc_out = encode(params, cfg, frames) if frames is not None else None
    x = _embed_inputs(params, cfg, tokens, extra_embeds)
    b, s, _ = x.shape
    pos = torch.broadcast_to(torch.arange(s, device=x.device)[None, :],
                             (b, s))
    x, _, aux = _stack_apply(params, cfg, x, positions=pos, enc_out=enc_out,
                             mode="train")
    return _logits(params, cfg, x), aux


def forward_rows(params: Shards, cfg: ModelConfig, tokens, *,
                 extra_embeds=None, frames=None, token_grid: bool = False):
    """:func:`forward` over the mesh, the training step's semantics: the
    batch splits over ``slot_rows`` data rows, each row runs the layers
    on its slots (heads, MLP columns and experts split over its shards;
    the MoE block as the reference's mesh step runs it,
    ``moe.moe_apply_mesh``; per-layer remat under ``cfg.remat``), and its
    head runs on its own hidden states.  Returns ``(parts, aux)``:
    ``parts[d][m]`` entry ``(d, m)``'s f32 logits for row ``d``'s slots,
    its shard's slice of the vocabulary where the vocabulary divides the
    shards (``layout.vocab``), else the whole logits on every entry;
    ``aux`` the summed MoE aux loss on entry (0, 0)'s device (0 without
    an MoE layer).  ``token_grid``: a VLM's patch positions are cut off
    before the head."""
    b, n_tok = tokens.shape
    rows = slot_rows(b, params.dp)
    layout = params.layout
    enc_outs = None if frames is None else _tp_encode(params, cfg, frames,
                                                      rows, train=True)
    xs = _tp_embed(params, cfg, tokens, rows)
    if extra_embeds is not None:
        for d, pre in enumerate(_row_split(extra_embeds, rows)):
            pre = broadcast(pre, params.row_devices(d))
            xs[d] = per_device(params.row_devices(d), lambda i: torch.cat(
                [pre[i].to(xs[d][i].dtype), xs[d][i]], dim=1))
    s = xs[0][0].shape[1]
    pos = torch.broadcast_to(
        torch.arange(s, device=params.devices[0])[None, :], (b, s))
    loc = _row_locals(params, rows, positions=pos, cache_index=None,
                      page_table=None, context_start=None)
    xs, _, aux = _tp_stack_apply(
        _layers_at_use(params, cfg, rows, lambda t: t["layers"], True), cfg,
        layout, xs, loc=loc, mode="train", enc_outs=enc_outs, train=True)
    if token_grid:
        xs = [[x[:, -n_tok:] for x in row] for row in xs]
    keys = ("final_norm", "embed") if cfg.tie_embeddings \
        else ("final_norm", "lm_head")
    ps = gather_rows(params, lambda t: {k: t[k] for k in keys}, rows,
                     cfg.quant_mode)
    parts = []
    for d in range(rows):
        devs = params.row_devices(d)
        if not layout.vocab:
            parts.append(per_device(devs, lambda i: _logits(
                ps[d][i], cfg, xs[d][i])))
            continue
        hs = per_device(devs, lambda i: rms_norm(
            ps[d][i]["final_norm"], xs[d][i], cfg.norm_eps))
        parts.append([embed_logits(p["embed"], h) if cfg.tie_embeddings
                      else bf16_matmul(h, p["lm_head"]["w"].to(h.dtype))
                      .to(torch.float32) for p, h in zip(ps[d], hs)])
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=params.devices[0])
    return parts, aux


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens, *, extra_embeds=None,
            frames=None, max_len: int | None = None, logits_index=None,
            ctx_caches=None, ctx_table=None, ctx_start=None):
    """Run the prompt; returns (logits (B, 1, V), caches, enc_out).
    ``extra_embeds`` (a VLM's patches) are prepended to the prompt, and
    positions and ``logits_index`` count them; ``frames`` run through the
    encoder, whose output ``enc_out`` (None without frames) the decode
    steps take.  ``logits_index`` (scalar or (B,)) picks the position
    whose logits are returned (default: the last), so a prompt
    zero-padded to a fixed slot budget returns its real last token's
    logits.  With ``max_len`` the caches are zero-grown to that length.

    Context prefill: with ``ctx_caches`` (the page pools), ``ctx_table``
    (the slot's (1, max_pages) table row) and ``ctx_start`` (an int or a
    0-d tensor), ``tokens`` is the uncached suffix of a prompt whose first
    ``ctx_start`` rows sit in the pools.  Queries run at ``ctx_start + [0,
    S)`` against the cached rows spliced below the fresh ones; the
    returned caches hold the suffix rows only.  ``ctx_start == 0`` gives
    the plain prefill's values through ``attention_core``.  A mamba
    layer's state is the prompt's whole: end padding would run through it,
    so its prompts come unpadded (the engine prefills them at their exact
    length)."""
    sharded = isinstance(params, Shards)
    b = tokens.shape[0]
    if sharded:
        rows = slot_rows(b, params.dp)
        enc_outs = None if frames is None else _tp_encode(params, cfg,
                                                          frames, rows)
        xs = _tp_embed(params, cfg, tokens, rows)
        if extra_embeds is not None:
            for d, pre in enumerate(_row_split(extra_embeds, rows)):
                pre = broadcast(pre, params.row_devices(d))
                xs[d] = per_device(params.row_devices(d), lambda i: torch.cat(
                    [pre[i].to(xs[d][i].dtype), xs[d][i]], dim=1))
        dev = params.devices[0]
        enc_out = None if enc_outs is None else (
            enc_outs[0][0] if rows == 1
            else torch.cat([e[0].to(dev) for e in enc_outs]))
    else:
        enc_out = encode(params, cfg, frames) if frames is not None \
            else None
        xs = [[_embed_inputs(params, cfg, tokens, extra_embeds)]]
        dev = xs[0][0].device
    s = xs[0][0].shape[1]
    pos = torch.arange(s, device=dev)[None, :]
    if ctx_start is not None:
        pos = pos + torch.as_tensor(ctx_start, device=dev)
    pos = torch.broadcast_to(pos, (b, s))
    if sharded:
        loc = _row_locals(params, rows, positions=pos, cache_index=None,
                          page_table=ctx_table, context_start=ctx_start)
        xs, caches, _ = _tp_stack_apply(
            _layers_at_use(params, cfg, rows, lambda t: t["layers"]), cfg,
            params.layout, xs, loc=loc,
            caches=None if ctx_caches is None
            else [ctx_caches.row(d) for d in range(rows)],
            mode="prefill", enc_outs=enc_outs)
        caches = Shards([t for row in caches for t in row],
                        params.devices[:len(xs) * params.tp], params.layout,
                        dp=rows)
    else:
        x, caches, _ = _stack_apply(params, cfg, xs[0][0], positions=pos,
                                    enc_out=enc_out, mode="prefill",
                                    caches=ctx_caches, page_table=ctx_table,
                                    context_start=ctx_start)
        xs = [[x]]
    if logits_index is None:
        x_last = [[x[:, -1:] for x in row] for row in xs]
    else:
        idx = torch.broadcast_to(
            torch.as_tensor(logits_index, device=dev).reshape(-1).long(),
            (b,))
        x_last = []
        for row, ix in zip(xs, _row_split(idx, len(xs))):
            ixs = broadcast(ix, [x.device for x in row])
            x_last.append([x[torch.arange(x.shape[0], device=x.device), i]
                           [:, None] for x, i in zip(row, ixs)])
    if sharded:
        logits = _logits_rows(params, cfg, x_last)
    else:
        logits = _logits(params, cfg, x_last[0][0])
    if max_len is not None and max_len > s:
        # the sequence axis is 1 in every sequence leaf; the recurrent
        # state has none
        grown = [[{k: torch.nn.functional.pad(
            v, (0, 0) * (v.ndim - 2) + (0, max_len - s))
            if k in _SEQ_CACHE_KEYS else v
            for k, v in c.items()} for c in tree]
            for tree in (caches if sharded else [caches])]
        caches = (dataclasses.replace(caches, trees=grown) if sharded
                  else grown[0])
    return logits, caches, enc_out


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token, caches, index, *,
                enc_out=None, page_table=None):
    """One decode step.  token: (B, S) int (classically S == 1); ``index``
    is the cache position of ``token[:, 0]``, a scalar or (B,) per-slot
    vector.  With ``page_table`` (B, max_pages) the caches are page pools.
    With ``enc_out`` (from :func:`prefill`) every decoder layer
    cross-attends it.  Caches are updated in place (a mamba layer's state
    included; it takes S == 1 only).  Returns (logits (B, S, V),
    caches)."""
    if isinstance(params, Shards):
        b, s = token.shape
        rows = slot_rows(b, caches.dp)
        xs = _tp_embed(params, cfg, token, rows)
        dev = params.devices[0]
        index = torch.as_tensor(index, device=dev).to(torch.int64)
        pos = (torch.broadcast_to(index.reshape(-1, 1), (b, 1))
               + torch.arange(s, device=dev)[None, :])
        loc = _row_locals(params, rows, positions=pos, cache_index=index,
                          page_table=page_table, context_start=None)
        enc_outs = None if enc_out is None else [
            broadcast(e, params.row_devices(d))
            for d, e in enumerate(_row_split(enc_out, rows))]
        xs, _, _ = _tp_stack_apply(
            _layers_at_use(params, cfg, rows, lambda t: t["layers"]), cfg,
            params.layout, xs, loc=loc,
            caches=[caches.row(d) for d in range(rows)], mode="decode",
            enc_outs=enc_outs)
        return _logits_rows(params, cfg, xs), caches
    x = _embed_inputs(params, cfg, token)
    b, s = x.shape[0], token.shape[1]
    index = torch.as_tensor(index, device=x.device).to(torch.int64)
    pos = (torch.broadcast_to(index.reshape(-1, 1), (b, 1))
           + torch.arange(s, device=x.device)[None, :])
    x, caches, _ = _stack_apply(params, cfg, x, positions=pos,
                                caches=caches, cache_index=index,
                                enc_out=enc_out, mode="decode",
                                page_table=page_table)
    return _logits(params, cfg, x), caches


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

# Cache leaves with a sequence axis (axis 1: slab rows or pool pages); every
# other leaf (mamba's conv and ssm state) is per-slot.  The reference's set,
# int8 scales included.
_SEQ_CACHE_KEYS = SEQ_CACHE_KEYS


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                device="cuda") -> list:
    """Per-layer decode caches: dense slabs, or page pools when
    ``cfg.cache_mode == "paged"`` (auto pool: capacity parity with the
    dense slab plus the trash page).  A mamba layer's state is per-slot
    in both modes."""
    device = resolve_device(device)
    return [_layer_cache(cfg, spec, batch, max_len, device)
            for spec in cfg.layer_specs]


def _layer_cache(cfg: ModelConfig, spec, batch: int, max_len: int,
                 device) -> dict:
    """One layer's cache as :func:`init_caches` builds it."""
    if cfg.cache_mode == "paged":
        ps = cfg.page_size
        if ps < 1:
            raise ValueError(f"page_size must be >= 1, got {ps}")
        if max_len % ps:
            raise ValueError(f"max_len {max_len} must be a multiple of "
                             f"page_size {ps}")
        num_pages = cfg.num_pages or batch * (max_len // ps) + 1
        return _paged_layer_cache(cfg, spec, batch, num_pages, ps, device)
    if spec.mixer == "mamba":
        return init_mamba_cache(cfg, batch, device)
    return (init_mla_cache if spec.attn_kind == "mla"
            else init_kv_cache)(cfg, batch, max_len, device)


def _paged_layer_cache(cfg, spec, batch, num_pages, page_size, device):
    if spec.mixer == "mamba":
        return init_mamba_cache(cfg, batch, device)
    return (init_paged_mla_cache if spec.attn_kind == "mla"
            else init_paged_kv_cache)(cfg, num_pages, page_size, device)


def init_paged_caches(cfg: ModelConfig, batch: int, num_pages: int,
                      page_size: int, *, device="cuda") -> list:
    """One set of shared pools per attention layer: ``(num_pages,
    page_size, KVH, hd)`` K and V, or MLA's ``(num_pages, page_size,
    kv_lora_rank)`` latents and ``(num_pages, page_size, qk_rope_dim)``
    rope keys; a mamba layer keeps its per-slot state beside them."""
    device = resolve_device(device)
    return [_paged_layer_cache(cfg, spec, batch, num_pages, page_size,
                               device) for spec in cfg.layer_specs]


def init_shard_caches(cfg: ModelConfig, batch: int, max_len: int,
                      params: Shards) -> Shards:
    """:func:`init_caches` for the mesh entries of ``params``: a GQA
    layer's pools hold each shard's share of the kv heads on its device,
    a mamba layer's state each shard's conv channels and SSD heads; where
    the heads do not divide the shards, and for MLA's latent pools (no
    head axis), the whole pools or state, one set per distinct device of
    a row (shared by the shards on it).  Over a data axis the slots split
    by row (``slot_rows``): each row's dense slabs and mamba state hold
    its ``batch / dp`` slots, and the paged pools are whole on every row,
    one copy per distinct device (shared by the rows on it)."""
    layout = params.layout
    scfg = layout.shard_cfg(cfg)
    paged = cfg.cache_mode == "paged"
    rows = slot_rows(batch, params.dp)
    per = batch // rows
    shared: dict = {}
    trees = []
    for d in range(rows):
        devs = params.row_devices(d)
        row = [[] for _ in devs]
        for li, spec in enumerate(cfg.layer_specs):
            pools = paged and spec.mixer != "mamba"
            n = batch if pools else per

            def make(i, c, key):
                # pools are shared by every row on a device, per-slot
                # leaves only within their row
                key = (li, key, str(devs[i])) if pools \
                    else (d, li, key, str(devs[i]))
                if key not in shared:
                    shared[key] = _layer_cache(c, spec, n, max_len, devs[i]) \
                        if c is not None else init_mamba_cache(
                            cfg, n, devs[i], ssm_dims(
                                cfg, ssm_segments(cfg, layout, i)))
                return shared[key]

            if layout.ssm_heads and spec.mixer == "mamba":
                cs = [make(i, None, i) for i in range(len(devs))]
            elif layout.heads and spec.mixer == "attn" \
                    and spec.attn_kind != "mla":
                cs = [make(i, scfg, i) for i in range(len(devs))]
            else:
                cs = [make(i, cfg, "whole") for i in range(len(devs))]
            for tree, c in zip(row, cs):
                tree.append(c)
        trees += row
    return Shards(trees, params.devices[:rows * params.tp], layout, dp=rows)


@torch.no_grad()
def decode_gather_bytes(params, cfg: ModelConfig, batch: int) -> int:
    """Weight bytes the FSDP gather writes in one decode step of ``batch``
    slots (0 without a data axis): one eager step over scratch caches
    (pools of two pages, or a one-row slab), counted by
    ``collectives.gathered_bytes``; the kernel launch counters are left
    as they were."""
    if not isinstance(params, Shards) or params.fsdp is None:
        return 0
    paged = cfg.cache_mode == "paged"
    c = cfg.replace(num_pages=2) if paged else cfg
    length = cfg.page_size if paged else 1
    caches = init_shard_caches(c, batch, length, params)
    dev = params.devices[0]
    zeros = torch.zeros((batch, 1), dtype=torch.int64, device=dev)
    before, launched = gathered_bytes(), launch_counts()
    decode_step(params, c, zeros, caches, zeros[:, 0],
                page_table=zeros if paged else None)
    # the scratch step's launches are no stage's
    add_launch_counts([b - a for a, b in zip(launch_counts(), launched)])
    return gathered_bytes() - before


def _unique(leaves):
    seen = set()
    for leaf in leaves:
        if id(leaf) not in seen:
            seen.add(id(leaf))
            yield leaf


def sequence_pools(caches) -> list:
    """Every sequence leaf of every layer (a slab or a page pool),
    layer-major, in key order; mamba's recurrent state has no sequence
    axis and is left out.  Over ``Shards``: every shard's, each tensor
    once.  The page helpers take these leaves only."""
    trees = caches if isinstance(caches, Shards) else [caches]
    return list(_unique(pool for tree in trees for c in tree
                        for k, pool in c.items() if k in _SEQ_CACHE_KEYS))


def _logical_pools(caches, d: int = 0):
    """Per sequence leaf of the unsharded layout, layer-major in key
    order, as data row ``d`` holds it: ``(pools, split)``: one pool per
    shard, split along the head axis (``split``: a GQA pool under
    head-split attention), or the replicated pool's copies, one per
    distinct device (an MLA latent pool, or heads that do not divide;
    unsharded caches: the pool alone)."""
    if not isinstance(caches, Shards):
        return [([pool], False) for pool in sequence_pools(caches)]
    heads = caches.layout.heads
    per = [[(k, pool) for c in tree for k, pool in c.items()
            if k in _SEQ_CACHE_KEYS] for tree in caches.row(d)]
    out = []
    for leaves in zip(*per):
        pools = [pool for _, pool in leaves]
        split = heads and leaves[0][0] not in MLA_CACHE_KEYS
        out.append((pools if split else list(_unique(pools)), split))
    return out


def cache_bytes(caches) -> int:
    """Bytes of every sequence leaf in the unsharded layout (what one
    device holds at ``tp=1``): shards' head slices summed, a replicated
    pool once, the pools whole on every data row counted once."""
    return sum(sum(p.numel() * p.element_size()
                   for p in (pools if split else pools[:1]))
               for pools, split in _logical_pools(caches))


def _leaves(big, one):
    """``(key, big leaf, one leaf, row)`` for every cache leaf,
    layer-major; over ``Shards`` every entry's, each big leaf once, with
    its data row, paired with the batch-1 cache's tree of the same model
    shard (a batch-1 prefill runs on one data row)."""
    if isinstance(big, Shards):
        tp = big.tp
        pairs = [(t, one.trees[e % tp], e // tp)
                 for e, t in enumerate(big.trees)]
    else:
        pairs = [(big, one, 0)]
    seen = set()
    for b_tree, s_tree, d in pairs:
        for b_c, s_c in zip(b_tree, s_tree):
            for key in b_c:
                if id(b_c[key]) not in seen:
                    seen.add(id(b_c[key]))
                    yield key, b_c[key], s_c[key], d


def _put_slot(b_leaf, s_leaf, slot: int, d: int) -> None:
    """Slot ``slot``'s row of a per-slot leaf held by data row ``d`` (its
    ``b_leaf.shape[0]`` slots from ``d * shape[0]``): written where the
    row holds the slot."""
    local = slot - d * b_leaf.shape[0]
    if 0 <= local < b_leaf.shape[0]:
        b_leaf[local] = s_leaf[0].to(b_leaf.dtype)


def merge_slot_caches(big: list, one: list, slot: int) -> list:
    """Copy a batch-1 cache (same max_len) into slot ``slot``, in place
    (over a data axis into the row that holds the slot)."""
    for _, b_leaf, s_leaf, d in _leaves(big, one):
        _put_slot(b_leaf, s_leaf, slot, d)
    return big


def merge_slot_paged_caches(big: list, one: list, slot: int, pages) -> list:
    """Copy a prefilled batch-1 cache into the pools, in place: its
    sequence leaves (length a whole number of pages) at page ids
    ``pages[:n]``, its recurrent state (mamba's conv and ssm) at batch
    slot ``slot`` as in the dense path.  Entries past the request's pages
    point at the trash page, so pad rows land there.  Over a data axis
    every copy of the pools is written, the state only in the slot's
    row."""
    for key, b_leaf, s_leaf, d in _leaves(big, one):
        if key not in _SEQ_CACHE_KEYS:
            _put_slot(b_leaf, s_leaf, slot, d)
            continue
        ps, s = b_leaf.shape[1], s_leaf.shape[1]
        if s % ps:
            raise ValueError(f"prefill cache length {s} is not a whole "
                             f"number of pages (page_size {ps})")
        n_p = s // ps
        idx = torch.as_tensor(pages, device=b_leaf.device).long()[:n_p]
        rows = s_leaf[0].reshape(n_p, ps, *s_leaf.shape[2:])
        b_leaf[idx] = rows.to(b_leaf.dtype)
    return big


def scatter_prefill_paged_caches(big: list, one: list, slot: int, row,
                                 start) -> list:
    """Row-granular dual of :func:`merge_slot_paged_caches` for the prefix
    cache: write a context-prefilled suffix cache (rows for positions
    ``start + [0, S)``) through one slot's table ``row`` into the pools,
    in place.  Shared prefix pages below ``start`` are never touched."""
    del slot                      # pools are shared; the row routes the slot
    row = torch.as_tensor(row)
    for key, b_leaf, s_leaf, _ in _leaves(big, one):
        if key in _SEQ_CACHE_KEYS:
            scatter_prefill_rows(b_leaf, s_leaf, row.to(b_leaf.device),
                                 start)
    return big


def copy_paged_cache_page(caches: list, src, dst) -> list:
    """Copy pool page ``src`` onto ``dst`` in every pool, in place (the
    copy-on-write primitive: a shared tail page is duplicated into the
    slot's private page before its first write).  ``src`` and ``dst`` may
    be 0-d tensors, so the copy is data, not shape, or (G,) vectors of
    pairs (a wave's lanes; every source is read before any write); the
    no-COW default ``0, 0`` rewrites the trash page with itself."""
    pools = sequence_pools(caches)
    src = torch.as_tensor(src, device=pools[0].device).reshape(-1).long()
    dst = torch.as_tensor(dst, device=pools[0].device).reshape(-1).long()
    for pool in pools:
        pool.index_copy_(0, dst.to(pool.device),
                         pool.index_select(0, src.to(pool.device)))
    return caches


def _pad_pages(pages, pad_to):
    """Page ids padded with the trash page (0) to ``pad_to`` entries, so
    every host-tier copy has one shape."""
    pages = list(pages)
    return pages + [0] * max(0, (pad_to or 0) - len(pages))


def extract_cache_pages(caches: list, pages, pad_to: int | None = None
                        ) -> list:
    """Copy pool pages ``pages`` of every layer's pools to host memory in
    one transfer: one payload per page, a flat CPU tensor holding the
    page's rows of every pool, layer-major in key order (GQA: K then V,
    and under the int8 KV cache their scales; MLA: latents then rope
    keys), each pool's bytes as they are.  Where every pool has one dtype
    the payload is in that dtype; where they differ (int8 K/V beside f32
    scales) it is the raw bytes, ``uint8``, so no pool is widened.  With
    :func:`insert_cache_pages` a page round-trips bit for bit (swap-out
    and prefix demotion).  ``pad_to`` pads the gather with the trash page,
    so every call has one shape; the padded rows are dropped."""
    pages = list(pages)
    logical = _logical_pools(caches)
    dev = logical[0][0][0].device
    idx = torch.as_tensor(_pad_pages(pages, pad_to), device=dev)
    parts = []
    for pools, split in logical:
        got = [pool[idx.to(pool.device)].to(dev)
               for pool in (pools if split else pools[:1])]
        # a page of a head-split pool: the shards' heads side by side
        page = torch.cat(got, dim=2)
        parts.append(page.reshape(len(idx), -1).view(torch.uint8))
    rows = torch.cat(parts, dim=1).cpu()
    dtypes = {pools[0].dtype for pools, _ in logical}
    if len(dtypes) == 1:
        rows = rows.view(dtypes.pop())
    return [rows[j].clone() for j in range(len(pages))]


def insert_cache_pages(caches: list, pages, payloads, pad_to: int | None = None
                       ) -> list:
    """Write host payloads (from :func:`extract_cache_pages`) into pool
    pages ``pages``, in place, in one transfer (swap-in and prefix
    promotion): each payload's bytes are split back into the pools' rows
    in their own dtypes.  ``pad_to`` pads with zero rows written onto the
    trash page, which no query attends.  Over a data axis every copy of
    the pools is written."""
    pages = list(pages)
    if len(pages) != len(payloads):
        raise ValueError(f"{len(pages)} pages but {len(payloads)} payloads")
    padded = _pad_pages(pages, pad_to)
    logical = _logical_pools(caches)
    dev = logical[0][0][0].device
    rows = torch.stack(list(payloads)).view(torch.uint8)
    if len(padded) > len(pages):
        rows = torch.cat([rows, rows.new_zeros(
            (len(padded) - len(pages), rows.shape[1]))])
    rows = rows.to(dev)
    idx = torch.as_tensor(padded, device=dev)
    width = [sum(p[0].numel() * p.element_size()
                 for p in (pools if split else pools[:1]))
             for pools, split in logical]
    n_rows = caches.dp if isinstance(caches, Shards) else 1
    per_row = [logical] + [_logical_pools(caches, d)
                           for d in range(1, n_rows)]
    written = set()
    for li, part in enumerate(torch.split(rows, width, dim=1)):
        pools, split = logical[li]
        shape = list(pools[0].shape[1:])
        if split:
            shape[1] *= len(pools)
        page = part.contiguous().view(pools[0].dtype).reshape(
            len(padded), *shape)
        for row in per_row:
            copies = row[li][0]
            heads = (torch.chunk(page, len(copies), dim=2) if split
                     else [page] * len(copies))
            for pool, rows_s in zip(copies, heads):
                if id(pool) not in written:
                    written.add(id(pool))
                    pool[idx.to(pool.device)] = rows_s.to(pool.device)
    return caches
