"""Partition rules and model-axis shards (port of
``repro.distributed.sharding``).

The rule functions are the reference's, as plain functions over this
package's trees: a spec is a tuple with one entry per dimension, each
``None``, an axis name or a tuple of axis names (``PartitionSpec``'s
layout).  The port's layers are unrolled, so no path holds ``blocks`` and
no spec carries the reference's leading block axis.  Conventions on a
``(data, model)`` mesh:

* **FSDP axes** = ("pod", "data") on a multi-pod mesh, else ("data",).
* **TP axis** = "model": megatron column/row pairs (``_COL_PARENTS``,
  ``_ROW_PARENTS``), MoE experts and the vocab dimension.
* **Caches**: KV heads on "model" when they divide it, else the sequence
  axis (in-page for paged pools); batch on the FSDP axes.

The port's prepared int8 leaves follow their weight: ``qt8`` / ``qt4``
(N-major, ``(out, in)``) take the weight's spec reversed, and the
per-channel scales ``s8`` / ``s4`` ``(1, out)`` take its out axis where
that is the model axis and are never FSDP-split, so a row-parallel
weight keeps its scales whole (each is the amax over the whole K
column).

:func:`shard_params` and :func:`shard_caches` apply the specs' "model"
axis: one tree per model shard on that shard's device (:class:`Shards`).
Where the heads do not divide the axis, the port runs each attention
block replicated on every shard, weights and pools whole, where the
reference splits the pools' in-page sequence axis; MLA's latent pools
have no head axis and are always whole, one per distinct device (the
reference splits their in-page axis too).  A mamba mixer splits by SSD
head: its fused ``in_proj`` columns and conv channels per segment
(``ssm_segments``), which the reference's contiguous channel rule does
not express, so the splitter cuts them, not the specs.  Replication is
always valid (``_fit_spec``), and the two differ only in memory.
Expert stacks split by expert (``experts % tp == 0``) or stay whole, as
the reference's engine falls back to its local MoE path.

A data axis above 1 (``dp`` rows): entry ``(d, m)`` stores piece ``d``
of model shard ``m``'s leaf along the leaf's FSDP dimension (where the
spec names the data axis and ``_fit_spec`` keeps it; every other leaf
whole, one tensor per distinct device), and :func:`gather_rows`
rebuilds shard ``m``'s tensors in data order on each device that uses
them, at use, one layer at a time.  The caches split by slot: slot ``b``
lives on data row ``b // (B / dp)`` when ``dp`` divides the batch ``B``
(its dense slab rows and mamba state), else the batch is not split and
data row 0 holds every slot (``slot_rows``; under the reference's mesh
semantics, ``semantics="mesh"``, every row holds every slot instead);
paged pools are whole on each row, one copy per distinct device.

:func:`train_shards` is :func:`shard_params` for the training step:
every entry's leaves its own tensors, marked to need grads; ``split``
and ``fsdp`` say which entries hold copies of one piece
(:func:`piece_groups`), whose gradients the step sums.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import data_gather, \
    entries_distinct

__all__ = ["TP_AXIS", "fsdp_axes", "param_specs", "opt_state_specs",
           "batch_specs", "cache_specs", "page_table_spec", "TPLayout",
           "tp_layout", "check_tp_supported", "Shards", "shard_params",
           "shard_caches", "split_dim", "data_dim", "slot_rows",
           "row_slots", "SEMANTICS", "check_semantics",
           "gather_rows", "stored_bytes", "MLA_CACHE_KEYS", "SSM_CACHE_KEYS",
           "SEQ_CACHE_KEYS", "SSMSegments", "ssm_segments", "train_shards",
           "piece_groups"]

TP_AXIS = "model"

# where ROADMAP.md places what a mesh inside one engine does not do yet
TP_ROADMAP = ("ROADMAP queue 1 item 4d (capture across cards, a speed item "
              "that waits for a 4-chip cell; item 4e, a multi-process "
              "backend, left the port queue: the reference has none)")


def fsdp_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

# parent-key of a linear's ``w`` -> spec builder.  COL = (fsdp, tp);
# ROW = (tp, fsdp)
_COL_PARENTS = {"wq", "wk", "wv", "gate", "up", "wq_b", "wkv_b", "in_proj",
                "lm_head"}
_ROW_PARENTS = {"wo", "down", "out_proj"}
_PLAIN_PARENTS = {"wq_a", "wkv_a"}       # low-rank downs: FSDP only
_QUANT_VALUES = ("qt8", "qt4")           # the port's prepared int8 weights
_QUANT_SCALES = ("s8", "s4")             # and their per-channel scales


def _w_rule(parent: str, fsdp: tuple) -> tuple:
    if parent in _COL_PARENTS:
        return (fsdp, TP_AXIS)
    if parent in _ROW_PARENTS:
        return (TP_AXIS, fsdp)
    return (fsdp, None)                  # low-rank downs, unknown linears


def _param_rule(path: tuple, leaf, fsdp: tuple) -> tuple:
    keys = list(path)
    leafk = keys[-1]
    parent = keys[-2] if len(keys) >= 2 else ""
    stacked = "blocks" in keys           # the reference's layout only

    def wrap(*spec):
        return ((None,) + spec) if stacked else spec

    if leafk == "emb":
        # (V, D): vocab on TP, D replicated (sharding D on the data axes
        # makes the embedding-grad contraction doubly data-sharded)
        return wrap(TP_AXIS, None)
    if leafk == "w":
        return wrap(*_w_rule(parent, fsdp))
    if leafk in _QUANT_VALUES:           # (out, in): the weight transposed
        return wrap(*reversed(_w_rule(parent, fsdp)))
    if leafk in _QUANT_SCALES:           # (1, out): the weight's out axis
        out_axis = _w_rule(parent, fsdp)[1]  # on "model" only: never FSDP
        return wrap(None, out_axis if out_axis == TP_AXIS else None)
    if leafk in ("w_gate", "w_up"):      # (E, D, F): EP x FSDP storage
        return wrap(TP_AXIS, fsdp, None)
    if leafk == "w_down":                # (E, F, D)
        return wrap(TP_AXIS, None, fsdp)
    if leafk == "router":                # small, replicate
        return wrap(None, None)
    if leafk == "conv_w":                # (W, C): channels on TP
        return wrap(None, TP_AXIS)
    if leafk == "conv_b":
        return wrap(TP_AXIS)
    # norms, A_log, D, dt_bias, scalars: replicated
    return wrap(*([None] * (leaf.ndim - (1 if stacked else 0))))


def _fit_spec(spec: tuple, shape, mesh) -> tuple:
    """Drop sharded axes that do not divide the dimension they shard
    (odd vocab sizes, batch-1 cells, tiny head counts); replication is
    always valid."""
    out = []
    for i, dim in enumerate(shape):
        axes = spec[i] if i < len(spec) else None
        if axes is None:
            out.append(None)
            continue
        size = 1
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            size *= mesh.shape[a]
        out.append(axes if dim % size == 0 else None)
    return tuple(out)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over dict / list nodes; a tuple is a leaf (a
    spec), as in a spec tree."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def param_specs(params: Any, mesh) -> Any:
    fsdp = fsdp_axes(mesh)
    return _map_with_path(
        lambda path, leaf: _fit_spec(_param_rule(path, leaf, fsdp),
                                     leaf.shape, mesh), params)


def opt_state_specs(opt_state: Any, params_spec: Any) -> Any:
    """Moments mirror the parameter specs; int8-moment scales are
    replicated."""
    def moment(pspec, node):
        if isinstance(node, dict) and "q" in node:
            return {"q": pspec, "scale": ()}
        if isinstance(node, dict):
            return {k: moment(pspec[k], v) for k, v in node.items()}
        if isinstance(node, list):
            return [moment(s, v) for s, v in zip(pspec, node)]
        return pspec

    return {"step": (), "mu": moment(params_spec, opt_state["mu"]),
            "nu": moment(params_spec, opt_state["nu"])}


# ---------------------------------------------------------------------------
# Batch / cache rules
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, mesh) -> dict:
    dp = fsdp_axes(mesh)                 # batch over pod + data
    spec = {"tokens": (dp, None), "labels": (dp, None)}
    if cfg.family == "vlm":
        spec["patch_embeds"] = (dp, None, None)
    if cfg.is_encdec:
        spec["frames"] = (dp, None, None)
    return spec


def _kv_spec(cfg: ModelConfig, mesh, batch: int, stacked: bool,
             seq_to_dp: bool) -> tuple:
    """(B, S, KVH, D) spec."""
    tp_size = mesh.shape[TP_AXIS]
    dp = fsdp_axes(mesh)
    if seq_to_dp:                        # batch-1 long-context cells
        head_ax = TP_AXIS if cfg.n_kv_heads % tp_size == 0 else None
        spec = (None, dp, head_ax, None)
    elif cfg.n_kv_heads % tp_size == 0:
        spec = (dp, None, TP_AXIS, None)
    else:                                # few KV heads: sequence on TP
        spec = (dp, TP_AXIS, None, None)
    return ((None,) + spec) if stacked else spec


def _mla_spec(mesh, stacked: bool, seq_to_dp: bool) -> tuple:
    dp = fsdp_axes(mesh)
    spec = (None, dp, None) if seq_to_dp else (dp, None, None)
    return ((None,) + spec) if stacked else spec


def _paged_kv_spec(cfg: ModelConfig, mesh, stacked: bool) -> tuple:
    """(num_pages, page_size, KVH, D-or-1) pool spec: KV heads on the TP
    axis when they divide it, else the in-page sequence axis; the page-id
    axis is never sharded (page ids are data)."""
    if cfg.n_kv_heads % mesh.shape[TP_AXIS] == 0:
        spec = (None, None, TP_AXIS, None)
    else:
        spec = (None, TP_AXIS, None, None)
    return ((None,) + spec) if stacked else spec


def _paged_mla_spec(stacked: bool) -> tuple:
    """(num_pages, page_size, rank) latent pool: no head axis, so the
    in-page sequence axis is the only shardable one."""
    spec = (None, TP_AXIS, None)
    return ((None,) + spec) if stacked else spec


def page_table_spec(mesh) -> tuple:
    """The (batch, max_pages) page table stays host-authored and fully
    replicated: every shard walks the same logical table."""
    del mesh
    return (None, None)


def _mamba_cache_spec(mesh, leafk: str, stacked: bool) -> tuple:
    dp = fsdp_axes(mesh)
    if leafk == "conv":                  # (B, W-1, C)
        spec = (dp, None, TP_AXIS)
    else:                                # ssm state (B, H, N, P)
        spec = (dp, TP_AXIS, None, None)
    return ((None,) + spec) if stacked else spec


def cache_specs(cfg: ModelConfig, caches: Any, mesh, *, batch: int) -> Any:
    seq_to_dp = batch == 1
    paged = cfg.cache_mode == "paged"

    def rule(path, leaf):
        stacked = "blocks" in path
        leafk = path[-1]
        if leafk in ("k", "v", "k_scale", "v_scale"):
            spec = (_paged_kv_spec(cfg, mesh, stacked) if paged
                    else _kv_spec(cfg, mesh, batch, stacked, seq_to_dp))
        elif leafk in ("c_kv", "k_rope"):
            spec = (_paged_mla_spec(stacked) if paged
                    else _mla_spec(mesh, stacked, seq_to_dp))
        elif leafk in ("conv", "ssm"):
            spec = _mamba_cache_spec(mesh, leafk, stacked)
        else:
            spec = (None,) * leaf.ndim
        return _fit_spec(spec, leaf.shape, mesh)

    return _map_with_path(rule, caches)


def _axis_dim(spec: tuple, axis: str) -> int | None:
    for i, axes in enumerate(spec):
        if axes == axis or (isinstance(axes, tuple) and axis in axes):
            return i
    return None


def split_dim(spec: tuple) -> int | None:
    """The dimension a spec shards over the "model" axis, or None."""
    return _axis_dim(spec, TP_AXIS)


def data_dim(spec: tuple) -> int | None:
    """The dimension a spec shards over the "data" axis (FSDP), or
    None."""
    return _axis_dim(spec, "data")


# the serving steps' routes over a data axis: the reference's engine's
# (it installs no mesh) and its dry run's (under ``ambient_mesh``)
SEMANTICS = ("engine", "mesh")


def check_semantics(semantics: str) -> None:
    if semantics not in SEMANTICS:
        raise ValueError(f"semantics {semantics!r}: one of {SEMANTICS}")


def slot_rows(batch: int, dp: int, semantics: str = "engine") -> int:
    """The data rows a batch of ``batch`` slots runs on: ``dp`` where it
    divides the batch; else under the engine's semantics 1 (``_fit_spec``
    drops the split and data row 0 runs every slot), under the mesh
    semantics ``dp``, each row holding the whole batch (the reference's
    ``P(None, ...)`` batch specs replicate it)."""
    check_semantics(semantics)
    return dp if batch % dp == 0 or semantics == "mesh" else 1


def row_slots(batch: int, rows: int) -> int:
    """The slots each of ``rows`` data rows holds: its share where the
    rows divide the batch, else the whole batch (replicated)."""
    return batch // rows if batch % rows == 0 else batch


# ---------------------------------------------------------------------------
# Model-axis shards
# ---------------------------------------------------------------------------

def check_tp_supported(cfg: ModelConfig, tp: int, dp: int = 1) -> None:
    """A ``(dp, tp)`` mesh inside one engine covers every mixer (GQA,
    MLA, the encoder's and the cross-attention, the mamba mixer) with MLP
    or MoE blocks, a VLM's patches and every quant mode, at any data
    size; only the sizes are checked."""
    del cfg
    if tp < 1 or dp < 1:
        raise ValueError(f"a mesh needs dp >= 1 and tp >= 1, got ({dp}, "
                         f"{tp})")


@dataclasses.dataclass(frozen=True)
class TPLayout:
    """How a model splits over ``tp`` model shards, as ``_fit_spec``
    decides for their weights: GQA attention blocks by kv heads
    (``heads``), MLA blocks by query heads (``mla_heads``: MLA has no kv
    heads of its own), mamba mixers by SSD head (``ssm_heads``; their B
    and C by group where the groups divide, ``ssm_groups``, else whole on
    every shard), MLPs by ``d_ff``, MoE expert stacks by expert
    (``experts``) and the shared expert by its ``d_ff`` (``shared``), the
    embedding and head by vocab; each whole and run replicated on every
    shard where it does not divide."""
    tp: int
    heads: bool
    ffn: bool
    vocab: bool
    mla_heads: bool = False
    experts: bool = False
    shared: bool = False
    ssm_heads: bool = False
    ssm_groups: bool = False

    def shard_cfg(self, cfg: ModelConfig) -> ModelConfig:
        """The config one shard's GQA attention runs: its share of the
        query and kv heads, or the whole model where heads are
        replicated."""
        if not self.heads:
            return cfg
        return cfg.replace(n_heads=cfg.n_heads // self.tp,
                           n_kv_heads=cfg.n_kv_heads // self.tp)

    def mla_cfg(self, cfg: ModelConfig) -> ModelConfig:
        """The config one shard's MLA heads run: its share of the query
        heads, or the whole model where they are replicated."""
        if not self.mla_heads:
            return cfg
        return cfg.replace(n_heads=cfg.n_heads // self.tp)


def tp_layout(cfg: ModelConfig, tp: int) -> TPLayout:
    shared_ff = cfg.d_ff_expert * cfg.n_shared_experts
    ssm = any(s.mixer == "mamba" for s in cfg.layer_specs) \
        and cfg.ssm_heads % tp == 0
    return TPLayout(tp=tp, heads=cfg.n_kv_heads % tp == 0,
                    ffn=cfg.d_ff % tp == 0, vocab=cfg.vocab_size % tp == 0,
                    mla_heads=cfg.n_heads % tp == 0 and any(
                        s.attn_kind == "mla" for s in cfg.layer_specs),
                    experts=cfg.n_experts > 0 and cfg.n_experts % tp == 0,
                    shared=shared_ff > 0 and shared_ff % tp == 0,
                    ssm_heads=ssm, ssm_groups=ssm and cfg.ssm_groups % tp == 0)


@dataclasses.dataclass(frozen=True)
class SSMSegments:
    """Shard ``s``'s pieces of a mamba mixer split by SSD head: its heads
    ``[head_lo, head_lo + heads)`` and its B/C groups ``[group_lo,
    group_lo + groups)`` (all of them where the groups do not divide);
    ``proj`` the ``(start, length)`` column ranges of ``in_proj``'s fused
    ``[z | x | B | C | dt]`` output it takes, in that order, and ``conv``
    those of the conv channels ``[x | B | C]``."""
    head_lo: int
    heads: int
    group_lo: int
    groups: int
    proj: tuple
    conv: tuple


def ssm_segments(cfg: ModelConfig, layout: TPLayout, s: int) -> SSMSegments:
    """Shard ``s``'s pieces of a mamba mixer under ``layout``."""
    tp = layout.tp
    d_in, n, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    di, hs = d_in // tp, cfg.ssm_heads // tp
    gs = g // tp if layout.ssm_groups else g
    g0 = s * gs if layout.ssm_groups else 0
    conv = ((s * di, di),                            # x
            (d_in + g0 * n, gs * n),                 # B
            (d_in + (g + g0) * n, gs * n))           # C
    proj = (((s * di, di),)                          # z
            + tuple((d_in + a, ln) for a, ln in conv)
            + ((2 * d_in + 2 * g * n + s * hs, hs),))  # dt
    return SSMSegments(head_lo=s * hs, heads=hs, group_lo=g0, groups=gs,
                       proj=proj, conv=conv)


# a mamba mixer's leaves split per segment (``ssm_segments``): leaf ->
# (dimension, which ranges)
_SSM_SPLITS = {"w": (1, "proj"), "qt8": (0, "proj"), "qt4": (0, "proj"),
               "s8": (1, "proj"), "s4": (1, "proj"), "conv_w": (1, "conv"),
               "conv_b": (0, "conv"), "conv": (2, "conv"),
               "A_log": (0, "heads"), "D": (0, "heads"),
               "dt_bias": (0, "heads"), "ssm": (1, "heads")}


def _ssm_cut(path) -> bool:
    """A mamba mixer leaf that :func:`_ssm_piece` cuts per segment."""
    leafk = path[-1]
    return leafk in _SSM_SPLITS and not (
        leafk in _QUANT_VALUES + _QUANT_SCALES + ("w",)
        and "in_proj" not in path)


def _ssm_piece(cfg, layout, s, path, leaf):
    """Shard ``s``'s piece of a mamba mixer leaf (``in_proj``'s leaves,
    the conv, the per-head scalars, the conv and SSM state), its segments
    concatenated in order; None for a leaf split as its spec says
    (``out_proj``, row-parallel) or kept whole (the norm)."""
    if not _ssm_cut(path):
        return None
    dim, which = _SSM_SPLITS[path[-1]]
    seg = ssm_segments(cfg, layout, s)
    ranges = ((seg.head_lo, seg.heads),) if which == "heads" \
        else getattr(seg, which)
    parts = [leaf.narrow(dim, a, ln) for a, ln in ranges]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


@dataclasses.dataclass
class Shards:
    """One tree per mesh entry: entry ``(d, m)`` (data row ``d``, model
    shard ``m``) at ``d * tp + m``, on ``devices[d * tp + m]`` (a device
    may repeat), split over the model axis as ``layout`` says; ``dp`` data
    rows (1: one tree per model shard).  Replicated leaves are one tensor
    per distinct device.  Parameters over a data axis above 1 carry
    ``fsdp``: one tree's layout with each leaf's FSDP dimension (None:
    stored whole), each entry holding its row's pieces
    (:func:`gather_rows` rebuilds a shard's tensors at use).  ``split``:
    one tree's layout with each leaf's model-axis split (True: every
    model shard holds its own part; False: whole on every shard).
    ``shared`` (:func:`train_shards`): per leaf index (``tree_leaves``
    order), the ranges of a split leaf's piece that every model shard
    holds a copy of."""
    trees: list
    devices: list
    layout: TPLayout
    dp: int = 1
    fsdp: Any = None
    split: Any = None
    shared: Any = None

    def __len__(self) -> int:
        return len(self.trees)

    def __getitem__(self, i):
        return self.trees[i]

    def __iter__(self):
        return iter(self.trees)

    @property
    def tp(self) -> int:
        return len(self.trees) // self.dp

    def row(self, d: int) -> list:
        """Data row ``d``'s trees, in model-shard order."""
        return self.trees[d * self.tp:(d + 1) * self.tp]

    def row_devices(self, d: int) -> list:
        return self.devices[d * self.tp:(d + 1) * self.tp]


def _copy_nodes(tree):
    """The dict / list skeleton copied, the tensors shared."""
    if isinstance(tree, dict):
        return {k: _copy_nodes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_nodes(v) for v in tree]
    return tree


def _split_tree(tree, specs, devices, keep_whole, *, copy_whole: bool,
                piece=None):
    """One tree per shard: each leaf narrowed along its spec's model axis,
    cut by ``piece(s, path, leaf)`` where that gives a tensor (a mamba
    mixer's per-segment split), or kept whole (one tensor per distinct
    device: the leaf itself where it already lies, unless ``copy_whole``,
    else one copy).  A narrowed piece on the leaf's own device is a view
    where the split is along dimension 0 (expert stacks, N-major int8
    weights, embedding rows) and a contiguous copy otherwise; on another
    device, or under ``copy_whole``, always a copy."""
    tp = len(devices)
    whole: dict = {}

    def leaf_for(s, path, leaf, spec):
        dev = devices[s]
        got = None if piece is None else piece(s, path, leaf)
        if got is not None:
            return got.to(dev, copy=True).contiguous() \
                if got.device != dev or copy_whole else got.contiguous()
        dim = None if keep_whole(path) else split_dim(spec)
        if dim is None:
            key = (path, str(dev))
            if key not in whole:
                same = leaf.device == dev and not copy_whole
                whole[key] = leaf if same else leaf.to(dev, copy=True)
            return whole[key]
        n = leaf.shape[dim] // tp
        part = leaf.narrow(dim, s * n, n)
        return part.to(dev, copy=True).contiguous() \
            if part.device != dev or copy_whole else part.contiguous()

    def walk(s, node, spec, path=()):
        if isinstance(node, dict):
            return {k: walk(s, v, spec[k], path + (k,))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(s, v, spec[i], path + (str(i),))
                    for i, v in enumerate(node)]
        return leaf_for(s, path, node, spec)

    return [walk(s, tree, specs) for s in range(tp)]


def _attn_kind(cfg: ModelConfig, path: tuple) -> str | None:
    """"mla" or "gqa" for a leaf of an attention block (a decoder layer's
    self-attention, its cross-attention, or an encoder layer's), else
    None."""
    if "attn" not in path and "cross" not in path:
        return None
    if path[0] == "layers" and "attn" in path \
            and cfg.layer_specs[int(path[1])].attn_kind == "mla":
        return "mla"
    return "gqa"


def shard_params(params: dict, cfg: ModelConfig, mesh) -> Shards:
    """One parameter tree per entry of ``mesh``, on that entry's device:
    without a data axis one per model shard, above it each entry ``(d,
    m)`` holding piece ``d`` of shard ``m``'s leaves (``_fsdp_pieces``:
    the FSDP dimension ``param_specs`` names, each other leaf whole).
    The weights are quantized for
    ``cfg.quant_mode`` first (as ``prepare_params`` does, on a copy of the
    tree's nodes: the caller's tree is never changed) and split after, so
    every int8 value and scale is the unsharded one.  Each leaf splits
    where its spec (``param_specs``) names the model axis, except the
    attention blocks whose heads do not divide it (kv heads for GQA,
    query heads for MLA), which stay whole; MLA's ``wq_b`` / ``wkv_b``
    split by whole heads (their outputs are head-major) and its ``wo``
    along K by heads, while ``wq_a``, ``wkv_a``, the latent norms and the
    MoE router stay whole.  A mamba mixer splits by SSD head where the
    heads divide (else it stays whole): ``in_proj`` (its ``w``, int8 copy
    and scales) takes each shard's columns of z, x, B, C and dt, the conv
    its channels of x, B and C (``ssm_segments``: B and C by group, or
    whole), ``A_log`` / ``D`` / ``dt_bias`` its heads, ``out_proj`` rows
    as any row-parallel weight, the gated norm whole.  A whole leaf is
    the caller's tensor on its own device and one copy per other device;
    a split leaf on its own device is a view where the split is along
    rows (an expert stack's shard is its experts' rows of the caller's
    stack), else a copy (a mamba mixer's gathered segments)."""
    from repro_torch.models.transformer import prepare_params

    tp = mesh.shape[TP_AXIS]
    check_tp_supported(cfg, tp, mesh.shape["data"])
    layout = tp_layout(cfg, tp)
    src = prepare_params(_copy_nodes(params), cfg)
    specs = param_specs(src, mesh)
    devices = mesh.model_devices
    keep_whole, piece = _param_splitters(cfg, layout)
    split = _map_with_path(lambda path, spec: (
        "mamba" in path and layout.ssm_heads and _ssm_cut(path))
        or (not keep_whole(path) and split_dim(spec) is not None), specs)
    trees = _split_tree(src, specs, devices, keep_whole, copy_whole=False,
                        piece=piece)
    if mesh.shape["data"] == 1:
        return Shards(trees, devices, layout, split=split)
    dims = _map_with_path(lambda path, spec: data_dim(spec), specs)
    return Shards(_fsdp_pieces(trees, dims, mesh), mesh.entries, layout,
                  dp=mesh.shape["data"], fsdp=dims, split=split)


def _param_splitters(cfg: ModelConfig, layout: TPLayout):
    """``(keep_whole(path), piece(s, path, leaf))`` of the parameter
    split: the attention blocks whose heads do not divide the shards (and
    the mamba mixers whose SSD heads do not) stay whole; a mamba mixer's
    leaves are cut per segment where they do."""
    def keep_whole(path):
        if "mamba" in path:
            return not layout.ssm_heads
        kind = _attn_kind(cfg, path)
        if kind is None:
            return False
        return not (layout.mla_heads if kind == "mla" else layout.heads)

    def piece(s, path, leaf):
        if "mamba" not in path or not layout.ssm_heads:
            return None
        return _ssm_piece(cfg, layout, s, path, leaf)

    return keep_whole, piece


def train_shards(params: dict, cfg: ModelConfig, mesh) -> Shards:
    """:func:`shard_params` for a training step over ``mesh``: every entry
    holds its own copy of each of its leaves (a fresh tensor, never a
    view or a tensor another entry holds, as on distinct cards), marked
    to need grads.  Train from unprepared float weights (``dense`` or
    ``qat``)."""
    shards = shard_params(params, cfg, mesh)

    def own(node):
        if isinstance(node, dict):
            return {k: own(v) for k, v in node.items()}
        if isinstance(node, list):
            return [own(v) for v in node]
        if not node.is_floating_point():
            raise ValueError(f"a {node.dtype} leaf: train from unprepared "
                             f"float weights")
        return node.detach().clone().requires_grad_(True)

    shards.trees = [own(t) for t in shards.trees]
    from repro_torch.tree import tree_paths
    shared = {j: _shared_ranges(cfg, shards.layout, tuple(path.split("/")))
              for j, (path, _) in enumerate(tree_paths(shards.trees[0]))}
    shards.shared = {j: r for j, r in shared.items() if r}
    return shards


def _shared_ranges(cfg: ModelConfig, layout: TPLayout, path: tuple) -> list:
    """``(dim, start, length)`` ranges of a model shard's piece of a mamba
    leaf (cut per segment, ``_ssm_piece``) that every shard holds a copy
    of: the B and C segments where the groups do not divide the shards
    (their gradients sum over the shards)."""
    if (layout.tp < 2 or not layout.ssm_heads or layout.ssm_groups
            or "mamba" not in path or not _ssm_cut(path)):
        return []
    dim, which = _SSM_SPLITS[path[-1]]
    if which == "heads":
        return []
    names = ("z", "x", "B", "C", "dt") if which == "proj" else ("x", "B",
                                                                 "C")
    out, off = [], 0
    for name, (_, ln) in zip(names, getattr(ssm_segments(cfg, layout, 0),
                                           which)):
        if name in ("B", "C"):
            out.append((dim, off, ln))
        off += ln
    return out


def piece_groups(shards: Shards) -> list:
    """Per leaf (in ``tree_paths`` order of one entry's tree), the entries
    holding one piece of it, grouped: a list of entry lists, each sorted.
    A leaf split over the model axis and over the data axis has one entry
    per piece; a leaf whole over an axis is held by every entry along it
    (its copies, whose gradients sum)."""
    from repro_torch.tree import tree_leaves
    tp, dp = shards.tp, shards.dp
    splits = tree_leaves(shards.split)
    dims = (tree_leaves(shards.fsdp) if shards.fsdp is not None
            else [None] * len(splits))
    out = []
    for split, dim in zip(splits, dims):
        groups: dict = {}
        for e in range(tp * dp):
            d, m = divmod(e, tp)
            key = (d if dim is not None else 0, m if split else 0)
            groups.setdefault(key, []).append(e)
        out.append(list(groups.values()))
    return out


def _fsdp_pieces(trees: list, dims, mesh) -> list:
    """Entry ``(d, m)``'s tree: piece ``d`` of ``trees[m]``'s leaf along
    its FSDP dimension ``dims`` says (a view where the split is along
    rows on the leaf's own device, else a copy), a whole leaf as it is
    where it already lies and one copy per other device."""
    dp = mesh.shape["data"]
    copies: dict = {}

    def walk(d, dev, node, dim):
        if isinstance(node, dict):
            return {k: walk(d, dev, v, dim[k]) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(d, dev, v, dm) for v, dm in zip(node, dim)]
        if dim is None:
            key = (id(node), str(dev))
            if key not in copies:
                copies[key] = node if node.device == dev \
                    else node.to(dev, copy=True)
            return copies[key]
        n = node.shape[dim] // dp
        part = node.narrow(dim, d * n, n)
        return part.contiguous() if part.device == dev \
            else part.to(dev, copy=True).contiguous()

    return [walk(d, mesh.devices[d][m], tree, dims)
            for d in range(dp) for m, tree in enumerate(trees)]


# bits of the int8 weight copy each integer mode reads
_MODE_BITS = {"w8a8_nibble": 8, "lut": 8, "w4a8_nibble": 4}


def _read_keys(node: dict, mode: str) -> list:
    """The leaves of ``node`` a call in ``mode`` reads: of a prepared
    linear (``w`` beside ``qt8`` / ``qt4`` and their scales) the int8
    copy and its scale an integer mode reads, else ``w``; every leaf of
    any other node."""
    if "w" not in node or not any(k in node for k in _QUANT_VALUES):
        return list(node)
    bits = _MODE_BITS.get(mode)
    if bits is not None and f"qt{bits}" in node:
        return [f"qt{bits}", f"s{bits}"]
    return ["w"]


def _gather_tree(pieces: list, dims, dev, mode: str, own, row: int):
    """One shard's subtree on ``dev`` for data row ``row``: each FSDP leaf
    gathered from ``pieces`` (the data rows' subtrees, in data order),
    each whole leaf ``own``'s (the subtree of an entry on ``dev``)."""
    if isinstance(own, dict):
        return {k: _gather_tree([p[k] for p in pieces], dims[k], dev, mode,
                                own[k], row) for k in _read_keys(own, mode)}
    if isinstance(own, list):
        return [_gather_tree([p[i] for p in pieces], dims[i], dev, mode, o,
                             row) for i, o in enumerate(own)]
    if dims is None:
        return own
    return data_gather(pieces, dims, [dev], rows=[row])[0]


def stored_bytes(trees: list) -> list:
    """Bytes of every tensor leaf of each tree (a tensor shared by two
    trees counts in both): the parameter storage of each mesh entry."""
    def size(node):
        if isinstance(node, dict):
            return sum(size(v) for v in node.values())
        if isinstance(node, list):
            return sum(size(v) for v in node)
        return node.numel() * node.element_size()

    return [size(t) for t in trees]


def gather_rows(params: Shards, select, rows: int, mode: str) -> list:
    """Data rows ``0 .. rows - 1``'s model shards of the subtree
    ``select(tree)`` picks, ``[d][m]``.  Without a data axis the stored
    trees themselves.  Above, the FSDP gather on use: each FSDP leaf of
    shard ``m`` concatenated in data order onto each distinct device of
    the rows' entries ``(d, m)`` (one gather a device, shared by the
    entries on it, and a copy even where every piece already lies there,
    as across cards), each whole leaf the entry's own; a linear's leaves
    ``mode`` does not read are left out (``_read_keys``).  Under
    ``collectives.distinct_entries`` every entry gathers its own."""
    tp = params.tp
    if params.fsdp is None:
        return [[select(t) for t in params.row(d)] for d in range(rows)]
    dims = select(params.fsdp)
    out = [[None] * tp for _ in range(rows)]
    for m in range(tp):
        pieces = [select(params.trees[r * tp + m]) for r in range(params.dp)]
        done: dict = {}
        for d in range(rows):
            dev = params.devices[d * tp + m]
            key = d if entries_distinct() else str(dev)
            if key not in done:
                done[key] = _gather_tree(pieces, dims, dev, mode, pieces[d],
                                         d)
            out[d][m] = done[key]
    return out


MLA_CACHE_KEYS = ("c_kv", "k_rope")
SSM_CACHE_KEYS = ("conv", "ssm")
# cache leaves with a sequence axis (slab rows or pool pages), the
# reference's set, int8 scales included; every other leaf is per-slot
SEQ_CACHE_KEYS = frozenset({"k", "v", "c_kv", "k_rope", "k_scale",
                            "v_scale"})


def shard_caches(caches: list, cfg: ModelConfig, mesh, batch: int) -> Shards:
    """One cache list per mesh entry, on that entry's device, in the
    layout the sharded engine serves from: KV (and int8 scale) leaves
    split along the head axis where ``cache_specs`` puts the model axis
    there, a mamba layer's conv history and SSM state by its shard's
    channels and heads (``ssm_segments``) where the SSD heads divide;
    every other leaf whole (the in-page sequence split the reference
    takes for indivisible heads and for MLA's latent pools is replicated
    here).  Over a data axis the slots split by row (``slot_rows``):
    a row holds its slots of every per-slot leaf (dense slabs, mamba
    state), and the paged pools are whole, one copy per distinct device
    shared by the rows on it.  Every leaf is a copy: the shards are
    written in place, the caller's tree never."""
    tp, dp = mesh.shape[TP_AXIS], mesh.shape["data"]
    layout = tp_layout(cfg, tp)
    specs = cache_specs(cfg, caches, mesh, batch=batch)
    paged = cfg.cache_mode == "paged"
    rows = slot_rows(batch, dp)
    per = batch // rows

    def keep_whole(path):
        if path[-1] in SSM_CACHE_KEYS:
            return not layout.ssm_heads
        return not layout.heads or path[-1] in MLA_CACHE_KEYS

    def piece(s, path, leaf):
        if path[-1] not in SSM_CACHE_KEYS or not layout.ssm_heads:
            return None
        return _ssm_piece(cfg, layout, s, path, leaf)

    trees: list = []
    pools: dict = {}
    for d in range(rows):
        src = [{k: v if paged and k in SEQ_CACHE_KEYS
                else v.narrow(0, d * per, per) for k, v in c.items()}
               for c in caches]
        for m, tree in enumerate(_split_tree(
                src, specs, mesh.row_devices(d), keep_whole,
                copy_whole=True, piece=piece)):
            for li, c in enumerate(tree):
                for k in c:
                    if paged and k in SEQ_CACHE_KEYS:
                        c[k] = pools.setdefault(
                            (m, li, k, str(c[k].device)), c[k])
            trees.append(tree)
    return Shards(trees, mesh.entries[:rows * tp], layout, dp=rows)
