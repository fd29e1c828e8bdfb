"""Training step: loss, gradient accumulation, compression hook, MTP
(port of ``repro.train.step``).

* next-token cross-entropy with label masking (-1 = ignore), over the
  token grid (a VLM's patch positions are cut off; an encoder-decoder's
  frames feed the encoder),
  ``logsumexp - logits[label]`` (the reference's one-hot product, read by
  a gather), plus the MoE aux
  loss (0 without an MoE layer), the z-loss and the
  optional multi-token-prediction terms;
* gradient accumulation over microbatches as a Python loop (the
  reference's ``lax.scan``), summing f32 gradients;
* optional int8 gradient compression before the optimizer;
* AdamW's weight decay on the leaves the reference decays
  (:func:`weight_decay_mask`).

Parameters are the port's nested dict, every leaf a float tensor that
is trained (integer copies prepared for serving have no place in it).
``train_step`` updates the parameters and the optimizer state in place
(see ``optim.adamw``) and returns them with the metrics.

**Over a mesh** (``Shards`` from ``sharding.train_shards``, optimizer
state from ``adamw_init`` over them): the step the reference's dry run
compiles under its ambient mesh, run with every entry a card of its own
(``collectives.distinct_entries``).  The batch splits over the data rows;
each row runs ``models.forward_rows`` (the reference's mesh MoE,
``moe.moe_apply_mesh``) and its vocabulary-parallel cross entropy: the
row's log-sum-exp from a max and a sum over its shards' logit slices,
the label's logit from the shard that holds it.  The loss is the global
batch's mean (numerators and the label count summed over the rows).
Gradients end on each entry's pieces; a piece held by several entries
(a leaf whole over an axis) sums its copies' gradients
(``sharding.piece_groups``, ``collectives.mesh_all_reduce``); the clip's
norm, the int8 moments' and the compression's scales span whole tensors
(``optim.adamw_update_mesh``, ``compression.compress_pieces_int8``).
``Trainer`` takes no mesh, as the reference's does not.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import broadcast, \
    distinct_entries, mesh_all_reduce, move, reduce_sum
from repro_torch.distributed.compression import compress_pieces_int8, \
    compress_tree_int8
from repro_torch.distributed.sharding import Shards, piece_groups
from repro_torch.models import forward
from repro_torch.models.transformer import _enc_cfg, _row_split, \
    forward_rows
from repro_torch.optim import AdamWConfig, adamw_update, warmup_cosine
from repro_torch.optim.adamw import adamw_update_mesh
from repro_torch.tree import tree_leaves, tree_map, tree_paths

__all__ = ["TrainConfig", "cross_entropy", "z_loss", "make_loss_fn",
           "accumulate_grads", "make_train_step", "trainable",
           "weight_decay_mask", "make_mesh_loss_fn", "mesh_grads"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    microbatches: int = 1            # gradient accumulation factor
    aux_loss_weight: float = 0.01
    mtp_weight: float = 0.0          # multi-token prediction
    mtp_depth: int = 1
    z_loss_weight: float = 1e-4      # logit normalization regularizer
    warmup_steps: int = 100
    total_steps: int = 10_000
    compress_grads: bool = False


def cross_entropy(logits, labels):
    """Masked next-token CE; labels == -1 are ignored.

    The reference reads the label's logit as ``sum(logits * one_hot)``; a
    gather gives the same value (the other terms are exact zeros) and the
    same gradient, without two (B, S, V) f32 temporaries."""
    logits = logits.to(torch.float32)
    mask = (labels >= 0).to(torch.float32)
    safe = torch.clamp(labels, min=0)
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(-1, safe.long()[..., None]).squeeze(-1)
    nll = lse - label_logit
    denom = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / denom


def z_loss(logits, labels):
    """(log Z)^2 regularizer over the unmasked positions."""
    mask = (labels >= 0).to(torch.float32)
    lse = torch.logsumexp(logits.to(torch.float32), dim=-1)
    denom = torch.clamp(mask.sum(), min=1.0)
    return (torch.square(lse) * mask).sum() / denom


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)``.  A VLM's batch
    carries ``patch_embeds`` (B, P, D), prepended to the tokens, and its
    logits are cut back to the token grid; an encoder-decoder's carries
    ``frames`` (B, S_enc, D) for the encoder."""
    def loss_fn(params, batch):
        extra = {}
        if cfg.family == "vlm":
            extra["extra_embeds"] = batch["patch_embeds"]
        if cfg.is_encdec:
            extra["frames"] = batch["frames"]
        logits, aux = forward(params, cfg, batch["tokens"], **extra)
        if cfg.family == "vlm":
            logits = logits[:, -batch["tokens"].shape[1]:]
        labels = batch["labels"]
        loss = cross_entropy(logits[:, :-1], labels[:, :-1])
        loss = loss + tcfg.aux_loss_weight * aux
        loss = loss + tcfg.z_loss_weight * z_loss(logits[:, :-1],
                                                  labels[:, :-1])
        if tcfg.mtp_weight > 0.0:
            # depth-d MTP: predict token t+1+d from position t, shared head
            for d in range(1, tcfg.mtp_depth + 1):
                loss = loss + tcfg.mtp_weight * cross_entropy(
                    logits[:, :-(1 + d)], labels[:, d:-1])
        return loss, {"ce": loss.detach(), "aux": aux.detach()}

    return loss_fn


def trainable(params) -> list[torch.Tensor]:
    """The leaves in tree order, marked to need grads."""
    leaves = []
    for path, t in tree_paths(params):
        if not t.is_floating_point():
            raise ValueError(f"{path} is {t.dtype}: train from unprepared "
                             f"float weights")
        leaves.append(t.requires_grad_(True))
    return leaves


def _grad_tree(params, grads):
    it = iter(grads)
    return tree_map(lambda _: next(it), params)


def accumulate_grads(loss_fn, params, batch, n_micro: int):
    """Returns (loss, metrics, grads); grads are a tree like ``params``.
    One microbatch: grads in the parameters' dtype.  Several: f32 grads
    summed over microbatches and scaled by ``1 / n_micro``, as the
    reference's scan does."""
    leaves = trainable(params)
    if n_micro == 1:
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), metrics, _grad_tree(params, grads)
    b = batch["tokens"].shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         f"microbatches")
    acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
           for t in leaves]
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
    per = b // n_micro
    for i in range(n_micro):
        mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        loss, _ = loss_fn(params, mb)
        for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
            a.add_(g.to(torch.float32))
        loss_sum = loss_sum + loss.detach()
    scale = 1.0 / n_micro
    grads = [a.mul_(scale) for a in acc]
    loss = loss_sum * scale
    return loss, {"ce": loss}, _grad_tree(params, grads)


def weight_decay_mask(params, cfg: ModelConfig):
    """A tree of bools like ``params``: the leaves the reference's AdamW
    decays.  It decays the leaves of two or more dimensions in its own
    layout, where the repeated blocks are stacked on a leading axis; so
    every leaf of a block layer is decayed, its vectors too (norm gains,
    the mamba mixer's ``A_log``, ``D``, ``dt_bias`` and conv bias), and of
    the prefix and suffix layers, the embedding, the head and the final
    norms only the matrices."""
    def stack_mask(layers, c):
        lo = len(c.prefix_pattern)
        hi = lo + c.n_blocks * len(c.block_pattern)
        return [tree_map(lambda t, blk=lo <= i < hi: blk or t.ndim >= 2, lp)
                for i, lp in enumerate(layers)]

    out = {k: tree_map(lambda t: t.ndim >= 2, v) for k, v in params.items()
           if k not in ("layers", "encoder")}
    out["layers"] = stack_mask(params["layers"], cfg)
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {
            "layers": stack_mask(enc["layers"], _enc_cfg(cfg)),
            "norm": tree_map(lambda t: t.ndim >= 2, enc["norm"])}
    return out


def _row_sums(parts: list, devs: list, labels, tcfg: TrainConfig):
    """One data row's loss numerators and label counts, on its first
    entry: ``[ce, count, z, (mtp_d, count_d) for each depth]``, from
    ``parts`` (the row's logits, one vocabulary slice per shard in shard
    order) and ``labels`` (B, S) on ``devs[0]``.  Each term takes its
    own log-sum-exp, as :func:`cross_entropy` and :func:`z_loss` do: per
    shard over its slice, then over the shards' values gathered on shard
    0 (one shard: the slice's own, so a (1, 1) mesh is the unsharded
    loss bit for bit)."""
    f32 = torch.float32
    width = parts[0].shape[-1]
    labs = broadcast(labels, devs)
    s = labels.shape[1]

    def lse(sl: list):
        local = [torch.logsumexp(p, dim=-1) for p in sl]
        if len(local) == 1:
            return local[0]
        return torch.logsumexp(torch.stack([
            v if i == 0 else move(v, devs[0], "all_gather")
            for i, v in enumerate(local)]), dim=0)

    def terms(shift: int, z: bool) -> list:
        n = s - 1 - shift            # positions [0, n) predict labels
        sl = [p[:, :n] for p in parts]
        row_lse = lse(sl)
        picked = []
        for i, (p, lab) in enumerate(zip(sl, labs)):
            local = lab[:, shift:shift + n].long() - i * width
            hit = (local >= 0) & (local < width)
            v = p.gather(-1, torch.clamp(local, 0, width - 1)[..., None])
            picked.append(torch.where(hit, v[..., 0], torch.zeros(
                (), dtype=f32, device=p.device)))
        label_logit = reduce_sum(picked, devices=devs)
        mask = (labels[:, shift:shift + n] >= 0).to(f32)
        out = [((row_lse - label_logit) * mask).sum(), mask.sum()]
        if z:
            out.append((torch.square(lse([p[:, :n] for p in parts]))
                        * mask).sum())
        return out

    vals = terms(0, True)
    if tcfg.mtp_weight > 0.0:
        for d in range(1, tcfg.mtp_depth + 1):
            vals += terms(d, False)
    return torch.stack(vals)


def make_mesh_loss_fn(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """``loss_fn(params: Shards, batch) -> (loss, metrics)``:
    :func:`make_loss_fn`'s loss over the mesh (see the module docstring),
    on entry (0, 0)'s device.  Run it under
    ``collectives.distinct_entries``."""
    def loss_fn(params, batch):
        extra = {}
        if cfg.family == "vlm":
            extra["extra_embeds"] = batch["patch_embeds"]
        if cfg.is_encdec:
            extra["frames"] = batch["frames"]
        parts, aux = forward_rows(params, cfg, batch["tokens"],
                                  token_grid=cfg.family == "vlm", **extra)
        rows = len(parts)
        leads = [params.row_devices(d)[0] for d in range(rows)]
        sums = []
        for d, (row, lab) in enumerate(zip(parts, _row_split(
                batch["labels"], rows))):
            devs = params.row_devices(d)
            if not params.layout.vocab:      # whole logits on every entry
                row, devs = row[:1], devs[:1]
            sums.append(_row_sums(row, devs, broadcast(lab, devs[:1])[0],
                                  tcfg))
        total = reduce_sum(sums, axis="data", devices=leads)
        denom = torch.clamp(total[1], min=1.0)
        loss = total[0] / denom
        loss = loss + tcfg.aux_loss_weight * aux
        loss = loss + tcfg.z_loss_weight * (total[2] / denom)
        for k in range(3, len(total), 2):
            loss = loss + tcfg.mtp_weight * (
                total[k] / torch.clamp(total[k + 1], min=1.0))
        return loss, {"ce": loss.detach(), "aux": aux.detach()}

    return loss_fn


def mesh_grads(loss_fn, params: Shards, batch, n_micro: int = 1):
    """(loss, metrics, grads) over the mesh: ``grads[e][j]`` entry ``e``'s
    gradient of its leaf ``j`` (``tree_leaves`` order), summed over the
    copies of each piece (the entries ``piece_groups`` groups).  Several
    microbatches sum f32 gradients scaled by ``1 / n_micro``."""
    leaves = [tree_leaves(t) for t in params.trees]
    flat = [t for row in leaves for t in row]
    n_leaf = len(leaves[0])

    def grads_of(loss):
        got = torch.autograd.grad(loss, flat, allow_unused=True)
        return [[torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves[e], got[e * n_leaf:
                                                (e + 1) * n_leaf])]
                for e in range(len(leaves))]

    if n_micro == 1:
        loss, metrics = loss_fn(params, batch)
        grads = grads_of(loss)
        loss = loss.detach()
    else:
        b = batch["tokens"].shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} does not split into {n_micro} "
                             f"microbatches")
        per = b // n_micro
        grads = None
        loss = 0.0
        for i in range(n_micro):
            mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            lm, _ = loss_fn(params, mb)
            gm = grads_of(lm)
            grads = [[g.to(torch.float32) for g in row] for row in gm] \
                if grads is None else [[a.add_(g.to(torch.float32))
                                        for a, g in zip(ra, rg)]
                                       for ra, rg in zip(grads, gm)]
            loss = loss + lm.detach()
        grads = [[g.mul_(1.0 / n_micro) for g in row] for row in grads]
        loss = loss * (1.0 / n_micro)
        metrics = {"ce": loss}
    devs, tp = params.devices, params.tp
    # ranges every model shard of a row holds a copy of (a mamba mixer's
    # B and C where the groups do not divide): summed over the row first
    for j, ranges in (params.shared or {}).items():
        for d in range(params.dp):
            row = list(range(d * tp, (d + 1) * tp))
            for e in row:
                grads[e][j] = grads[e][j].to(torch.float32)
            for dim, start, ln in ranges:
                summed = mesh_all_reduce(
                    [grads[e][j].narrow(dim, start, ln) for e in row], row,
                    [devs[e] for e in row], tp)
                for e, t in zip(row, summed):
                    grads[e][j].narrow(dim, start, ln).copy_(t)
    for j, groups in enumerate(piece_groups(params)):
        for g in groups:
            if len(g) > 1:
                summed = mesh_all_reduce(
                    [grads[e][j].to(torch.float32) for e in g], g,
                    [devs[e] for e in g], tp)
                for e, t in zip(g, summed):
                    grads[e][j] = t
    return loss, metrics, grads


def _mesh_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    loss_fn = make_mesh_loss_fn(cfg, tcfg)

    def train_step(params, opt_state, batch):
        with distinct_entries():
            loss, metrics, grads = mesh_grads(loss_fn, params, batch,
                                              tcfg.microbatches)
            if tcfg.compress_grads:
                grads = compress_pieces_int8(grads, params.devices,
                                             params.tp)
            lr_scale = [warmup_cosine(st, warmup=tcfg.warmup_steps,
                                      total=tcfg.total_steps)
                        for st in opt_state["step"]]
            params, opt_state, opt_metrics = adamw_update_mesh(
                params, grads, opt_state, tcfg.optimizer, lr_scale,
                piece_groups(params),
                tree_leaves(weight_decay_mask(params.trees[0], cfg)),
                params.shared)
        del grads
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, opt_state, metrics

    return train_step


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; over ``Shards`` the mesh step (module docstring)."""
    loss_fn = make_loss_fn(cfg, tcfg)
    mesh_step = _mesh_train_step(cfg, tcfg)

    def train_step(params, opt_state, batch):
        if isinstance(params, Shards):
            return mesh_step(params, opt_state, batch)
        loss, metrics, grads = accumulate_grads(loss_fn, params, batch,
                                                tcfg.microbatches)
        if tcfg.compress_grads:
            grads, _ = compress_tree_int8(grads)
        lr_scale = warmup_cosine(opt_state["step"],
                                 warmup=tcfg.warmup_steps,
                                 total=tcfg.total_steps)
        params, opt_state, opt_metrics = adamw_update(
            params, grads, opt_state, tcfg.optimizer, lr_scale,
            decay=weight_decay_mask(params, cfg))
        del grads
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, opt_state, metrics

    return train_step
