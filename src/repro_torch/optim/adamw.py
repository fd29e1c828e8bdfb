"""AdamW with optional int8-quantized moments (port of
``repro.optim.adamw``), in the reference's f32 arithmetic.

Parameters, gradients and moments are trees of the same nesting
(``repro_torch.tree``).  :func:`adamw_update` **updates in place**: the
parameter leaves are overwritten with their new values and the f32
moments are updated where they lie (the state dict is returned with the
same tensors), so a full-width step holds no second copy of the
parameters or moments.  The operations and their order are the
reference's: clip by the global norm, ``mu = b1 * mu + (1 - b1) * g``,
``nu = b2 * nu + (1 - b2) * g^2``, bias correction, decoupled weight decay
on matrices only (``ndim >= 2``, or the leaves a ``decay`` tree marks),
``p - lr * delta`` in f32 and one cast back to the parameter's dtype.

The quantized-moment mode stores both moments as int8 with one
per-tensor abs-max scale, re-quantized after every update.

Over a mesh (:func:`adamw_update_mesh`, the training step over
``Shards``): every entry updates its own pieces with the gradients summed
over each piece's copies, and keeps its own moments (shaped as its
pieces: ``opt_state_specs``).  The statistics the reference takes over
whole tensors stay whole: the clip's global norm counts each piece once
(summed over the mesh), and an int8 moment's scale is the max of its
pieces' amaxes.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quantize import scale_from_amax
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "adamw_update_mesh"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_moments: bool = False   # int8 moment storage


def _q8(x, amax=None):
    scale = scale_from_amax(x.abs().max() if amax is None else amax,
                            floor=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dq8(m):
    return m["q"].to(torch.float32) * m["scale"]


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """Zero moments like ``params`` and a step counter; over ``Shards``
    one state per entry, on its device (``step``, ``mu`` and ``nu`` are
    then lists by entry)."""
    from repro_torch.distributed.sharding import Shards
    if isinstance(params, Shards):
        per = [adamw_init(t, cfg) for t in params.trees]
        return {k: [st[k] for st in per] for k in ("step", "mu", "nu")}
    device = tree_leaves(params)[0].device

    def zeros_like_moment(p):
        if cfg.quantize_moments:
            return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                     device=p.device),
                    "scale": torch.zeros((), dtype=torch.float32,
                                         device=p.device)}
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "mu": tree_map(zeros_like_moment, params),
            "nu": tree_map(zeros_like_moment, params)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(grads)))


def _moment_leaves(tree, quantized: bool):
    if not quantized:
        return tree_leaves(tree)
    out = []

    def walk(node):
        if isinstance(node, dict) and "q" in node and "scale" in node:
            out.append(node)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        else:
            for v in node:
                walk(v)

    walk(tree)
    return out


def _scalars(step, cfg: AdamWConfig, lr_scale):
    """The step's bias corrections and learning rate on ``step``'s
    device."""
    f32 = torch.float32
    stepf = step.to(f32)
    b1c = 1.0 - torch.pow(torch.full((), cfg.b1, dtype=f32,
                                     device=step.device), stepf)
    b2c = 1.0 - torch.pow(torch.full((), cfg.b2, dtype=f32,
                                     device=step.device), stepf)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=f32, device=step.device)
    return b1c, b2c, lr


def _clip(gnorm, cfg: AdamWConfig):
    return (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0) if cfg.grad_clip else None)


def _update_leaf(p, g, mu_f, nu_f, *, clip, b1c, b2c, lr, decayed,
                 cfg: AdamWConfig) -> None:
    """One leaf's update in place: the moments ``mu_f`` / ``nu_f`` (f32)
    and the parameter."""
    f32 = torch.float32
    g = g.to(f32, copy=True)
    if clip is not None:
        g.mul_(clip)
    mu_f.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    nu_f.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
    del g
    delta = (mu_f / b1c).div_((nu_f / b2c).sqrt_().add_(cfg.eps))
    if decayed:                      # decoupled weight decay
        delta.add_(p.to(f32) * cfg.weight_decay)
    p.copy_(p.to(f32).sub_(delta.mul_(lr)))


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig, lr_scale=1.0,
                 decay=None):
    """Returns (params, state, metrics): the same parameter tree and state
    dict, updated in place, and ``{"grad_norm", "lr"}`` (0-dim f32).
    ``decay``: a tree of bools like ``params`` naming the leaves that take
    weight decay; None decays the leaves of two or more dimensions."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = _clip(gnorm, cfg)
    b1c, b2c, lr = _scalars(step, cfg, lr_scale)

    qm = cfg.quantize_moments
    p_leaves = tree_leaves(params)
    decays = ([p.ndim >= 2 for p in p_leaves] if decay is None
              else tree_leaves(decay))
    leaves = zip(p_leaves, tree_leaves(grads),
                 _moment_leaves(state["mu"], qm),
                 _moment_leaves(state["nu"], qm), decays)
    for p, g, mu, nu, decayed in leaves:
        mu_f = _dq8(mu) if qm else mu
        nu_f = _dq8(nu) if qm else nu
        _update_leaf(p, g, mu_f, nu_f, clip=clip, b1c=b1c, b2c=b2c, lr=lr,
                     decayed=decayed, cfg=cfg)
        if qm:
            mu["q"], mu["scale"] = _q8(mu_f)
            nu["q"], nu["scale"] = _q8(nu_f)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def adamw_update_mesh(params, grads: list, state: dict, cfg: AdamWConfig,
                      lr_scale: list, groups: list, decays: list,
                      shared=None):
    """:func:`adamw_update` over the entries of ``params`` (``Shards``):
    ``grads[e]`` entry ``e``'s gradients in ``tree_leaves`` order, summed
    over each piece's copies; ``state`` from :func:`adamw_init` over the
    same ``Shards``; ``lr_scale[e]`` on entry ``e``'s device; ``groups``
    (``sharding.piece_groups``) and ``decays`` per leaf; ``shared``
    (``Shards.shared``) the ranges of a piece every model shard holds a
    copy of, counted in the norm on shard 0 only.  Returns (params,
    state, metrics on entry 0's device)."""
    from repro_torch.distributed.collectives import mesh_all_reduce
    f32 = torch.float32
    devs, tp = params.devices, params.tp
    entries = list(range(len(params.trees)))
    # the global norm: each piece once, on the first entry that holds it
    sq = [torch.zeros((), dtype=f32, device=d) for d in devs]
    for j, gs in enumerate(groups):
        for g in gs:
            e = g[0]
            sq[e] = sq[e] + torch.sum(torch.square(grads[e][j].to(f32)))
            if e % tp:
                for dim, start, ln in (shared or {}).get(j, ()):
                    sq[e] = sq[e] - torch.sum(torch.square(
                        grads[e][j].narrow(dim, start, ln).to(f32)))
    gnorm = [torch.sqrt(t) for t in mesh_all_reduce(sq, entries, devs, tp)]
    qm = cfg.quantize_moments
    p_leaves = [tree_leaves(t) for t in params.trees]
    mus = [_moment_leaves(t, qm) for t in state["mu"]]
    nus = [_moment_leaves(t, qm) for t in state["nu"]]
    steps = [st + 1 for st in state["step"]]
    scal = [_scalars(st, cfg, ls) for st, ls in zip(steps, lr_scale)]
    for j, decayed in enumerate(decays):
        moments = []
        for e in entries:
            mu, nu = mus[e][j], nus[e][j]
            mu_f = _dq8(mu) if qm else mu
            nu_f = _dq8(nu) if qm else nu
            b1c, b2c, lr = scal[e]
            _update_leaf(p_leaves[e][j], grads[e][j], mu_f, nu_f,
                         clip=_clip(gnorm[e], cfg), b1c=b1c, b2c=b2c, lr=lr,
                         decayed=decayed, cfg=cfg)
            moments.append((mu_f, nu_f))
        if not qm:
            continue
        # one per-tensor scale: the max over the pieces' amaxes
        amax = [mesh_all_reduce([m[k].abs().max() for m in moments],
                                entries, devs, tp, op="max")
                for k in (0, 1)]
        for e, (mu_f, nu_f) in enumerate(moments):
            mu, nu = mus[e][j], nus[e][j]
            mu["q"], mu["scale"] = _q8(mu_f, amax[0][e])
            nu["q"], nu["scale"] = _q8(nu_f, amax[1][e])
    state["step"] = steps
    return params, state, {"grad_norm": gnorm[0], "lr": scal[0][2]}
