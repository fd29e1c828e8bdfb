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
on matrices only (``ndim >= 2``), ``p - lr * delta`` in f32 and one cast
back to the parameter's dtype.

The quantized-moment mode stores both moments as int8 with one
per-tensor abs-max scale, re-quantized after every update.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quantize import scale_from_amax
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_moments: bool = False   # int8 moment storage


def _q8(x):
    scale = scale_from_amax(x.abs().max(), floor=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dq8(m):
    return m["q"].to(torch.float32) * m["scale"]


def adamw_init(params, cfg: AdamWConfig) -> dict:
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


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig, lr_scale=1.0):
    """Returns (params, state, metrics): the same parameter tree and state
    dict, updated in place, and ``{"grad_norm", "lr"}`` (0-dim f32)."""
    f32 = torch.float32
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0) if cfg.grad_clip else None)
    stepf = step.to(f32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=f32,
                                       device=step.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=f32,
                                       device=step.device), stepf)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=f32, device=step.device)

    qm = cfg.quantize_moments
    leaves = zip(tree_leaves(params), tree_leaves(grads),
                 _moment_leaves(state["mu"], qm),
                 _moment_leaves(state["nu"], qm))
    for p, g, mu, nu in leaves:
        g = g.to(f32, copy=True)
        if clip is not None:
            g.mul_(clip)
        mu_f = _dq8(mu) if qm else mu
        nu_f = _dq8(nu) if qm else nu
        mu_f.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        nu_f.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
        del g
        delta = (mu_f / b1c).div_((nu_f / b2c).sqrt_().add_(cfg.eps))
        if p.ndim >= 2:                  # decoupled decay on matrices only
            delta.add_(p.to(f32) * cfg.weight_decay)
        p.copy_(p.to(f32).sub_(delta.mul_(lr)))
        del delta
        if qm:
            mu["q"], mu["scale"] = _q8(mu_f)
            nu["q"], nu["scale"] = _q8(nu_f)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
