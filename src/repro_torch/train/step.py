"""Training step: loss, gradient accumulation, compression hook, MTP
(port of ``repro.train.step``).

* next-token cross-entropy with label masking (-1 = ignore),
  ``logsumexp - logits[label]`` (the reference's one-hot product, read by
  a gather), plus the MoE aux
  loss (0 for the attention-only stacks ported here), the z-loss and the
  optional multi-token-prediction terms;
* gradient accumulation over microbatches as a Python loop (the
  reference's ``lax.scan``), summing f32 gradients;
* optional int8 gradient compression before the optimizer.

Parameters are the port's nested dict, every leaf a float tensor that
is trained (integer copies prepared for serving have no place in it).
``train_step`` updates the parameters and the optimizer state in place
(see ``optim.adamw``) and returns them with the metrics.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.compression import compress_tree_int8
from repro_torch.models import forward
from repro_torch.optim import AdamWConfig, adamw_update, warmup_cosine
from repro_torch.tree import tree_map, tree_paths

__all__ = ["TrainConfig", "cross_entropy", "z_loss", "make_loss_fn",
           "accumulate_grads", "make_train_step", "trainable"]


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
    if cfg.family in ("vlm", "encdec"):
        raise NotImplementedError(f"{cfg.family} training inputs are not "
                                  f"ported yet")

    def loss_fn(params, batch):
        logits, aux = forward(params, cfg, batch["tokens"])
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


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    loss_fn = make_loss_fn(cfg, tcfg)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = accumulate_grads(loss_fn, params, batch,
                                                tcfg.microbatches)
        if tcfg.compress_grads:
            grads, _ = compress_tree_int8(grads)
        lr_scale = warmup_cosine(opt_state["step"],
                                 warmup=tcfg.warmup_steps,
                                 total=tcfg.total_steps)
        params, opt_state, opt_metrics = adamw_update(
            params, grads, opt_state, tcfg.optimizer, lr_scale)
        del grads
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, opt_state, metrics

    return train_step
