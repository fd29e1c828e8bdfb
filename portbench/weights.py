"""Seeded weights, made on the device in a few large calls.

A configuration's reference module lists its leaves (``weight_layout``):
each a name, a shape, a dtype and an init rule.  The weights are made
here from ``--seed`` and handed to both sides, the program and the
plain reference; neither makes its own.  All ``normal`` leaves of one
group (one layer, or the embedding, or the head) come from one
``torch.randn`` call in bf16 on a ``torch.Generator`` of the device, cut
into views and scaled in place; the same seed gives the same bits.
The few small per-head leaves with a published init of their own
(Mamba-2's ``A_log`` and ``dt_bias``) come from a second generator.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = ["Leaf", "make_weights", "generator_seed"]


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str                 # "layers.3.wq", "embed", ...
    shape: tuple
    init: str                 # "normal" | "zeros" | "ones" |
    #                           "log_uniform" | "dt_bias"
    std: float = 0.0          # for "normal"
    lo: float = 0.0           # range of "log_uniform" and "dt_bias"
    hi: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    group: str = ""           # leaves of one group share one randn call


def generator_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for ``(seed, stream)``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_weights(layout: list[Leaf], seed: int, device) -> dict:
    """``{name: tensor}`` for every leaf of ``layout``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(generator_seed(seed, 1))
    small = torch.Generator(device=device)
    small.manual_seed(generator_seed(seed, 4))
    out: dict[str, torch.Tensor] = {}
    groups: dict[str, list[Leaf]] = {}
    for leaf in layout:
        if leaf.init == "normal":
            groups.setdefault(leaf.group or leaf.name, []).append(leaf)
        elif leaf.init == "zeros":
            out[leaf.name] = torch.zeros(leaf.shape, dtype=leaf.dtype,
                                         device=device)
        elif leaf.init == "ones":
            out[leaf.name] = torch.ones(leaf.shape, dtype=leaf.dtype,
                                        device=device)
        elif leaf.init in ("log_uniform", "dt_bias"):
            u = torch.rand(leaf.shape, generator=small, device=device,
                           dtype=torch.float32)
            out[leaf.name] = _published(leaf, u).to(leaf.dtype)
        else:
            raise ValueError(f"unknown init {leaf.init!r} for {leaf.name}")
    for leaves in groups.values():
        total = sum(math.prod(leaf.shape) for leaf in leaves)
        buf = torch.randn(total, generator=gen, device=device,
                          dtype=torch.bfloat16)
        off = 0
        for leaf in leaves:
            n = math.prod(leaf.shape)
            view = buf[off:off + n].view(leaf.shape)
            view.mul_(leaf.std)
            out[leaf.name] = view if leaf.dtype == torch.bfloat16 \
                else view.to(leaf.dtype)
            off += n
    return out


def _published(leaf: Leaf, u: torch.Tensor) -> torch.Tensor:
    """Mamba-2's own init from uniform draws ``u``: ``log_uniform`` is
    ``log(A)``, ``A`` uniform in [lo, hi]; ``dt_bias`` is the inverse
    softplus of a step ``dt`` log-uniform in [lo, hi] (floor 1e-4)."""
    if leaf.init == "log_uniform":
        return torch.log(leaf.lo + u * (leaf.hi - leaf.lo))
    dt = torch.exp(math.log(leaf.lo) + u * (math.log(leaf.hi)
                                            - math.log(leaf.lo)))
    dt = dt.clamp(min=1e-4)
    return dt + torch.log(-torch.expm1(-dt))
