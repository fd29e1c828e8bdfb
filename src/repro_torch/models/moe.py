"""Mixture-of-Experts block (port of ``repro.models.moe``, the local path).

Top-k routing over an f32 router, then a fixed-shape sort dispatch: the
(token, k) assignments are sorted by expert id (stable), each takes its
position inside its expert's segment, assignments past the capacity
``C = max(8, int(k * T / E * capacity_factor))`` are dropped, and the kept
ones are added into an (E, C, D) buffer that the stacked SwiGLU experts
run as three batched bf16 products (``bf16_matmul``).  The combine
weights each expert row by its renormalised router weight in f32 and
sums a token's k rows.

Every shape is a function of the static token count ``T = B * S``, and no
step reads the device from the host (no ``.item()``, no ``nonzero``, no
``bincount``), so the block runs inside a captured CUDA graph.  Two sums
are kept exact or ordered, so that a run repeats bit for bit: the
dispatch adds one real row per buffer slot plus exact zeros (any order
gives the same bits), and the combine sums each token's k rows in
ascending expert order, one add at a time, the order in which the
reference's scatter-add visits them (an atomic ``index_add_`` would sum
in a different order on every CUDA run).

The reference's expert-parallel path (``_moe_sharded``, a ``shard_map``
over a device mesh) waits for the scale-out slice; without a mesh the
reference runs the local path ported here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import bf16_matmul, mlp_apply, mlp_init

__all__ = ["moe_init", "moe_apply"]


def moe_init(cfg, *, generator, device) -> dict:
    """The router (d, E) in f32 (0.02 normal) and the expert stacks
    ``w_gate``/``w_up`` (E, d, f) and ``w_down`` (E, f, d) in bf16
    (He-scaled), plus the shared expert's MLP.  The stacks are drawn one
    expert at a time, so no f32 copy of a whole stack is ever held."""
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    scale = (2.0 / (d + f)) ** 0.5

    def stack(shape):
        w = torch.empty((e, *shape), dtype=torch.bfloat16, device=device)
        for i in range(e):
            w[i] = (torch.randn(shape, generator=generator, device=device,
                                dtype=torch.float32) * scale)
        return w

    p = {"router": torch.randn((d, e), generator=generator, device=device,
                               dtype=torch.float32) * 0.02,
         "w_gate": stack((d, f)),
         "w_up": stack((d, f)),
         "w_down": stack((f, d))}
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(d, cfg.d_ff_expert * cfg.n_shared_experts,
                               generator=generator, device=device)
    return p


def _capacity(cfg, n_tokens: int, n_experts: int) -> int:
    c = int(cfg.top_k * n_tokens / n_experts * cfg.capacity_factor)
    return max(8, c)


def _route(params, cfg, xt):
    """xt: (T, D) -> (top_w (T, k) f32, top_e (T, k) int64, aux loss).
    The router is cast to the activations' dtype at use and the product
    accumulates in f32, as the reference's ``preferred_element_type``."""
    e, k = cfg.n_experts, cfg.top_k
    t = xt.shape[0]
    router = params["router"].to(xt.dtype)
    logits = torch.matmul(xt.to(torch.float32), router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(0)
    # adds of 1.0 are exact in any order
    ce = torch.zeros((e,), dtype=torch.float32, device=xt.device) \
        .index_add_(0, top_e.reshape(-1),
                    torch.ones((t * k,), dtype=torch.float32,
                               device=xt.device)) / (t * k)
    aux = e * torch.sum(me * ce)
    return top_w, top_e, aux


def _dispatch_compute_combine(cfg, xt, top_w, top_e, w_gate, w_up, w_down,
                              *, cap: int):
    """Sort-dispatch every assignment onto the expert stack, run the
    SwiGLU experts, combine back to (T, D) in the input's dtype."""
    t, d = xt.shape
    k = cfg.top_k
    e = cfg.n_experts
    dev = xt.device

    flat_e = top_e.reshape(-1)
    flat_w = top_w.reshape(-1).to(torch.float32)
    n = t * k
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    tok_sorted = order // k
    w_sorted = flat_w[order]

    # a segment starts where its expert id first appears in the sorted ids
    idx = torch.arange(n, device=dev)
    pos_in_e = idx - torch.searchsorted(e_sorted, e_sorted)
    keep = pos_in_e < cap

    slot_e = torch.where(keep, e_sorted, 0)
    slot_c = torch.where(keep, pos_in_e, 0)
    w_eff = torch.where(keep, w_sorted, 0.0)

    contrib_in = torch.where(keep[:, None], xt[tok_sorted],
                             torch.zeros((), dtype=xt.dtype, device=dev))
    expert_in = torch.zeros((e, cap, d), dtype=xt.dtype, device=dev)
    # one real row per slot plus exact zeros (the dropped rows at (0, 0)):
    # exact in any order
    expert_in.index_put_((slot_e, slot_c), contrib_in, accumulate=True)

    g = bf16_matmul(expert_in, w_gate.to(xt.dtype))
    u = bf16_matmul(expert_in, w_up.to(xt.dtype))
    g = F.silu(g.to(torch.float32)).to(xt.dtype)
    expert_out = bf16_matmul(g * u, w_down.to(xt.dtype))

    contrib = expert_out[slot_e, slot_c].to(torch.float32) * w_eff[:, None]
    # back to (T, k) in ascending expert order per token (the sort is
    # stable and token-major, so a token's rows arrive by expert id); the
    # inverse permutation is a scatter of distinct indices
    inv = torch.empty_like(order).scatter_(0, order, idx)
    tok_rank = torch.argsort(top_e, dim=-1, stable=True)
    per_tok = contrib[inv].reshape(t, k, d)
    per_tok = torch.gather(per_tok, 1,
                           tok_rank[:, :, None].expand(t, k, d))
    out = torch.zeros((t, d), dtype=torch.float32, device=dev)
    for j in range(k):
        out = out + per_tok[:, j]
    return out.to(xt.dtype)


def moe_apply(params, cfg, x):
    """x: (B, S, D) -> (out (B, S, D), aux loss f32 scalar).  The capacity
    is taken over all B * S tokens, frozen and pad rows included, as in
    the reference, so a token's output depends on its batch only through
    which assignments overflow."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    top_w, top_e, aux = _route(params, cfg, xt)
    cap = _capacity(cfg, b * s, cfg.n_experts)
    out = _dispatch_compute_combine(cfg, xt, top_w, top_e, params["w_gate"],
                                    params["w_up"], params["w_down"],
                                    cap=cap).reshape(b, s, d)
    if cfg.n_shared_experts:
        shared = mlp_apply(params["shared"], xt, act=cfg.act,
                           quant_mode=cfg.quant_mode,
                           quant_backend=cfg.quant_backend)
        out = out + shared.reshape(b, s, d)
    return out, aux
