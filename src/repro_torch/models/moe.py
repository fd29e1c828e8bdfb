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

Expert parallelism (:func:`moe_apply_shards`) splits the expert stacks
over the model shards by expert and keeps tp=1's values bit for bit: the
router runs once per distinct device, each shard dispatches and runs only
its own experts (every other assignment dropped), the shards' per-
assignment rows (each non-zero on exactly one shard) are summed, which is
exact, and the ordered combine runs once per distinct device.  This is
the reference engine's semantics: its engine installs no ambient mesh,
so GSPMD partitions ``_moe_local`` by expert and its tp=2 streams equal
its tp=1's.  The reference's ``_moe_sharded`` (a ``shard_map`` that sums
each shard's bf16 output with ``psum``) runs only under its dry run's
ambient mesh, and is not this path.

:func:`moe_apply_mesh` is that ``_moe_sharded``, the semantics of the
reference's training step over a mesh and of its dry run's serving
steps (the two places it sets the ambient mesh), where the experts
divide the model shards: each data row routes its own tokens (all of
them where the rows do not divide the batch), with the capacity taken
over its own token count; each model shard runs its ``E / tp`` experts
and combines their rows to a bf16 output; the shards' bf16 outputs are
summed in shard order.  Its aux loss is the value of data row 0's
routing (the reference's ``out_specs=P()`` returns one shard's value)
and carries the gradient of the rows' mean (what the reference's
transpose of that output gives each row); without gradients (the
serving steps under the mesh semantics, the reference's dry-run
``prefill`` and ``decode_step``) it is row 0's value alone, and nothing
crosses the data axis for it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.linear import linear_apply_row
from repro_torch.distributed.collectives import all_reduce_sum, \
    per_device, reduce_sum
from repro_torch.models.layers import bf16_matmul, mlp_apply, mlp_hidden, \
    mlp_init

__all__ = ["moe_init", "moe_apply", "moe_apply_shards", "moe_apply_mesh"]


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


def _sort(top_e):
    """The stable sort of the (token, k) assignments by expert id
    (token-major within an expert): ``order`` and the sorted ids."""
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    return order, flat_e[order]


def _expert_rows(cfg, xt, top_w, top_e, sort, w_gate, w_up, w_down, *,
                 cap: int, e_lo: int = 0):
    """Sort-dispatch the assignments of experts ``[e_lo, e_lo + E_s)`` (the
    stacks' experts, E_s = ``w_gate.shape[0]``) onto the stacks, run the
    SwiGLU experts and return each assignment's weighted output row
    ``(T * k, D)`` f32 in sorted order: zero where the assignment was
    dropped (past its expert's capacity, or another shard's expert).
    Segments and positions are over every expert's sorted ids, so each
    expert keeps tp=1's segment and capacity drops."""
    t, d = xt.shape
    k = cfg.top_k
    dev = xt.device
    order, e_sorted = sort
    flat_w = top_w.reshape(-1).to(torch.float32)
    n = t * k
    tok_sorted = order // k
    w_sorted = flat_w[order]

    # a segment starts where its expert id first appears in the sorted ids
    idx = torch.arange(n, device=dev)
    pos_in_e = idx - torch.searchsorted(e_sorted, e_sorted)
    keep = pos_in_e < cap
    if w_gate.shape[0] != cfg.n_experts:         # one shard's experts
        keep = keep & (e_sorted >= e_lo) \
            & (e_sorted < e_lo + w_gate.shape[0])

    slot_e = torch.where(keep, e_sorted - e_lo, 0)
    slot_c = torch.where(keep, pos_in_e, 0)
    w_eff = torch.where(keep, w_sorted, 0.0)

    contrib_in = torch.where(keep[:, None], xt[tok_sorted],
                             torch.zeros((), dtype=xt.dtype, device=dev))
    expert_in = torch.zeros((w_gate.shape[0], cap, d), dtype=xt.dtype,
                            device=dev)
    # one real row per slot plus exact zeros (the dropped rows at (0, 0)):
    # exact in any order
    expert_in.index_put_((slot_e, slot_c), contrib_in, accumulate=True)

    g = bf16_matmul(expert_in, w_gate.to(xt.dtype))
    u = bf16_matmul(expert_in, w_up.to(xt.dtype))
    g = F.silu(g.to(torch.float32)).to(xt.dtype)
    expert_out = bf16_matmul(g * u, w_down.to(xt.dtype))
    return expert_out[slot_e, slot_c].to(torch.float32) * w_eff[:, None]


def _combine(contrib, top_e, sort, dtype):
    """The sorted rows back to (T, D) in ``dtype``: each token's k rows
    summed in ascending expert order, one add at a time."""
    t, k = top_e.shape
    d = contrib.shape[-1]
    order = sort[0]
    idx = torch.arange(t * k, device=contrib.device)
    # back to (T, k) in ascending expert order per token (the sort is
    # stable and token-major, so a token's rows arrive by expert id); the
    # inverse permutation is a scatter of distinct indices
    inv = torch.empty_like(order).scatter_(0, order, idx)
    tok_rank = torch.argsort(top_e, dim=-1, stable=True)
    per_tok = contrib[inv].reshape(t, k, d)
    per_tok = torch.gather(per_tok, 1,
                           tok_rank[:, :, None].expand(t, k, d))
    out = torch.zeros((t, d), dtype=torch.float32, device=contrib.device)
    for j in range(k):
        out = out + per_tok[:, j]
    return out.to(dtype)


def _dispatch_compute_combine(cfg, xt, top_w, top_e, w_gate, w_up, w_down,
                              *, cap: int):
    """Sort-dispatch every assignment onto the expert stack, run the
    SwiGLU experts, combine back to (T, D) in the input's dtype."""
    sort = _sort(top_e)
    rows = _expert_rows(cfg, xt, top_w, top_e, sort, w_gate, w_up, w_down,
                        cap=cap)
    return _combine(rows, top_e, sort, xt.dtype)


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


def moe_apply_shards(ps: list, cfg, xs: list, layout):
    """:func:`moe_apply` over model shards: ``ps`` one MoE dict per shard
    (``layout.experts``: its ``E / tp`` experts' rows of the stacks,
    shard ``s`` holding ``[s E/tp, (s + 1) E/tp)``; else the whole
    stacks), ``xs`` the replicated input per shard.  Returns (one output
    per shard, shared by the shards on a device; aux), bit for bit
    :func:`moe_apply`'s.  Experts that do not divide the shards run
    replicated, once per distinct device, as the reference's engine runs
    its local path; the shared expert is row-parallel where its ``d_ff``
    divides (``layout.shared``), else replicated."""
    devs = [x.device for x in xs]
    b, s, d = xs[0].shape
    xts = [x.reshape(b * s, d) for x in xs]
    routes = per_device(devs, lambda i: _route(ps[i], cfg, xts[i]))
    cap = _capacity(cfg, b * s, cfg.n_experts)
    if layout.experts:
        sorts = per_device(devs, lambda i: _sort(routes[i][1]))
        rows = all_reduce_sum([
            _expert_rows(cfg, xts[i], routes[i][0], routes[i][1], sorts[i],
                         p["w_gate"], p["w_up"], p["w_down"], cap=cap,
                         e_lo=i * p["w_gate"].shape[0])
            for i, p in enumerate(ps)])
        outs = per_device(devs, lambda i: _combine(
            rows[i], routes[i][1], sorts[i], xs[i].dtype))
    else:
        outs = per_device(devs, lambda i: _dispatch_compute_combine(
            cfg, xts[i], routes[i][0], routes[i][1], ps[i]["w_gate"],
            ps[i]["w_up"], ps[i]["w_down"], cap=cap))
    if cfg.n_shared_experts:
        act = dict(act=cfg.act, quant_mode=cfg.quant_mode,
                   quant_backend=cfg.quant_backend)
        if layout.shared:
            shared = linear_apply_row(
                [p["shared"]["down"] for p in ps],
                [mlp_hidden(p["shared"], xt, **act)
                 for p, xt in zip(ps, xts)],
                mode=cfg.quant_mode, backend=cfg.quant_backend)
        else:
            shared = per_device(devs, lambda i: mlp_apply(
                ps[i]["shared"], xts[i], **act))
        outs = per_device(devs, lambda i: outs[i] + shared[i])
    return per_device(devs, lambda i: outs[i].reshape(b, s, d)), \
        routes[0][2]


def _shared_rows(ps: list, cfg, xts: list, layout) -> list:
    """The shared expert over one row's shards (flat tokens ``xts``):
    row-parallel where its ``d_ff`` divides, else once per device."""
    act = dict(act=cfg.act, quant_mode=cfg.quant_mode,
               quant_backend=cfg.quant_backend)
    if layout.shared:
        return linear_apply_row(
            [p["shared"]["down"] for p in ps],
            [mlp_hidden(p["shared"], xt, **act) for p, xt in zip(ps, xts)],
            mode=cfg.quant_mode, backend=cfg.quant_backend)
    devs = [x.device for x in xts]
    return per_device(devs, lambda i: mlp_apply(ps[i]["shared"], xts[i],
                                                **act))


def moe_apply_mesh(ps: list, cfg, hs: list, layout):
    """The reference's ``_moe_sharded`` over a mesh (``layout.experts``):
    ``ps[d][m]`` entry ``(d, m)``'s MoE dict (its shard's experts),
    ``hs[d][m]`` data row ``d``'s input, replicated over its shards (the
    rows hold their own tokens).  Returns (outputs ``[d][m]``, aux): the
    outputs as the module docstring says, the aux on entry ``(0, 0)``'s
    device, valued as row 0's with the gradient of the rows' mean."""
    auxes, outs = [], []
    for pr, xr in zip(ps, hs):
        devs = [x.device for x in xr]
        b, s, d = xr[0].shape
        xts = [x.reshape(b * s, d) for x in xr]
        routes = per_device(devs, lambda i: _route(pr[i], cfg, xts[i]))
        sorts = per_device(devs, lambda i: _sort(routes[i][1]))
        cap = _capacity(cfg, b * s, cfg.n_experts)
        parts = [_combine(_expert_rows(
            cfg, xts[i], routes[i][0], routes[i][1], sorts[i], p["w_gate"],
            p["w_up"], p["w_down"], cap=cap, e_lo=i * p["w_gate"].shape[0]),
            routes[i][1], sorts[i], xr[i].dtype) for i, p in enumerate(pr)]
        out = all_reduce_sum(parts, devices=devs)
        if cfg.n_shared_experts:
            shared = _shared_rows(pr, cfg, xts, layout)
            out = per_device(devs, lambda i: out[i] + shared[i])
        outs.append(per_device(devs, lambda i: out[i].reshape(b, s, d)))
        auxes.append(routes[0][2])
    if len(auxes) == 1 or not torch.is_grad_enabled():
        return outs, auxes[0]
    mean = reduce_sum(auxes, axis="data",
                      devices=[row[0].device for row in hs]) / len(auxes)
    return outs, mean + (auxes[0] - mean).detach()
