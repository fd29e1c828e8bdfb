"""Analytic per-device FLOPs and bytes of the flash attention kernels (port
of ``repro.roofline.attn_model``).

The reference adds these to its measured numbers because XLA's
``cost_analysis`` hides an interpret-mode Pallas grid.  The port's walk
sees every call (``kernels.ops.flash_mha`` and ``flash_mha_bwd`` report
their cost through ``ops.costed``), so here the model is a second,
independent account to hold the walk to.  It is the reference's: the
standard flash-2 accounting, probabilities never in HBM; the forward's
products ``QK^T`` and ``PV`` over the causal half of the square; in
training the remat forward and a backward of 2.5 forwards (4.5 forwards
in all); K/V streamed once per query block (the kernel's schedule).  The
port's forward kernel takes 64 query rows a block (``_BQ``).

The walk counts the costed calls' full square instead (the plain
versions' work: no causal mask subtracted) and its backward as the five
products the plain backward runs (``3 d + 2 dv`` MACs a pair), so for
``d == dv`` a training step's attention flops in the walk are twice this
model's (causal halving), and a prefill's are twice its too.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.shapes import ShapeCase

__all__ = ["flash_attn_cost"]

_BQ = 64  # query rows a forward block (csrc/flash_attention.cu)


def _per_layer(cfg: ModelConfig, b_loc: int, s: int, h_loc: int,
               kvh_loc: int, d_qk: int, d_v: int, train: bool):
    """(flops, hbm_bytes) for one attention layer on one device."""
    # FLOPs: QK^T + PV per forward = 2·2·B·H·S²·d (causal halves it)
    fwd = 2 * b_loc * h_loc * s * s * (d_qk + d_v)          # 2·(S²d) × 2 mat
    fwd = fwd // 2                                          # causal
    # backward ≈ 2.5× forward (dq, dk, dv, p-recompute ×2 passes)
    flops = fwd * (1 + 1 + 2.5) if train else fwd           # +remat fwd
    nq = max(1, s // _BQ)
    q_bytes = b_loc * s * h_loc * d_qk * 2
    kv_bytes = b_loc * s * kvh_loc * (d_qk + d_v) * 2
    o_bytes = b_loc * s * h_loc * d_v * 2
    lse = b_loc * s * h_loc * 4
    # fwd: read Q once, stream K/V once per q-row of the grid, write O.
    pass_io = q_bytes + nq * kv_bytes + o_bytes + lse
    if train:
        # primal fwd + remat fwd + bwd (reads Q,K,V,O,dO; writes dQ,dK,dV)
        io = 2 * pass_io + (q_bytes + nq * kv_bytes + 2 * o_bytes
                            + q_bytes + kv_bytes + lse)
    else:
        io = pass_io
    return flops, io


def flash_attn_cost(cfg: ModelConfig, case: ShapeCase, *,
                    dp: int = 32, tp: int = 8) -> tuple[float, float]:
    """(flops, bytes) per device for the whole model's attention under
    the flash kernels, matching the sharding rules (heads on TP when the
    KV head count divides, else replicated).  The defaults are the port's
    production mesh, (data 32, model 8)."""
    train = case.kind == "train"
    s = case.seq
    b_loc = max(1, case.batch // dp)
    total_f, total_b = 0.0, 0.0
    for spec in cfg.layer_specs:
        if spec.mixer != "attn":
            continue
        if spec.attn_kind == "mla":
            h, kvh = cfg.n_heads, cfg.n_heads
            d_qk = cfg.qk_nope_dim + cfg.qk_rope_dim
            d_v = cfg.v_head_dim
        else:
            h, kvh = cfg.n_heads, cfg.n_kv_heads
            d_qk = d_v = cfg.head_dim
        if kvh % tp == 0:
            h_loc, kvh_loc = h // tp, kvh // tp
        else:                                   # replicated heads
            h_loc, kvh_loc = h, kvh
        f, by = _per_layer(cfg, b_loc, s, h_loc, kvh_loc, d_qk, d_v, train)
        total_f += f
        total_b += by
    return total_f, total_b
