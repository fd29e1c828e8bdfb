"""Analytical parameter counts, total and active (port of
``repro.models.params``).

Model FLOPs per trained token are 6 N (dense) or 6 N_active (MoE); the
counters walk the same layer specs ``model_init`` walks, so they agree
with the parameter trees (``tests/test_torch_params.py`` holds them to
the reference and to ``model_init`` at reduced size).
"""

from __future__ import annotations

from repro_torch.configs.base import LayerSpec, ModelConfig

__all__ = ["count_params_analytical"]


def _attn_params(cfg: ModelConfig, spec: LayerSpec) -> int:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if spec.attn_kind == "mla":
        r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
        d_qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        n = d * r_q + r_q * h * d_qk                      # q down/up
        n += d * (r_kv + cfg.qk_rope_dim)                 # kv down
        n += r_kv * h * (cfg.qk_nope_dim + cfg.v_head_dim)  # kv up
        n += h * cfg.v_head_dim * d                       # o
        return n
    return d * h * hd + 2 * d * kvh * hd + h * hd * d


def _mlp_params(d: int, f: int) -> int:
    return 3 * d * f


def _moe_params(cfg: ModelConfig, active: bool) -> int:
    d, f = cfg.d_model, cfg.d_ff_expert
    e_used = cfg.top_k if active else cfg.n_experts
    n = e_used * _mlp_params(d, f)
    n += cfg.n_shared_experts * _mlp_params(d, f)
    if not active:
        n += d * cfg.n_experts                            # router
    return n


def _mamba_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    d_in = cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_ch = d_in + 2 * g * n
    total = d * (2 * d_in + 2 * g * n + h)                # in_proj
    total += cfg.conv_width * conv_ch + conv_ch           # conv
    total += 3 * h + d_in                                 # A, D, dt_bias, norm
    total += d_in * d                                     # out_proj
    return total


def count_params_analytical(cfg: ModelConfig, active_only: bool = False) -> int:
    total = cfg.vocab_size * cfg.d_model                  # embedding
    if not cfg.tie_embeddings:
        total += cfg.d_model * cfg.vocab_size

    def layer(spec: LayerSpec) -> int:
        n = 0
        if spec.mixer == "attn":
            n += _attn_params(cfg, spec)
        elif spec.mixer == "mamba":
            n += _mamba_params(cfg)
        if spec.ffn == "moe":
            n += _moe_params(cfg, active_only)
        elif spec.ffn == "mlp":
            n += _mlp_params(cfg.d_model, cfg.d_ff)
        if cfg.is_encdec:                                  # cross attention
            n += _attn_params(cfg, LayerSpec())
        return n

    total += sum(layer(s) for s in cfg.layer_specs)

    if cfg.is_encdec:  # encoder stack (self-attn + mlp, no cross)
        enc_layer = _attn_params(cfg, LayerSpec()) \
            + _mlp_params(cfg.d_model, cfg.d_ff)
        total += cfg.n_enc_layers * enc_layer
    return total
