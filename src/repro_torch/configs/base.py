"""Model configuration schema + registry (the port's own copy).

Mirrors ``repro.configs.base`` field for field (attention + MLP stacks,
MLA, MoE, the Mamba2 SSD mixer, the encoder-decoder and the VLM), so one
configuration value means the same thing in both packages.  Differences:

* ``quant_backend`` takes ``"torch"`` (plain PyTorch formulas, the
  counterpart of the reference's ``"xla"``) or ``"cuda"`` (the
  hand-written Hopper kernels, the counterpart of ``"pallas"``);
* ``attn_impl`` keeps ``"chunked" | "flash"``; ``"flash"`` routes the
  training forward and backward, prefill and paged decode attention
  through the CUDA kernels on the card.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Sequence

__all__ = ["ModelConfig", "LayerSpec", "QUANT_MODES", "get_config",
           "reduced", "spec_split", "ARCH_NAMES"]

# QuantLinear execution modes a draft model may run under; the verifier
# of a self-speculative pair is always "dense" (accepted tokens must be
# exactly what the dense model would have emitted)
QUANT_MODES = ("dense", "qat", "w8a8_nibble", "w4a8_nibble", "lut")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer's composition inside the (possibly heterogeneous) stack."""
    mixer: str = "attn"       # "attn" | "mamba" | "none"
    attn_kind: str = "full"   # "full" | "local" | "mla" (when mixer=attn)
    ffn: str = "mlp"          # "mlp" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # layer stack = prefix + block * n + suffix
    block_pattern: Sequence[LayerSpec] = (LayerSpec(),)
    prefix_pattern: Sequence[LayerSpec] = ()
    suffix_pattern: Sequence[LayerSpec] = ()

    # attention
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_local: float = 10_000.0
    sliding_window: int = 0            # for attn_kind="local"
    attn_logit_softcap: float = 0.0
    attn_scale: float = 0.0            # 0 => 1/sqrt(head_dim)

    # MLA (deepseek)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_width: int = 4
    ssm_chunk: int = 256

    # encoder-decoder
    n_enc_layers: int = 0
    enc_seq_len: int = 0               # stub-frontend frame count (whisper)

    # VLM
    n_patches: int = 0                 # stub-frontend patch count

    # activations / embeddings
    act: str = "silu"                  # "silu" (SwiGLU) | "gelu" (GeGLU)
    tie_embeddings: bool = True
    emb_scale_by_sqrt_dim: bool = False

    # execution
    quant_mode: str = "dense"          # QuantLinear mode for projections
    quant_backend: str = "torch"       # "torch" | "cuda"
    remat: bool = True                 # recompute each layer in backward
    norm_eps: float = 1e-6
    attn_impl: str = "chunked"         # "chunked" | "flash"
    kv_cache_dtype: str = "bf16"       # "bf16" | "int8" (symmetric int8
    #   per (token, head) with f32 scales; MLA caches stay bf16)
    cache_mode: str = "dense"          # "dense" | "paged"
    page_size: int = 16                # tokens per KV page (paged mode)
    num_pages: int = 0                 # pool size incl. the trash page;
    #   0 = slots × max_len / page_size + 1

    @property
    def layer_specs(self) -> list[LayerSpec]:
        """The fully unrolled layer stack."""
        n_fixed = len(self.prefix_pattern) + len(self.suffix_pattern)
        n_rep = self.n_layers - n_fixed
        if n_rep % len(self.block_pattern):
            raise ValueError(
                f"{self.name}: {n_rep} repeated layers not divisible by "
                f"block of {len(self.block_pattern)}")
        blocks = n_rep // len(self.block_pattern)
        return (list(self.prefix_pattern)
                + list(self.block_pattern) * blocks
                + list(self.suffix_pattern))

    @property
    def n_blocks(self) -> int:
        n_fixed = len(self.prefix_pattern) + len(self.suffix_pattern)
        return (self.n_layers - n_fixed) // len(self.block_pattern)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def d_inner(self) -> int:          # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self, active_only: bool = False) -> int:
        """Analytical parameter count (``models.params``): every expert,
        or with ``active_only`` those a token runs through."""
        from repro_torch.models.params import count_params_analytical
        return count_params_analytical(self, active_only=active_only)


ARCH_NAMES = [
    "gemma3_1b", "gemma_7b", "qwen3_4b", "yi_6b", "mamba2_780m",
    "phi3_vision_4_2b", "whisper_base", "deepseek_v3_671b",
    "llama4_maverick_400b_a17b", "jamba_v0_1_52b",
]

_ALIASES = {
    "gemma3-1b": "gemma3_1b",
    "gemma-7b": "gemma_7b",
    "qwen3-4b": "qwen3_4b",
    "yi-6b": "yi_6b",
    "mamba2-780m": "mamba2_780m",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
    "whisper-base": "whisper_base",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}


def get_config(name: str, **overrides) -> ModelConfig:
    mod_name = _ALIASES.get(name, name)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    cfg: ModelConfig = mod.CONFIG
    return cfg.replace(**overrides) if overrides else cfg


def spec_split(cfg: ModelConfig, draft_mode: str | None = None
               ) -> tuple[ModelConfig, ModelConfig]:
    """``(draft_cfg, verify_cfg)`` for self-speculative decoding: two
    execution modes over the same weights and the same KV pools.  The
    draft keeps every serving knob of ``cfg`` under ``draft_mode``
    (default: ``cfg.quant_mode``, the quantized deployment drafting for
    itself); the verifier is ``cfg`` pinned to ``quant_mode="dense"``."""
    draft = draft_mode or cfg.quant_mode
    if draft not in QUANT_MODES:
        raise ValueError(f"unknown draft quant mode {draft!r}; expected "
                         f"one of {QUANT_MODES}")
    return cfg.replace(quant_mode=draft), cfg.replace(quant_mode="dense")


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant: same family & layer pattern, tiny dimensions
    (the reference's rules)."""
    kw = dict(
        n_layers=len(cfg.prefix_pattern) + len(cfg.block_pattern)
        + len(cfg.suffix_pattern),
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
    )
    if cfg.n_experts:
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2), d_ff_expert=64)
    if cfg.q_lora_rank or cfg.kv_lora_rank:
        kw.update(q_lora_rank=32, kv_lora_rank=16, qk_rope_dim=8,
                  qk_nope_dim=8, v_head_dim=16)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.sliding_window:
        kw.update(sliding_window=8)
    if cfg.n_enc_layers:
        kw.update(n_enc_layers=2, enc_seq_len=32)
        kw["n_layers"] = 2
    if cfg.n_patches:
        kw.update(n_patches=8)
    return cfg.replace(**kw)
