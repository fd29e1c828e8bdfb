"""Model configuration schema + registry (the port's own copy).

Mirrors ``repro.configs.base`` field for field for the families this
package runs, so one configuration value means the same thing in both
packages.  Differences:

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

__all__ = ["ModelConfig", "LayerSpec", "get_config", "reduced"]


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
    kv_cache_dtype: str = "bf16"       # only "bf16" is ported
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

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_ALIASES = {
    "qwen3-4b": "qwen3_4b",
    "yi-6b": "yi_6b",
}


def get_config(name: str, **overrides) -> ModelConfig:
    mod_name = _ALIASES.get(name, name)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    cfg: ModelConfig = mod.CONFIG
    return cfg.replace(**overrides) if overrides else cfg


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant: same family & layer pattern, tiny dimensions
    (the reference's rule for the dense attention families)."""
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
    if cfg.sliding_window:
        kw.update(sliding_window=8)
    return cfg.replace(**kw)
