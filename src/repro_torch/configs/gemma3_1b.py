"""gemma3-1b [dense]: 26L, d_model 1152, 4H GQA kv=1 (MQA), d_ff 6912,
vocab 262144 — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

Layer pattern: repeating block of 5 sliding-window (local) layers + 1
global layer; 26 = 4×6 + 2 trailing local layers.  Local layers use the
short RoPE base, global layers the long base (gemma3 convention).
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

_LOCAL = LayerSpec(mixer="attn", attn_kind="local", ffn="mlp")
_GLOBAL = LayerSpec(mixer="attn", attn_kind="full", ffn="mlp")

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    block_pattern=(_LOCAL,) * 5 + (_GLOBAL,),
    suffix_pattern=(_LOCAL, _LOCAL),
    sliding_window=512,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    act="gelu",
    qk_norm=True,
    tie_embeddings=True,
    emb_scale_by_sqrt_dim=True,
)
