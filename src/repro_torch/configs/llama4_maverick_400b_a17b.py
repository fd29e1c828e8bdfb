"""llama4-maverick-400b-a17b [moe]: 48L, d_model 5120, 40H GQA kv=8,
expert d_ff 8192, vocab 202048 — MoE 128 experts top-1 + shared expert,
dense/MoE interleave every other layer; early-fusion multimodal (text
backbone only here, per the brief).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""

from repro_torch.configs.base import LayerSpec, ModelConfig

_DENSE = LayerSpec(mixer="attn", attn_kind="full", ffn="mlp")
_MOE = LayerSpec(mixer="attn", attn_kind="full", ffn="moe")

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,                # dense-layer FFN
    vocab_size=202_048,
    block_pattern=(_DENSE, _MOE),
    n_experts=128,
    n_shared_experts=1,
    top_k=1,
    d_ff_expert=8192,
    rope_theta=500_000.0,
    act="silu",
    tie_embeddings=False,
)
