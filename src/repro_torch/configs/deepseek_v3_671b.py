"""deepseek-v3-671b [moe]: 61L, d_model 7168, 128H (MLA), expert d_ff
2048, vocab 129280, MoE 256 routed top-8 + 1 shared.
[arXiv:2412.19437; hf]

Faithful structure: first 3 layers dense (d_ff 18432), remaining 58 MoE;
MLA with q_lora 1536 / kv_lora 512 / rope 64 / nope 128 / v 128.
MTP (multi-token prediction) is a training-objective add-on, exposed via
``repro_torch.train.step``'s ``mtp_weight`` option rather than the config.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

_DENSE = LayerSpec(mixer="attn", attn_kind="mla", ffn="mlp")
_MOE = LayerSpec(mixer="attn", attn_kind="mla", ffn="moe")

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18432,                 # the 3 dense layers
    vocab_size=129_280,
    prefix_pattern=(_DENSE, _DENSE, _DENSE),
    block_pattern=(_MOE,),
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    n_experts=256,
    n_shared_experts=1,
    top_k=8,
    d_ff_expert=2048,
    rope_theta=10_000.0,
    act="silu",
    tie_embeddings=False,
)
