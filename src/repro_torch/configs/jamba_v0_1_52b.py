"""jamba-v0.1-52b [hybrid]: 32L, d_model 4096, 32H GQA kv=8, d_ff 14336,
vocab 65536 — Mamba+attention 1:7 interleave, MoE 16 experts top-2 every
other layer.  [arXiv:2403.19887; hf]

Block of 8 layers: attention at in-block index 4, Mamba elsewhere; MoE
FFN on odd in-block indices, dense FFN on even (the paper's e=2, a=8
configuration).  Jamba's Mamba layers use state 16.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig


def _spec(i: int) -> LayerSpec:
    mixer = "attn" if i == 4 else "mamba"
    ffn = "moe" if i % 2 == 1 else "mlp"
    return LayerSpec(mixer=mixer, attn_kind="full", ffn=ffn)


CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65_536,
    block_pattern=tuple(_spec(i) for i in range(8)),
    n_experts=16,
    n_shared_experts=0,
    top_k=2,
    d_ff_expert=14336,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    conv_width=4,
    ssm_chunk=256,
    act="silu",
    tie_embeddings=False,
)
