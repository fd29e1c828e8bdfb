"""mamba2-780m [ssm]: 48L, d_model 1536, attention-free, vocab 50280,
ssm_state 128 — SSD (state-space duality).  [arXiv:2405.21060; unverified]

Pure stack of SSD mixer blocks (no FFN — mamba2 convention: the block's
expansion is inside the mixer).  d_inner = 2·1536 = 3072, head_dim 64 →
48 SSD heads, 1 B/C group.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50_280,
    block_pattern=(LayerSpec(mixer="mamba", ffn="none"),),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    conv_width=4,
    ssm_chunk=256,
    tie_embeddings=True,
)
