"""gemma-7b [dense]: 28L, d_model 3072, 16H (kv=16, MHA), head_dim 256,
d_ff 24576, vocab 256000 — GeGLU.  [arXiv:2403.08295; hf]"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256_000,
    block_pattern=(LayerSpec(mixer="attn", attn_kind="full", ffn="mlp"),),
    act="gelu",
    tie_embeddings=True,
    emb_scale_by_sqrt_dim=True,
)
