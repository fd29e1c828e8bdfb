"""phi-3-vision-4.2b [vlm]: 32L, d_model 3072, 32H (kv=32), d_ff 8192,
vocab 32064 — phi3-mini backbone + CLIP frontend (STUB: ``input_specs``
provides precomputed patch embeddings, per the brief).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32_064,
    block_pattern=(LayerSpec(mixer="attn", attn_kind="full", ffn="mlp"),),
    n_patches=576,            # stub CLIP-ViT-L/14 336px patch count
    rope_theta=10_000.0,
    act="silu",
    tie_embeddings=False,
)
