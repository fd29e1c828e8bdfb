"""whisper-base [audio]: 6L enc + 6L dec, d_model 512, 8H, d_ff 2048,
vocab 51865 — encoder-decoder; conv frontend STUB (``input_specs``
provides precomputed frame embeddings (B, 1500, 512)).
[arXiv:2212.04356; unverified]"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,                  # decoder layers
    n_enc_layers=6,
    enc_seq_len=1500,            # 30 s of audio at 50 Hz after the conv stub
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51_865,
    block_pattern=(LayerSpec(mixer="attn", attn_kind="full", ffn="mlp"),),
    act="gelu",
    tie_embeddings=True,
)
