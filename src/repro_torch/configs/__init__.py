"""Architecture configs, all ten of the reference's (``ARCH_NAMES``):
gemma3-1b, gemma-7b, qwen3-4b, yi-6b, mamba2-780m, phi-3-vision-4.2b,
whisper-base, deepseek-v3-671b, llama4-maverick-400b-a17b and
jamba-v0.1-52b.  ``get_config`` accepts both the assignment ids
(``yi-6b``) and module names (``yi_6b``)."""

from repro_torch.configs.base import (  # noqa: F401
    ARCH_NAMES,
    QUANT_MODES,
    LayerSpec,
    ModelConfig,
    get_config,
    reduced,
    spec_split,
)
