"""Architecture configs ported so far: gemma3-1b, gemma-7b, qwen3-4b,
yi-6b, mamba2-780m, deepseek-v3-671b, llama4-maverick-400b-a17b and
jamba-v0.1-52b.  ``get_config``
accepts both the assignment ids (``yi-6b``) and module names
(``yi_6b``)."""

from repro_torch.configs.base import (  # noqa: F401
    QUANT_MODES,
    LayerSpec,
    ModelConfig,
    get_config,
    reduced,
    spec_split,
)
