"""Architecture configs ported so far.  ``get_config(name)`` accepts both
the assignment ids (``yi-6b``) and module names (``yi_6b``)."""

from repro_torch.configs.base import (  # noqa: F401
    QUANT_MODES,
    LayerSpec,
    ModelConfig,
    get_config,
    reduced,
    spec_split,
)
