from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig,
    SyntheticLM,
    host_batch_slice,
)
