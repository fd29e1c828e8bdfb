from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
)
from repro_torch.optim.schedule import (  # noqa: F401
    warmup_constant,
    warmup_cosine,
)
