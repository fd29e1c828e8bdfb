"""Model zoo (attention-only stacks): layers, GQA attention, assembly."""

from repro_torch.models.transformer import (  # noqa: F401
    decode_step,
    forward,
    init_caches,
    init_paged_caches,
    load_jax_params,
    merge_slot_caches,
    merge_slot_paged_caches,
    model_init,
    prefill,
    prepare_params,
)
