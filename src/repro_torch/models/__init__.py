"""Model zoo: layers, GQA (self and cross) and MLA attention, MoE, the
Mamba2 mixer, assembly (decoder-only, encoder-decoder, VLM)."""

from repro_torch.models.transformer import (  # noqa: F401
    copy_paged_cache_page,
    decode_step,
    encode,
    extract_cache_pages,
    forward,
    init_caches,
    init_paged_caches,
    insert_cache_pages,
    load_jax_params,
    merge_slot_caches,
    merge_slot_paged_caches,
    model_init,
    prefill,
    prepare_params,
    scatter_prefill_paged_caches,
    unstack_jax_tree,
)
