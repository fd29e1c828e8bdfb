"""Port parity for the model layer: the weight bridge, ``forward``,
``prefill`` and ``decode_step`` over dense and paged caches, on reduced
yi-6b (2 layers, untied head) and reduced qwen3-4b (qk_norm, tied head),
in ``dense`` and ``w8a8_nibble``, with chunked and flash attention.

Logit tolerance LOGIT_ATOL = 0.08: both packages compute the same
function, but XLA and torch round f32 ``sin``/``cos``/``exp`` differently
in the last ulp (measured on this CPU: ~3-6% of RoPE table entries), which
flips some bf16 roundings of activations and, in w8a8, some int8
roundings; yi-6b's logits are themselves bf16 (ulp 2**-6 for |x| in
[2, 4)), so the measured difference is up to ~3 logit ulps.  Exact:
the bridged weights, and layer 0's V cache (no RoPE before it).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro import models as jmodels
from repro_torch.configs import get_config, reduced
from repro_torch.models import (
    decode_step,
    forward,
    init_caches,
    load_jax_params,
    merge_slot_caches,
    merge_slot_paged_caches,
    model_init,
    prefill,
)

torch.set_num_threads(1)

LOGIT_ATOL = 0.08

# the reference's entry points, compiled whole (eager op-by-op dispatch
# compiles every small op separately and dominates the test time)
jmodel_init = jax.jit(jmodels.model_init, static_argnums=1)
jforward = jax.jit(jmodels.forward, static_argnums=1)
jprefill = jax.jit(jmodels.prefill, static_argnums=1,
                   static_argnames=("max_len",))
jdecode = jax.jit(jmodels.decode_step, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _jax_params(arch, n_layers):
    """Reference weights (independent of the execution knobs) and their
    numpy tree, built once per architecture."""
    cfg = jreduced(jget_config(arch)).replace(n_layers=n_layers)
    jp = jmodel_init(jax.random.PRNGKey(0), cfg)
    return jp, jax.tree_util.tree_map(
        lambda a: np.array(a.astype(jnp.float32)), jp)


def _pair(arch, **over):
    over.setdefault("n_layers", 2)
    jcfg = jreduced(jget_config(arch)).replace(**over)
    tcfg = reduced(get_config(arch)).replace(**over)
    jp, tree = _jax_params(arch, over["n_layers"])
    return jcfg, jp, tcfg, load_jax_params(tree, tcfg, device="cpu")


def _close(got, want, atol=LOGIT_ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


# every knob on yi-6b; qwen3-4b (qk_norm, tied f32 head) once per mode
CASES = [("yi-6b", mode, impl) for mode in ("dense", "w8a8_nibble")
         for impl in ("chunked", "flash")] + [
    ("qwen3-4b", "dense", "chunked"), ("qwen3-4b", "w8a8_nibble", "flash")]
DECODE_CASES = [("yi-6b", mode, cache) for mode in ("dense", "w8a8_nibble")
                for cache in ("dense", "paged")] + [
    ("qwen3-4b", "w8a8_nibble", "paged")]


def test_bridge_copies_weights_exactly():
    jcfg, jp, tcfg, tp = _pair("yi-6b", n_layers=3)
    assert len(tp["layers"]) == 3
    blk = jp["stack"]["blocks"]["0"]
    for i in range(3):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(
                tp["layers"][i]["attn"][name]["w"].float().numpy(),
                np.asarray(blk["attn"][name]["w"][i].astype(jnp.float32)))
        np.testing.assert_array_equal(
            tp["layers"][i]["mlp"]["down"]["w"].float().numpy(),
            np.asarray(blk["mlp"]["down"]["w"][i].astype(jnp.float32)))
    np.testing.assert_array_equal(
        tp["lm_head"]["w"].float().numpy(),
        np.asarray(jp["lm_head"]["w"].astype(jnp.float32)))
    assert tp["final_norm"]["scale"].dtype == torch.float32


def test_model_init_is_seeded_and_prepares_weights():
    cfg = reduced(get_config("yi-6b")).replace(quant_mode="w8a8_nibble")
    a = model_init(cfg, seed=3, device="cpu")
    b = model_init(cfg, seed=3, device="cpu")
    wq = a["layers"][0]["attn"]["wq"]
    assert torch.equal(wq["w"], b["layers"][0]["attn"]["wq"]["w"])
    assert wq["qt8"].shape == (cfg.n_heads * cfg.head_dim, cfg.d_model)
    assert wq["qt8"].dtype == torch.int8


@pytest.mark.parametrize("arch,mode,impl", CASES)
def test_forward_logits_match(arch, mode, impl):
    jcfg, jp, tcfg, tp = _pair(arch, quant_mode=mode, attn_impl=impl)
    toks = np.random.default_rng(0).integers(0, 256, (2, 11)).astype(np.int32)
    want, _ = jforward(jp, jcfg, jnp.asarray(toks))
    got, aux = forward(tp, tcfg, torch.from_numpy(toks))
    assert float(aux) == 0.0
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("arch,mode,cache_mode", DECODE_CASES)
def test_prefill_then_decode_match(arch, mode, cache_mode):
    """Prefill two prompts (padded, per-row logits_index), grow to the
    decode budget, move them into a 3-slot cache (slab rows or pages) and
    run decode steps at per-slot positions, with flash attention (the
    paged kernel's plain version on the paged path)."""
    over = dict(quant_mode=mode, attn_impl="flash", cache_mode=cache_mode,
                page_size=4)
    jcfg, jp, tcfg, tp = _pair(arch, **over)
    rng = np.random.default_rng(1)
    max_len, pad = 16, 8
    lens = [5, 8]
    prompts = np.zeros((2, pad), np.int32)
    for i, n in enumerate(lens):
        prompts[i, :n] = rng.integers(0, 256, n)

    # JAX: prefill each prompt alone, merge into slots 0 and 2
    from repro.models import init_caches as jinit_caches
    from repro.models import merge_slot_caches as jmerge
    from repro.models import merge_slot_paged_caches as jmerge_paged
    jcaches = jinit_caches(jcfg, 3, max_len)
    tcaches = init_caches(tcfg, 3, max_len, device="cpu")
    table = np.zeros((3, max_len // 4), np.int32)
    table[0, :4] = [1, 2, 3, 4]
    table[2, :4] = [5, 6, 7, 8]
    grow = max_len if cache_mode == "dense" else pad
    for slot, row in ((0, 0), (2, 1)):
        p = prompts[row:row + 1]
        jl, jone, _ = jprefill(jp, jcfg, jnp.asarray(p), max_len=grow,
                               logits_index=lens[row] - 1)
        tl, tone = prefill(tp, tcfg, torch.from_numpy(p), max_len=grow,
                           logits_index=lens[row] - 1)
        _close(tl, jl)
        v_j = np.asarray(jone["blocks"]["0"]["attn"]["v"][0]
                         .astype(jnp.float32))
        np.testing.assert_array_equal(tone[0]["v"].float().numpy(), v_j)
        _close(tone[0]["k"].float().numpy(),
               np.asarray(jone["blocks"]["0"]["attn"]["k"][0]
                          .astype(jnp.float32)), atol=2e-2)
        if cache_mode == "dense":
            jcaches = jmerge(jcaches, jone, slot)
            merge_slot_caches(tcaches, tone, slot)
        else:
            jcaches = jmerge_paged(jcaches, jone, slot,
                                   jnp.asarray(table[slot]))
            merge_slot_paged_caches(tcaches, tone, slot,
                                    torch.from_numpy(table[slot]))

    pos = np.array([lens[0], 3, lens[1]], np.int32)
    tok = rng.integers(0, 256, (3, 1)).astype(np.int32)
    page_j = jnp.asarray(table) if cache_mode == "paged" else None
    page_t = torch.from_numpy(table) if cache_mode == "paged" else None
    for _ in range(3):
        jl, jcaches = jdecode(jp, jcfg, jnp.asarray(tok), jcaches,
                              jnp.asarray(pos), page_table=page_j)
        tl, tcaches = decode_step(tp, tcfg, torch.from_numpy(tok), tcaches,
                                  torch.from_numpy(pos), page_table=page_t)
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        pos = pos + 1


def test_first_layer_integer_path_exact():
    """Embedding -> RMSNorm -> per-tensor int8 activations -> the wq
    nibble accumulator: every integer on the way is bit-identical."""
    from repro.core import linear as jlin
    from repro.core import quantize as jq
    from repro.models.layers import embed_apply as jembed
    from repro.models.layers import rms_norm as jrms
    from repro_torch.core import quantize as tq
    from repro_torch.kernels.nibble_matmul import nibble_matmul_plain
    from repro_torch.models.layers import embed_apply, rms_norm
    jcfg, jp, tcfg, tp = _pair("yi-6b", quant_mode="w8a8_nibble")
    toks = np.random.default_rng(3).integers(0, 256, (2, 9)).astype(np.int32)
    blk = jax.tree_util.tree_map(lambda a: a[0], jp["stack"]["blocks"]["0"])
    jh = jrms(blk["mixer_norm"], jembed(jp["embed"], jnp.asarray(toks)))
    jx = jq.quantize(jh.astype(jnp.float32), granularity="per_tensor")
    jw = jq.quantize(blk["attn"]["wq"]["w"].astype(jnp.float32),
                     granularity="per_channel", axis=0)
    jacc = jlin.nibble_matmul_xla(jx.values, jw.values)
    layer = tp["layers"][0]
    th = rms_norm(layer["mixer_norm"],
                  embed_apply(tp["embed"], torch.from_numpy(toks)))
    tx = tq.quantize(th.float(), granularity="per_tensor")
    np.testing.assert_array_equal(tx.values.numpy(), np.asarray(jx.values))
    tacc = nibble_matmul_plain(tx.values, layer["attn"]["wq"]["qt8"].t())
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))


def test_scalar_index_decode_matches():
    """Lockstep decode (one scalar write position for the whole batch)."""
    jcfg, jp, tcfg, tp = _pair("yi-6b", quant_mode="w8a8_nibble")
    toks = np.random.default_rng(2).integers(0, 256, (2, 6)).astype(np.int32)
    jl, jc, _ = jprefill(jp, jcfg, jnp.asarray(toks), max_len=10)
    tl, tc = prefill(tp, tcfg, torch.from_numpy(toks), max_len=10)
    _close(tl, jl)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    jl, _ = jdecode(jp, jcfg, jnp.asarray(nxt), jc, 6)
    tl, _ = decode_step(tp, tcfg, torch.from_numpy(nxt), tc, 6)
    _close(tl, jl)


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_forward_gradients_with_and_without_remat(impl):
    """``forward`` is differentiable in every leaf (untied head included);
    recomputing each layer in the backward pass (remat) changes nothing."""
    grads = {}
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, 256, (2, 7)).astype(np.int64))
    for remat in (True, False):
        *_, tcfg, tp = _pair("yi-6b", attn_impl=impl, remat=remat)
        leaves = [tp["lm_head"]["w"], tp["layers"][0]["attn"]["wq"]["w"],
                  tp["layers"][1]["mixer_norm"]["scale"], tp["embed"]["emb"]]
        for t in leaves:
            t.requires_grad_(True)
        logits, _ = forward(tp, tcfg, toks)
        grads[remat] = torch.autograd.grad(logits.square().mean(), leaves)
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b) and bool(a.abs().sum() > 0)


def test_unported_layers_raise():
    cfg = reduced(get_config("yi-6b")).replace(kv_cache_dtype="int8")
    with pytest.raises(NotImplementedError):
        init_caches(cfg, 2, 8, device="cpu")
