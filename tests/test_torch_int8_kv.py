"""Port parity for the int8 KV cache (``kv_cache_dtype="int8"``):
symmetric int8 per (token, head) with f32 scales beside K and V, written
by prefill and decode, dequantized in f32 for ``attention_core``.

Reduced yi-6b (2 layers, head_dim 16) from the reference's seed through
the weight bridge.  Tolerances, each with its reason:
* ``_q8_heads``: integers and scales exact against the reference run
  as it always runs, jitted (the same f32 ``abs``, max, product with
  the reciprocal of 127, divide and round-half-even in both packages);
* the int8 caches a prefill writes: layer 0's V rows and scales exact
  (no RoPE before them; see ``test_torch_model.py``);
* prefill and decode logits: equal bit for bit in both modes, against
  the reference compiled by ``tm.exact_jit`` (measured on a CPU: equal in
  all four cases; under int8 both packages gather and dequantize the
  pages, so no attention kernel's sum order differs.  They were held to
  0.08 in ``dense`` and 0.16 in ``w8a8_nibble`` while the reference ran
  with excess precision);
* teacher-forced int8 decode against the bf16 forward: the reference's
  rule, within 5% of the largest logit (``tests/test_serve.py``);
* engine streams inside the port (paged against the dense slab, the host
  swap against replay, speculative decoding against the plain engine, in
  ``dense``): token for token, as ``tests/test_paging.py`` holds the
  reference;
* against the reference engine (its stages compiled by
  ``tm.exact_engine``): ``test_torch_engine.py``'s tie rule;
* refusals: the reference's messages, word for word.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.engine as jengine
import test_torch_engine as te
import test_torch_model as tm
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import attention as jattn
from repro.models import init_caches as jinit_caches
from repro.models import merge_slot_caches as jmerge
from repro.models import merge_slot_paged_caches as jmerge_paged
from repro_torch.configs import get_config, reduced
from repro_torch.models import (
    decode_step,
    extract_cache_pages,
    forward,
    init_caches,
    insert_cache_pages,
    merge_slot_caches,
    merge_slot_paged_caches,
    model_init,
    prefill,
)
from repro_torch.models import attention as tattn
from repro_torch.serve import Engine, ServeConfig

torch.set_num_threads(1)

INT8 = dict(kv_cache_dtype="int8")


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config("yi-6b")).replace(**INT8)
    return cfg, model_init(cfg, device="cpu")


def _serve(cfg, params, prompts, n_new, **over):
    kw = dict(batch=3, max_len=16, prefill_len=8, decode_chunk=3,
              cache_mode="paged", page_size=4)
    kw.update(over)
    engine = Engine(cfg, params, ServeConfig(**kw), device="cpu")
    ids = [engine.submit(p, n_new) for p in prompts]
    done = engine.run()
    engine.release_prefix_cache()
    assert engine.leaked_pages() == 0
    return engine, [done[i].tokens for i in ids]


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  np.asarray(want, np.float32))


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# The quantizer and the caches
# ---------------------------------------------------------------------------

def test_q8_heads_integer_exact():
    """Per (token, head) over the last axis: random rows, a zero row (the
    1e-8 floor), rows with ties at .5 steps and a row at the clip."""
    rng = np.random.default_rng(0)
    t = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3
    t[0, 0, 0] = 0.0
    t[0, 1, 1] = np.arange(16, dtype=np.float32) - 7.5    # .5-step ties
    t[1, 2, 2, 0] = -127.0
    t[1, 2, 2, 1:] = 127.0 * rng.uniform(-1, 1, 15)
    for dtype in (jnp.float32, jnp.bfloat16):
        x = jnp.asarray(t, dtype)
        jq, js = jax.jit(jattn._q8_heads)(x)
        tq, ts = tattn._q8_heads(torch.from_numpy(
            np.asarray(x.astype(jnp.float32))).to(
                torch.float32 if dtype == jnp.float32 else torch.bfloat16))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        assert ts.shape == (2, 5, 3, 1)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("cache_mode", ["dense", "paged"])
def test_int8_caches_have_the_reference_layout(cache_mode):
    cfg = reduced(get_config("yi-6b")).replace(
        cache_mode=cache_mode, page_size=4, **INT8)
    jcfg = jreduced(jget_config("yi-6b")).replace(
        cache_mode=cache_mode, page_size=4, **INT8)
    caches = init_caches(cfg, 2, 16, device="cpu")
    ref = jinit_caches(jcfg, 2, 16)["blocks"]["0"]["attn"]
    for c in caches:
        assert set(c) == set(ref)
        for key, leaf in c.items():
            assert tuple(leaf.shape) == ref[key].shape[1:], key
            assert str(leaf.dtype).split(".")[-1] == str(ref[key].dtype)


def test_bytes_ratio_counts_the_scales():
    """bf16 over int8 cache bytes: 2 / (1 + 4 / head_dim), 1.6 at the
    reduced head_dim 16 (above the reference's 1.55), in the caches and
    in the engine's ``cache_token_bytes``."""
    cfg = reduced(get_config("yi-6b"))
    params = model_init(cfg, device="cpu")

    def nbytes(c):
        return sum(t.numel() * t.element_size() for layer in c
                   for t in layer.values())

    big = init_caches(cfg, 2, 512, device="cpu")
    small = init_caches(cfg.replace(**INT8), 2, 512, device="cpu")
    ratio = nbytes(big) / nbytes(small)
    assert ratio > 1.55
    assert abs(ratio - 2 / (1 + 4 / cfg.head_dim)) < 1e-6
    scfg = ServeConfig(batch=2, max_len=16, cache_mode="paged", page_size=4)
    b16 = Engine(cfg, params, scfg, device="cpu").cache_token_bytes
    b8 = Engine(cfg.replace(**INT8), params, scfg,
                device="cpu").cache_token_bytes
    # per token and layer: K and V, KVH x hd values, and 2 x KVH f32 scales
    assert b8 == cfg.n_layers * 2 * cfg.n_kv_heads * (cfg.head_dim + 4)
    assert b16 / b8 == ratio


def test_mla_stays_bf16_under_int8():
    """MLA caches latents and rope keys in bf16 whatever
    ``kv_cache_dtype`` says, in both packages; the model serves."""
    arch = "deepseek-v3-671b"
    for mode in ("dense", "paged"):
        cfg = reduced(get_config(arch)).replace(cache_mode=mode,
                                                page_size=4, **INT8)
        jcfg = jreduced(jget_config(arch)).replace(cache_mode=mode,
                                                   page_size=4, **INT8)
        for c in init_caches(cfg, 2, 8, device="cpu"):
            assert set(c) == {"c_kv", "k_rope"}
            assert all(t.dtype == torch.bfloat16 for t in c.values())
        for leaf in jax.tree_util.tree_leaves(jinit_caches(jcfg, 2, 8)):
            assert leaf.dtype == jnp.bfloat16
    params = model_init(cfg, device="cpu")
    _, streams = _serve(cfg, params, _prompts(256, (4, 6), 2), 3,
                        batch=2, max_len=12)
    assert [len(s) for s in streams] == [3, 3]


# ---------------------------------------------------------------------------
# Model: prefill and decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache_mode", ["dense", "paged"])
@pytest.mark.parametrize("mode", ["dense", "w8a8_nibble"])
def test_int8_prefill_then_decode_match(mode, cache_mode):
    """Two prompts prefilled alone (padded, per-row ``logits_index``) into
    int8 caches, merged into a 3-slot slab or out-of-order pool pages,
    then 3 decode steps at per-slot positions (flash attention: the paged
    kernel stays off under int8); layer 0's quantized V rows and scales
    equal the reference's, and every logit equal bit for bit (measured so
    on a CPU in all four cases)."""
    over = dict(quant_mode=mode, attn_impl="flash", cache_mode=cache_mode,
                page_size=4, **INT8)
    jcfg, jp, tcfg, tp = tm._pair("yi-6b", **over)
    rng = np.random.default_rng(1)
    max_len, pad, lens = 16, 8, [5, 8]
    prompts = np.zeros((2, pad), np.int32)
    for i, n in enumerate(lens):
        prompts[i, :n] = rng.integers(0, 256, n)
    jc = jinit_caches(jcfg, 3, max_len)
    tc = init_caches(tcfg, 3, max_len, device="cpu")
    table = np.zeros((3, max_len // 4), np.int32)
    table[0, :4] = [4, 3, 2, 1]
    table[2, :4] = [5, 8, 7, 6]
    grow = max_len if cache_mode == "dense" else pad
    for slot, row in ((0, 0), (2, 1)):
        p = prompts[row:row + 1]
        jl, jone, _ = tm.jprefill(jp, jcfg, jnp.asarray(p), max_len=grow,
                                  logits_index=lens[row] - 1)
        tl, tone, _ = prefill(tp, tcfg, torch.from_numpy(p), max_len=grow,
                              logits_index=lens[row] - 1)
        _equal(tl, jl)
        for key in ("v", "v_scale"):
            np.testing.assert_array_equal(
                tone[0][key].numpy(),
                np.asarray(jone["blocks"]["0"]["attn"][key][0]))
        assert tone[0]["k"].dtype == torch.int8
        if cache_mode == "dense":
            jc = jmerge(jc, jone, slot)
            merge_slot_caches(tc, tone, slot)
        else:
            jc = jmerge_paged(jc, jone, slot, jnp.asarray(table[slot]))
            merge_slot_paged_caches(tc, tone, slot, table[slot])
    tok = np.array([[7], [0], [9]], np.int32)
    pos = np.array(lens[:1] + [0] + lens[1:], np.int32)
    kw_j, kw_t = {}, {}
    if cache_mode == "paged":
        kw_j = {"page_table": jnp.asarray(table)}
        kw_t = {"page_table": torch.from_numpy(table)}
    for _ in range(3):
        jl, jc = tm.jdecode(jp, jcfg, jnp.asarray(tok), jc,
                            jnp.asarray(pos), **kw_j)
        tl, tc = decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                             torch.from_numpy(pos), **kw_t)
        _equal(tl[[0, 2]], np.asarray(jl)[[0, 2]])
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        pos = pos + np.array([1, 0, 1], np.int32)


def test_int8_decode_tracks_bf16_forward():
    """The reference's rule (``tests/test_serve.py::
    test_int8_kv_cache_decode_accuracy``) on the port: prefill 4 tokens
    into int8 caches, decode 4 teacher-forced, within 5% of the largest
    bf16 forward logit."""
    cfg = reduced(get_config("yi-6b"))
    params = model_init(cfg, device="cpu")
    cfg8 = cfg.replace(**INT8)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 8)))
    full, _ = forward(params, cfg, tokens)
    logits, caches, _ = prefill(params, cfg8, tokens[:, :4], max_len=8)
    assert caches[0]["k"].dtype == torch.int8
    got = [logits[:, -1]]
    for t in range(4, 8):
        lg, caches = decode_step(params, cfg8, tokens[:, t:t + 1], caches, t)
        got.append(lg[:, -1])
    want = full[:, 3:].numpy()
    got = torch.stack(got, 1)[:, :want.shape[1]].numpy()
    rel = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert rel < 0.05, rel


# ---------------------------------------------------------------------------
# Refusals (the reference's rules and messages)
# ---------------------------------------------------------------------------

def _message(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as exc:
        return type(exc), str(exc)
    raise AssertionError("no refusal")


@pytest.mark.parametrize("over", [
    dict(prefix_cache=True), dict(prefill_chunk=4),
    dict(admit_group=2)], ids=["prefix", "wave-chunk", "wave-group"])
def test_int8_refuses_prefix_cache_and_wave(model, over):
    cfg, params = model
    jcfg = jreduced(jget_config("yi-6b")).replace(**INT8)
    kw = dict(batch=2, max_len=16, prefill_len=8, cache_mode="paged",
              page_size=4, **over)
    jparams = tm._jax_params("yi-6b", 2)[0]
    want = _message(lambda: jengine.Engine(jcfg, jparams,
                                           jengine.ServeConfig(**kw)))
    got = _message(lambda: Engine(cfg, params, ServeConfig(**kw),
                                  device="cpu"))
    assert got == want and "int8" in got[1]


def test_int8_context_prefill_raises():
    """The context prefill (the prefix cache's suffix against cached
    rows) over int8 pools raises the reference's ``NotImplementedError``."""
    over = dict(cache_mode="paged", page_size=4, **INT8)
    jcfg, jp, tcfg, tp = tm._pair("yi-6b", **over)
    suffix = np.ones((1, 4), np.int32)
    row = np.array([[1, 2, 3, 4]], np.int32)
    want = _message(lambda: jax.jit(
        tm.jmodels.prefill, static_argnums=1)(
            jp, jcfg, jnp.asarray(suffix), ctx_caches=jinit_caches(
                jcfg, 1, 16), ctx_table=jnp.asarray(row),
            ctx_start=jnp.int32(4)))
    got = _message(lambda: prefill(
        tp, tcfg, torch.from_numpy(suffix), ctx_caches=init_caches(
            tcfg, 1, 16, device="cpu"), ctx_table=torch.from_numpy(row),
        ctx_start=torch.tensor(4)))
    assert got == want and got[0] is NotImplementedError


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

def test_paged_int8_matches_dense_streams(model):
    """``tests/test_paging.py::test_paged_int8_kv_matches_dense`` on the
    port: the int8 rows quantize the same through pool and slab scatter,
    so greedy streams are equal token for token."""
    cfg, params = model
    prompts = _prompts(cfg.vocab_size, (4, 6, 5), 1)
    _, want = _serve(cfg, params, prompts, 6, cache_mode="dense",
                     page_size=None)
    _, got = _serve(cfg, params, prompts, 6)
    assert got == want


def test_int8_pages_roundtrip_bit_for_bit():
    """Int8 K/V pools and f32 scale pools through host payloads: raw
    bytes (``uint8``), no pool widened (a payload is one page's bytes of
    every pool), and back into other pages bit for bit; pad rows land on
    the trash page only."""
    cfg = reduced(get_config("yi-6b")).replace(cache_mode="paged",
                                               page_size=4, **INT8)
    caches = init_caches(cfg, 2, 16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for c in caches:
        for key, pool in c.items():
            if pool.dtype == torch.int8:
                pool.copy_(torch.randint(-128, 128, pool.shape,
                                         generator=gen))
            else:
                pool.copy_(torch.rand(pool.shape, generator=gen))
    before = [{k: v.clone() for k, v in c.items()} for c in caches]
    page_bytes = sum(t[0].numel() * t.element_size()
                     for c in caches for t in c.values())
    src, dst = [3, 6, 1], [2, 5, 8]
    for pad_to in (None, 4):
        pay = extract_cache_pages(caches, src, pad_to=pad_to)
        assert all(p.dtype == torch.uint8 and p.shape == (page_bytes,)
                   for p in pay)
        insert_cache_pages(caches, dst, pay, pad_to=pad_to)
        untouched = [p for p in range(caches[0]["k"].shape[0])
                     if p not in dst and p != 0]
        for c, b in zip(caches, before):
            for key in c:
                assert c[key].dtype == b[key].dtype
                assert torch.equal(c[key][dst], b[key][src])
                assert torch.equal(c[key][untouched], b[key][untouched])


def test_int8_host_swap_matches_replay(model):
    """An overcommitted incremental pool evicts mid-stream; with the host
    swap every resume restores its int8 rows and scales by page copy, and
    the streams equal the replay engine's (``dense``)."""
    cfg, params = model
    prompts = _prompts(cfg.vocab_size, (4, 6, 5, 7), 4)
    over = dict(alloc_mode="incremental", num_pages=7)
    _, want = _serve(cfg, params, prompts, 8, **over)
    engine, got = _serve(cfg, params, prompts, 8, swap_mode="host", **over)
    assert got == want
    st = engine.stats
    assert st["swap_in"] == st["swap_out"] >= 1
    assert st["replay_steps_saved"] >= 1
    assert engine.host_pool.in_use == 0


def test_int8_spec_decode_matches_plain_engine(model):
    """Speculative decoding runs under int8 (the reference allows it): the
    greedy spec engine (``w8a8_nibble`` draft, dense verify over the int8
    pools) emits the dense engine's streams."""
    cfg, params = model
    prompts = _prompts(cfg.vocab_size, (4, 6, 5), 5)
    over = dict(alloc_mode="incremental", max_len=24)
    _, want = _serve(cfg, params, prompts, 8, decode_chunk=1, **over)
    engine, got = _serve(cfg, params, prompts, 8, spec_decode=True,
                         spec_quant_mode="w8a8_nibble", **over)
    assert got == want and engine.stats["spec_rounds"] >= 1


@pytest.mark.parametrize("cache_mode", ["dense", "paged"])
def test_int8_streams_match_reference(monkeypatch, cache_mode):
    """``test_torch_engine.py``'s staggered workload (greedy, dense, flash
    attention) on the int8 KV cache through both packages' engines:
    equal streams, each divergence at a tie."""
    over = dict(quant_mode="dense", attn_impl="flash", cache_mode=cache_mode,
                page_size=4, **INT8)
    jcfg, jparams, tcfg, tparams = tm._pair("yi-6b", **over)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab_size, p).astype(np.int32)
               for p, _ in te.SPEC]
    records = te._recorders(monkeypatch)
    tm.exact_engine(monkeypatch)
    kw = dict(batch=3, max_len=24, prefill_len=8, decode_chunk=3)
    jeng = jengine.Engine(jcfg, jparams, jengine.ServeConfig(**kw))
    jids = [jeng.submit(p, n) for p, (_, n) in zip(prompts, te.SPEC)]
    jdone = jeng.run()
    teng = Engine(tcfg, tparams, ServeConfig(**kw), device="cpu")
    tids = [teng.submit(p, n) for p, (_, n) in zip(prompts, te.SPEC)]
    tdone = teng.run()
    for jid, tid, prompt, (_, n) in zip(jids, tids, prompts, te.SPEC):
        want, got = jdone[jid].tokens, tdone[tid].tokens
        assert len(got) == len(want) == n
        diff = [i for i in range(n) if want[i] != got[i]]
        if diff:
            i = diff[0]
            _, logits = te._reference_logits(records, prompt, want, i)
            assert logits[want[i]] - logits[got[i]] <= te.LOGIT_TOL


def test_engine_decodes_from_int8_pools(model):
    """The config carries the KV dtype into the engine (the serve
    launcher has no flag for it, as the reference's has none): its pools
    are int8, and it serves."""
    cfg, params = model
    engine, streams = _serve(cfg, params, _prompts(256, (5,), 6), 4)
    assert all(c["k"].dtype == torch.int8 for c in engine._caches)
    assert len(streams[0]) == 4
