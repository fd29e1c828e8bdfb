"""The prefix cache in the port (``PrefixCache``, context prefill,
copy-on-write, the capacity cap), against the reference.

* Module parity, bit-exact (bf16 compared through ``.view(torch.int16)``):
  ``hash_chunks``, ``scatter_prefill_rows``, ``_splice_context``,
  ``copy_paged_cache_page`` and ``scatter_prefill_paged_caches`` on the
  same numpy inputs.
* The context prefill against the reference's, in ``dense`` and
  ``w8a8_nibble``: logits within ``test_torch_model.py``'s LOGIT_ATOL;
  the suffix K/V rows within KV_ATOL (below); layer 0's V rows exact (no
  RoPE before them).  With ``ctx_start=0`` the port equals its own plain
  prefill through ``attention_core`` bit for bit.
* The contracts of the reference's ``tests/test_prefix_cache.py`` held
  inside the port (reduced yi-6b, the port's own weights).
* Cross-package: the port's prefix engine and the reference's on one
  seed-pinned workload give equal counters and equal greedy streams under
  ``test_torch_engine.py``'s tie rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.serve.engine as jengine
import test_torch_engine as te
import test_torch_model as tm
from repro.models import attention as jattn
from repro.models import transformer as jtransformer
from repro.serve import paging as jpaging
from repro_torch.configs import LayerSpec, get_config, reduced
from repro_torch.models import attention as tattn
from repro_torch.models import (
    copy_paged_cache_page,
    init_caches,
    model_init,
    prefill,
    scatter_prefill_paged_caches,
)
from repro_torch.serve import (
    Engine,
    PageAllocator,
    PrefixCache,
    ServeConfig,
    draw_workload,
    hash_chunks,
    run_timed_workload,
)
from repro_torch.serve.paging import HostPagePool

torch.set_num_threads(1)

# suffix K/V rows of a context prefill, port vs reference: V of layer 0 is
# exact; K carries RoPE (XLA and torch round sin/cos differently in the
# last ulp) and layer 1 sees layer 0's output, which flips some bf16
# roundings and, in w8a8, some int8 activation roundings (one int8 step
# moves a projected value by its scale).  Measured on a CPU: up to
# 0.018 in dense, 0.0625 in w8a8_nibble, on values up to ~4
KV_ATOL = 0.08


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


def _to_bf16(a: np.ndarray):
    """The same bf16 values on both sides: (jax array, torch tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _jbits(a) -> np.ndarray:
    return np.asarray(a).view(np.int16)


# ---------------------------------------------------------------------------
# Module parity, bit-exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,page_size", [(0, 4), (7, 4), (8, 4), (33, 16),
                                         (128, 16)])
def test_hash_chunks_bytes_match_reference(n, page_size):
    tokens = np.random.default_rng(n).integers(0, 64000, n)
    assert hash_chunks(tokens, page_size) == jpaging.hash_chunks(tokens,
                                                                 page_size)
    # int64 input hashes its int32 values, as the reference does
    assert hash_chunks(tokens.astype(np.int64), page_size) \
        == jpaging.hash_chunks(tokens, page_size)


@pytest.mark.parametrize("start,s", [(0, 8), (4, 8), (7, 8), (10, 8)])
def test_scatter_prefill_rows_matches_reference(start, s):
    """Row-granular writes through one table row; positions past the
    budget (start 10 + 8 > 16) clamp to the last logical row (the clamped
    rows carry the same value, the last one, in both packages)."""
    rng = np.random.default_rng(start)
    pool_j, pool_t = _to_bf16(rng.standard_normal((9, 4, 2, 3)))
    new = rng.standard_normal((1, s, 2, 3))
    if start + s > 16:
        new[0, 16 - start:] = new[0, -1]
    new_j, new_t = _to_bf16(new)
    row = np.array([3, 5, 7, 2], np.int32)
    want = jattn.scatter_prefill_rows(pool_j, new_j, jnp.asarray(row), start)
    got = tattn.scatter_prefill_rows(pool_t, new_t, torch.from_numpy(row),
                                     torch.tensor(start))
    np.testing.assert_array_equal(_bits(got), _jbits(want))


@pytest.mark.parametrize("start", [0, 1, 4, 7, 8])
def test_splice_context_matches_reference(start):
    rng = np.random.default_rng(10 + start)
    ctx_j, ctx_t = _to_bf16(rng.standard_normal((1, 12, 2, 3)))
    new_j, new_t = _to_bf16(rng.standard_normal((1, 8, 2, 3)))
    want = jattn._splice_context(ctx_j, new_j, start)
    got = tattn._splice_context(ctx_t, new_t, torch.tensor(start))
    np.testing.assert_array_equal(_bits(got), _jbits(want))
    if start == 0:
        np.testing.assert_array_equal(_bits(got), _bits(new_t))


def _pool_pair(seed, n_layers=2, num_pages=9, ps=4, kvh=2, hd=3):
    """Reference-shaped paged caches (block-stacked) and the port's list
    of per-layer pools, holding the same bf16 values."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((n_layers, num_pages, ps, kvh, hd))
    v = rng.standard_normal((n_layers, num_pages, ps, kvh, hd))
    kj, kt = _to_bf16(k)
    vj, vt = _to_bf16(v)
    jc = {"prefix": [], "suffix": [],
          "blocks": {"0": {"attn": {"k": kj, "v": vj}}}}
    tc = [{"k": kt[i].clone(), "v": vt[i].clone()} for i in range(n_layers)]
    return jc, tc


def _assert_pools_equal(tc, jc):
    for key in ("k", "v"):
        want = _jbits(jc["blocks"]["0"]["attn"][key])
        got = np.stack([_bits(layer[key]) for layer in tc])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", [(0, 0), (3, 6), (8, 1)])
def test_copy_paged_cache_page_matches_reference(src, dst):
    jc, tc = _pool_pair(src + 7 * dst)
    want = jtransformer.copy_paged_cache_page(jc, src, dst)
    copy_paged_cache_page(tc, torch.tensor(src), torch.tensor(dst))
    _assert_pools_equal(tc, want)


@pytest.mark.parametrize("start", [0, 5, 8])
def test_scatter_prefill_paged_caches_matches_reference(start):
    jc, tc = _pool_pair(20 + start)
    rng = np.random.default_rng(start)
    new = rng.standard_normal((2, 2, 1, 8, 2, 3))   # (k|v, layer, 1, S, ..)
    (kj, kt), (vj, vt) = _to_bf16(new[0]), _to_bf16(new[1])
    jone = {"prefix": [], "suffix": [],
            "blocks": {"0": {"attn": {"k": kj, "v": vj}}}}
    tone = [{"k": kt[i], "v": vt[i]} for i in range(2)]
    row = np.array([4, 6, 1, 0], np.int32)
    want = jtransformer.scatter_prefill_paged_caches(
        jc, jone, 0, jnp.asarray(row), start)
    scatter_prefill_paged_caches(tc, tone, 0, torch.from_numpy(row),
                                 torch.tensor(start))
    _assert_pools_equal(tc, want)


# ---------------------------------------------------------------------------
# Context prefill against the reference
# ---------------------------------------------------------------------------

def _pair(**over):
    """Reduced yi-6b (2 layers, paged, page 4, flash) in both packages on
    the reference's weights."""
    return tm._pair("yi-6b", **dict(dict(attn_impl="flash",
                                         cache_mode="paged", page_size=4),
                                    **over))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("mode", ["dense", "w8a8_nibble"])
@pytest.mark.parametrize("start", [4, 7])
def test_context_prefill_matches_reference(mode, backend, start):
    """A suffix at ``start`` against cached rows in the pools (random
    bf16 K/V behind a 4-page table row), reference on ``xla``; the port
    on both of its backends (on the CPU the ``cuda`` one runs the
    kernels' plain versions)."""
    jcfg, jp, tcfg, tp = _pair(quant_mode=mode)
    tcfg = tcfg.replace(quant_backend=backend)
    jc, tc = _pool_pair(start, num_pages=9, kvh=jcfg.n_kv_heads,
                        hd=jcfg.head_dim)
    rng = np.random.default_rng(start)
    sfx_len = 10 - start
    suffix = np.zeros((1, 8), np.int32)
    suffix[0, :sfx_len] = rng.integers(0, 256, sfx_len)
    row = np.array([3, 5, 7, 2], np.int32)
    jl, jone, _ = tm.jprefill(jp, jcfg, jnp.asarray(suffix),
                           logits_index=sfx_len - 1, ctx_caches=jc,
                           ctx_table=jnp.asarray(row)[None],
                           ctx_start=jnp.int32(start))
    tl, tone, _ = prefill(tp, tcfg, torch.from_numpy(suffix).long(),
                          logits_index=sfx_len - 1, ctx_caches=tc,
                          ctx_table=torch.from_numpy(row)[None],
                          ctx_start=torch.tensor(start))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32),
                               atol=te.LOGIT_TOL, rtol=0)
    for key in ("k", "v"):
        want = np.asarray(jone["blocks"]["0"]["attn"][key][:, 0, :sfx_len]
                          .astype(jnp.float32))
        got = np.stack([layer[key][0, :sfx_len].float().numpy()
                        for layer in tone])
        if key == "v":
            np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got, want, atol=KV_ATOL, rtol=0)
    # the pools are read, never written
    _assert_pools_equal(tc, _pool_pair(start, num_pages=9,
                                       kvh=jcfg.n_kv_heads,
                                       hd=jcfg.head_dim)[0])


@pytest.mark.parametrize("mode", ["dense", "w8a8_nibble"])
def test_context_prefill_at_zero_is_the_plain_prefill(mode):
    """``ctx_start=0`` (a prefix-cache miss) gives the plain prefill's
    logits and K/V bit for bit (plain prefill through ``attention_core``,
    ``attn_impl="chunked"``)."""
    cfg = reduced(get_config("yi-6b")).replace(
        quant_mode=mode, n_layers=2, cache_mode="paged", page_size=4)
    params = model_init(cfg, device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, (1, 8))).long()
    caches = init_caches(cfg, 2, 16, device="cpu")
    row = torch.tensor([[1, 2, 0, 0]])
    want_l, want_c, _ = prefill(params, cfg, tokens, logits_index=5)
    for impl in ("chunked", "flash"):
        got_l, got_c, _ = prefill(params, cfg.replace(attn_impl=impl),
                                  tokens, logits_index=5, ctx_caches=caches,
                                  ctx_table=row, ctx_start=torch.tensor(0))
        assert torch.equal(got_l, want_l)
        for g, w in zip(got_c, want_c):
            for key in ("k", "v"):
                np.testing.assert_array_equal(_bits(g[key]), _bits(w[key]))


# ---------------------------------------------------------------------------
# The reference's contracts (tests/test_prefix_cache.py) inside the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config("yi-6b"))
    return cfg, model_init(cfg, device="cpu")


def _scfg(**over):
    kw = dict(batch=2, max_len=16, prefill_len=8, decode_chunk=3,
              cache_mode="paged", page_size=4)
    kw.update(over)
    return ServeConfig(**kw)


def _drive(cfg, params, prompts, budgets, scfg, priorities=None):
    engine = Engine(cfg, params, scfg, device="cpu")
    priorities = priorities or [0] * len(prompts)
    ids = [engine.submit(p, n, priority=pr)
           for p, n, pr in zip(prompts, budgets, priorities)]
    done = engine.run()
    return engine, [done[i] for i in ids]


def _shared_prompts(vocab, head_len=4, tails=(2, 3), seed=0):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, head_len)
    return [np.concatenate([head, rng.integers(0, vocab, t)]).astype(np.int32)
            for t in tails]


def test_prefix_cache_chain_keys_commit_to_whole_prefix():
    c = PrefixCache(4, PageAllocator(8, reserved=1))
    k1 = c.chunk_keys(np.arange(8))
    k2 = c.chunk_keys(np.concatenate([np.arange(4) + 1, np.arange(4, 8)]))
    assert k1[0] != k2[0]
    assert k1[1] != k2[1]                   # same chunk 1 tokens, new key
    assert len(c.chunk_keys(np.arange(7))) == 1   # partial tail unindexed


def test_prefix_cache_insert_match_acquire():
    a = PageAllocator(8, reserved=1)
    c = PrefixCache(4, a)
    pages = a.alloc(2)
    keys = c.chunk_keys(np.arange(8))
    assert c.match(keys) == []
    c.insert(keys, pages)
    assert all(a.refcount(p) == 2 for p in pages)  # owner + index
    assert c.match(keys) == pages
    assert c.match(keys[:1]) == pages[:1]
    got = c.acquire(keys)
    assert got == pages
    assert all(a.refcount(p) == 3 for p in pages)
    a.free(got)
    a.free(pages)
    assert a.in_use == 2                    # index refs keep them live
    c.drop()
    assert a.in_use == 0


def test_prefix_cache_reclaim_is_lru_leaf_first():
    a = PageAllocator(8, reserved=1)
    c = PrefixCache(2, a)
    pages = a.alloc(3)
    keys = c.chunk_keys(np.arange(6))
    c.insert(keys, pages)
    a.free(pages)                           # only the index holds them
    assert c.reclaimable() == 3
    assert c.reclaim(1) == 1                # the leaf goes first
    assert c.match(keys) == pages[:2]
    c.acquire(keys[:2])                     # another holder: not reclaimable
    assert c.reclaimable() == 0
    assert c.reclaim(2) == 0
    a.free(pages[:2])
    assert c.reclaim(2) == 2
    assert a.in_use == 0


@pytest.mark.parametrize("quant,backend", [
    ("dense", "torch"), ("dense", "cuda"),
    ("w8a8_nibble", "torch"), ("w8a8_nibble", "cuda")])
def test_shared_prefix_bitmatch_and_suffix_only_prefill(quant, backend):
    """Two requests sharing a page-aligned head: equal streams to the
    uncached engine's, the second prefills only its suffix, one signature
    per stage, zero leaks once the index lets go."""
    cfg = reduced(get_config("yi-6b")).replace(quant_mode=quant,
                                               quant_backend=backend)
    params = model_init(cfg, device="cpu")
    prompts = _shared_prompts(cfg.vocab_size)   # 4-token head = 1 page
    _, want = _drive(cfg, params, prompts, [4, 4], _scfg())
    engine, got = _drive(cfg, params, prompts, [4, 4],
                         _scfg(prefix_cache=True))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert engine.prefill_tokens == 6 + 3
    assert engine.stats["prefix_hits"] == 1
    assert engine.compile_counts == {"prefill": 1, "decode_chunk": 1}
    assert engine.allocator.in_use == len(engine.prefix_cache.pages)
    engine.release_prefix_cache()
    assert engine.allocator.in_use == 0


def test_shared_prefix_matches_solo_uncached_runs(model):
    cfg, params = model
    prompts = _shared_prompts(cfg.vocab_size, seed=3)
    _, got = _drive(cfg, params, prompts, [4, 4], _scfg(prefix_cache=True))
    for p, r in zip(prompts, got):
        _, solo = _drive(cfg, params, [p], [4], _scfg())
        assert r.tokens == solo[0].tokens


def test_cow_fires_exactly_on_fully_covered_prompt(model):
    cfg, params = model
    p = np.random.default_rng(7).integers(0, cfg.vocab_size, 8)
    _, want = _drive(cfg, params, [p, p], [4, 4], _scfg())
    engine, got = _drive(cfg, params, [p, p], [4, 4],
                         _scfg(prefix_cache=True))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert engine.cow_copies == 1
    assert engine.prefill_tokens == 8 + 1   # full prompt, then one token
    # a partial hit never copies: its uncached tail has a private page
    engine2, _ = _drive(cfg, params, [p[:6]] * 2, [4, 4],
                        _scfg(prefix_cache=True))
    assert engine2.cow_copies == 0
    assert engine2.prefill_tokens == 6 + 2


def test_cow_leaves_shared_page_intact_for_other_holder(model):
    cfg, params = model
    p = np.random.default_rng(11).integers(0, cfg.vocab_size, 8)
    _, want = _drive(cfg, params, [p] * 3, [4] * 3, _scfg(batch=1))
    engine, got = _drive(cfg, params, [p] * 3, [4] * 3,
                         _scfg(batch=1, prefix_cache=True))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert engine.cow_copies == 2           # admissions 2 and 3
    engine.release_prefix_cache()
    assert engine.allocator.in_use == 0


def test_paged_flash_engine_shared_prefix(model):
    """``attn_impl="flash"``: decode over shared pages runs the paged
    kernel's wrapper (its plain version here), the context prefill
    ``attention_core``; streams equal the uncached flash engine's."""
    cfg, params = model
    fcfg = cfg.replace(attn_impl="flash")
    prompts = _shared_prompts(cfg.vocab_size, seed=5)
    _, want = _drive(fcfg, params, prompts, [4, 4], _scfg())
    engine, got = _drive(fcfg, params, prompts, [4, 4],
                         _scfg(prefix_cache=True))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert engine.stats["prefix_hits"] == 1


def test_evict_while_shared_survivor_keeps_pages(model):
    cfg, params = model
    rng = np.random.default_rng(13)
    head = rng.integers(0, cfg.vocab_size, 4)
    prompts = [np.concatenate([head, rng.integers(0, cfg.vocab_size, 3)])
               for _ in range(3)]
    over = dict(batch=3, max_len=16, num_pages=10, alloc_mode="incremental")
    _, want = _drive(cfg, params, prompts, [8] * 3,
                     _scfg(cache_mode="dense", page_size=None, batch=3))
    engine, got = _drive(cfg, params, prompts, [8] * 3,
                         _scfg(prefix_cache=True, **over))
    assert engine.preemptions > 0
    assert [r.tokens for r in got] == [r.tokens for r in want]
    engine.release_prefix_cache()
    assert engine.allocator.in_use == 0
    assert engine.allocator.available == engine.allocator.capacity


def test_cold_prefix_pages_reclaimed_under_pressure(model):
    cfg, params = model
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab_size, 6) for _ in range(4)]
    engine, got = _drive(cfg, params, prompts, [4] * 4,
                         _scfg(batch=1, num_pages=5, prefix_cache=True))
    assert all(len(r.tokens) == 4 for r in got)
    _, want = _drive(cfg, params, prompts, [4] * 4, _scfg(batch=1))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    engine.release_prefix_cache()
    assert engine.allocator.in_use == 0


@given(n_chunks=st.integers(1, 6), host_pages=st.integers(1, 8))
@settings(max_examples=40, deadline=None)
def test_cold_tier_demote_promote_roundtrip(n_chunks, host_pages):
    """Reclaiming an ``n_chunks`` chain through a ``host_pages``-deep cold
    tier leaves a contiguous head run of ``min(n_chunks, host_pages)``
    cold entries, promoted payloads read back what demotion stored, and
    the round trip leaks neither device nor host pages."""
    alloc = PageAllocator(16, reserved=1)
    host = HostPagePool(host_pages)
    cache = PrefixCache(2, alloc)
    stored = {}

    def demote(page):
        hid = host.alloc(1)
        if hid is None:
            return None
        host.store(hid[0], ("rows-of", page))
        stored[hid[0]] = ("rows-of", page)
        return hid[0]

    cache.attach_cold_tier(demote, lambda hid: host.free([hid]))
    keys = cache.chunk_keys(np.arange(n_chunks * 2, dtype=np.int64))
    assert len(keys) == n_chunks
    pages = alloc.alloc(n_chunks)
    cache.insert(keys, pages)
    alloc.free(pages)
    assert cache.reclaim(n_chunks) == n_chunks
    assert alloc.in_use == 0
    n_cold = min(n_chunks, host_pages)
    assert cache.cold_size == n_cold
    assert host.in_use == n_cold
    assert cache.match_cold(keys, 0) == n_cold
    hids = cache.pop_cold(keys[:n_cold])
    for hid in hids:
        assert host.load(hid) == stored[hid]
        host.free([hid])
    assert cache.cold_size == 0
    assert host.in_use == 0
    with pytest.raises(ValueError, match="not in the cold index"):
        cache.pop_cold(keys[:1])
    cache.drop()
    assert alloc.in_use == 0


def test_resume_after_eviction_hits_own_prefix(model):
    """A preempted request's indexed chunks survive its eviction, so its
    replay-resume prefills only the uncached tail."""
    cfg, params = model
    rng = np.random.default_rng(19)
    p_hi = rng.integers(0, cfg.vocab_size, 5)
    p_lo = rng.integers(0, cfg.vocab_size, 8)
    engine = Engine(cfg, params, _scfg(batch=1, prefix_cache=True,
                                       alloc_mode="incremental",
                                       num_pages=5), device="cpu")
    lo = engine.submit(p_lo, 8)
    # hi arrives while lo decodes (driven step by step: a timed arrival
    # races a fast CPU, which can finish lo first)
    engine.start()
    engine._admit(0.0)
    engine._run_chunk(0.0)
    engine.submit(p_hi, 4, priority=5)
    engine._admit(0.0)
    done = engine.run()
    assert done[lo].preemptions >= 1
    assert engine.prefill_tokens < 8 + len(p_hi) + 8
    engine.release_prefix_cache()
    assert engine.allocator.in_use == 0


def test_exact_length_prefill_shared_prefix_bitmatch(model):
    """``prefill_len=0``: the suffix buffer pads to the full prompt
    length, so the splice spans every cached key position."""
    cfg, params = model
    prompts = _shared_prompts(cfg.vocab_size, seed=21)
    _, want = _drive(cfg, params, prompts, [4, 4], _scfg(prefill_len=0))
    engine, got = _drive(cfg, params, prompts, [4, 4],
                         _scfg(prefill_len=0, prefix_cache=True))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert engine.stats["prefix_hits"] == 1
    engine.release_prefix_cache()
    assert engine.allocator.in_use == 0


def test_prefix_cache_requires_paged(model):
    cfg, params = model
    with pytest.raises(ValueError, match="requires"):
        Engine(cfg, params, _scfg(cache_mode="dense", page_size=None,
                                  prefix_cache=True), device="cpu")


def test_prefix_cache_rejects_mamba_and_int8_kv(model):
    cfg, params = model
    mamba = cfg.replace(block_pattern=(LayerSpec(mixer="mamba"),))
    with pytest.raises(ValueError, match="mamba"):
        Engine(mamba, params, _scfg(prefix_cache=True), device="cpu")
    with pytest.raises(ValueError, match="int8"):
        Engine(cfg.replace(kv_cache_dtype="int8"), params,
               _scfg(prefix_cache=True), device="cpu")


def test_workload_shared_prefix_reports_hit_rate(model):
    cfg, params = model
    engine = Engine(cfg, params, _scfg(batch=2, max_len=24,
                                       prefix_cache=True), device="cpu")
    r = run_timed_workload(engine, cfg.vocab_size, requests=6,
                           prompt_budget=8, new_tokens=3, shared_prefix=1.0)
    assert r["prefix_hit_rate"] > 0.0
    assert r["prefill_tokens"] > 0
    with pytest.raises(ValueError, match="shared_prefix"):
        run_timed_workload(engine, cfg.vocab_size, requests=2,
                           prompt_budget=8, new_tokens=2, shared_prefix=1.5)


# ---------------------------------------------------------------------------
# Cross-package: the reference's prefix engine and the port's
# ---------------------------------------------------------------------------

COUNTERS = ("prefill_tokens", "prefix_hits", "cow_copies", "preemptions",
            "swap_out", "swap_in", "replay_steps_saved", "decode_chunks")


def _first_token_logits(records, prompt, stream):
    """The reference's logits for a request's first token, where its
    prefill may have run a suffix only (a prefix hit)."""
    p = len(prompt)
    for kind, tok, _, logits in records:
        if kind != "prefill" or int(logits[0].argmax()) != stream[0]:
            continue
        if any(np.array_equal(tok[:p - s], prompt[s:]) for s in range(p)):
            return logits[0]
    raise AssertionError("no reference prefill emitted token 0")


def assert_streams_match(records, prompts, jdone, jids, tdone, tids, dense):
    """``test_torch_engine.py``'s tie rule: a divergence is accepted only
    where the reference's own margin is within LOGIT_TOL; in the integer
    modes (rows coupled through the batch's activation scale) only the
    first divergence in time is held to it."""
    firsts = []
    for jid, tid, prompt in zip(jids, tids, prompts):
        want, got = jdone[jid].tokens, tdone[tid].tokens
        assert len(got) == len(want)
        diff = [i for i in range(len(want)) if want[i] != got[i]]
        if not diff:
            continue
        i = diff[0]
        if i == 0:
            rec, logits = -1, _first_token_logits(records, prompt, want)
        else:
            rec, logits = te._reference_logits(records, prompt, want, i)
        firsts.append((rec, float(logits[want[i]] - logits[got[i]]), i))
    firsts.sort()
    for _, margin, i in (firsts if dense else firsts[:1]):
        assert margin <= te.LOGIT_TOL, (
            f"streams diverge at token {i} where the reference's margin "
            f"is {margin} > {te.LOGIT_TOL}: not a tie")


def cross_package_run(monkeypatch, mode, prompts, n_new, **kw):
    """The same prompts through the reference engine (``xla``) and the
    port's (CPU), both on the reference's weights; checks the counters,
    the streams (tie rule), leaks and stage signatures."""
    jcfg, jp, tcfg, tp = _pair(quant_mode=mode)
    records = te._recorders(monkeypatch)
    jeng = jengine.Engine(jcfg, jp, jengine.ServeConfig(**kw))
    jids = [jeng.submit(p, n_new) for p in prompts]
    jdone = jeng.run()
    teng = Engine(tcfg, tp, ServeConfig(**kw), device="cpu")
    tids = [teng.submit(p, n_new) for p in prompts]
    tdone = teng.run()
    for key in COUNTERS:
        assert teng.stats[key] == jeng.stats[key], key
    assert ([tdone[i].preemptions for i in tids]
            == [jdone[i].preemptions for i in jids])
    assert teng.compile_counts == {"prefill": 1, "decode_chunk": 1}
    teng.release_prefix_cache()
    assert teng.leaked_pages() == 0
    assert_streams_match(records, prompts, jdone, jids, tdone, tids,
                         dense=(mode == "dense"))
    return teng.stats


@pytest.mark.parametrize("mode", ["dense", "w8a8_nibble"])
def test_prefix_engine_matches_reference(monkeypatch, mode):
    """A shared-prefix workload (seed 3, 75% shared heads) plus one
    page-aligned prompt submitted twice (COW), 3 slots."""
    draw = draw_workload(256, requests=8, prompt_budget=8, new_tokens=6,
                         seed=3, shared_prefix=0.75)
    twice = np.random.default_rng(5).integers(0, 256, 8).astype(np.int32)
    stats = cross_package_run(
        monkeypatch, mode, list(draw.prompts) + [twice, twice], 6,
        batch=3, max_len=16, prefill_len=8, decode_chunk=3,
        prefix_cache=True)
    assert stats["prefix_hits"] >= 1 and stats["cow_copies"] == 1
