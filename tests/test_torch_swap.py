"""The host swap tier in the port (``HostPagePool``, swap-out on eviction,
swap-in on resume, the prefix cache's cold tier and capacity cap),
against the reference.

* ``extract_cache_pages`` -> ``insert_cache_pages`` round-trips pages bit
  for bit, as the reference's pair does on the same arrays.
* The reference's ``HostPagePool`` and tail-latency contracts
  (``tests/test_tail_latency.py``) held inside the port.
* What a swapped stream is held to.  A restore is a bit copy, but an
  eviction changes which rows share a decode batch; in ``w8a8_nibble``
  the activation scale is taken over the whole batch, so a preempted
  stream need not equal the uncontended one.  So the swap engine is held
  to the dense slab in ``dense`` (rows independent) and to the port's own
  replay engine in ``w8a8_nibble``.  The reference behaves the same way:
  on its ``test_swap_roundtrip_bitmatch`` workload in ``w8a8_nibble`` /
  ``xla`` its replay and swap engines give equal streams (a test below
  records it), while both differ from the slab.
* Cross-package: the port's swap engine against the reference's on one
  seed-pinned overcommitted workload, in ``dense`` and ``w8a8_nibble``:
  equal counters, equal streams under ``test_torch_engine.py``'s tie
  rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.serve.engine as jengine
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import transformer as jtransformer
from test_torch_model import _jax_params
from test_torch_prefix_cache import (
    _assert_pools_equal,
    _pool_pair,
    cross_package_run,
)
from repro_torch.configs import get_config, reduced
from repro_torch.models import (
    extract_cache_pages,
    insert_cache_pages,
    model_init,
)
from repro_torch.serve import Engine, HostPagePool, ServeConfig

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config("yi-6b"))
    return cfg, model_init(cfg, device="cpu")


def _scfg(**over):
    kw = dict(batch=3, max_len=16, prefill_len=8, decode_chunk=3,
              cache_mode="paged", page_size=4)
    kw.update(over)
    return ServeConfig(**kw)


def _drive(cfg, params, prompts, budgets, scfg):
    engine = Engine(cfg, params, scfg, device="cpu")
    ids = [engine.submit(p, n) for p, n in zip(prompts, budgets)]
    done = engine.run()
    return engine, [done[i] for i in ids]


def _leaks(engine) -> int:
    engine.release_prefix_cache()
    return engine.leaked_pages()


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


OVERCOMMIT = dict(alloc_mode="incremental", num_pages=7)


# ---------------------------------------------------------------------------
# Page payloads: extract -> insert, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad_to", [None, 4])
def test_extract_insert_roundtrip_matches_reference(pad_to):
    """Pages 3, 6, 1 out to host payloads, back into pages 2, 5, 8: the
    payloads hold the reference's values, and both packages' pools end
    bit-equal (with ``pad_to``, zero rows land on the trash page 0)."""
    jc, tc = _pool_pair(31)
    src, dst = [3, 6, 1], [2, 5, 8]
    jpay = jtransformer.extract_cache_pages(jc, src, pad_to=pad_to)
    tpay = extract_cache_pages(tc, src, pad_to=pad_to)
    assert len(tpay) == len(jpay) == 3
    for jp_, tp_ in zip(jpay, tpay):
        assert tp_.device.type == "cpu" and tp_.ndim == 1
        k, v = (np.asarray(a).view(np.int16) for a in jp_.values())
        # the flat payload: every layer's K rows, then its V rows
        rows = tp_.reshape(-1, *k.shape[1:])
        np.testing.assert_array_equal(
            rows[0::2].view(torch.int16).numpy(), k)
        np.testing.assert_array_equal(
            rows[1::2].view(torch.int16).numpy(), v)
    want = jtransformer.insert_cache_pages(jc, dst, jpay, pad_to=pad_to)
    insert_cache_pages(tc, dst, tpay, pad_to=pad_to)
    _assert_pools_equal(tc, want)
    for layer in tc:
        for key in ("k", "v"):
            assert torch.equal(layer[key][dst], layer[key][src])
    with pytest.raises(ValueError, match="payloads"):
        insert_cache_pages(tc, dst[:2], tpay)


# ---------------------------------------------------------------------------
# HostPagePool (tests/test_tail_latency.py)
# ---------------------------------------------------------------------------

def test_host_pool_alloc_store_load_free():
    pool = HostPagePool(4)
    assert pool.capacity == 4 and pool.available == 4
    pages = pool.alloc(2)
    assert pool.in_use == 2
    pool.store(pages[0], {"rows": 123})
    assert pool.load(pages[0]) == {"rows": 123}
    pool.free(pages)
    assert pool.in_use == 0 and pool.available == 4


def test_host_pool_payload_dies_with_last_holder():
    pool = HostPagePool(2)
    (p,) = pool.alloc(1)
    pool.store(p, "payload")
    pool.share([p])
    pool.free([p])
    assert pool.load(p) == "payload"
    pool.free([p])
    (q,) = pool.alloc(1)
    with pytest.raises(ValueError, match="no stored payload"):
        pool.load(q)


def test_host_pool_store_load_errors():
    pool = HostPagePool(2)
    (p,) = pool.alloc(1)
    with pytest.raises(ValueError, match="no stored payload"):
        pool.load(p)
    pool.free([p])
    with pytest.raises(ValueError, match="no outstanding references"):
        pool.store(p, "stale")
    with pytest.raises(ValueError, match="not currently allocated"):
        pool.free([p])
    with pytest.raises(ValueError, match="num_pages"):
        HostPagePool(0)


def test_host_pool_backpressure():
    pool = HostPagePool(2)
    held = pool.alloc(2)
    assert pool.alloc(1) is None
    assert not pool.can_alloc(1)
    pool.free(held[:1])
    assert pool.alloc(1) is not None


@given(num_pages=st.integers(1, 6),
       ops=st.lists(st.sampled_from(["alloc", "share", "free", "store"]),
                    min_size=1, max_size=40))
@settings(max_examples=60, deadline=None)
def test_host_pool_refcount_invariants(num_pages, ops):
    """Under any interleaving of alloc/share/free/store the pool's
    counters match a shadow refcount model, payloads are readable iff
    stored on a held page, and a payload dies with its last holder."""
    pool = HostPagePool(num_pages)
    rc: dict[int, int] = {}
    stored: dict[int, object] = {}
    for step, op in enumerate(ops):
        held = sorted(p for p, n in rc.items() if n > 0)
        if op == "alloc":
            got = pool.alloc(1)
            if len(held) >= num_pages:
                assert got is None
            else:
                assert got is not None
                (p,) = got
                assert rc.get(p, 0) == 0, "live id handed out twice"
                rc[p] = 1
                assert p not in stored
        elif op == "share" and held:
            p = held[step % len(held)]
            pool.share([p])
            rc[p] += 1
        elif op == "free" and held:
            p = held[step % len(held)]
            pool.free([p])
            rc[p] -= 1
            if rc[p] == 0:
                stored.pop(p, None)
                with pytest.raises(ValueError):
                    pool.load(p)
        elif op == "store" and held:
            p = held[step % len(held)]
            pool.store(p, ("payload", step))
            stored[p] = ("payload", step)
        assert pool.in_use == sum(1 for n in rc.values() if n > 0)
        assert pool.available == pool.capacity - pool.in_use
        for p, n in rc.items():
            assert pool.refcount(p) == n
        for p, payload in stored.items():
            assert pool.load(p) == payload


# ---------------------------------------------------------------------------
# Swap-resume in the engine
# ---------------------------------------------------------------------------

def _check_swap_engine(engine):
    st = engine.stats
    assert st["preemptions"] >= 1
    assert st["swap_out"] >= 1
    assert st["swap_in"] == st["swap_out"]
    assert st["replay_steps_saved"] >= 1
    assert st["host_pages"] == 2 * engine.allocator.capacity
    assert engine.compile_counts == {"prefill": 1, "decode_chunk": 1}
    assert _leaks(engine) == 0
    assert engine.host_pool.in_use == 0


@pytest.mark.parametrize("quant,backend", [
    ("dense", "torch"), ("dense", "cuda"),
    ("w8a8_nibble", "torch"), ("w8a8_nibble", "cuda")])
def test_swap_roundtrip_bitmatch(quant, backend):
    """The overcommitted pool evicts mid-stream; with the host swap every
    resume restores its rows by page copy.  Streams equal the dense slab's
    in ``dense`` and the port's replay engine's in ``w8a8_nibble`` (see
    the module docstring); zero leaks on both pools."""
    cfg = reduced(get_config("yi-6b")).replace(quant_mode=quant,
                                               quant_backend=backend)
    params = model_init(cfg, device="cpu")
    prompts = _prompts(cfg.vocab_size, (4, 6, 5, 7), seed=4)
    budgets = [8] * 4
    want_scfg = (_scfg(cache_mode="dense", page_size=None)
                 if quant == "dense" else _scfg(**OVERCOMMIT))
    _, want = _drive(cfg, params, prompts, budgets, want_scfg)
    engine, got = _drive(cfg, params, prompts, budgets,
                         _scfg(swap_mode="host", **OVERCOMMIT))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    _check_swap_engine(engine)


def test_swap_saves_decode_steps_vs_replay(model):
    cfg, params = model
    prompts = _prompts(cfg.vocab_size, (4, 6, 5, 7), seed=5)
    off, got_off = _drive(cfg, params, prompts, [8] * 4,
                          _scfg(**OVERCOMMIT))
    on, got_on = _drive(cfg, params, prompts, [8] * 4,
                        _scfg(swap_mode="host", **OVERCOMMIT))
    assert [r.tokens for r in got_on] == [r.tokens for r in got_off]
    assert on.stats["replay_steps_saved"] >= 1
    assert on.stats["decode_chunks"] < off.stats["decode_chunks"]
    assert on.stats["prefill_tokens"] < off.stats["prefill_tokens"]
    assert _leaks(on) == 0 and _leaks(off) == 0


def test_full_host_pool_falls_back_to_replay(model):
    """A one-page host pool cannot hold a victim's rows: the eviction
    falls back to replay-resume (``swap_out`` does not count it) and the
    streams still equal the slab's."""
    cfg, params = model
    prompts = _prompts(cfg.vocab_size, (4, 6, 5, 7), seed=4)
    _, want = _drive(cfg, params, prompts, [8] * 4,
                     _scfg(cache_mode="dense", page_size=None))
    engine, got = _drive(cfg, params, prompts, [8] * 4,
                         _scfg(swap_mode="host", host_pages=1, **OVERCOMMIT))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    st = engine.stats
    assert st["host_pages"] == 1
    assert st["swap_out"] < st["preemptions"]
    assert st["swap_in"] == st["swap_out"]
    assert _leaks(engine) == 0


def test_prefix_cache_pages_cap_reclaims(model):
    cfg, params = model
    prompts = _prompts(cfg.vocab_size, (5, 6, 7, 5, 6, 7), seed=10)
    engine, _ = _drive(cfg, params, prompts, [4] * 6,
                       _scfg(batch=2, num_pages=24, prefix_cache=True,
                             prefix_cache_pages=2))
    assert len(engine.prefix_cache) <= 2
    assert engine.prefix_capacity_reclaims >= 1
    assert _leaks(engine) == 0


def test_cold_tier_demotes_and_promotes(model):
    """The capped reclaim demotes the shared head chunk to a host page;
    a later request whose chain reaches it promotes it back (a prefix
    hit), and its stream equals the same request run uncached."""
    cfg, params = model
    rng = np.random.default_rng(9)
    head = rng.integers(0, cfg.vocab_size, 4)
    first, again = (np.concatenate([head, rng.integers(0, cfg.vocab_size,
                                                       3)])
                    for _ in range(2))
    evictors = _prompts(cfg.vocab_size, (5, 6, 7), seed=11)
    engine = Engine(cfg, params,
                    _scfg(batch=1, num_pages=24, prefix_cache=True,
                          prefix_cache_pages=1, swap_mode="host"),
                    device="cpu")
    ids = [engine.submit(p, 4) for p in (first, *evictors, again)]
    done = engine.run()
    st = engine.stats
    assert st["prefix_demotions"] >= 1
    assert st["prefix_cold_hits"] >= 1
    assert st["prefix_hits"] >= 1
    assert st["prefix_hit_rate"] > 0.0
    _, solo = _drive(cfg, params, [again], [4], _scfg(batch=1))
    assert done[ids[-1]].tokens == solo[0].tokens
    assert _leaks(engine) == 0
    assert engine.host_pool.in_use == 0


def test_swap_requires_paged(model):
    cfg, params = model
    with pytest.raises(ValueError, match="swap_mode='host' requires"):
        Engine(cfg, params, _scfg(cache_mode="dense", page_size=None,
                                  swap_mode="host"), device="cpu")
    with pytest.raises(ValueError, match="swap_mode must be"):
        Engine(cfg, params, _scfg(swap_mode="disk"), device="cpu")
    with pytest.raises(ValueError, match="host_pages must be"):
        Engine(cfg, params, _scfg(swap_mode="host", host_pages=-1),
               device="cpu")
    with pytest.raises(ValueError, match="prefix_cache_pages must be"):
        Engine(cfg, params, _scfg(prefix_cache=True, prefix_cache_pages=-1),
               device="cpu")


# ---------------------------------------------------------------------------
# The reference's own swap, and cross-package parity
# ---------------------------------------------------------------------------

def test_reference_replay_and_swap_agree_in_w8a8_xla():
    """The workload of the reference's
    ``test_swap_roundtrip_bitmatch[w8a8_nibble-xla]``: the reference's
    replay engine and its swap engine give equal streams (its swap is
    exact; what that test's slab expectation misses is the batch-wide
    activation scale)."""
    cfg = jreduced(jget_config("yi-6b")).replace(quant_mode="w8a8_nibble",
                                                 quant_backend="xla")
    params = _jax_params("yi-6b", 1)[0]
    prompts = [jnp.asarray(p) for p in
               _prompts(cfg.vocab_size, (4, 6, 5, 7), seed=4)]
    runs = []
    for swap in ("off", "host"):
        engine = jengine.Engine(cfg, params, jengine.ServeConfig(
            batch=3, max_len=16, prefill_len=8, decode_chunk=3,
            cache_mode="paged", page_size=4, swap_mode=swap, **OVERCOMMIT))
        ids = [engine.submit(p, 8) for p in prompts]
        done = engine.run()
        runs.append(([done[i].tokens for i in ids], engine.stats))
    (replay, st_off), (swapped, st_on) = runs
    assert st_off["preemptions"] >= 1
    assert st_on["swap_in"] >= 1 and st_on["preemptions"] >= 1
    assert swapped == replay


@pytest.mark.parametrize("prefix", [False, True], ids=["swap", "swap+prefix"])
@pytest.mark.parametrize("mode", ["dense", "w8a8_nibble"])
def test_swap_engine_matches_reference(monkeypatch, mode, prefix):
    """The overcommitted workload of ``test_swap_roundtrip_bitmatch`` on
    the reference's weights (2 layers) through both packages' swap
    engines, alone and with the prefix cache (prompts sharing a 4-token
    head), as the card's workload phase runs them."""
    prompts = _prompts(256, (4, 6, 5, 7, 6, 5), seed=4)
    if prefix:
        prompts = [np.concatenate([prompts[3][:4], p])[:8] for p in prompts]
    stats = cross_package_run(
        monkeypatch, mode, prompts, 8, batch=3, max_len=16, prefill_len=8,
        decode_chunk=3, cache_mode="paged", page_size=4, swap_mode="host",
        prefix_cache=prefix, **OVERCOMMIT)
    assert stats["swap_in"] >= 1 and stats["replay_steps_saved"] >= 1
    assert (stats["prefix_hits"] >= 1) == prefix
