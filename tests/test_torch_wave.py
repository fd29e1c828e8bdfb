"""The wave prefill in the port (chunked prefill and grouped admission),
against the reference.

* ``copy_paged_cache_page`` with a (G,) vector of COW pairs (one per wave
  lane) equals the reference's, bit for bit.
* The wave contracts of the reference's ``tests/test_tail_latency.py``
  held inside the port (reduced yi-6b, the port's own weights, CPU, plain
  kernel versions): every chunk width and group gives the monolithic
  engine's greedy streams token for token through one wave signature
  (``{"prefill": 0, "decode_chunk": 1, "prefill_chunk": 1}``); a
  prefilling lane is not idle (no stall); waves compose with the host
  swap, with speculative decoding and with the prefix cache's cold tier;
  zero leaks on both pools.
* Cross-package: the port's wave engine and the reference's
  (``prefill_chunk=3, admit_group=2``) on the same prompts and the
  reference's weights, in ``dense`` and ``w8a8_nibble``: equal streams
  under ``test_torch_engine.py``'s tie rule, and equal ``prefill_waves``
  and preemptions where no stream diverges.
"""

import numpy as np
import pytest
import torch

import test_torch_prefix_cache as tpc
from repro.models import transformer as jtransformer
from test_torch_spec_decode import cross_package
from repro_torch.configs import get_config, reduced
from repro_torch.models import copy_paged_cache_page, model_init
from repro_torch.serve import Engine, ServeConfig, run_timed_workload

torch.set_num_threads(1)

WAVE_COUNTS = {"prefill": 0, "decode_chunk": 1, "prefill_chunk": 1}


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


# ---------------------------------------------------------------------------
# The wave's COW pairs against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pairs", [[(3, 5), (0, 0), (7, 2)], [(0, 0)] * 3,
                                   [(1, 8)]])
def test_copy_paged_cache_page_pairs_match_reference(pairs):
    jc, tc = tpc._pool_pair(11)
    src, dst = (np.asarray(v, np.int32) for v in zip(*pairs))
    copy_paged_cache_page(tc, torch.as_tensor(src), torch.as_tensor(dst))
    jc = jtransformer.copy_paged_cache_page(jc, src, dst)
    tpc._assert_pools_equal(tc, jc)


# ---------------------------------------------------------------------------
# Chunked prefill and grouped admission == monolithic, inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [2, 3, 8])
def test_chunked_prefill_bitmatches_monolithic(model, chunk):
    """Every chunk width (8 never splits a prompt) gives the monolithic
    engine's streams through one wave signature; the monolithic prefill
    never runs."""
    cfg, params = model
    prompts = _prompts(cfg.vocab_size, (7, 5, 6, 4), seed=0)
    _, want = _drive(cfg, params, prompts, [6] * 4, _scfg())
    engine, got = _drive(cfg, params, prompts, [6] * 4,
                         _scfg(prefill_chunk=chunk))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert engine.compile_counts == WAVE_COUNTS
    assert engine.stats["prefill_waves"] >= 1
    assert engine.stats["prefill_tokens"] == sum(len(p) for p in prompts)
    assert _leaks(engine) == 0


def test_chunked_prefill_batch1_backlog_no_stall(model):
    """One slot mid-prefill (inactive but progressing) with a second
    request queued: the scheduler keeps running waves instead of raising
    its stall error."""
    cfg, params = model
    prompts = _prompts(cfg.vocab_size, (7, 5), seed=1)
    _, want = _drive(cfg, params, prompts, [5, 5], _scfg(batch=1))
    engine, got = _drive(cfg, params, prompts, [5, 5],
                         _scfg(batch=1, prefill_chunk=2))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert _leaks(engine) == 0


def test_grouped_admission_bitmatches_serialized(model):
    """A simultaneous burst admitted as one (G, prefill_len) wave gives the
    serialized engine's streams in one wave."""
    cfg, params = model
    prompts = _prompts(cfg.vocab_size, (7, 5, 6), seed=2)
    _, want = _drive(cfg, params, prompts, [6] * 3, _scfg())
    engine, got = _drive(cfg, params, prompts, [6] * 3,
                         _scfg(admit_group=3))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert engine.compile_counts == WAVE_COUNTS
    assert engine.stats["prefill_waves"] == 1
    assert _leaks(engine) == 0


def test_chunked_plus_grouped_bitmatch(model):
    cfg, params = model
    prompts = _prompts(cfg.vocab_size, (7, 6, 5, 7, 4), seed=3)
    _, want = _drive(cfg, params, prompts, [6] * 5, _scfg())
    engine, got = _drive(cfg, params, prompts, [6] * 5,
                         _scfg(prefill_chunk=3, admit_group=2))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert engine.compile_counts == WAVE_COUNTS
    assert _leaks(engine) == 0


def test_wave_config_rules(model):
    cfg, params = model
    with pytest.raises(ValueError, match="require"):
        Engine(cfg, params, _scfg(cache_mode="dense", page_size=None,
                                  prefill_chunk=4), device="cpu")
    with pytest.raises(ValueError, match="prefill_len"):
        Engine(cfg, params, _scfg(admit_group=2, prefill_len=0),
               device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk must be"):
        Engine(cfg, params, _scfg(prefill_chunk=-1), device="cpu")
    with pytest.raises(ValueError, match="admit_group must be"):
        Engine(cfg, params, _scfg(admit_group=0), device="cpu")


def test_evicted_prefilling_lane_restarts_its_prompt(model):
    """A lane evicted mid-prefill drops its chunk cursor and COW pair with
    its pages; on re-admission its prompt restarts from 0, and both
    streams equal their solo monolithic runs."""
    cfg, params = model
    lo_p, hi_p = _prompts(cfg.vocab_size, (7, 4), seed=4)
    engine = Engine(cfg, params, _scfg(batch=1, prefill_chunk=2),
                    device="cpu")
    lo = engine.submit(lo_p, 5)
    engine.start()
    engine._admit(0.0)
    engine._run_wave()
    assert engine._prefill_next[0] == 2
    hi = engine.submit(hi_p, 4, priority=5)
    engine._admit(0.0)
    assert engine.preemptions == 1
    assert engine._slots[0].id == hi and engine._prefill_next[0] == 0
    done = engine.run()
    assert done[lo].preemptions == 1
    for rid, prompt, n in ((lo, lo_p, 5), (hi, hi_p, 4)):
        _, (ref,) = _drive(cfg, params, [prompt], [n], _scfg(batch=1))
        assert done[rid].tokens == ref.tokens, rid
    assert engine.stats["prefill_tokens"] == 2 + len(lo_p) + len(hi_p)
    assert _leaks(engine) == 0


# ---------------------------------------------------------------------------
# Compositions
# ---------------------------------------------------------------------------

def test_all_three_mechanisms_compose(model):
    """Chunked + grouped + swap on one overcommitted pool: the plain
    engine's streams, the wave pins, no leak on either pool."""
    cfg, params = model
    prompts = _prompts(cfg.vocab_size, (4, 6, 5, 7, 6), seed=7)
    budgets = [8] * 5
    over = dict(alloc_mode="incremental", num_pages=7)
    _, want = _drive(cfg, params, prompts, budgets, _scfg(**over))
    engine, got = _drive(cfg, params, prompts, budgets,
                         _scfg(prefill_chunk=3, admit_group=2,
                               swap_mode="host", **over))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert engine.stats["preemptions"] >= 1
    assert engine.compile_counts == WAVE_COUNTS
    assert _leaks(engine) == 0
    assert engine.host_pool.in_use == 0


def test_spec_decode_composes_with_wave_and_swap(model):
    """Spec keeps its draft/verify pins while the wave replaces the
    prefill, and its streams equal the plain non-spec engine's."""
    cfg, params = model
    prompts = _prompts(cfg.vocab_size, (7, 5, 6), seed=8)
    budgets = [6] * 3
    _, want = _drive(cfg, params, prompts, budgets, _scfg())
    engine, got = _drive(cfg, params, prompts, budgets,
                         _scfg(spec_decode=True, spec_k=3, prefill_chunk=4,
                               swap_mode="host"))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert engine.compile_counts == {"prefill": 0, "decode_chunk": 0,
                                     "prefill_chunk": 1, "draft": 1,
                                     "verify": 1}
    assert _leaks(engine) == 0


def test_cold_tier_composes_with_chunked_prefill(model):
    """Prefix hits (hot and cold) with chunked prefill: suffix chunks start
    past the cached prefix, and the streams equal the plain uncached
    engine's."""
    cfg, params = model
    rng = np.random.default_rng(13)
    head = rng.integers(0, cfg.vocab_size, 4)
    prompts = [np.concatenate([head, rng.integers(0, cfg.vocab_size, 3)])
               .astype(np.int32) for _ in range(3)]
    _, want = _drive(cfg, params, prompts, [4] * 3, _scfg(batch=1))
    engine, got = _drive(cfg, params, prompts, [4] * 3,
                         _scfg(batch=1, prefix_cache=True, prefill_chunk=2,
                               swap_mode="host"))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert engine.stats["prefix_hits"] >= 1
    assert engine.stats["prefill_tokens"] < sum(len(p) for p in prompts)
    assert engine.compile_counts == WAVE_COUNTS
    assert _leaks(engine) == 0


def test_wave_cow_on_fully_covered_prompt(model):
    """A page-aligned prompt submitted twice: the second admission shares
    every page but the tail, whose COW copy runs with its final (one-row)
    chunk; both streams equal the uncached engine's."""
    cfg, params = model
    twice = _prompts(cfg.vocab_size, (8,), seed=5)[0]
    _, want = _drive(cfg, params, [twice], [5], _scfg(batch=1))
    engine, got = _drive(cfg, params, [twice, twice], [5, 5],
                         _scfg(batch=1, prefix_cache=True, prefill_chunk=3))
    assert [r.tokens for r in got] == [want[0].tokens] * 2
    assert engine.stats["cow_copies"] == 1
    assert engine.stats["prefill_tokens"] == len(twice) + 1
    assert _leaks(engine) == 0


def test_bursty_workload_reports_wave_columns(model):
    cfg, params = model
    engine = Engine(cfg, params, _scfg(prefill_chunk=2, admit_group=2),
                    device="cpu")
    r = run_timed_workload(engine, cfg.vocab_size, requests=5,
                           prompt_budget=8, new_tokens=4, stagger_s=0.005,
                           seed=3, arrival_mode="bursty")
    assert r["prefill_waves"] == engine.stats["prefill_waves"] >= 1
    assert r["compile_counts"] == WAVE_COUNTS


# ---------------------------------------------------------------------------
# Cross-package parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["dense", "w8a8_nibble"])
def test_wave_engine_matches_reference(monkeypatch, mode):
    """``prefill_chunk=3, admit_group=2`` on 3 slots over an overcommitted
    incremental pool (preemptions restart prompts), 6 prompts of 3-8
    tokens x 6 new tokens, both packages on the reference's weights; every
    stream is equal in both modes, so the counters are held equal."""
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, n).astype(np.int32)
               for n in (5, 8, 3, 7, 4, 6)]
    teng, compared = cross_package(
        monkeypatch, mode, prompts, 6, mode, batch=3, max_len=16,
        prefill_len=8, decode_chunk=3, cache_mode="paged", page_size=4,
        alloc_mode="incremental", num_pages=8, prefill_chunk=3,
        admit_group=2)
    assert compared                   # every stream equal: counters held
    assert teng.stats["prefill_waves"] >= 3
    assert teng.stats["preemptions"] >= 1
    assert teng.compile_counts == WAVE_COUNTS
