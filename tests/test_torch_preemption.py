"""Incremental page allocation and evict-and-resume preemption in the
port's engine: the contracts of the reference's ``tests/test_preemption.py``
held inside the port (a preempted greedy stream equals an uninterrupted
one in ``quant_mode="dense"``, where rows do not depend on each other; an
overcommitted pool drains with zero leaks and one signature per stage),
and one cross-package case: the same overcommitted workload on the
reference engine and on the port gives the same greedy streams, under
``test_torch_engine.py``'s tie rule, and the same preemptions per request.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.engine as jengine
import test_torch_engine as te
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import model_init as jmodel_init
from repro_torch.configs import get_config, reduced
from repro_torch.models import load_jax_params, model_init
from repro_torch.serve import Engine, ServeConfig, draw_workload

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


def _engine(cfg, params, scfg):
    return Engine(cfg, params, scfg, device="cpu")


def _drive(cfg, params, prompts, budgets, scfg, priorities=None):
    engine = _engine(cfg, params, scfg)
    priorities = priorities or [0] * len(prompts)
    ids = [engine.submit(p, n, priority=pr)
           for p, n, pr in zip(prompts, budgets, priorities)]
    done = engine.run()
    return engine, [done[i] for i in ids]


def _prompts(seed, vocab, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# Incremental allocation: overcommitted pool, zero leaks, bit-match
# ---------------------------------------------------------------------------

def test_overcommitted_pool_drains_bitmatch(model):
    """4 requests x 4 pages worst case through an allocatable pool of 6:
    every request drains, every page returns, each stage keeps one
    signature, and the streams equal an uncontended dense-cache engine's."""
    cfg, params = model
    prompts = _prompts(0, cfg.vocab_size, (4, 6, 5, 7))
    budgets = [8, 8, 8, 8]
    _, want = _drive(cfg, params, prompts, budgets,
                     _scfg(cache_mode="dense", page_size=None))
    engine, got = _drive(cfg, params, prompts, budgets,
                         _scfg(alloc_mode="incremental", num_pages=7))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert engine.leaked_pages() == 0
    assert engine.allocator.available == engine.allocator.capacity
    assert engine.compile_counts == {"prefill": 1, "decode_chunk": 1}
    assert engine.stats["preemptions"] >= 1
    assert sum(r.preemptions for r in got) == engine.stats["preemptions"]
    assert 0.0 < engine.stats["occupancy"] <= 1.0


def test_overcommit_raises_concurrency_vs_reserve(model):
    """Booking live pages instead of worst cases admits more concurrent
    requests from the same pool."""
    cfg, params = model
    prompts = _prompts(1, cfg.vocab_size, (5,) * 4)
    res, _ = _drive(cfg, params, prompts, [8] * 4,
                    _scfg(alloc_mode="reserve", num_pages=5))
    inc, _ = _drive(cfg, params, prompts, [8] * 4,
                    _scfg(alloc_mode="incremental", num_pages=5))
    assert res.stats["concurrency"] <= 1.0 + 1e-9
    assert inc.stats["concurrency"] > res.stats["concurrency"]
    assert inc.leaked_pages() == 0 and res.leaked_pages() == 0


def test_incremental_frees_tail_pages_on_early_eos(model):
    """An early-EOS request under incremental allocation never books its
    unreached tail; reserve mode books the worst case up front."""
    cfg, params = model

    def run_mode(alloc_mode, eos_id=-1):
        engine = _engine(cfg, params, _scfg(
            batch=1, max_len=32, decode_chunk=2, alloc_mode=alloc_mode,
            eos_id=eos_id))
        rid = engine.submit(np.asarray([1, 2, 3, 4]), 20)
        return engine.run()[rid]

    eos = run_mode("reserve").tokens[2]
    res = run_mode("reserve", eos_id=eos)
    inc = run_mode("incremental", eos_id=eos)
    assert res.tokens == inc.tokens
    assert res.cache_rows == 24               # ceil((4 + 20 - 1) / 4) pages
    assert inc.cache_rows < res.cache_rows


# ---------------------------------------------------------------------------
# Preemption: evict-and-resume, bit-identical greedy resume
# ---------------------------------------------------------------------------

def test_high_priority_arrival_preempts_and_victim_resumes(model):
    """batch=1: a high-priority arrival evicts the running request; the
    victim resumes later and both streams equal uninterrupted solo runs."""
    cfg, params = model
    lo_p, hi_p = _prompts(2, cfg.vocab_size, (5, 4))
    scfg = _scfg(batch=1, decode_chunk=2)
    engine = _engine(cfg, params, scfg)
    lo = engine.submit(lo_p, 6)
    engine._t0 = time.perf_counter()
    engine._admit(0.0)
    assert engine._slots[0] is not None and engine._slots[0].id == lo
    engine._run_chunk(0.0)
    hi = engine.submit(hi_p, 5, priority=5)
    engine._admit(0.0)                         # full batch: evicts lo
    assert engine._slots[0].id == hi
    assert engine.preemptions == 1
    done = engine.run()
    assert engine.leaked_pages() == 0
    assert done[lo].preemptions == 1
    assert done[hi].t_done <= done[lo].t_done
    for rid, prompt, n in ((lo, lo_p, 6), (hi, hi_p, 5)):
        _, (ref,) = _drive(cfg, params, [prompt], [n], scfg)
        assert done[rid].tokens == ref.tokens, rid
    # the victim's replayed tokens kept their first emission stamps
    assert len(done[lo].t_tokens) == len(done[lo].tokens)
    assert engine.compile_counts == {"prefill": 1, "decode_chunk": 1}


def test_no_slot_eviction_for_page_infeasible_arrival(model):
    """An arrival whose pages could not be covered even after evicting
    every strictly weaker runner costs nobody their slot."""
    cfg, params = model
    engine = _engine(cfg, params, _scfg(batch=2, decode_chunk=2,
                                        num_pages=6))
    a = engine.submit(np.asarray([1, 2, 3, 4, 5]), 8, priority=10)
    b = engine.submit(np.asarray([6, 7, 8, 9, 10]), 4, priority=1)
    engine._t0 = time.perf_counter()
    engine._admit(0.0)
    assert {r.id for r in engine._slots if r is not None} == {a, b}
    assert engine.allocator.available == 0
    # C needs 4 pages; evicting B recovers only 2 and A outranks C
    c = engine.submit(np.arange(1, 8), 9, priority=5)
    engine._admit(0.0)
    assert engine.preemptions == 0
    assert {r.id for r in engine._slots if r is not None} == {a, b}
    done = engine.run()
    assert set(done) == {a, b, c}
    assert engine.leaked_pages() == 0


def test_arrival_during_admission_window_is_not_a_stall(model):
    cfg, params = model
    engine = _engine(cfg, params, _scfg(batch=1))
    a = engine.submit(np.asarray([1, 2, 3]), 1, arrival=0.0)
    b = engine.submit(np.asarray([4, 5, 6]), 3, arrival=1e-4)
    done = engine.run()
    assert set(done) == {a, b}
    assert len(done[b].tokens) == 3
    assert engine.leaked_pages() == 0


def test_equal_priority_never_preempts(model):
    cfg, params = model
    engine = _engine(cfg, params, _scfg(batch=1, decode_chunk=2))
    a = engine.submit(np.asarray([1, 2, 3]), 4, priority=2)
    engine._t0 = time.perf_counter()
    engine._admit(0.0)
    engine.submit(np.asarray([4, 5, 6]), 4, priority=2)
    engine._admit(0.0)
    assert engine._slots[0] is not None and engine._slots[0].id == a
    assert engine.preemptions == 0
    engine.run()
    assert engine.leaked_pages() == 0


def test_preemption_in_dense_mode(model):
    """Slot preemption does not depend on paging."""
    cfg, params = model
    lo_p, hi_p = _prompts(3, cfg.vocab_size, (5, 3))
    scfg = _scfg(batch=1, decode_chunk=2, cache_mode="dense",
                 page_size=None)
    engine = _engine(cfg, params, scfg)
    lo = engine.submit(lo_p, 6)
    engine._t0 = time.perf_counter()
    engine._admit(0.0)
    engine._run_chunk(0.0)
    engine.submit(hi_p, 4, priority=9)
    engine._admit(0.0)
    assert engine._slots[0].id != lo and engine.preemptions == 1
    done = engine.run()
    _, (ref,) = _drive(cfg, params, [lo_p], [6], scfg)
    assert done[lo].tokens == ref.tokens
    assert engine.stats["pool_pages"] == 0 and engine.leaked_pages() == 0


def test_preempted_mid_replay_carries_full_stream(model):
    """Evicting a slot still replaying splices the unreplayed tail back:
    nothing of the stream is lost or duplicated."""
    cfg, params = model
    (prompt,) = _prompts(4, cfg.vocab_size, (4,))
    scfg = _scfg(batch=1, decode_chunk=2)
    engine = _engine(cfg, params, scfg)
    rid = engine.submit(prompt, 8)
    engine._t0 = time.perf_counter()
    engine._admit(0.0)
    for _ in range(3):                        # 1 + 3 x 2 tokens
        engine._run_chunk(0.0)
    engine._evict(0)
    engine._admit(0.0)
    engine._run_chunk(0.0)
    assert engine._slot_forced[0]             # replay still pending
    engine._evict(0)
    done = engine.run()
    _, (ref,) = _drive(cfg, params, [prompt], [8], scfg)
    assert done[rid].tokens == ref.tokens
    assert done[rid].preemptions == 2
    assert engine.leaked_pages() == 0


# ---------------------------------------------------------------------------
# Bookkeeping and the batch API
# ---------------------------------------------------------------------------

def test_stage_counter_tracks_signatures(model):
    """A new prompt budget is a new prefill signature, as a new jit
    signature is in the reference."""
    cfg, params = model
    engine = _engine(cfg, params, _scfg(prefill_len=0, cache_mode="dense",
                                        page_size=None))
    for n in (3, 3, 5):
        engine.submit(np.arange(1, n + 1), 2)
    engine.run()
    assert engine.compile_counts == {"prefill": 2, "decode_chunk": 1}


def test_submit_truncation_is_explicit(model):
    cfg, params = model
    engine = _engine(cfg, params, _scfg(batch=1, cache_mode="dense",
                                        page_size=None))
    rid = engine.submit(np.asarray([1, 2, 3, 4, 5]), 100)
    done = engine.run()
    assert done[rid].truncated
    assert len(done[rid].tokens) == 16 - 5
    ok = engine.submit(np.asarray([1, 2, 3]), 4)
    assert not engine.run()[ok].truncated


def test_generate_is_rectangular_and_names_eos(model):
    cfg, params = model
    probe = _engine(cfg, params, ServeConfig(batch=2, max_len=16))
    prompts = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]])
    out = probe.generate(prompts, 6)
    assert out.shape == (2, 10) and out.dtype == torch.int32
    assert out.device == probe.device
    assert torch.equal(out[:, :4], prompts.int())
    # the same streams as submit/run
    ids = [probe.submit(p, 6) for p in prompts]
    done = probe.run()
    assert [done[i].tokens for i in ids] == out[:, 4:].tolist()
    eos = int(out[0, 5])                      # first row's second token
    engine = _engine(cfg, params, ServeConfig(batch=2, max_len=16,
                                              eos_id=eos))
    with pytest.raises(RuntimeError, match=f"eos_id={eos}"):
        engine.generate(prompts, 6)
    with pytest.raises(ValueError, match="batch"):
        probe.generate(prompts[:1], 6)


def test_scheduler_stall_raises_not_spins(model):
    cfg, params = model
    engine = _engine(cfg, params, _scfg(batch=2, num_pages=5))
    engine.allocator.alloc(3)                 # simulate a leak
    engine.submit(np.asarray([1, 2, 3, 4, 5]), 4)
    with pytest.raises(RuntimeError, match="stalled"):
        engine.run()


def test_incremental_requires_paged(model):
    cfg, params = model
    with pytest.raises(ValueError, match="incremental"):
        _engine(cfg, params, ServeConfig(batch=1, max_len=16,
                                         alloc_mode="incremental"))
    with pytest.raises(ValueError, match="alloc_mode"):
        _engine(cfg, params, ServeConfig(batch=1, max_len=16,
                                         alloc_mode="lazy"))


def test_serve_overrides_reach_the_model_config(model):
    """The overrides change the engine's config, not the caller's."""
    cfg, params = model
    engine = _engine(cfg, params, ServeConfig(
        batch=2, max_len=16, quant_mode="w8a8_nibble", cache_mode="paged",
        page_size=8, num_pages=3))
    assert engine.cfg.quant_mode == "w8a8_nibble"
    assert engine.cfg.page_size == 8 and engine.cfg.num_pages == 3
    assert engine.stats["pool_pages"] == 3
    assert cfg.quant_mode == "dense"          # the caller's config stays


# ---------------------------------------------------------------------------
# Cross-package: the reference engine and the port on one workload
# ---------------------------------------------------------------------------

def test_overcommitted_workload_matches_reference(monkeypatch):
    """All arrivals at 0, aging 0, the overcommitted incremental pool:
    equal greedy streams (a divergence only at an exact tie of the
    reference's logits) and equal preemptions, per request and in all."""
    over = dict(quant_mode="dense", attn_impl="flash", cache_mode="paged",
                page_size=4, n_layers=2)
    jcfg = jreduced(jget_config("yi-6b")).replace(**over)
    tcfg = reduced(get_config("yi-6b")).replace(**over)
    jparams = jax.jit(jmodel_init, static_argnums=1)(jax.random.PRNGKey(0),
                                                      jcfg)
    tree = jax.tree_util.tree_map(
        lambda a: np.array(a.astype(jnp.float32)), jparams)
    tparams = load_jax_params(tree, tcfg, device="cpu")
    draw = draw_workload(jcfg.vocab_size, requests=6, prompt_budget=8,
                         new_tokens=8, seed=11)
    kw = dict(batch=3, max_len=16, prefill_len=8, decode_chunk=3,
              alloc_mode="incremental", num_pages=7)

    records = te._recorders(monkeypatch)
    jeng = jengine.Engine(jcfg, jparams, jengine.ServeConfig(**kw))
    jids = [jeng.submit(p, 8) for p in draw.prompts]
    jdone = jeng.run()
    teng = Engine(tcfg, tparams, ServeConfig(**kw), device="cpu")
    tids = [teng.submit(p, 8) for p in draw.prompts]
    tdone = teng.run()

    assert teng.stats["preemptions"] == jeng.stats["preemptions"] >= 1
    assert ([tdone[i].preemptions for i in tids]
            == [jdone[i].preemptions for i in jids])
    assert teng.leaked_pages() == 0
    assert teng.compile_counts == {"prefill": 1, "decode_chunk": 1}
    for jid, tid, prompt in zip(jids, tids, draw.prompts):
        want, got = jdone[jid].tokens, tdone[tid].tokens
        assert len(got) == len(want) == 8
        diff = [i for i in range(8) if want[i] != got[i]]
        if not diff:
            continue
        i = diff[0]
        _, logits = te._reference_logits(records, prompt, want, i)
        margin = logits[want[i]] - logits[got[i]]
        assert margin <= te.LOGIT_TOL, (
            f"streams diverge at token {i} where the reference's margin "
            f"is {margin} > {te.LOGIT_TOL}: not a tie")
