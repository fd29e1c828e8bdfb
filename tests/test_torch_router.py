"""Port parity for the DP router (``repro_torch.serve.router``) against the
reference's ``Router`` (``tests/test_router.py``'s scenarios and sizes):
reduced yi-6b in ``quant_mode="dense"`` (w8a8 activation scales span the
batch, so placement legitimately moves quantized streams), the same
weights in both packages (``load_jax_params``), the reference's stages
compiled without excess precision (``test_torch_model.exact_engine``).

On the same submissions, all at arrival 0, the port's fleet must equal
the reference's fleet in every placement decision (``placements``,
``placement_order``, ``affinity_hits``, each request's replica-local id)
and in every greedy stream, keyed by global id, and both must equal the
port's solo engine.  The timed driver runs a fleet unchanged and reports
its topology; bad sizing raises; no page leaks.  (The ``cuda`` case of a
two-replica fleet with captured stages is in ``test_torch_graphs.py``,
which runs on the card without JAX.)"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_model as tm
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.serve import Router as JRouter
from repro.serve import ServeConfig as JServeConfig
from repro.serve.workload import run_timed_workload as jrun_timed_workload
from repro_torch.configs import get_config, reduced
from repro_torch.models import load_jax_params
from repro_torch.serve import Engine, Router, ServeConfig, \
    run_timed_workload
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _weights():
    """The reference's weights (``PRNGKey(0)``, as ``test_router.py``) and
    the port's copy of them."""
    jcfg = jreduced(jget_config("yi-6b"))
    jp = tm.jmodel_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.array(a.astype(jnp.float32)),
                                  jp)
    tcfg = reduced(get_config("yi-6b"))
    return jcfg, jp, tcfg, load_jax_params(tree, tcfg, device="cpu")


def _kw(**over):
    kw = dict(batch=2, max_len=16, prefill_len=8, decode_chunk=3,
              cache_mode="paged", page_size=4, alloc_mode="incremental")
    kw.update(over)
    return kw


def _prompts(vocab, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, rng.integers(3, 8)) for _ in range(n)]


def _fleets(monkeypatch, **over):
    """The reference's fleet and the port's, on the same weights."""
    tm.exact_engine(monkeypatch)
    jcfg, jp, tcfg, tp = _weights()
    return (JRouter(jcfg, jp, JServeConfig(**_kw(**over)), replicas=2),
            Router(tcfg, tp, ServeConfig(**_kw(**over)), replicas=2,
                   device="cpu"))


def _placement(router, done):
    return (router.placements, router.placement_order,
            router.affinity_hits,
            {g: r.id for g, r in done.items()})


@pytest.mark.parametrize("over", [
    {}, dict(alloc_mode="reserve"),
    dict(cache_mode="dense", page_size=None, alloc_mode="reserve")],
    ids=["paged-incremental", "paged-reserve", "dense-slab"])
def test_routed_streams_equal_solo_and_reference(monkeypatch, over):
    """Every routed greedy stream equals the port's solo engine's and the
    reference fleet's for the same submissions, keyed by global id; every
    placement and replica-local id equals the reference's."""
    jr, tr = _fleets(monkeypatch, **over)
    _, _, tcfg, tp = _weights()
    prompts = _prompts(tcfg.vocab_size)
    solo = Engine(tcfg, tp, ServeConfig(**_kw(**over)), device="cpu")
    ids = [solo.submit(p, 6) for p in prompts]
    solo_done = solo.run()
    jg = [jr.submit(p, 6) for p in prompts]
    tg = [tr.submit(p, 6) for p in prompts]
    assert tg == jg == list(range(len(prompts)))
    jdone, tdone = jr.run(), tr.run()
    assert [tdone[g].tokens for g in tg] == [solo_done[i].tokens
                                             for i in ids]
    assert [tdone[g].tokens for g in tg] == [jdone[g].tokens for g in jg]
    assert _placement(tr, tdone) == _placement(jr, jdone)
    assert {r.id for r in tdone.values()} >= {1 << 20}   # replica 1's block
    assert tr.compile_counts == jr.compile_counts == {"prefill": 1,
                                                      "decode_chunk": 1}
    assert tr.capture_counts == {"decode_chunk": 0}
    assert tr.leaked_pages() == 0


def test_jsq_spreads_uniform_arrivals_as_reference(monkeypatch):
    """Simultaneous arrivals on an idle fleet split [4, 4] (queued plus
    running requests), in the reference's order; the fleet stats carry
    the reference's keys."""
    jr, tr = _fleets(monkeypatch)
    for router in (jr, tr):
        for p in _prompts(256, n=8, seed=1):
            router.submit(p, 4)
    jdone, tdone = jr.run(), tr.run()
    assert tr.placements == [4, 4]
    assert _placement(tr, tdone) == _placement(jr, jdone)
    js, ts = jr.stats, tr.stats
    assert set(ts) == set(js)
    assert ts["dp_replicas"] == 2 and sum(ts["placements"]) == 8
    assert [r["placed"] for r in ts["per_replica"]] == [4, 4]
    assert [set(r) for r in ts["per_replica"]] == [set(r) for r in
                                                   js["per_replica"]]
    for key in ("preemptions", "pool_pages", "prefill_tokens",
                "decode_chunks", "placements"):
        assert ts[key] == js[key], key


def test_places_high_priority_first_as_reference(monkeypatch):
    """Both classes queued at t=0: the router's own priority queue hands
    the high-priority request to a replica first, though the low one was
    submitted earlier."""
    jr, tr = _fleets(monkeypatch)
    orders = []
    for router in (jr, tr):
        lo = router.submit(_prompts(256)[0], 4, priority=0)
        hi = router.submit(_prompts(256)[1], 4, priority=1)
        done = router.run()
        assert router.placement_order[:2] == [hi, lo]
        orders.append(_placement(router, done))
    assert orders[0] == orders[1]


def test_prefix_affinity_follows_cached_pages_as_reference(monkeypatch):
    """Two drain cycles: the first seeds one replica's prefix index, and
    in the second all three requests sharing the cached head follow it
    (4 placed, 3 affinity hits, rate 0.75), in both packages."""
    jr, tr = _fleets(monkeypatch, prefix_cache=True)
    got = []
    for router in (jr, tr):
        rng = np.random.default_rng(5)
        head = rng.integers(0, 256, 4)                 # one full page

        def mk():
            return np.concatenate([head, rng.integers(0, 256, 3)])

        router.submit(mk(), 4)
        first = router.run()
        seeded = router.placements.index(1)
        for _ in range(3):
            router.submit(mk(), 4)
        second = router.run()
        assert router.placements[seeded] == 4
        assert router.affinity_hits[seeded] == 3
        assert router.stats["per_replica"][seeded]["affinity_hit_rate"] \
            == 0.75
        router.release_prefix_cache()
        assert router.leaked_pages() == 0
        got.append((_placement(router, {**first, **second}),
                    {g: r.tokens for g, r in {**first, **second}.items()},
                    router.stats["prefix_hits"]))
    assert got[0] == got[1]


def test_timed_workload_runs_a_fleet(monkeypatch):
    """``run_timed_workload`` drives a fleet unchanged: one warm-up
    request per replica keeps one signature per stage, and the result
    carries the fleet topology (``tests/test_router.py``'s contract) under
    the reference's keys."""
    jr, tr = _fleets(monkeypatch, prefix_cache=True)
    kw = dict(requests=6, prompt_budget=8, new_tokens=4, shared_prefix=0.5)
    want = jrun_timed_workload(jr, 256, **kw)
    r = run_timed_workload(tr, 256, **kw)
    assert set(r) == set(want)
    assert r["dp_replicas"] == want["dp_replicas"] == 2
    assert r["device_count"] == want["device_count"] == 1
    assert r["mesh_shape"] == want["mesh_shape"] == [1, 1]
    assert len(r["per_replica"]) == 2
    assert sum(p["placed"] for p in r["per_replica"]) == 6
    assert [p["placed"] for p in r["per_replica"]] == \
        [p["placed"] for p in want["per_replica"]]
    assert r["compile_counts"] == {"prefill": 1, "decode_chunk": 1}
    assert r["tokens"] == want["tokens"] == 6 * 4
    tr.release_prefix_cache()
    assert tr.leaked_pages() == 0


def test_fleet_sizing_and_devices():
    """``replicas < 1``, and fewer ``devices`` than replicas, raise
    ``ValueError``; tensor-parallel replicas take disjoint ``dp * tp``
    slices (the reference's error when too few); the unmeshed replicas
    share the weights and the device, or sit one per device."""
    _, _, tcfg, tp = _weights()
    scfg = ServeConfig(**_kw())
    with pytest.raises(ValueError, match="replicas must be >= 1"):
        Router(tcfg, tp, scfg, replicas=0, device="cpu")
    with pytest.raises(ValueError, match="devices"):
        Router(tcfg, tp, scfg, replicas=3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="2 replicas x 2 devices/replica "
                                         "needs 4 devices but only 1"):
        Router(tcfg, tp, ServeConfig(**_kw(tp=2)), device="cpu")
    meshed = Router(tcfg, tp, ServeConfig(**_kw(tp=2)),
                    devices=["cpu"] * 4)
    assert meshed.device_count == 4 and meshed.mesh_shape == (1, 2)
    shared = Router(tcfg, tp, scfg, replicas=3, device="cpu")
    assert shared.device_count == 1 and shared.mesh_shape == (1, 1)
    ptrs = [t.data_ptr() for t in tree_leaves(tp)]
    for eng in shared.replicas:
        assert [t.data_ptr() for t in tree_leaves(eng.params)] == ptrs
    placed = Router(tcfg, tp, scfg, replicas=2, devices=["cpu", "cpu"])
    assert [e.device.type for e in placed.replicas] == ["cpu", "cpu"]
    assert placed.device_count == 1
    assert [e._next_id for e in placed.replicas] == [0, 1 << 20]


def test_router_defaults_to_cuda():
    """No fallback: without ``device="cpu"`` the fleet needs a card."""
    _, _, tcfg, tp = _weights()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        Router(tcfg, tp, ServeConfig(**_kw()))
