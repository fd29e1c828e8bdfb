"""Port parity for the capacity model (``repro_torch.capacity``) against
the reference's ``repro.capacity``, and the engine's stage surface it
calibrates.

The model, the knob search and the validation are NumPy and plain Python
copied from the reference, so their results must be exactly equal (dict
equality) for the same inputs: ``predict`` on the closed-form cases of
``tests/test_capacity.py`` and on a seeded grid of knobs x shapes x
costs, ``knob_grid``, ``search`` under each objective (given the
reference's device rates; the port's default rates are the H100's),
``table_lines`` and ``validate_rows`` over the committed
``benchmarks/BENCH_serve.json``; ``analytic_cache_token_bytes`` and
``analytic_macs`` on all ten configs.  A ``Knobs`` built by the port
names the port's backend (``cuda``) where the reference's names ``xla``:
the knob comparisons leave that one field out and check it apart.

``calibrate_engine`` on CPU engines: every stage the mode built gets a
positive time, the others stay 0.0, and the streams the engine serves
after calibration equal those before it.  ``stage_programs()`` has the
reference engine's keys in the plain, wave, spec and wave + spec modes.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import repro.capacity as jcap
import repro.capacity.tune as jtune
import repro.capacity.validate as jvalidate
import repro_torch.capacity as tcap
import repro_torch.capacity.tune as ttune
import repro_torch.capacity.validate as tvalidate
from repro.configs import ARCH_NAMES as J_ARCH_NAMES
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch.mesh import HW
from repro.models import model_init as jmodel_init
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro.staticcheck.flops import analytic_macs as janalytic_macs
from repro_torch.capacity.calibrate import calibrate_engine, time_stage
from repro_torch.capacity import model as tmodel
from repro_torch.capacity.model import H100, analytic_macs
from repro_torch.configs import ARCH_NAMES, get_config, reduced
from repro_torch.models import model_init
from repro_torch.serve import Engine, ServeConfig

torch.set_num_threads(1)

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "BENCH_serve.json")


@pytest.fixture
def ref_rates(monkeypatch):
    """The reference's device rates in the port's static cost model, so
    the two searches rank the same numbers (the port's own are the
    H100's)."""
    monkeypatch.setattr(tmodel.H100, "PEAK_BF16_FLOPS", HW.PEAK_BF16_FLOPS)
    monkeypatch.setattr(tmodel.H100, "HBM_BW", HW.HBM_BW)


def _both(knobs=None, shape=None, costs=None):
    """The same inputs as the reference's and the port's dataclasses."""
    out = []
    for mod in (jcap, tcap):
        out.append((mod.Knobs(**knobs) if knobs is not None else None,
                    mod.WorkloadShape(**shape) if shape is not None
                    else None,
                    mod.StageCosts(**costs) if costs is not None
                    else None))
    return out


def _predict_both(knobs, shape, costs, **kw):
    """Each package's prediction, or its ``CapacityError`` message."""
    out = []
    for (k, s, c), mod in zip(_both(knobs, shape, costs), (jcap, tcap)):
        try:
            out.append(mod.predict(k, s, c, **kw))
        except mod.CapacityError as e:
            out.append(("CapacityError", str(e)))
    return out


def _knob_dict(k):
    d = k.to_dict()
    d.pop("quant_backend")
    return d


# ---------------------------------------------------------------------------
# predict
# ---------------------------------------------------------------------------

_SHAPE2 = dict(prompt_budget=2, stagger_s=0.0)
_COSTS = dict(prefill_s=0.01, decode_chunk_s=0.004)
CLOSED_FORM = {
    # name: (knobs, shape, costs, acceptance, expected closed-form values)
    "zero_arrival_batch": (
        dict(batch=2, max_len=16, decode_chunk=4, cache_mode="dense"),
        dict(requests=2, new_tokens=9, **_SHAPE2), _COSTS, None,
        dict(tokens=18, decode_chunks=2, preemptions=0, wall_s=0.028)),
    "single_stream": (
        dict(batch=2, max_len=32, decode_chunk=8, cache_mode="dense"),
        dict(requests=1, new_tokens=17, **_SHAPE2), _COSTS, None,
        dict(tokens=17, decode_chunks=2, wall_s=0.018, ttft_p50_ms=10.0)),
    "saturated_pool": (
        dict(batch=2, max_len=16, decode_chunk=4, cache_mode="paged",
             page_size=4, num_pages=4, alloc_mode="reserve"),
        dict(requests=2, new_tokens=9, **_SHAPE2), _COSTS, None,
        dict(tokens=18, preemptions=0, wall_s=0.036, pool_pages=4)),
    "pool_too_small": (
        dict(batch=2, max_len=16, decode_chunk=4, cache_mode="paged",
             page_size=4, num_pages=2, alloc_mode="reserve"),
        dict(requests=1, new_tokens=9, **_SHAPE2), _COSTS, None, None),
    "spec_geometric": (
        dict(batch=2, max_len=32, decode_chunk=8, cache_mode="paged",
             page_size=4, spec_decode=True, spec_k=4),
        dict(requests=2, new_tokens=17, **_SHAPE2),
        dict(prefill_s=0.01, draft_s=0.002, verify_s=0.004), 0.8,
        dict(tokens=34)),
}


@pytest.mark.parametrize("name", sorted(CLOSED_FORM))
def test_closed_form_predictions_equal_reference(name):
    knobs, shape, costs, alpha, want = CLOSED_FORM[name]
    ref, got = _predict_both(knobs, shape, costs, acceptance=alpha)
    assert got == ref
    if want is None:
        assert got[0] == "CapacityError" and "pool" in got[1]
        return
    assert got["feasible"]
    for key, value in want.items():
        assert got[key] == pytest.approx(value), key


def _random_case(seed):
    """One seeded (knobs, shape, costs, acceptance) draw over the knob
    space: dense or paged, reserve or incremental, overcommitted pools,
    the wave, the host swap, spec decoding, aging, priorities and
    bursty arrivals."""
    r = np.random.default_rng(seed)
    page = int(r.choice([2, 4, 8]))
    max_len = page * int(r.integers(3, 9))
    batch = int(r.integers(1, 5))
    paged = bool(r.random() < 0.8)
    knobs = dict(batch=batch, max_len=max_len,
                 prefill_len=int(r.choice([0, max_len // 2])),
                 decode_chunk=int(r.choice([1, 2, 4, 8])),
                 priority_aging_s=float(r.choice([0.0, 0.01])))
    if paged:
        knobs.update(cache_mode="paged", page_size=page,
                     alloc_mode=str(r.choice(["reserve", "incremental"])))
        parity = batch * (max_len // page) + 1
        knobs["num_pages"] = int(r.choice(
            [0, max(2, parity // 2), max(2, parity // 3)])) or None
        if r.random() < 0.3:
            knobs.update(prefill_chunk=int(r.choice([0, 2, 3])),
                         admit_group=int(r.integers(1, 3)))
            if not knobs["prefill_chunk"] and not knobs["prefill_len"]:
                knobs["prefill_len"] = max_len // 2
        if r.random() < 0.3:
            knobs.update(swap_mode="host",
                         host_pages=int(r.choice([0, 2])))
        if r.random() < 0.3:
            knobs.update(spec_decode=True, spec_k=int(r.integers(1, 5)))
    shape = dict(requests=int(r.integers(1, 12)),
                 prompt_budget=int(r.integers(2, max_len // 2 + 1)),
                 new_tokens=int(r.integers(1, max_len)),
                 stagger_s=float(r.choice([0.0, 0.001, 0.02])),
                 seed=int(r.integers(0, 100)),
                 priority_mix=float(r.choice([0.0, 0.3])),
                 arrival_mode=str(r.choice(["uniform", "bursty"])))
    costs = dict(prefill_s=float(r.uniform(1e-4, 1e-2)),
                 decode_chunk_s=float(r.uniform(1e-4, 5e-3)),
                 prefill_chunk_s=float(r.uniform(1e-4, 5e-3)),
                 draft_s=float(r.uniform(1e-4, 2e-3)),
                 verify_s=float(r.uniform(1e-4, 4e-3)),
                 swap_event_s=float(r.uniform(0, 1e-3)),
                 overhead_s=float(r.uniform(0, 1e-3)))
    return knobs, shape, costs, float(r.uniform(0.3, 1.0))


@pytest.mark.parametrize("block", range(8))
def test_predict_grid_equals_reference(block):
    """25 seeded knob x shape x cost draws per block: the predictions (or
    the ``CapacityError`` messages) are equal, key for key and bit for
    bit."""
    feasible = 0
    for seed in range(block * 25, block * 25 + 25):
        knobs, shape, costs, alpha = _random_case(seed)
        ref, got = _predict_both(knobs, shape, costs,
                                 cache_token_bytes=seed * 16,
                                 acceptance=alpha)
        assert got == ref, (seed, knobs, shape)
        feasible += isinstance(got, dict) and got["feasible"]
    assert feasible >= 5


def test_predict_takes_a_port_serve_config():
    """``predict`` reads the port's ``ServeConfig`` as the reference's
    reads its own; ``Knobs.from_serve_config`` keeps the port's backend
    and ``to_serve_config`` builds the port's ``ServeConfig``."""
    kw = dict(batch=2, max_len=16, prefill_len=8, decode_chunk=4,
              cache_mode="paged", page_size=4, num_pages=7,
              alloc_mode="incremental", quant_mode="w8a8_nibble")
    shape = dict(requests=5, prompt_budget=8, new_tokens=6)
    (_, js, jc), (_, ts, tc) = _both(shape=shape, costs=_COSTS)
    want = jcap.predict(JServeConfig(**kw, quant_backend="xla"), js, jc)
    got = tcap.predict(ServeConfig(**kw, quant_backend="cuda"), ts, tc)
    assert got == want
    knobs = tcap.Knobs.from_serve_config(ServeConfig(**kw,
                                                     quant_backend="cuda"))
    assert knobs.quant_backend == "cuda"
    back = knobs.to_serve_config()
    assert isinstance(back, ServeConfig)
    assert {f: getattr(back, f) for f in kw} == kw
    assert tcap.Knobs.from_dict({**knobs.to_dict(), "quant_backend":
                                 "xla"}).quant_backend == "xla"
    spec = dataclasses.replace(knobs, spec_decode=True).to_serve_config()
    assert spec.spec_quant_mode == "w8a8_nibble"


@pytest.mark.parametrize("fn,args", [
    ("expected_tokens_per_round", [(a, k) for a in (0.0, 0.3, 0.8, 1.0)
                                   for k in (1, 2, 4, 7)]),
    ("speedup", [(a, k, cd, cv) for a in (0.5, 0.9) for k in (2, 4)
                 for cd, cv in ((0.5, 1.0), (0.25, 1.2))]),
    ("acceptance_from_tokens_per_step", [(t, k) for k in (1, 4)
                                         for t in (1.0, 1.5, float(k + 1))]),
])
def test_spec_math_equals_reference(fn, args):
    for a in args:
        assert getattr(tcap, fn)(*a) == getattr(jcap, fn)(*a), a
    with pytest.raises(ValueError, match="alpha"):
        tcap.expected_tokens_per_round(1.5, 2)


# ---------------------------------------------------------------------------
# the knob search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("small", [True, False], ids=["small", "full"])
def test_knob_grid_equals_reference(small):
    kw = dict(batch=2, max_len=32, prefill_len=8, small=small)
    (_, js, _), (_, ts, _) = _both(shape=dict(requests=4, prompt_budget=8,
                                              new_tokens=8))
    want, got = jtune.knob_grid(js, **kw), ttune.knob_grid(ts, **kw)
    assert [_knob_dict(k) for k in got] == [_knob_dict(k) for k in want]
    assert {k.quant_backend for k in got} == {"cuda"}
    assert len(got) == len(set(got))


def _search_both(objective, ttft_slo_ms, small, arch="yi-6b"):
    kw = dict(batch=2, max_len=32, prefill_len=8, small=small)
    (_, js, _), (_, ts, _) = _both(shape=dict(requests=4, prompt_budget=8,
                                              new_tokens=8))
    jcfg, tcfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    want = jtune.search(jcfg, js, jtune.knob_grid(js, **kw),
                        objective=objective, ttft_slo_ms=ttft_slo_ms,
                        alpha=0.8)
    got = ttune.search(tcfg, ts, ttune.knob_grid(ts, **kw),
                       objective=objective, ttft_slo_ms=ttft_slo_ms,
                       alpha=0.8)
    return want, got


def _plain(results):
    return [{**r, "knobs": _knob_dict(r["knobs"])} for r in results]


@pytest.mark.parametrize("objective,slo", [
    ("max-tok-s", None), ("max-tok-s", 2.0), ("min-pages", None)])
@pytest.mark.parametrize("small", [True, False], ids=["small", "full"])
def test_search_and_table_equal_reference(ref_rates, objective, slo,
                                          small):
    """Under the reference's device rates the ranked results, the winner
    and the report table are the reference's."""
    (jres, jwin), (tres, twin) = _search_both(objective, slo, small)
    assert _plain(tres) == _plain(jres)
    assert (twin is None) == (jwin is None)
    if twin is not None:
        assert _plain([twin]) == _plain([jwin])
    assert list(ttune.table_lines(tres, twin)) == \
        list(jtune.table_lines(jres, jwin))


def test_search_on_h100_rates_ranks_feasible_cells():
    """The port's default rates are the H100's: the search still finds an
    admissible winner under each objective, and the winner of max-tok-s
    has the highest predicted tok/s of the admissible cells."""
    assert (H100.PEAK_BF16_FLOPS, H100.HBM_BW) == (989e12, 3.35e12)
    cfg = reduced(get_config("yi-6b"))
    shape = tcap.WorkloadShape(requests=4, prompt_budget=8, new_tokens=8)
    cells = ttune.knob_grid(shape, batch=2, max_len=32, prefill_len=8)
    res, win = ttune.search(cfg, shape, cells, objective="max-tok-s",
                            ttft_slo_ms=None, alpha=0.8)
    assert win is not None
    assert win["prediction"]["tok_per_s"] == max(
        r["prediction"]["tok_per_s"] for r in res if r["admissible"])
    res, win = ttune.search(cfg, shape, cells, objective="min-pages",
                            ttft_slo_ms=None, alpha=0.8)
    assert win["knobs"].paged and win["prediction"]["preemptions"] == 0


def test_validate_rows_equal_reference():
    """The replay of every committed ``BENCH_serve.json`` row (read-only)
    gives the reference's verdicts, row for row."""
    want = jvalidate.validate_rows(jvalidate.load_bench(BENCH))
    got = tvalidate.validate_rows(tvalidate.load_bench(BENCH))
    assert got == want
    assert got[0] and len(got[1]) >= 20
    assert tvalidate.TOLERANCE == jvalidate.TOLERANCE


# ---------------------------------------------------------------------------
# closed-form sizes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_analytic_sizes_equal_reference(ref_rates, arch):
    assert tuple(ARCH_NAMES) == tuple(J_ARCH_NAMES)
    jcfg, tcfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    assert tcap.analytic_cache_token_bytes(tcfg) == \
        jcap.analytic_cache_token_bytes(jcfg)
    for tokens, kv, logits, q in ((1, 16, 1, True), (8, 64, 8, False),
                                  (32, 32, 1, True)):
        assert analytic_macs(tcfg, tokens, kv, logits, q) == \
            janalytic_macs(jcfg, tokens, kv, logits, q)
    for knobs in ttune.knob_grid(
            tcap.WorkloadShape(requests=2, prompt_budget=8, new_tokens=4),
            batch=2, max_len=16, prefill_len=8, small=True):
        jk = jcap.Knobs(**{**knobs.to_dict(), "quant_backend": "xla"})
        assert tcap.StageCosts.from_model(tcfg, knobs).to_dict() == \
            jcap.StageCosts.from_model(jcfg, jk).to_dict()


@pytest.mark.parametrize("arch,over,scfg", [
    ("yi-6b", {}, {}),
    ("yi-6b", {}, dict(cache_mode="dense", page_size=None)),
    ("deepseek-v3-671b", {}, {}),
    ("yi-6b", dict(kv_cache_dtype="int8"), {}),
    ("jamba-v0.1-52b", {}, {}),
    ("mamba2-780m", {}, {})],
    ids=["yi-6b", "yi-6b-slab", "mla", "int8-kv", "jamba", "mamba2"])
def test_analytic_cache_bytes_equal_engine(arch, over, scfg):
    """The closed form equals what the port's engine allocates per token
    (the reference's ``test_analytic_cache_bytes_match_engine``, on the
    families with other cache layouts)."""
    cfg = reduced(get_config(arch)).replace(**over)
    kw = dict(batch=2, max_len=16, prefill_len=8, cache_mode="paged",
              page_size=4)
    kw.update(scfg)
    engine = Engine(cfg, model_init(cfg, device="cpu"), ServeConfig(**kw),
                    device="cpu")
    assert tcap.analytic_cache_token_bytes(cfg) == engine.cache_token_bytes


# ---------------------------------------------------------------------------
# the stage surface and calibration
# ---------------------------------------------------------------------------

MODES = {
    "plain": {},
    "wave": dict(prefill_chunk=3, admit_group=2),
    "spec": dict(spec_decode=True, spec_quant_mode="w8a8_nibble"),
    "wave+spec": dict(prefill_chunk=3, admit_group=2, spec_decode=True,
                      spec_quant_mode="w8a8_nibble"),
}


def _scfg_kw(mode, **over):
    kw = dict(batch=2, max_len=16, prefill_len=8, decode_chunk=3,
              cache_mode="paged", page_size=4, alloc_mode="incremental",
              num_pages=7)
    kw.update(MODES[mode], **over)
    return kw


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config("yi-6b"))
    return cfg, model_init(cfg, device="cpu")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_stage_programs_keys_equal_reference(model, mode):
    cfg, params = model
    jcfg = jreduced(jget_config("yi-6b"))
    jeng = JEngine(jcfg, jmodel_init(jax.random.PRNGKey(0), jcfg),
                   JServeConfig(**_scfg_kw(mode)))
    teng = Engine(cfg, params, ServeConfig(**_scfg_kw(mode)), device="cpu")
    assert list(teng.stage_programs()) == list(jeng.stage_programs())


def _serve(engine, prompts, n=6):
    ids = [engine.submit(p, n) for p in prompts]
    done = engine.run()
    return [done[i].tokens for i in ids]


@pytest.mark.parametrize("mode,over", [
    ("plain", {}), ("wave", {}), ("spec", {}), ("wave+spec", {}),
    ("plain", dict(swap_mode="host", prefix_cache=True)),
    ("plain", dict(cache_mode="dense", page_size=None,
                   alloc_mode="reserve", num_pages=None)),
    ("plain", dict(temperature=0.7))],
    ids=["plain", "wave", "spec", "wave+spec", "swap+prefix", "dense-slab",
         "sampled"])
def test_calibrate_fills_built_stages_and_keeps_streams(model, mode, over):
    """``calibrate_engine`` on a drained CPU engine: a positive time for
    every stage the mode built, 0.0 for the others (and for the swap
    event without the host swap), a non-negative host overhead; the
    engine is reset with its ids and base key kept, so the streams it
    serves next equal those a second engine serves at the same point."""
    cfg, params = model
    scfg = ServeConfig(**_scfg_kw(mode, **over))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 7, 4, 6)]
    engines = [Engine(cfg, params, scfg, device="cpu") for _ in range(2)]
    first = [_serve(e, prompts) for e in engines]
    assert first[0] == first[1]
    costs = calibrate_engine(engines[0], iters=1)
    assert costs.source == "measured"
    built = {"prefill": "prefill_s", "prefill_chunk": "prefill_chunk_s",
             "decode_chunk": "decode_chunk_s", "draft": "draft_s",
             "verify": "verify_s"}
    names = set(engines[0].stage_programs())
    for stage, field in built.items():
        value = getattr(costs, field)
        assert (value > 0.0) if stage in names else (value == 0.0), stage
    assert (costs.swap_event_s > 0.0) == (scfg.swap_mode == "host")
    assert costs.overhead_s >= 0.0
    assert engines[0]._next_id == engines[1]._next_id
    assert engines[0].leaked_pages() == 0
    assert _serve(engines[0], prompts[::-1]) == \
        _serve(engines[1], prompts[::-1])
    for stage in engines[0].stage_programs().values():
        assert time_stage(stage, iters=1) > 0.0


def test_calibrate_needs_a_drained_engine(model):
    cfg, params = model
    engine = Engine(cfg, params, ServeConfig(**_scfg_kw("plain")),
                    device="cpu")
    _serve(engine, [np.arange(1, 6)])
    engine.submit(np.arange(1, 6), 4)
    with pytest.raises(ValueError, match="drained"):
        calibrate_engine(engine)


def test_autotune_table_is_the_reference_tool_s(ref_rates):
    """The launcher's ``--autotune`` table equals the reference's
    ``tools/autotune.py`` table for the same workload once both use the
    same device rates (the reference tool's planning defaults)."""
    shape_kw = dict(requests=8, prompt_budget=16, new_tokens=16)
    (_, js, _), (_, ts, _) = _both(shape=shape_kw)
    kw = dict(batch=4, max_len=64, prefill_len=16)
    jcfg, tcfg = jreduced(jget_config("yi-6b")), reduced(get_config("yi-6b"))
    jres, jwin = jtune.search(jcfg, js, jtune.knob_grid(js, **kw),
                              objective="max-tok-s", ttft_slo_ms=50.0,
                              alpha=0.8)
    tres, twin = ttune.search(tcfg, ts, ttune.knob_grid(ts, **kw),
                              objective="max-tok-s", ttft_slo_ms=50.0,
                              alpha=0.8)
    assert list(ttune.table_lines(tres, twin)) == \
        list(jtune.table_lines(jres, jwin))
    assert json.dumps(_knob_dict(twin["knobs"])) == \
        json.dumps(_knob_dict(jwin["knobs"]))
