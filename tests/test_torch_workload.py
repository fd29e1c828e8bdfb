"""Port parity for the timed workload driver: ``draw_workload`` is the
reference's numpy draw, array for array, for every knob; the percentile
helpers and the knob validation behave as the reference's; the result of
``run_timed_workload`` on the port's engine carries exactly the
reference's keys; and ``cache_token_bytes`` equals the reference engine's
for the same dense and paged configurations."""

import jax
import numpy as np
import pytest
import torch

import repro.serve.workload as jworkload
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import model_init as jmodel_init
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_config, reduced
from repro_torch.models import model_init
from repro_torch.serve import Engine, ServeConfig, draw_workload, \
    run_timed_workload
from repro_torch.serve import workload as tworkload

torch.set_num_threads(1)

DRAWS = {
    "uniform": dict(requests=7, prompt_budget=12),
    "uniform-staggered": dict(requests=7, prompt_budget=12,
                              stagger_s=0.05),
    "bursty": dict(requests=16, prompt_budget=64, arrival_mode="bursty"),
    "bursty-staggered": dict(requests=16, prompt_budget=64,
                             arrival_mode="bursty", stagger_s=0.05, seed=3),
    "priority-mix": dict(requests=12, prompt_budget=20, priority_mix=0.25,
                         stagger_s=0.01, seed=5),
    "shared-prefix": dict(requests=10, prompt_budget=16, shared_prefix=0.6,
                          arrival_mode="bursty", stagger_s=0.02, seed=7),
    "not-materialized": dict(requests=9, prompt_budget=32,
                             arrival_mode="bursty", stagger_s=0.05,
                             priority_mix=0.5, shared_prefix=0.5,
                             materialize=False),
}


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_draw_equals_reference(name):
    kw = dict(new_tokens=5, **DRAWS[name])
    want = jworkload.draw_workload(256, **kw)
    got = draw_workload(256, **kw)
    for field in ("lens", "arrivals", "prios", "shared", "eff_lens"):
        a, b = getattr(want, field), getattr(got, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert got.sys_len == want.sys_len
    assert got.summary(5) == want.summary(5)
    if kw.get("materialize", True):
        assert len(got.prompts) == len(want.prompts) == kw["requests"]
        for a, b in zip(want.prompts, got.prompts):
            assert np.array_equal(a, b)
    else:
        assert got.prompts is None and want.prompts is None


def test_percentile_helpers_survive_empty_samples():
    for mod in (jworkload, tworkload):
        assert mod._pct([], 50) is None
        assert mod._pct(None, 99) is None
        assert mod._ms(None) is None
    sample = np.asarray([0.004, 0.010, 0.0125, 0.3])
    for q in (50, 99):
        assert tworkload._pct(sample, q) == jworkload._pct(sample, q)
    assert tworkload._ms(0.01234, 2) == jworkload._ms(0.01234, 2) == 12.34


@pytest.mark.parametrize("bad", [
    dict(requests=0), dict(prompt_budget=1), dict(new_tokens=0),
    dict(priority_mix=1.5), dict(shared_prefix=-0.1),
    dict(arrival_mode="poisson")])
def test_validate_workload_errors_match_reference(bad):
    kw = dict(requests=4, prompt_budget=8, new_tokens=2, priority_mix=0.0,
              shared_prefix=0.0, arrival_mode="uniform")
    kw.update(bad)
    with pytest.raises(ValueError) as want:
        jworkload._validate_workload(**kw)
    with pytest.raises(ValueError) as got:
        tworkload._validate_workload(**kw)
    assert str(got.value) == str(want.value)


def _engines(cache_mode, **over):
    kw = dict(batch=2, max_len=16, prefill_len=8, decode_chunk=3,
              cache_mode=cache_mode, page_size=4)
    kw.update(over)
    jcfg = jreduced(jget_config("yi-6b"))
    tcfg = reduced(get_config("yi-6b"))
    jeng = JEngine(jcfg, jmodel_init(jax.random.PRNGKey(0), jcfg),
                   JServeConfig(**kw))
    teng = Engine(tcfg, model_init(tcfg, device="cpu"), ServeConfig(**kw),
                  device="cpu")
    return jeng, teng


def test_timed_workload_result_has_the_reference_keys():
    jeng, teng = _engines("paged", alloc_mode="incremental", num_pages=7)
    kw = dict(requests=5, prompt_budget=8, new_tokens=6, stagger_s=0.002,
              priority_mix=0.4, arrival_mode="bursty", collect_streams=True)
    want = jworkload.run_timed_workload(jeng, 256, **kw)
    got = run_timed_workload(teng, 256, **kw)
    assert set(got) == set(want)
    assert set(got["workload_shape"]) == set(want["workload_shape"])
    assert got["workload_shape"] == want["workload_shape"]
    assert got["compile_counts"] == {"prefill": 1, "decode_chunk": 1}
    assert got["device_count"] == 1 and got["mesh_shape"] == [1, 1]
    assert got["tokens"] == want["tokens"] == 5 * 6
    assert got["pool_pages"] == want["pool_pages"] == 7
    assert set(got["streams"]) == set(range(5))
    assert set(teng.stats) == set(jeng.stats)
    assert teng.leaked_pages() == 0


@pytest.mark.parametrize("cache_mode,over", [
    ("dense", {}), ("paged", {}), ("paged", dict(num_pages=7)),
    ("paged", dict(page_size=8, num_pages=3))])
def test_cache_token_bytes_equal_reference(cache_mode, over):
    jeng, teng = _engines(cache_mode, **over)
    assert teng.cache_token_bytes == jeng.cache_token_bytes > 0
