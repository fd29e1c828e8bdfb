"""The comparison that decides ``correct``, shown to fail: a whole run of
each cell at a tiny size on the CPU (the harness's look for a card
skipped, the rest as on the chip) comes out correct, and comes out not
correct when its timed path is broken underneath (a served token
altered where it is produced, the decode state left unchanged, half the
batch left out) or when it serves through the program's lower-precision
path, the control (``w4a8_nibble``).  The limit here is the tiny size's
own; the cells' limits are set from readings at their own size."""

import json
import time

import pytest
import torch

from portbench.harness import ROOT, load_cell, run_cell
from repro_torch.models import attention, mamba
from repro_torch.serve import engine as engine_mod

TINY = {"yi6b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     head_dim=16, d_ff=128, vocab_size=256),
        "mamba2": dict(n_layers=2, d_model=64, vocab_size=256, ssm_state=16,
                       ssm_head_dim=16, ssm_chunk=16)}
MIX = dict(slots=4, max_len=64, block=4,
           prompt={"kind": "ladder", "lo": 8, "hi": 24},
           output={"kind": "ladder", "lo": 4, "hi": 20})
CLOSED = dict(MIX, in_flight=4)
OPEN = dict(MIX, loop="open", gaps={"kind": "exponential", "mean_s": 0.04,
                                    "draw_seed": 1})
# the number each cell compares, with its limit at this size, read on
# seeds 100-111 in each cell: yi6b's widest gap 0.034-0.122 sound,
# 0.639-1.60 under the control, each fault 1.84 or more; mamba2's mean
# gap 0.0001-0.0007 sound, 0.0169-0.0219 under the control, each fault
# 0.0177 or more (seeds 100-102)
TINY_LIMIT = {"yi6b": ("widest_logit_gap", 0.3),
              "mamba2": ("mean_logit_gap", 0.004)}
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny(cell, fam):
    number, limit = TINY_LIMIT[fam]
    assert number in cell.limits
    cell.limits = dict(cell.limits, **{number: limit})
    return cell


def run(name, seed=11, quant=None, log=lambda *a: None, mix=CLOSED):
    fam = name.split(".")[0]
    cell = tiny(load_cell(name, mix_overrides=mix), fam)
    return run_cell(cell, seed, 0.6, False, t_start=time.perf_counter(),
                    device="cpu", model_overrides=TINY[fam], quant_mode=quant,
                    log=log)


def _token_altered(mp):
    draw = engine_mod.Engine._draw
    mp.setattr(engine_mod.Engine, "_draw", lambda self, lg, k, i: (
        draw(self, lg, k, i) + 1) % lg.shape[-1])


def _state_unchanged(mp):
    mp.setattr(attention, "scatter_paged_rows", lambda *a, **k: None)
    step = mamba._step_heads
    mp.setattr(mamba, "_step_heads", lambda p, c, dm, x, cache, a=None: step(
        p, c, dm, x, {k: v.clone() for k, v in cache.items()}, a))


def _half_batch(mp):
    decode = engine_mod.decode_step

    def half(*a, **k):
        logits, caches = decode(*a, **k)
        b = logits.shape[0]
        logits = logits.clone()
        logits[b // 2:] = logits[:b - b // 2]
        return logits, caches
    mp.setattr(engine_mod, "decode_step", half)


FAULTS = {"token_altered": _token_altered,
          "state_unchanged": _state_unchanged,
          "half_batch": _half_batch}


@pytest.mark.parametrize("name,mix", [(c, CLOSED) for c in CELLS]
                         + [("yi6b.decode_long", OPEN)])
def test_sound_run_is_correct(name, mix):
    r = run(name, mix=mix)
    assert r["correct"], r["checked"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checked"
    e2e = {m["name"] for m in BENCH["end_to_end"]
           if name in m.get("workloads", [name])}
    assert set(r["metrics"]) == e2e


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["yi6b.decode_long", "mamba2.decode_long"])
def test_fault_is_caught(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = run(name)
    assert not r["correct"], r["checked"]


@pytest.mark.parametrize("name", ["yi6b.decode_long", "mamba2.decode_long"])
def test_control_is_not_correct(name):
    r = run(name, quant="w4a8_nibble")
    assert not r["correct"], r["checked"]


@pytest.mark.cuda
def test_control_on_the_card(cuda_device):
    """The same at the tiny size through the CUDA kernels and graphs."""
    for name in ("yi6b.decode_long", "mamba2.decode_long"):
        fam = name.split(".")[0]
        cell = tiny(load_cell(name, mix_overrides=CLOSED), fam)
        kw = dict(t_start=time.perf_counter(), device=cuda_device,
                  model_overrides=TINY[fam], log=lambda *a: None)
        assert run_cell(cell, 5, 0.6, False, **kw)["correct"]
        assert not run_cell(cell, 5, 0.6, False, quant_mode="w4a8_nibble",
                            **kw)["correct"]
        torch.cuda.empty_cache()


def test_traced_run_reports_its_layers():
    """A ``--trace 1`` run through the same path: the program-counter
    metrics are there, the device's are left out without a card."""
    cell = tiny(load_cell("yi6b.decode_long", mix_overrides=dict(
        CLOSED, trace_seconds=1.5)), "yi6b")
    r = run_cell(cell, 3, 2.0, True, t_start=time.perf_counter(),
                 device="cpu", model_overrides=TINY["yi6b"],
                 log=lambda *a: None)
    assert r["correct"]
    assert {"prefill_step_share.tok", "step_mfu.tok"} <= set(r["metrics"]) \
        <= {"prefill_step_share.tok", "step_mfu.tok", "decode_chunk_ms.tok"}
    assert 0 <= r["metrics"]["prefill_step_share.tok"]["value"] < 100
    assert r["device"]["window_s"] > 0 and "breakdown" in r
