"""Every seed gets the same work: for 12 seeds, each mix gives the
same request count, prompt tokens, output tokens and (open loop) sum of
gaps over whole blocks; seeds differ only in order and token ids."""

import json

import numpy as np
import pytest

from portbench.harness import ROOT
from portbench.traffic import RequestStream, block_lists, load_mix, mix_from

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# an open-loop mix for the generator's open-loop path: the chat mix of
# PERF.md's open questions, which no traffic file holds until a sweep on
# the chip has set its arrival rate
OPEN = {"name": "chat", "loop": "open", "slots": 64, "max_len": 2560,
        "block": 32, "pairing_seed": 3,
        "prompt": {"kind": "pareto", "lo": 32, "hi": 2048, "alpha": 1.5,
                   "scale": 256, "draw_seed": 5},
        "output": {"kind": "ladder", "lo": 64, "hi": 512},
        "gaps": {"kind": "exponential", "mean_s": 0.25, "draw_seed": 6}}
# every mix on file, and the open loop
MIXES = sorted(p.stem for p in (ROOT / "portbench" / "traffic").glob("*.json")
               ) + [OPEN["name"]]
SEEDS = [0, 1, 7, 12345, 2**31 - 1, 2**31, 2**31 + 7, 3141592653,
         99, 271828, 42, 2**32 + 3]
BLOCKS = 5


def test_every_cell_has_its_mix():
    assert {w["traffic"] for w in BENCH["workloads"]} <= set(MIXES[:-1])


def _mix(traffic):
    if traffic == OPEN["name"]:
        return mix_from(OPEN)
    return load_mix(ROOT / "portbench" / "traffic" / f"{traffic}.json")


def _draw(mix, seed, vocab=64000):
    stream = RequestStream(mix, seed, vocab)
    reqs = stream.take(BLOCKS * mix.block)
    return reqs, stream


@pytest.mark.parametrize("traffic", MIXES)
def test_same_work_for_every_seed(traffic):
    mix = _mix(traffic)
    totals = set()
    for seed in SEEDS:
        reqs, stream = _draw(mix, seed)
        gaps = stream._clock if mix.loop == "open" else 0.0
        totals.add((len(reqs), sum(len(r.prompt) for r in reqs),
                    sum(r.max_new_tokens for r in reqs), round(gaps, 9)))
    assert len(totals) == 1, totals


@pytest.mark.parametrize("traffic", MIXES)
def test_seeds_differ_in_order_and_ids(traffic):
    mix = _mix(traffic)
    a, _ = _draw(mix, SEEDS[4])
    b, _ = _draw(mix, SEEDS[5])
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b] or \
        [r.max_new_tokens for r in a] != [r.max_new_tokens for r in b]
    assert not np.array_equal(a[0].prompt[:8], b[0].prompt[:8])
    again, _ = _draw(mix, SEEDS[4])
    assert all(np.array_equal(x.prompt, y.prompt)
               and x.max_new_tokens == y.max_new_tokens
               for x, y in zip(a, again))


@pytest.mark.parametrize("traffic", MIXES)
def test_requests_fit_the_slot_budget(traffic):
    mix = _mix(traffic)
    prompts, outputs, gaps = block_lists(mix)
    assert (prompts + outputs <= mix.max_len).all()
    assert prompts.min() >= 1 and outputs.min() >= 1
    if mix.loop == "open":
        assert gaps.sum() == pytest.approx(
            mix.block * mix.gaps["mean_s"], rel=1e-12)


def test_ladder_and_open_loop_arrivals():
    mix = _mix("decode_long")
    prompts, outputs, _ = block_lists(mix)
    assert sorted(prompts) == list(np.rint(np.linspace(128, 512, 16)))
    assert sorted(outputs) == list(np.rint(np.linspace(64, 1024, 16)))
    chat = _mix("chat")
    stream = RequestStream(chat, 5, 64000)
    reqs = stream.until(10.0)
    dues = [r.due_s for r in reqs]
    assert dues[0] == 0.0 and dues == sorted(dues) and dues[-1] < 10.0
