"""The harness's arithmetic and guards on the CPU: the time per output
token, the percentile, the sample of finished requests, the reduction
of a device trace, and the entry point's refusals."""

import shutil
import subprocess
import sys

import numpy as np
import pytest

from portbench import run as entry
from portbench.harness import (ROOT, Run, Served, _reader, percentile,
                               pick_sample, tpot_ms)
from portbench.trace import kernel_class, reduce


def test_tpot_counts_tokens_after_the_first_stamp():
    # a prefill token at 0.1, then two chunks of 8 tokens at 0.5 and 0.9
    stamps = [0.1] + [0.5] * 8 + [0.9] * 8
    assert tpot_ms(stamps, 10.0) == pytest.approx(800 / 16)
    # inside the window only: the chunk at 0.9 is past a 0.6 s window
    assert tpot_ms(stamps, 0.6) == pytest.approx(400 / 8)
    assert tpot_ms([0.5] * 8, 10.0) is None


def test_percentile_is_linear():
    assert percentile(range(101), 95) == pytest.approx(95.0)
    assert percentile([1.0, 2.0], 50) == pytest.approx(1.5)


def _served(i, n, done=True):
    return Served(i, np.zeros(4, np.int32), n, 0.0, [1] * n, 0.1,
                  [0.1] * n, done)


def test_sample_holds_the_longest_and_enough_tokens():
    served = [_served(i, n) for i, n in enumerate([5, 50, 7, 9, 11, 3])]
    served.append(_served(6, 500, done=False))
    s = pick_sample(served, 3, tokens=60, requests=3)
    assert s[0].index == 1 and len(s) >= 3
    assert sum(len(x.tokens) for x in s) >= 60
    assert all(x.finished for x in s)
    assert [x.index for x in s] == [x.index for x in pick_sample(
        served, 3, tokens=60, requests=3)]


class _Ev:
    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._u = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u


def test_reduce_busy_gaps_and_classes():
    cpu, gpu = "DeviceType.CPU", "DeviceType.CUDA"
    evs = [_Ev("portbench.window", cpu, 0, 1_000_000),
           _Ev("portbench.step", cpu, 0, 300_000),
           _Ev("portbench.step", cpu, 600_000, 300_000),
           _Ev("void nibble_mm_kernel<64, 1>", gpu, 100_000, 200_000),
           _Ev("void at::native::elementwise_kernel", gpu, 250_000, 100_000),
           _Ev("void paged_decode_mma_kernel<128>", gpu, 310_000, 40_000),
           _Ev("void flash_fwd_mma_kernel<128>", gpu, 700_000, 100_000),
           # the device-side copy of a span is no device operation
           _Ev("portbench.step", gpu, 0, 300_000)]
    t = reduce(evs, ["step_with_prefill", "decode_chunk_step"])
    assert t.window_s == pytest.approx(1e-3)
    # union: [100, 350] and [700, 800] us
    assert t.busy_s == pytest.approx(350e-6)
    assert t.seconds("nibble") == pytest.approx(200e-6)
    assert t.seconds("torch") == pytest.approx(100e-6)
    assert t.gaps["step_with_prefill"] == (1, pytest.approx(100e-6))
    assert t.gaps["harness"] == (1, pytest.approx(350e-6))
    assert t.gaps["decode_chunk_step"] == (1, pytest.approx(200e-6))
    assert kernel_class("void paged_decode_mma_kernel<64>") == "paged_decode"
    assert kernel_class("void at::native::reduce_kernel") == "torch"


def test_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert entry.main(["--workload", "yi6b.decode_long", "--seed", "1",
                       "--seconds", "1"]) == 3


def test_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "yi6b.decode_long", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro_torch_fake" not in entry.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax.numpy" in entry.forbidden_modules()


def test_end_to_end_metrics_of_a_window():
    """Every end-to-end metric a cell may name, on a made-up window of
    10 s: one request sent before it, two due inside it."""
    p = np.zeros(100, np.int32)
    served = [Served(0, p, 9, -1.0, [1] * 9, -0.5, [-0.5] + [1.0] * 8, True),
              Served(1, p, 9, 2.0, [1] * 9, 2.5, [2.5] + [3.0] * 8, True),
              Served(2, p, 9, 9.0, [1] * 9, 9.8, [9.8] + [10.5] * 8, False)]
    run = Run(model={}, family="dense", mix=None, config={}, seconds=10.0,
              served=served, steps=[(True, 1.0, False), (False, 2.0, False),
                                    (False, 4.0, True)],
              trace=None, trace_bounds=None)
    assert run.end_to_end("output_tok_s") == pytest.approx(18 / 10)
    assert run.end_to_end("prompt_tok_s") == pytest.approx(200 / 10)
    assert run.end_to_end("ttft_p95_ms") == pytest.approx(
        percentile([500.0, 800.0], 95))
    # only request 1 has two stamps inside: 0.5 s over its 8 later tokens
    assert run.end_to_end("tpot_p95_ms") == pytest.approx(500 / 8)
    # the steps: one that prefilled, two chunk-only (one traced)
    assert run.step_seconds(True) == (1, 1.0)
    assert run.step_seconds(False) == (2, 6.0)
    assert run.step_seconds(False, untraced=True) == (1, 2.0)
    assert _reader("prefill_step_share.tok")(run) == pytest.approx(10.0)
    assert _reader("decode_chunk_ms.tok")(run) == pytest.approx(2000.0)
