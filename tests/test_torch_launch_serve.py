"""The port's serving launcher on the CPU (reduced yi-6b, plain kernel
versions): lockstep batch generation, the uniform and bursty timed
workloads, an overcommitted incremental pool that must preempt, the
prefix cache and the host swap, speculative decoding and the wave
prefill, temperature sampling, the ``--verify`` re-run, the DP fleet
(``--dp``), the capacity model (``--predict``, ``--autotune``,
``--ttft-slo-ms``), and tensor parallelism (``--tp``, ``--mesh``, ``--dp``
x ``--tp``) over repeated CPU entries, held by ``--verify`` to the
single-device engine."""

import json

import pytest
import torch

from repro_torch.launch import serve

torch.set_num_threads(1)

BASE = ["--device", "cpu", "--arch", "yi-6b", "--batch", "2",
        "--prompt-len", "8", "--new-tokens", "6", "--requests", "5"]
OVERCOMMIT = ["--cache-mode", "paged", "--page-size", "4",
              "--alloc-mode", "incremental", "--num-pages", "6"]


def _main(capsys, *extra):
    assert serve.main(BASE + list(extra)) == 0
    return capsys.readouterr().out


def test_batch_workload(capsys):
    out = _main(capsys, "--quant", "w8a8_nibble")
    assert "workload=batch" in out
    assert "{'prefill': 1, 'decode_chunk': 1}" in out
    assert "sample token ids" in out


@pytest.mark.parametrize("workload", ["uniform", "bursty"])
def test_request_workloads(capsys, workload):
    out = _main(capsys, "--workload", workload, "--stagger-ms", "2",
                "--cache-mode", "paged", "--page-size", "4",
                "--priority-mix", "0.4")
    assert f"workload={workload}" in out
    assert "ttft p50=" in out and "itl p50=" in out
    assert "priority split" in out
    assert "compilations: {'prefill': 1, 'decode_chunk': 1}" in out


def _run_requests(monkeypatch, workload, *extra):
    """``main``'s request path; returns the driver's result and engine."""
    seen = {}
    orig = serve.run_requests

    def spy(args, cfg, engine):
        seen["engine"] = engine
        seen["r"] = orig(args, cfg, engine)
        return seen["r"]

    monkeypatch.setattr(serve, "run_requests", spy)
    assert serve.main(BASE + ["--workload", workload] + list(extra)) == 0
    return seen["r"], seen["engine"]


@pytest.mark.parametrize("workload", ["uniform", "bursty"])
def test_overcommitted_incremental_pool_preempts(monkeypatch, capsys,
                                                 workload):
    # 2 slots x 4 pages worst case against 5 allocatable; arrivals at 0
    r, engine = _run_requests(monkeypatch, workload, "--stagger-ms", "0",
                              "--new-tokens", "8", *OVERCOMMIT)
    assert r["preemptions"] >= 1
    assert r["pool_pages"] == 6
    assert r["tokens"] == 5 * 8
    assert engine.leaked_pages() == 0
    out = capsys.readouterr().out
    assert f"preemptions {r['preemptions']}" in out


def test_verify_passes(capsys):
    out = _main(capsys, "--workload", "uniform", "--verify", *OVERCOMMIT)
    assert "verify: 5 streams bit-match" in out


PREFIX = ["--cache-mode", "paged", "--page-size", "4", "--shared-prefix",
          "0.75", "--prefix-cache"]
SWAP = OVERCOMMIT + ["--stagger-ms", "0", "--new-tokens", "8",
                     "--swap-mode", "host"]


@pytest.mark.parametrize("flags", [
    PREFIX, PREFIX + ["--prefix-cache-pages", "4"], SWAP,
    SWAP + ["--host-pages", "8"]],
    ids=["prefix-cache", "prefix-cache-pages", "swap-mode", "host-pages"])
def test_prefix_and_swap_flags_serve(monkeypatch, capsys, flags):
    """The prefix cache serves shared heads from cache (hit rate > 0);
    the host swap resumes evicted requests by page copy on the
    overcommitted pool (swap_in >= 1); both drain with zero leaks."""
    r, engine = _run_requests(monkeypatch, "uniform", *flags)
    out = capsys.readouterr().out
    if "--prefix-cache" in flags:
        assert r["prefix_hit_rate"] > 0
        assert "prefix cache: hit rate" in out
        cap = int(flags[-1]) if "--prefix-cache-pages" in flags else 0
        assert engine.scfg.prefix_cache_pages == cap
    else:
        assert r["swap_in"] >= 1 and r["swap_in"] == r["swap_out"]
        assert f"host swap: {r['swap_out']} out" in out
        assert r["tokens"] == 5 * 8
        assert engine.stats["host_pages"] == (
            8 if "--host-pages" in flags else 2 * 5)
    assert r["compile_counts"] == {"prefill": 1, "decode_chunk": 1}
    assert engine.leaked_pages() == 0


SPEC = ["--cache-mode", "paged", "--page-size", "4", "--alloc-mode",
        "incremental", "--spec-decode"]
WAVE = ["--cache-mode", "paged", "--page-size", "4"]


@pytest.mark.parametrize("flags", [
    SPEC, SPEC + ["--spec-k", "2"], SPEC + ["--spec-quant", "w8a8_nibble"],
    WAVE + ["--prefill-chunk", "4"], WAVE + ["--admit-group", "2"]],
    ids=["spec-decode", "spec-k", "spec-quant", "prefill-chunk",
         "admit-group"])
def test_spec_and_wave_flags_serve(monkeypatch, capsys, flags):
    """The spec flags build a spec engine (its report line, the spec
    pins) and the wave flags a wave engine (its report line, the wave
    pins); both drain every request with zero leaks and pass
    ``--verify`` against the plain build."""
    r, engine = _run_requests(monkeypatch, "uniform", "--verify", *flags)
    out = capsys.readouterr().out
    assert r["tokens"] == 5 * 6
    assert engine.leaked_pages() == 0
    assert "verify: 5 streams bit-match" in out
    if "--spec-decode" in flags:
        k = int(flags[-1]) if "--spec-k" in flags else 4
        draft = flags[-1] if "--spec-quant" in flags else "dense"
        assert engine.scfg.spec_k == k
        assert engine._draft_cfg.quant_mode == draft
        assert f"spec decode: k={k} draft={draft}" in out
        assert r["spec"] and r["tokens_per_step"] >= 1.0
        assert r["compile_counts"] == {"prefill": 1, "decode_chunk": 0,
                                       "draft": 1, "verify": 1}
    else:
        assert f"wave prefill: {r['prefill_waves']} waves" in out
        assert r["prefill_waves"] >= 1
        assert r["compile_counts"] == {"prefill": 0, "decode_chunk": 1,
                                       "prefill_chunk": 1}


@pytest.mark.parametrize("flag", [["--tp", "2"], ["--mesh", "1x2"]],
                         ids=lambda f: f[0])
def test_unported_flags_raise(monkeypatch, capsys, flag):
    """``--tp 2`` and ``--mesh 1x2`` serve over a (1, 2) mesh of CPU
    entries, ``--verify`` holding the streams to the tp=1 engine's, and
    ``--predict`` is skipped; a data axis above 1 (``--mesh 2x1``, and
    ``--mesh 2x2`` beside ``--tp 2``) serves too, its streams held to the
    single-device build; a malformed mesh still raises."""
    r, engine = _run_requests(monkeypatch, "uniform", "--verify",
                              "--predict", "--quant", "w8a8_nibble",
                              *OVERCOMMIT, *flag)
    out = capsys.readouterr().out
    assert engine.mesh_shape == (1, 2) and r["device_count"] == 2
    assert "per-engine mesh (1, 2)" in out
    assert "verify: 5 streams bit-match" in out
    assert "capacity model: (skipped" in out
    assert r["preemptions"] >= 1 and engine.leaked_pages() == 0
    data = (["--mesh", "2x1"] if flag[0] == "--mesh"
            else flag + ["--mesh", "2x2"])
    r, engine = _run_requests(monkeypatch, "uniform", "--verify", "--quant",
                              "w8a8_nibble", *OVERCOMMIT, *data)
    out = capsys.readouterr().out
    assert engine.mesh_shape == ((2, 1) if flag[0] == "--mesh" else (2, 2))
    assert "verify: 5 streams bit-match" in out and "fsdp:" in out
    assert engine.leaked_pages() == 0
    with pytest.raises(SystemExit, match="DATAxMODEL"):
        serve.main(BASE + ["--workload", "uniform", "--mesh", "2by1"])


@pytest.mark.parametrize("extra", [[], PREFIX],
                         ids=["jsq", "prefix-affinity"])
def test_dp_serves_a_fleet(monkeypatch, capsys, extra):
    """``--dp 2`` serves through a ``Router`` of two replicas on the one
    device: every request placed and drained, the fleet topology and the
    per-replica split reported, one signature per stage, no leak, and
    ``--verify`` (dense) equal to one engine's streams."""
    r, fleet = _run_requests(monkeypatch, "bursty", "--dp", "2",
                             "--stagger-ms", "1", "--verify",
                             *(extra or OVERCOMMIT))
    out = capsys.readouterr().out
    assert r["dp_replicas"] == 2 and len(fleet.replicas) == 2
    assert r["device_count"] == 1 and r["mesh_shape"] == [1, 1]
    assert sum(p["placed"] for p in r["per_replica"]) == 5
    assert r["tokens"] == 5 * 6
    assert r["compile_counts"] == {"prefill": 1, "decode_chunk": 1}
    assert "dp_replicas=2" in out and "replica 1:" in out
    assert "verify: 5 streams bit-match" in out
    assert fleet.leaked_pages() == 0


def test_dp_refusals():
    """The reference's refusals: ``--dp`` with the batch workload, and
    ``--verify`` of a quantized fleet (placement moves w8a8 streams)."""
    with pytest.raises(SystemExit, match="request workloads"):
        serve.main(BASE + ["--dp", "2"])
    with pytest.raises(SystemExit, match="--quant dense"):
        serve.main(BASE + ["--workload", "uniform", "--dp", "2",
                           "--quant", "w8a8_nibble", "--verify"])


@pytest.mark.parametrize("extra", [OVERCOMMIT, OVERCOMMIT + ["--dp", "2"]],
                         ids=["engine", "fleet"])
def test_predict_prints_the_capacity_model(monkeypatch, capsys, extra):
    """``--predict`` calibrates the drained engine and prints the model's
    prediction beside the measurement (the fleet skips it, as the
    reference's launcher does); the engine stays serviceable."""
    r, engine = _run_requests(monkeypatch, "uniform", "--predict", *extra)
    out = capsys.readouterr().out
    if "--dp" in extra:
        assert r["prediction"] is None
        assert "capacity model: (skipped" in out
        return
    p = r["prediction"]
    assert p["feasible"] and p["tokens"] == r["tokens"] == 5 * 6
    assert p["pool_pages"] == r["pool_pages"] == 6
    assert f"predicted {p['tok_per_s']:.1f} tok/s" in out
    assert engine.leaked_pages() == 0
    ids = [engine.submit([1, 2, 3, 4], 4) for _ in range(2)]
    done = engine.run()
    assert [len(done[i].tokens) for i in ids] == [4, 4]


@pytest.mark.parametrize("flags", [
    ["--autotune", "max-tok-s", "--ttft-slo-ms", "100"],
    ["--autotune", "min-pages"],
    ["--autotune", "max-tok-s", "--ttft-slo-ms", "0.001"]],
    ids=["max-tok-s-slo", "min-pages", "unmeetable-slo"])
def test_autotune_plans_without_a_model(capsys, flags):
    """``--autotune`` runs no model (so it needs no card: no ``--device``
    here): it prints the knob table and the winning ServeConfig kwargs,
    or says that no cell meets the SLO and returns 1."""
    argv = ["--arch", "yi-6b", "--batch", "2", "--prompt-len", "8",
            "--new-tokens", "6", "--requests", "5", "--workload",
            "uniform"] + flags
    rc = serve.main(argv)
    out = capsys.readouterr().out
    assert out.startswith("# autotune: ")
    assert "cache,alloc,page_size,pool_pages" in out
    if flags[-1] == "0.001":
        assert rc == 1 and "no admissible configuration" in out
        return
    assert rc == 0 and "<== winner" in out
    kwargs = json.loads(out.split("# winning ServeConfig kwargs:\n")[1])
    assert kwargs["quant_backend"] == "cuda"
    if flags[1] == "min-pages":
        assert kwargs["cache_mode"] == "paged"
    with pytest.raises(SystemExit, match="batch mode"):
        serve.main(argv[:-len(flags)] + ["--workload", "batch"] + flags)


@pytest.mark.parametrize("flags", [[], SPEC], ids=["temperature",
                                                   "temperature+spec"])
def test_temperature_flag_serves(monkeypatch, capsys, flags):
    """``--temperature 0.7`` samples, alone and with ``--spec-decode``, on
    an overcommitted pool: every request drains with zero leaks, spec
    rounds account for every token after the firsts, and ``--verify``
    (a greedy bit-match) refuses a sampled run, as the reference's
    launcher does."""
    extra = OVERCOMMIT if not flags else flags + ["--num-pages", "6"]
    r, engine = _run_requests(monkeypatch, "uniform", "--temperature",
                              "0.7", *extra)
    out = capsys.readouterr().out
    assert engine.scfg.temperature == 0.7
    assert r["tokens"] == 5 * 6 and engine.leaked_pages() == 0
    if flags:
        assert "spec decode: k=4" in out
        assert engine.spec_tokens == 5 * 6 - 5
        assert 0.0 <= r["acceptance_rate"] <= 1.0
    else:
        assert r["preemptions"] >= 1
    with pytest.raises(SystemExit, match="greedy"):
        serve.main(BASE + ["--workload", "uniform", "--temperature", "0.7",
                           "--verify"] + extra)


def test_torch_backend_needs_the_cpu():
    with pytest.raises(SystemExit, match="--device cpu"):
        serve.main(["--device", "cuda", "--quant-backend", "torch"])
