"""The port's static gate (``repro_torch.staticcheck``): each rule flags an
injected violation and passes its clean twin, the baseline's mechanics,
the whole tree and the CPU grid clean on HEAD, the static counts against
the closed-form model and the cycle model, and parity with the reference
gate's pure parts and engines (its jaxpr walk no longer runs on this JAX:
``jax.core.ClosedJaxpr`` is gone, so the reference's own grid tests fail
there; parity is held through its geometry, pins, analytic model and
engines)."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.staticcheck import flops as jflops
from repro.staticcheck import runner as jrunner
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core.cycle_model import cycles_per_operand
from repro_torch.kernels import ops
from repro_torch.serve.engine import _StageCounter
from repro_torch.staticcheck import graph_rules, runner
from repro_torch.staticcheck.__main__ import main as cli_main
from repro_torch.staticcheck.ast_rules import find_stage_bodies, \
    run_ast_rules
from repro_torch.staticcheck.findings import (Finding, apply_baseline,
                                              load_baseline)
from repro_torch.staticcheck.flops import (StageWalk, analytic_macs,
                                           cycle_bridge, walk_stage)

REPO = Path(__file__).resolve().parent.parent
BASELINE = REPO / "src" / "repro_torch" / "staticcheck" / "baseline.json"
ARCHS = ARCH_NAMES
STAGES = ("prefill", "prefill_chunk", "decode_chunk", "draft", "verify")
# the port's cells and the reference's, by name
REF_CELLS = {"dense": "dense-xla", "nibble": "nibble-xla",
             "nibble-spec": "nibble-xla-spec",
             "nibble-wave": "nibble-xla-wave", "nibble-cuda": "nibble-pallas"}


# ---------------------------------------------------------------------------
# AST rule units: each rule flags an injected violation and passes its
# clean twin
# ---------------------------------------------------------------------------

ENGINE = """
import numpy as np
import torch

class Engine:
    def __init__(self, cuda):
        self._stage = _CapturedStage(self._body, None, True)
        self._caches = [{{"k": torch.zeros(4)}}]

{body}
"""


def _lint(tmp_path, source, relname="src/repro_torch/mod.py"):
    p = tmp_path / relname
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))
    return [f.rule for f in run_ast_rules(tmp_path / "src",
                                          repo_root=tmp_path)]


def _body(src):
    return ENGINE.format(body=textwrap.indent(textwrap.dedent(src), "    "))


def test_stage_bodies_come_from_the_constructor_calls():
    """The engine's six bodies, found from the ``_StageCounter`` /
    ``_CapturedStage`` calls (a conditional argument and a for loop over
    pairs among them), with no list of names."""
    import ast
    tree = ast.parse((REPO / "src" / "repro_torch" / "serve"
                      / "engine.py").read_text())
    assert [q for q, _ in find_stage_bodies(tree)] == [
        "Engine._chunk_body", "Engine._draft_body", "Engine._prefill_body",
        "Engine._prefix_body", "Engine._verify_body", "Engine._wave_body"]


def test_sc101_item_on_traced(tmp_path):
    bad = _body("""
        def _body(self, x):
            return x.item()
    """)
    bad_tolist = _body("""
        def _body(self, x):
            return x.tolist()
    """)
    # a body named through a for loop over (name, method) pairs
    bad_loop = """
        class Engine:
            def __init__(self):
                for name, fn in (("a", self._a), ("b", self._b)):
                    _StageCounter(fn, None)

            def _a(self, x):
                return x

            def _b(self, x):
                return x.item()
    """
    good = _body("""
        def _body(self, x):
            return x.sum()
    """)
    assert "SC101" in _lint(tmp_path / "bad", bad)
    assert "SC101" in _lint(tmp_path / "tolist", bad_tolist)
    assert "SC101" in _lint(tmp_path / "loop", bad_loop)
    assert _lint(tmp_path / "good", good) == []


def test_sc102_cast_on_traced(tmp_path):
    bad = _body("""
        def _body(self, x):
            return x * float(x[0])
    """)
    good = _body("""
        def _body(self, x):
            scale = float(1.5)
            return x * scale
    """)
    assert "SC102" in _lint(tmp_path / "bad", bad)
    assert _lint(tmp_path / "good", good) == []


def test_sc103_numpy_on_traced(tmp_path):
    bad = _body("""
        def _body(self, x):
            return np.asarray(x)
    """)
    good = _body("""
        def _body(self, x):
            iota = np.arange(4)
            return x + torch.from_numpy(iota)
    """)
    assert "SC103" in _lint(tmp_path / "bad", bad)
    assert _lint(tmp_path / "good", good) == []


def test_sc104_branch_on_traced(tmp_path):
    bad = _body("""
        def _body(self, x):
            y = x * 2
            if y.sum() > 0:
                return x
            return -x
    """)
    bad_nested = _body("""
        def _body(self, x):
            def step(t):
                return t if t > 0 else -t
            return step(x)
    """)
    good_shape = _body("""
        def _body(self, x):
            if x.shape[0] > 1 and x.numel() > 1:
                return x
            return -x
    """)
    good_self = _body("""
        def _body(self, x):
            if self.flag:
                return x
            return -x
    """)
    good_none = _body("""
        def _body(self, x, y=None):
            if y is not None:
                return x + y
            return x
    """)
    assert "SC104" in _lint(tmp_path / "bad", bad)
    assert "SC104" in _lint(tmp_path / "nested", bad_nested)
    assert _lint(tmp_path / "g1", good_shape) == []
    assert _lint(tmp_path / "g2", good_self) == []
    assert _lint(tmp_path / "g3", good_none) == []


def test_sc105_host_sync_in_serve(tmp_path):
    rel = "src/repro_torch/serve/stepper.py"
    for i, bad in enumerate(("torch.cuda.synchronize()",
                             "event.synchronize()",
                             "torch.cuda.current_stream().synchronize()",
                             "x.sum().item()")):
        src = f"""
            import torch
            def step(x, event):
                {bad}
                return x
        """
        assert "SC105" in _lint(tmp_path / f"bad{i}", src, rel)
        # outside serve/ the same code is not an engine step path
        assert _lint(tmp_path / f"other{i}", src,
                     "src/repro_torch/launch/x.py") == []
    good = """
        def step(x):
            return x.cpu().numpy()
    """
    assert _lint(tmp_path / "good", good, rel) == []


def test_sc201_caches_written_in_place(tmp_path):
    bads = ["self._caches = [{'k': x}]",
            "self._caches[0] = {'k': x}",
            "self._caches[0]['k'] = self._caches[0]['k'] + x",
            "logits, self._caches = x, []",
            "caches = self._caches\ncaches[0]['k'] = x.clone()"]
    for i, line in enumerate(bads):
        src = _body("def _body(self, x):\n"
                    + textwrap.indent(line, "    ") + "\n    return x\n")
        assert "SC201" in _lint(tmp_path / f"bad{i}", src), line
    good = _body("""
        def _body(self, x):
            self._caches[0]["k"][0] = x[0]
            self._caches[0]["k"].add_(x)
            scatter(self._caches, x)
            return x
    """)
    assert _lint(tmp_path / "good", good) == []
    # a method no stage runs may rebind them (the engine's __init__ does)
    setup = _body("""
        def _body(self, x):
            return x

        def grow(self, x):
            self._caches = [{"k": x}]
    """)
    assert _lint(tmp_path / "setup", setup) == []


def test_sc202_paging_stays_numpy(tmp_path):
    rel = "src/repro_torch/serve/paging.py"
    bad = """
        import torch
        def alloc(n):
            return torch.zeros(n)
    """
    bad_from = """
        from torch import zeros
        def alloc(n):
            return zeros(n)
    """
    good = """
        import numpy as np
        def alloc(n):
            return np.zeros(n)
    """
    assert "SC202" in _lint(tmp_path / "bad", bad, rel)
    assert "SC202" in _lint(tmp_path / "bad_from", bad_from, rel)
    assert _lint(tmp_path / "good", good, rel) == []


# ---------------------------------------------------------------------------
# graph rule units, each on a synthetic stage
# ---------------------------------------------------------------------------

def _stage(fn, *args):
    stage = _StageCounter(fn, torch.device("cpu"))
    stage.record(*args)
    return stage


def _rules(findings):
    return {f.rule for f in findings}


def test_sc301_quant_widening():
    x = torch.zeros((8, 16), dtype=torch.int8)
    w = torch.zeros((16, 4), dtype=torch.int8)

    def bad(x_q, w):
        return x_q.to(torch.float32) @ w.to(torch.float32)

    def bad_layout(x_q, w):
        xf = x_q.to(torch.float32).reshape(2, 4, 16).transpose(0, 1)
        return torch.matmul(xf.reshape(8, 16), w.float())

    def good(x_q, w):
        # the same widening inside the entry point's plain version
        return ops.quant_matmul(x_q, w).to(torch.float32)

    def good_scaled(x_q, w):
        # widened, then scaled: not the operand any more
        return (x_q.to(torch.float32) * 0.5) @ torch.ones(16, 4)

    for fn in (bad, bad_layout):
        f, _ = graph_rules.check_stage(_stage(fn, x, w), "s", "unit", list)
        assert _rules(f) == {"SC301"}, fn.__name__
    for fn in (good, good_scaled):
        f, _ = graph_rules.check_stage(_stage(fn, x, w), "s", "unit", list)
        assert "SC301" not in _rules(f), fn.__name__


def test_sc302_caches_keep_their_storage():
    caches = [{"k": torch.zeros(16, 4), "v": torch.zeros(16, 4)}]
    x = torch.zeros(4)

    def rebound(x):
        caches[0]["k"] = caches[0]["k"] + x
        return x

    def copied(x):
        return caches[0]["v"].clone()[0] + x

    def in_place(x):
        caches[0]["k"][3] = x
        caches[0]["v"].index_copy_(0, torch.tensor([1]), x[None])
        return caches[0]["k"][:4].sum(0) + x

    for fn in (rebound, copied):
        f, _ = graph_rules.check_stage(_stage(fn, x), "s", "unit",
                                       lambda: caches)
        assert "SC302" in _rules(f), fn.__name__
    f, costs = graph_rules.check_stage(_stage(in_place, x), "s", "unit",
                                       lambda: caches)
    assert "SC302" not in _rules(f)
    # both pools are written in place: each counts on both sides
    pool = 16 * 4 * 4
    assert costs[0]["io_bytes"] >= 4 * pool


def test_sc303_host_sync_in_body():
    x = torch.zeros(8)

    def bad_item(x):
        return x * x.sum().item()

    def bad_nonzero(x):
        return x[x > 0]

    def bad_transfer(x):
        return x.to("meta")

    def good(x):
        return x * x.sum()

    for fn in (bad_item, bad_nonzero, bad_transfer):
        f, _ = graph_rules.check_stage(_stage(fn, x), "s", "unit", list)
        assert _rules(f) == {"SC303"}, fn.__name__
    f, _ = graph_rules.check_stage(_stage(good, x), "s", "unit", list)
    assert f == []


class _FakeEngine:
    def __init__(self, stage, captures=None):
        self._stage = stage
        self.capture_counts = {"decode_chunk": captures}

    def stage_programs(self):
        return {"decode_chunk": self._stage}


def test_sc304_signature_pins():
    pins = {"decode_chunk": 1}
    churner = _StageCounter(lambda x: x + 1)
    churner.record(torch.ones(4))
    churner.record(torch.ones(8))       # a second distinct signature
    f = graph_rules.check_pins(_FakeEngine(churner), pins, "unit")
    assert [x.rule for x in f] == ["SC304"]
    stable = _StageCounter(lambda x: x + 1)
    stable.record(torch.ones(4))
    stable.record(torch.ones(4))        # the same signature twice
    assert graph_rules.check_pins(_FakeEngine(stable), pins, "unit") == []
    # on the card: one graph per signature
    assert graph_rules.check_pins(_FakeEngine(stable, 1), pins, "unit",
                                  captured=True) == []
    f = graph_rules.check_pins(_FakeEngine(stable, 0), pins, "unit",
                               captured=True)
    assert [x.rule for x in f] == ["SC304"]


def test_sc305_bracket_and_the_hook():
    """A costed call counts its shapes' work and nothing inside it; the
    flop counter sees the plain version's products, within the bracket;
    the hook is cleared after the walk."""
    x = torch.zeros((4, 32), dtype=torch.int8)
    w = torch.zeros((32, 8), dtype=torch.int8)

    def body(x_q, w):
        return ops.quant_matmul(x_q, w, x_scale=torch.ones(()),
                                w_scale=torch.ones(8))

    stage = _stage(body, x, w)
    walk, counted = walk_stage(stage, stage.signatures[0],
                               flop_counter=True)
    assert ops.cost_hook is None
    assert walk.cost.int_dot_macs == 2 * 4 * 32 * 8      # two planes
    assert walk.cost.float_dot_macs == 0 and walk.hooked_calls == 1
    assert counted == 2 * walk.cost.dot_macs            # float64 [lo|hi]
    f, _ = graph_rules.check_stage(stage, "s", "unit", list)
    assert f == []


def test_walks_do_not_nest():
    with StageWalk():
        with pytest.raises(RuntimeError, match="already running"):
            StageWalk().__enter__()
    assert ops.cost_hook is None


# ---------------------------------------------------------------------------
# baseline mechanics
# ---------------------------------------------------------------------------

def test_baseline_suppression_and_staleness():
    f1 = Finding("SC101", "src/a.py", "f", "msg")
    f2 = Finding("SC104", "src/b.py", "g", "msg")
    baseline = {"version": 1, "suppressions": [
        {"key": f1.key, "reason": "known"},
        {"key": "SC999:src/gone.py:h", "reason": "fixed long ago"},
    ]}
    unsup, sup, stale = apply_baseline([f1, f2], baseline)
    assert [f.rule for f in unsup] == ["SC104"]
    assert [f.rule for f in sup] == ["SC101"]
    assert stale == ["SC999:src/gone.py:h"]


def test_committed_baseline_empty_for_serve_and_kernels():
    baseline = load_baseline(BASELINE)
    for entry in baseline["suppressions"]:
        assert "src/repro_torch/serve" not in entry["key"]
        assert "src/repro_torch/kernels" not in entry["key"]


# ---------------------------------------------------------------------------
# whole-tree runs on HEAD
# ---------------------------------------------------------------------------

def test_ast_layer_clean_on_head():
    findings = run_ast_rules(REPO / "src" / "repro_torch", repo_root=REPO)
    unsup, _sup, _stale = apply_baseline(findings, load_baseline(BASELINE))
    assert unsup == [], "\n".join(f.render() for f in unsup)


def test_cli_ast_only_exits_clean(tmp_path):
    report = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.staticcheck", "--ast-only",
         "--report", str(report)], capture_output=True, text=True,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    data = json.loads(report.read_text())
    assert data["findings"] == [] and data["stale_suppressions"] == []
    assert data["rules"]["ast"] == runner.AST_RULES
    assert data["rules"]["graph"] == [] and data["grid"] == []


@pytest.mark.parametrize("argv", [[], ["--device", "cuda"]])
def test_cli_on_cuda_needs_a_card(tmp_path, argv):
    """The grid runs on the card unless the caller asks for the CPU: by
    default, or asked for the card, it raises without one, as do the
    runner's functions."""
    if torch.cuda.is_available():
        return                     # the card runs it (chip_smoke.py)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main(argv + ["--report", str(tmp_path / "r")])
    assert not (tmp_path / "r").exists()
    for call in (lambda: runner.run_gate(REPO / "src" / "repro_torch", REPO),
                 runner.run_graph_layer,
                 lambda: runner.build_cell_engine(runner.GRID_CELLS[0])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert runner.cells_for() == runner.GRID_CELLS
    with pytest.raises(ValueError, match="needs device='cuda'"):
        runner.run_graph_layer([runner.GRID_CELLS[-1]], device="cpu")


# ---------------------------------------------------------------------------
# the CPU grid
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grid():
    """Every CPU cell's driven engine, its findings and its cost rows."""
    engines, findings, table = {}, [], []
    for cell in runner.cells_for("cpu"):
        engines[cell.name] = runner.build_cell_engine(cell, "cpu")
        f, t = runner.check_cell(cell, engines[cell.name])
        findings += f
        table += t
    return engines, findings, table


def test_grid_is_the_reference_grid():
    assert [c.name for c in runner.cells_for("cpu")] == [
        "dense", "nibble", "nibble-spec", "nibble-wave"]
    assert [c.name for c in runner.GRID_CELLS][-1] == "nibble-cuda"
    for name in ("ARCH", "BATCH", "MAX_LEN", "PREFILL_LEN", "DECODE_CHUNK",
                 "PAGE_SIZE", "SPEC_K", "WAVE_CHUNK", "WAVE_GROUP"):
        assert getattr(runner, name) == getattr(jrunner, name), name


def test_grid_contracts_clean(grid):
    _, findings, table = grid
    assert findings == [], "\n".join(f.render() for f in findings)
    assert {(r["cell"], r["stage"]) for r in table} == {
        ("dense", "prefill"), ("dense", "decode_chunk"),
        ("nibble", "prefill"), ("nibble", "decode_chunk"),
        ("nibble-spec", "prefill"), ("nibble-spec", "draft"),
        ("nibble-spec", "verify"), ("nibble-wave", "prefill_chunk"),
        ("nibble-wave", "decode_chunk")}


def test_static_macs_equal_the_analytic_model(grid):
    """SC306 holds, and exactly: every static MAC count equals the closed
    form (the reference's are exact on its xla cells too)."""
    _, _, table = grid
    for r in table:
        assert r["dot_macs"] == r["analytic_macs"], (r["cell"], r["stage"])
        quantized = runner._stage_quantized(
            r["stage"], next(c for c in runner.GRID_CELLS
                             if c.name == r["cell"]))
        assert (r["int_dot_macs"] > 0) == quantized
        assert r["padding_macs"] > 0      # attention_core's fixed calls


def test_cycle_bridge_and_roofline_rows(grid):
    _, _, table = grid
    for r in table:
        nib = cycle_bridge(r["dot_macs"], "nibble_precompute")
        assert r["nibble_cycles"] == nib == r["dot_macs"] * \
            cycles_per_operand("nibble_precompute", 8)
        assert r["shift_add_cycles"] == 4 * nib
        t = r["roofline"]
        assert t["compute_s"] > 0 and t["memory_s"] > 0
        assert t["step_s"] == max(t["compute_s"], t["memory_s"])
        low = t["arithmetic_intensity"] < t["ridge_intensity"]
        assert t["dominant"] == ("memory" if low else "compute")
        assert r["scan_once_flops"] == r["total_flops"]


def test_bytes_and_flops_bracket(grid):
    _, _, table = grid
    for r in table:
        assert 0 < r["io_bytes"] <= r["bytes_accessed"] * 1.5
        counted = r["flop_counter_flops"]
        assert r["dot_flops"] * 0.5 <= counted <= \
            (r["dot_flops"] + 2 * r["padding_macs"]) * 1.5
        # the plain versions run exactly the costed work plus the padding
        assert counted == r["dot_flops"] + 2 * r["padding_macs"]


def test_static_count_is_the_same_on_every_route(grid):
    """The kernel cell's configuration (flash prefill, the paged decode
    kernel's entry point) and the reference's formulas (no entry point:
    ``quant_backend="torch"``) count each stage's MACs as the plain
    cell does."""
    engines, _, table = grid
    want = {r["stage"]: r["dot_macs"] for r in table
            if r["cell"] == "nibble"}
    flash = runner.GRID_CELLS[-1]
    engine = runner.build_cell_engine(flash, "cpu")
    _, rows = runner.check_cell(flash, engine)
    assert {r["stage"]: r["dot_macs"] for r in rows} == want
    torch_route = engines["nibble"]
    torch_route.cfg = torch_route.cfg.replace(quant_backend="torch")
    try:
        for name, stage in torch_route.stage_programs().items():
            walk, _ = walk_stage(stage, stage.signatures[0],
                                 flop_counter=False)
            assert walk.cost.dot_macs == want[name], name
            # the formulas widen int8 to float64 outside an entry point
            assert walk.widened_products
    finally:
        torch_route.cfg = torch_route.cfg.replace(quant_backend="cuda")
        torch_route.reset()


def test_run_gate_report():
    findings, report = runner.run_gate(REPO / "src" / "repro_torch", REPO,
                                       device="cpu")
    assert findings == []
    assert report["rules"]["ast"] == ["SC101", "SC102", "SC103", "SC104",
                                      "SC105", "SC201", "SC202"]
    assert report["rules"]["graph"] == ["SC301", "SC302", "SC303", "SC304",
                                        "SC305", "SC306"]
    assert report["grid"] == ["dense", "nibble", "nibble-spec",
                              "nibble-wave"]
    assert {"findings", "stage_costs", "device"} <= set(report)
    assert len(report["stage_costs"]) == 9


# ---------------------------------------------------------------------------
# parity with the reference gate
# ---------------------------------------------------------------------------

def _geometries():
    for cell in runner.GRID_CELLS:
        for stage in STAGES:
            geo = runner._stage_geometry(stage, cell)
            if geo is not None:
                yield geo


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_macs_equal_the_reference(arch):
    tcfg, jcfg = get_config(arch), jget_config(arch)
    for geo in _geometries():
        for quantized in (False, True):
            assert analytic_macs(tcfg, quantized=quantized, **geo) == \
                jflops.analytic_macs(jcfg, quantized=quantized, **geo)


def test_geometry_pins_and_quantization_equal_the_reference():
    jcells = {c.name: c for c in jrunner.GRID_CELLS}
    for cell in runner.GRID_CELLS:
        jcell = jcells[REF_CELLS[cell.name]]
        assert cell.expected_pins == jcell.expected_pins
        assert (cell.quant_mode, cell.mode) == (jcell.quant_mode,
                                                jcell.mode)
        for stage in STAGES:
            assert runner._stage_geometry(stage, cell) == \
                jrunner._stage_geometry(stage, jcell)
            assert runner._stage_quantized(stage, cell) == \
                jrunner._stage_quantized(stage, jcell)
            assert runner.analytic_stage_macs(stage, cell) == \
                jrunner.analytic_stage_macs(stage, jcell)


def test_compile_counts_equal_the_reference(grid):
    """Each cell's engine records the reference engine's signature counts,
    the reference built its way with ``quant_backend="xla"``."""
    engines, _, _ = grid
    for cell in runner.cells_for("cpu"):
        jcell = next(c for c in jrunner.GRID_CELLS
                     if c.name == REF_CELLS[cell.name])
        jengine = jrunner.build_cell_engine(
            jrunner.GridCell(jcell.name, jcell.quant_mode, "xla",
                             jcell.mode))
        assert engines[cell.name].compile_counts == jengine.compile_counts
        assert engines[cell.name].compile_counts == {
            k: v for k, v in cell.expected_pins.items()
            if k in engines[cell.name].compile_counts}


def test_engine_serves_after_a_walk(grid):
    """A walked, reset engine serves the same greedy streams again."""
    engines, _, _ = grid
    engine = engines["nibble"]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (4, 6)]

    def serve():
        for p in prompts:
            engine.submit(p, max_new_tokens=4)
        out = engine.run()
        return [list(out[k].tokens) for k in sorted(out)]

    first = serve()
    stage = engine.stage_programs()["decode_chunk"]
    walk_stage(stage, stage.signatures[0])
    engine.reset()
    assert serve() == first
