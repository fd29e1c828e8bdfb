"""Gate orchestration: the AST layer + the grid of engine cells (port of
``repro.staticcheck.runner``).

Each grid cell builds a tiny (``reduced``) engine, drives a few requests
through it so every stage records its signatures, then hands the stages
to the graph rules.  The cells mirror the reference's: dense and
nibble-quantized stages, the spec and wave modes whose pins differ, and
the counterpart of ``nibble-pallas``, ``nibble-cuda``, which runs the CUDA
kernels (the nibble matmul, and the flash forward and paged decode under
``attn_impl="flash"``) and so needs a card.

A plain-route cell runs on the CPU: its projections go through the
``kernels/ops`` entry points, which run their plain versions on CPU
tensors (the reference's ``xla`` cells run its plain formulas).  The
gate runs every cell on one device: by default the card, all five cells,
each then running the kernels, and captured (it raises without a card);
with ``device="cpu"``, the plain-route cells.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from repro_torch.roofline.analysis import stage_roofline
from repro_torch.staticcheck import graph_rules
from repro_torch.staticcheck.ast_rules import run_ast_rules
from repro_torch.staticcheck.findings import Finding
from repro_torch.staticcheck.flops import analytic_macs, cycle_bridge

# the reference's gate shape (reduced yi-6b), kept tiny: the contracts are
# shape-independent, so the gate runs in seconds
ARCH = "yi-6b"
BATCH = 4
MAX_LEN = 32
PREFILL_LEN = 8
DECODE_CHUNK = 4
PAGE_SIZE = 4
SPEC_K = 4
WAVE_CHUNK = 4
WAVE_GROUP = 2

AST_RULES = ["SC101", "SC102", "SC103", "SC104", "SC105", "SC201", "SC202"]
GRAPH_RULES = ["SC301", "SC302", "SC303", "SC304", "SC305", "SC306"]


@dataclasses.dataclass(frozen=True)
class GridCell:
    name: str
    quant_mode: str
    attn_impl: str
    mode: str                     # "plain" | "spec" | "wave"
    needs_card: bool = False

    @property
    def expected_pins(self) -> dict:
        if self.mode == "spec":
            return {"prefill": 1, "decode_chunk": 0, "draft": 1,
                    "verify": 1}
        if self.mode == "wave":
            return {"prefill": 0, "decode_chunk": 1, "prefill_chunk": 1}
        return {"prefill": 1, "decode_chunk": 1}


GRID_CELLS = (
    GridCell("dense", "dense", "chunked", "plain"),
    GridCell("nibble", "w8a8_nibble", "chunked", "plain"),
    GridCell("nibble-spec", "w8a8_nibble", "chunked", "spec"),
    GridCell("nibble-wave", "w8a8_nibble", "chunked", "wave"),
    GridCell("nibble-cuda", "w8a8_nibble", "flash", "plain",
             needs_card=True),
)


def cells_for(device: str = "cuda") -> tuple:
    """The cells a gate on ``device`` runs: every cell on the card, the
    plain-route ones on the CPU."""
    if device == "cpu":
        return tuple(c for c in GRID_CELLS if not c.needs_card)
    return GRID_CELLS


def build_cell_engine(cell: GridCell, device: str = "cuda"):
    """Build the cell's engine on ``device`` (captured on the card) and
    run a tiny workload so every stage records its signatures (3
    requests of 5, 8 and 3 tokens x 4 new, from seed 0)."""
    from repro_torch import resolve_device
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model_init
    from repro_torch.serve.engine import Engine, ServeConfig

    device = resolve_device(device)

    # the quant mode in the model config, so model_init prepares the
    # int8 weights once, as a served model's are
    cfg = reduced(get_config(ARCH)).replace(
        attn_impl=cell.attn_impl, quant_mode=cell.quant_mode,
        quant_backend="cuda")
    scfg = ServeConfig(
        batch=BATCH, max_len=MAX_LEN, prefill_len=PREFILL_LEN,
        decode_chunk=DECODE_CHUNK, cache_mode="paged",
        page_size=PAGE_SIZE, quant_mode=cell.quant_mode,
        quant_backend="cuda",
        spec_decode=(cell.mode == "spec"), spec_k=SPEC_K,
        prefill_chunk=(WAVE_CHUNK if cell.mode == "wave" else 0),
        admit_group=(WAVE_GROUP if cell.mode == "wave" else 1),
    )
    params = model_init(cfg, seed=0, device=device)
    engine = Engine(cfg, params, scfg, device=device)
    rng = np.random.default_rng(0)
    for length in (5, 8, 3):
        engine.submit(rng.integers(1, cfg.vocab_size,
                                   size=length).astype(np.int32),
                      max_new_tokens=4)
    engine.run()
    return engine


# per-stage geometry for the analytic cross-check: tokens processed,
# padded attention context, and LM-head positions per dispatch
def _stage_geometry(stage: str, cell: GridCell) -> dict | None:
    if stage == "prefill":
        return dict(tokens=PREFILL_LEN, kv_len=PREFILL_LEN,
                    logit_positions=1)
    if stage == "prefill_chunk":
        # the wave program projects the LM head over every (G, C)
        # position and gathers per-lane last tokens afterwards
        return dict(tokens=WAVE_GROUP * WAVE_CHUNK, kv_len=MAX_LEN,
                    logit_positions=WAVE_GROUP * WAVE_CHUNK)
    if stage == "decode_chunk":
        return dict(tokens=BATCH * DECODE_CHUNK, kv_len=MAX_LEN,
                    logit_positions=BATCH * DECODE_CHUNK)
    if stage == "draft":
        return dict(tokens=BATCH * SPEC_K, kv_len=MAX_LEN,
                    logit_positions=BATCH * SPEC_K)
    if stage == "verify":
        return dict(tokens=BATCH * (SPEC_K + 1), kv_len=MAX_LEN,
                    logit_positions=BATCH * (SPEC_K + 1))
    return None


def _stage_quantized(stage: str, cell: GridCell) -> bool:
    if cell.quant_mode == "dense":
        return False
    if cell.mode == "spec":
        # spec pins prefill/verify to dense; only the draft runs
        # quantized
        return stage == "draft"
    return True


def analytic_stage_macs(stage: str, cell: GridCell) -> dict | None:
    """Closed-form MACs for one stage dispatch on the gate's shapes."""
    from repro_torch.configs import get_config, reduced
    geo = _stage_geometry(stage, cell)
    if geo is None:
        return None
    cfg = reduced(get_config(ARCH))
    return analytic_macs(cfg, quantized=_stage_quantized(stage, cell),
                         **geo)


# SC306: static MACs vs the closed-form model from the ModelConfig
# geometry.  The port's agree EXACTLY on every cell, kernel route
# included: the costed entry points charge the useful products (the
# fixed-shape attention calls' zero padding is not work), and a
# stage's head runs at the geometry's logit positions only.  The
# tolerance absorbs future benign reassociations.
ANALYTIC_RTOL = 0.02


def check_cell(cell: GridCell, engine):
    """The graph rules and the cost table over one driven engine (drained;
    the walk writes its caches, so it is reset afterwards)."""
    plain = engine.device.type == "cpu"
    findings = graph_rules.check_pins(engine, cell.expected_pins, cell.name,
                                      captured=not plain)
    table = []
    for name, stage in sorted(engine.stage_programs().items()):
        f, costs = graph_rules.check_stage(stage, name, cell.name,
                                           lambda: engine._caches,
                                           plain_route=plain)
        findings += f
        analytic = analytic_stage_macs(name, cell)
        for c in costs:
            c["device"] = str(engine.device)
            if analytic is not None:
                c["analytic_macs"] = analytic["total_macs"]
                c["analytic_detail"] = analytic
                rel = (abs(c["dot_macs"] - analytic["total_macs"])
                       / max(analytic["total_macs"], 1))
                c["analytic_rel_err"] = rel
                if rel > ANALYTIC_RTOL:
                    findings.append(Finding(
                        "SC306", f"graph:{cell.name}", name,
                        f"static dot MACs {c['dot_macs']} vs analytic "
                        f"{analytic['total_macs']} disagree by {rel:.1%} "
                        f"(> {ANALYTIC_RTOL:.0%}): the stage geometry or "
                        "the MAC model drifted"))
            c["nibble_cycles"] = cycle_bridge(c["dot_macs"],
                                              "nibble_precompute")
            c["shift_add_cycles"] = cycle_bridge(c["dot_macs"], "shift_add")
            c["roofline"] = stage_roofline(c)
        table += costs
    engine.reset()
    return findings, table


def run_graph_layer(cells=None, device: str = "cuda"):
    """Build and drive every cell on ``device``, run the graph rules, and
    emit the per-stage cost table (static walk + analytic model + cycle
    bridge + roofline).  ``cells`` defaults to :func:`cells_for`; a cell
    that needs a card raises on the CPU, and ``device="cuda"`` raises
    without a card."""
    from repro_torch import resolve_device
    device = resolve_device(device).type
    cells = cells_for(device) if cells is None else cells
    findings: list = []
    table: list = []
    for cell in cells:
        if cell.needs_card and device == "cpu":
            raise ValueError(f"cell {cell.name} runs the CUDA kernels: it "
                             "needs device='cuda'")
        f, t = check_cell(cell, build_cell_engine(cell, device))
        findings += f
        table += t
    return findings, table


def run_gate(src_root: str | Path, repo_root: str | Path | None = None,
             ast_only: bool = False, cells=None, device: str = "cuda"):
    """The full gate: AST layer + (optionally) the grid on ``device`` (the
    card unless the caller asks for the CPU; ``ast_only`` builds no
    engine, so it runs anywhere).

    Returns ``(findings, report)`` where ``report`` is the
    JSON-serializable summary ``--report`` emits."""
    findings = run_ast_rules(src_root, repo_root)
    table: list = []
    cells = cells_for(device) if cells is None else cells
    if not ast_only:
        gf, table = run_graph_layer(cells, device)
        findings += gf
    report = {
        "rules": {"ast": list(AST_RULES),
                  "graph": [] if ast_only else list(GRAPH_RULES)},
        "grid": [] if ast_only else [c.name for c in cells],
        "device": device,
        "findings": [f.to_dict() for f in findings],
        "stage_costs": table,
    }
    return findings, report
