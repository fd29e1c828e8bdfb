"""Roofline terms for one serving stage's static cost (port of
``repro.roofline.analysis.stage_roofline``), at the H100's rates
(``launch.mesh.HW``).

Two terms per stage dispatch, in seconds:

    compute = 2 x int MACs / int8 peak
              + (2 x float MACs + elementwise flops) / bf16 peak
    memory  = io_bytes / HBM bandwidth

The reference divides every flop by its bf16 peak; on the H100 the int8
tensor-core rate is twice the bf16 one, and the nibble products are int8
work (``chip_smoke.py``'s kernel bounds divide them by the same int8
peak), so the port charges each dtype class its own rate.  A
single-device dispatch has no collective term.

The dry-run readers (``analyze_cell``, ``analyze_file``,
``format_table``) read the records ``launch.dryrun`` writes, three terms
per (arch x shape x mesh) cell, in seconds, from its per-device figures:

    compute    = int flops / int8 peak + other flops / bf16 peak
    memory     = bytes / HBM bandwidth
    collective = model-axis bytes / NVLink + data-axis bytes / network

The two link classes are charged one after the other (a step's
collectives mostly wait on each other), and each record's ``chips`` is
its mesh's entry count.  A record in the reference's layout (collective
bytes by kind alone, no ``chips``) reads as the reference reads it: every
byte over the NVLink term (its ICI) and the chips from the mesh tag.
``MODEL_FLOPS`` stays the reference's yardstick, 6 N D for training and
2 N D otherwise (N the active parameters).
"""

from __future__ import annotations

import dataclasses
import json

from repro_torch.launch.mesh import HW

__all__ = ["stage_roofline", "RooflineTerms", "analyze_cell",
           "analyze_file", "format_table"]


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_per_device: float
    hlo_flops_per_device: float
    useful_ratio: float          # MODEL_FLOPS / walked flops (~1 is good)
    roofline_fraction: float     # dominant-bound utilization estimate
    note: str = ""

    @property
    def total_s(self) -> float:
        # optimistic perfectly-overlapped lower bound = max of terms
        return max(self.compute_s, self.memory_s, self.collective_s)


def _chips(mesh_tag: str) -> int:
    """The reference's pod sizes, for a record that carries no
    ``chips``."""
    return 512 if "2pod" in mesh_tag else 256


def _tokens(shape: str) -> int:
    return {
        "train_4k": 256 * 4096,
        "prefill_32k": 32 * 32_768,
        "decode_32k": 128 * 1,          # one new token per sequence
        "long_500k": 1 * 1,
    }[shape]


def _model_flops(record: dict) -> float:
    """6 N(_active) tokens; backward ~ 2x forward -> train gets 3x 2 N D."""
    n = record["params_active"]
    toks = _tokens(record["shape"])
    if record["shape"] == "train_4k":
        return 6.0 * n * toks
    return 2.0 * n * toks                # inference: forward only


def _axis_bytes(coll: dict) -> tuple:
    """(model-axis bytes, data-axis bytes) per device of a record's
    collective bytes: the dry run's ``{kind: {axis: bytes}}``, or the
    reference's ``{kind: bytes}`` (all on the one link it models)."""
    model = data = 0.0
    for kind, v in coll.items():
        if kind == "n_ops":
            continue
        if isinstance(v, dict):
            model += v.get("model", 0.0)
            data += v.get("data", 0.0) + v.get("pod", 0.0)
        else:
            model += v
    return model, data


def analyze_cell(record: dict) -> RooflineTerms | None:
    if record.get("status") != "ok":
        return None
    chips = record.get("chips") or _chips(record["mesh"])
    flops_dev = record.get("flops_extrapolated", record["flops"])
    int_dev = record.get("int_flops_extrapolated", record.get("int_flops",
                                                              0.0))
    bytes_dev = record.get("bytes_extrapolated", record["bytes_accessed"])
    model_b, data_b = _axis_bytes(record.get(
        "collective_bytes_extrapolated", record.get("collective_bytes", {})))

    compute_s = (int_dev / HW.PEAK_INT8_OPS
                 + (flops_dev - int_dev) / HW.PEAK_BF16_FLOPS)
    memory_s = bytes_dev / HW.HBM_BW
    collective_s = model_b / HW.NVLINK_BW + data_b / HW.NET_BW

    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)

    model_flops = _model_flops(record) / chips
    useful = model_flops / max(flops_dev, 1.0)
    # roofline fraction: useful compute time over the bound step time
    frac = (model_flops / HW.PEAK_BF16_FLOPS) / max(max(terms.values()),
                                                    1e-12)
    return RooflineTerms(
        arch=record["arch"], shape=record["shape"], mesh=record["mesh"],
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops_per_device=model_flops,
        hlo_flops_per_device=flops_dev, useful_ratio=useful,
        roofline_fraction=frac)


def analyze_file(path: str) -> list[RooflineTerms]:
    with open(path) as f:
        records = json.load(f)
    return [t for t in map(analyze_cell, records) if t]


def format_table(terms: list[RooflineTerms]) -> str:
    hdr = (f"{'arch':28s} {'shape':12s} {'mesh':12s} "
           f"{'compute':>10s} {'memory':>10s} {'collect':>10s} "
           f"{'dominant':>10s} {'useful':>7s} {'roofl%':>7s}")
    lines = [hdr, "-" * len(hdr)]
    for t in sorted(terms, key=lambda t: (t.mesh, t.arch, t.shape)):
        lines.append(
            f"{t.arch:28s} {t.shape:12s} {t.mesh:12s} "
            f"{t.compute_s:10.4f} {t.memory_s:10.4f} "
            f"{t.collective_s:10.4f} {t.dominant:>10s} "
            f"{t.useful_ratio:7.3f} {100 * t.roofline_fraction:6.1f}%")
    return "\n".join(lines)


def stage_roofline(stage_cost: dict) -> dict:
    """Roofline terms for one ``staticcheck`` stage-cost row: flops and
    bytes come from the walk of the stage's body
    (``repro_torch.staticcheck.flops``), so a serving stage gets its
    compute / memory floor from shapes alone.  ``ridge_intensity`` is the
    ridge of this stage's mix of int8 and bf16 work (flops over
    ``compute_s``, over the HBM rate), so ``dominant`` is "compute"
    exactly when the arithmetic intensity reaches it; ``ridge_int8`` and
    ``ridge_bf16`` are the ridges of the two classes alone."""
    int_flops = 2.0 * stage_cost["int_dot_macs"]
    float_flops = (2.0 * stage_cost["float_dot_macs"]
                   + stage_cost["elementwise_flops"])
    flops = int_flops + float_flops
    io_bytes = float(stage_cost["io_bytes"])
    compute_s = (int_flops / HW.PEAK_INT8_OPS
                 + float_flops / HW.PEAK_BF16_FLOPS)
    memory_s = io_bytes / HW.HBM_BW
    peak = flops / compute_s if compute_s > 0 else HW.PEAK_BF16_FLOPS
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "step_s": max(compute_s, memory_s),   # overlapped lower bound
        "dominant": "compute" if compute_s >= memory_s else "memory",
        "arithmetic_intensity": flops / max(io_bytes, 1.0),
        "ridge_intensity": peak / HW.HBM_BW,
        "ridge_int8": HW.PEAK_INT8_OPS / HW.HBM_BW,
        "ridge_bf16": HW.PEAK_BF16_FLOPS / HW.HBM_BW,
    }
