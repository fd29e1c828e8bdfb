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

The dry-run readers (``analyze_cell``, ``analyze_file``, ``format_table``)
come with the dry run that writes their records (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

from repro_torch.launch.mesh import HW

__all__ = ["stage_roofline"]


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
