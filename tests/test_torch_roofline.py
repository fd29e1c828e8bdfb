"""The port's roofline against the reference's: the H100's ``HW``, and
``stage_roofline`` (the reference's formula where int8 and bf16 share
one rate, with the port's ``HW`` set to the reference's numbers; each
dtype class at its own H100 peak otherwise)."""

import pytest

from repro.launch import mesh as jmesh
from repro.roofline import analysis as janalysis
from repro_torch.capacity import model as capacity_model
from repro_torch.launch.mesh import HW
from repro_torch.roofline import analysis


def _row(int_macs, float_macs, elementwise, io_bytes) -> dict:
    return {"int_dot_macs": int_macs, "float_dot_macs": float_macs,
            "elementwise_flops": elementwise,
            "total_flops": 2 * (int_macs + float_macs) + elementwise,
            "io_bytes": io_bytes}


# the serve cell's rows on the card (yi-6b full width, 4 slots, max_len
# 160, decode_chunk 8: chip_smoke.py's static phase)
CHUNK = _row(354334801920, 9730785280, 218775984, 6676628468)
PREFILL = _row(1417339207680, 4557111296, 865594, 6676884520)
# rows of one dtype class each, and a float-only compute-bound one
INT_ONLY = _row(10 ** 12, 0, 0, 10 ** 9)
FLOAT_ONLY = _row(0, 10 ** 12, 0, 10 ** 9)
ROWS = {"chunk": CHUNK, "prefill": PREFILL, "int": INT_ONLY,
        "float": FLOAT_ONLY}


@pytest.fixture
def reference_hw(monkeypatch):
    """The port's ``HW`` carrying the reference's numbers, its int8 work
    at the bf16 rate as the reference divides it."""
    monkeypatch.setattr(HW, "PEAK_BF16_FLOPS", jmesh.HW.PEAK_BF16_FLOPS)
    monkeypatch.setattr(HW, "PEAK_INT8_OPS", jmesh.HW.PEAK_BF16_FLOPS)
    monkeypatch.setattr(HW, "HBM_BW", jmesh.HW.HBM_BW)
    monkeypatch.setattr(HW, "NVLINK_BW", jmesh.HW.ICI_BW)


def test_hw_is_the_h100():
    assert (HW.PEAK_BF16_FLOPS, HW.PEAK_INT8_OPS, HW.HBM_BW, HW.HBM_BYTES,
            HW.NVLINK_BW) == (989e12, 1.979e15, 3.35e12, 80e9, 450e9)
    # the capacity model divides by the same class
    assert capacity_model.H100 is HW


@pytest.mark.parametrize("name", sorted(ROWS))
def test_stage_roofline_equals_the_reference_at_one_rate(name, reference_hw):
    """With int8 at the bf16 rate the port's terms are the reference's."""
    row = ROWS[name]
    got, want = analysis.stage_roofline(row), janalysis.stage_roofline(row)
    assert got["dominant"] == want["dominant"]
    for key in want:
        if key != "dominant":
            assert got[key] == pytest.approx(want[key], rel=1e-12), key
    assert got["ridge_int8"] == got["ridge_bf16"] == \
        pytest.approx(want["ridge_intensity"], rel=1e-12)


@pytest.mark.parametrize("name", sorted(ROWS))
def test_stage_roofline_charges_each_class_its_peak(name):
    """int MACs over the int8 peak, float MACs and elementwise flops over
    the bf16 peak; the dominant term is arithmetic intensity against the
    mix's own ridge, which lies between the two classes' ridges."""
    row = ROWS[name]
    r = analysis.stage_roofline(row)
    compute = (2 * row["int_dot_macs"] / 1.979e15
               + (2 * row["float_dot_macs"] + row["elementwise_flops"])
               / 989e12)
    assert r["compute_s"] == pytest.approx(compute, rel=1e-12)
    assert r["memory_s"] == pytest.approx(row["io_bytes"] / 3.35e12)
    assert r["step_s"] == max(r["compute_s"], r["memory_s"])
    assert r["arithmetic_intensity"] == pytest.approx(
        row["total_flops"] / row["io_bytes"])
    assert r["ridge_int8"] == pytest.approx(1.979e15 / 3.35e12)
    assert r["ridge_bf16"] == pytest.approx(989e12 / 3.35e12)
    assert r["ridge_bf16"] <= r["ridge_intensity"] * (1 + 1e-12)
    assert r["ridge_intensity"] <= r["ridge_int8"] * (1 + 1e-12)
    assert (r["dominant"] == "compute") == \
        (r["arithmetic_intensity"] >= r["ridge_intensity"] * (1 - 1e-12))


def test_serve_cell_rows_at_the_h100_rates():
    """The full-width serve cell: the chunk and the prefill are both
    memory-bound at the H100's int8 rate (the prefill's 2.83e12 int8
    ops take 1.43 ms, under its 1.99 ms of bytes)."""
    chunk, prefill = (analysis.stage_roofline(CHUNK),
                      analysis.stage_roofline(PREFILL))
    assert chunk["dominant"] == prefill["dominant"] == "memory"
    assert chunk["compute_s"] == pytest.approx(3.780e-4, rel=1e-3)
    assert prefill["compute_s"] == pytest.approx(1.4416e-3, rel=1e-3)
    assert prefill["step_s"] == pytest.approx(6676884520 / 3.35e12)
    # the int8 ridge is twice the bf16 one
    assert prefill["ridge_int8"] == pytest.approx(2 * 295.22, rel=1e-3)


def test_stage_roofline_of_an_empty_stage():
    r = analysis.stage_roofline(_row(0, 0, 0, 0))
    assert r["compute_s"] == r["memory_s"] == r["step_s"] == 0.0
    assert r["ridge_intensity"] == pytest.approx(989e12 / 3.35e12)
