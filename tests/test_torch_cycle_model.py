"""Port parity for the analytical cycle, area and power model
(``repro_torch.core.cycle_model``, the port's own NumPy copy): every
public function equals the reference's exactly (float ``==``, no
tolerance) for every architecture, N in {1, 4, 8, 16, 128} and the
operand widths each function takes, and it raises where the reference
raises.  Then the paper's Table 2 and Fig. 4 claims, as
``tests/test_cycle_model.py`` holds the reference to them."""

import dataclasses

import pytest

from repro.core import cycle_model as jcm
from repro_torch.core import cycle_model as tcm

ARCHES = list(jcm.ARCHES)
NS = [1, 4, 8, 16, 128]
WIDTHS = [4, 8, 16, 32]


def test_public_names_and_tables_match():
    assert tcm.ARCHES == jcm.ARCHES
    assert set(tcm.__all__) == set(jcm.__all__)
    for name in ("_PAPER_AREA", "_PAPER_POWER", "_AREA_COEF",
                 "_POWER_COEF"):
        assert getattr(tcm, name) == getattr(jcm, name), name
    assert [f.name for f in dataclasses.fields(tcm.GateCount)] == \
        [f.name for f in dataclasses.fields(jcm.GateCount)]


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("arch", ARCHES)
def test_cycles_and_gate_counts_match(arch, width):
    assert tcm.cycles_per_operand(arch, width) == \
        jcm.cycles_per_operand(arch, width)
    for n in NS:
        assert tcm.total_cycles(arch, n, width) == \
            jcm.total_cycles(arch, n, width)
    assert dataclasses.astuple(tcm.gate_counts(arch, width)) == \
        dataclasses.astuple(jcm.gate_counts(arch, width))


@pytest.mark.parametrize("arch", ARCHES)
def test_area_power_energy_match(arch):
    for metric in ("area", "power"):
        assert tcm.paper_reported(metric, arch) == \
            jcm.paper_reported(metric, arch)
    for n in NS:
        assert tcm.area_um2(arch, n) == jcm.area_um2(arch, n)
        assert tcm.power_mw(arch, n) == jcm.power_mw(arch, n)
        for freq in (1.0, 0.5):
            assert tcm.energy_per_product_pj(arch, n, 8, freq) == \
                jcm.energy_per_product_pj(arch, n, 8, freq)
        for base in ARCHES:
            for metric in ("area", "power"):
                assert tcm.improvement_vs(base, arch, metric, n) == \
                    jcm.improvement_vs(base, arch, metric, n)


@pytest.mark.parametrize("call", [
    lambda m: m.cycles_per_operand("array"),
    lambda m: m.total_cycles("array", 4),
    lambda m: m.gate_counts("array"),
    lambda m: m.area_um2("shift_add", 4, width=16),
    lambda m: m.power_mw("shift_add", 4, width=4),
])
def test_refusals_match(call):
    errors = []
    for m in (jcm, tcm):
        with pytest.raises((KeyError, NotImplementedError)) as info:
            call(m)
        errors.append(type(info.value))
    assert errors[0] is errors[1]


@pytest.mark.parametrize("arch,per_op,total_16", [
    ("shift_add", 8, 128), ("booth_radix2", 4, 64),
    ("nibble_precompute", 2, 32), ("wallace", 1, 1), ("lut_array", 1, 1)])
def test_table2_from_the_port(arch, per_op, total_16):
    assert tcm.cycles_per_operand(arch) == per_op
    assert tcm.total_cycles(arch, 16) == total_16


def test_fig4_ratios_from_the_port():
    """The paper's headline ratios at 16 operands, with the bounds of
    ``tests/test_cycle_model.py``."""
    area_sa = tcm.improvement_vs("shift_add", "nibble_precompute", "area", 16)
    power_sa = tcm.improvement_vs("shift_add", "nibble_precompute", "power",
                                  16)
    area_lut = tcm.improvement_vs("lut_array", "nibble_precompute", "area",
                                  16)
    power_lut = tcm.improvement_vs("lut_array", "nibble_precompute",
                                   "power", 16)
    assert abs(area_sa - 1.69) < 0.02
    assert abs(power_sa - 1.63) < 0.03
    assert abs(area_lut - 2.6) < 0.1
    assert power_lut > 2.7
    # Fig. 4(b)'s crossover: nibble loses on power at N = 4
    assert tcm.improvement_vs("shift_add", "nibble_precompute", "power",
                              4) < 1.0
