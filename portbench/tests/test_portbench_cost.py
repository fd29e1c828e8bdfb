"""The counts behind the rooflines and the MFU, against hand arithmetic
at yi-6b's decode shape."""

import json

import pytest

from portbench import cost
from portbench.harness import ROOT

YI = json.loads((ROOT / "portbench/configs/yi-6b.json").read_text())["model"]
MAMBA = json.loads(
    (ROOT / "portbench/configs/mamba2-780m.json").read_text())["model"]


def test_nibble_call_at_the_up_projection():
    ops, nbytes = cost.nibble_call(128, 4096, 11008)
    assert ops == 2 * 128 * 4096 * 11008 == 11_542_724_608
    # int8 x and w, f32 x scale, (1, N) f32 w scales, bf16 out
    assert nbytes == 524_288 + 45_088_768 + 4 + 44_032 + 2_818_048
    floor = cost.floor_s(ops, nbytes, cost.INT8_PEAK)
    assert floor == pytest.approx(48_475_140 / 3.35e12)   # bytes bound
    assert ops / cost.INT8_PEAK == pytest.approx(5.8326e-6, rel=1e-4)


def test_paged_decode_call():
    rows = [300, 1000]
    ops, nbytes = cost.paged_decode_call(rows, 32, 4, 128, 16)
    assert ops == 4 * 32 * 128 * 1300
    kv = 2 * 2 * 4 * 128 * 1300                      # bf16 K and V rows
    qo = 2 * 2 * 2 * 32 * 128                        # bf16 q in, out
    table = 4 * (19 + 63) + 4 * 2                    # pages, positions
    assert nbytes == kv + qo + table


def test_flash_prefill_call():
    ops, nbytes = cost.flash_prefill_call(4, 32, 4, 128)
    # causal: query i meets i + 1 keys, 10 pairs; QK and PV, 2 FLOP a MAC
    assert ops == 2 * 2 * 32 * 128 * 10
    assert nbytes == 2 * 4 * 128 * (32 + 32 + 4 + 4)


def test_yi_token_work():
    per_layer = (4096 * 4096 + 2 * 4096 * 512 + 4096 * 4096
                 + 3 * 4096 * 11008)
    assert sum(k * n for k, n in cost.projections(YI, "dense")) == per_layer
    i_ops, f_ops = cost.token_work(YI, "dense", 1000)
    assert i_ops == 32 * 2 * per_layer
    assert f_ops == 32 * 4 * 32 * 128 * 1000 + 2 * 4096 * 64000
    # about 11.1 G int8 ops a token: 2 x 5.5 G projection MACs
    assert i_ops == pytest.approx(11.08e9, rel=0.01)
    p_int, p_flt = cost.prefill_work(YI, "dense", 2)
    assert p_int == 2 * i_ops
    assert p_flt == 32 * 2 * 32 * 128 * 2 * 3 + 2 * 4096 * 64000


def test_mamba_projections():
    (k1, n1), (k2, n2) = cost.projections(MAMBA, "ssd")
    assert (k1, n1) == (1536, 2 * 3072 + 2 * 128 + 48)
    assert (k2, n2) == (3072, 1536)
    _, f_ops = cost.token_work(MAMBA, "ssd", 0)
    assert f_ops == 48 * 4 * 3072 * 128 + 2 * 1536 * 50280


def test_mfu_seconds():
    assert cost.mfu_seconds(1979e12, 989e12) == pytest.approx(2.0)
