"""Port parity for the paper's multiplier layer: the five architecture
models (``repro_torch.core.multipliers``) and the precompute-logic
helpers of ``repro_torch.core.nibble`` against the reference's, on the
CPU.  Every comparison is exact: products are int32 and equal the
reference's bit for bit (and ``a * b``), ``cycles`` and
``cycles_per_operand`` are equal, and so are the NumPy tables.

The reference side of an exhaustive sweep runs its function under
``jax.vmap`` over the broadcast operand and ``jax.jit`` (integer
arithmetic: the program's order changes nothing); its cycle counts come
from one unjitted call.  The same sweeps on the card are in
``test_torch_cuda.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multipliers as jmul
from repro.core import nibble as jnib
from repro_torch.core import multipliers as tmul
from repro_torch.core import nibble as tnib

torch.set_num_threads(1)

UNSIGNED = np.arange(256)
SIGNED = np.arange(-128, 128)
ARCHES = list(tmul.MULTIPLIERS)
# the unsigned sweep of every architecture; the signed sweeps of the two
# models that take signed operands
SWEEPS = [(arch, "unsigned") for arch in ARCHES] + [
    ("booth_radix2", "signed"), ("nibble_precompute", "signed")]


def _fns(arch, kind):
    # Booth recodes two's complement whatever it is given
    kw = {"signed": True} if (kind, arch) == ("signed",
                                              "nibble_precompute") else {}
    return (functools.partial(jmul.MULTIPLIERS[arch], **kw),
            functools.partial(tmul.MULTIPLIERS[arch], device="cpu", **kw))


def _reference_sweep(jfn, a, bs):
    """(len(bs), len(a)) reference products, one row per broadcast b."""
    lanes = jnp.asarray(a, jnp.int32)
    rows = jax.jit(jax.vmap(lambda b: jfn(lanes, b).products))
    return np.asarray(rows(jnp.asarray(bs, jnp.int32)))


def test_registry_matches_reference():
    assert list(tmul.MULTIPLIERS) == list(jmul.MULTIPLIERS)
    assert set(tmul.__all__) >= set(jmul.__all__) | {"lut_array_16bit"}


@pytest.mark.parametrize("arch,kind", SWEEPS)
def test_exhaustive_8bit_matches_reference(arch, kind):
    """Every (a, b) of the 8-bit range (unsigned [0, 256)², or signed
    [-128, 128)²): the port's products equal the reference's and a * b
    (Booth: a * int8(b)), lane for lane; cycles and cycles per operand
    equal too."""
    jfn, tfn = _fns(arch, kind)
    a = SIGNED if kind == "signed" else UNSIGNED
    want = _reference_sweep(jfn, a, a)
    lanes = torch.from_numpy(a).to(torch.int32)
    for i, b in enumerate(a):
        got = tfn(lanes, int(b))
        assert got.products.dtype == torch.int32
        np.testing.assert_array_equal(got.products.numpy(), want[i],
                                      err_msg=f"{arch} b={b}")
    # Booth's four digits read b as int8: b >= 128 multiplies by b - 256
    bs = (a + 128) % 256 - 128 if arch == "booth_radix2" else a
    np.testing.assert_array_equal(want, np.outer(bs, a))
    jtrace = jfn(jnp.asarray(a, jnp.int32), int(a[7]))
    ttrace = tfn(lanes, int(a[7]))
    assert (ttrace.cycles, ttrace.cycles_per_operand, ttrace.name) == \
        (jtrace.cycles, jtrace.cycles_per_operand, jtrace.name)


@pytest.mark.parametrize("arch", ARCHES)
@pytest.mark.parametrize("operands", ["python", "numpy", "tensor"])
def test_operand_kinds_and_unpacking(arch, operands):
    """Python lists and NumPy arrays go to the device asked for; a tensor
    keeps its own; the trace unpacks as ``products, cycles``."""
    a = [0, 3, 17, 255, 128]
    a_in = {"python": a, "numpy": np.asarray(a, np.uint8),
            "tensor": torch.tensor(a, dtype=torch.uint8)}[operands]
    b = {"python": 171, "numpy": np.uint8(171),
         "tensor": torch.tensor(171)}[operands]
    products, cycles = tmul.MULTIPLIERS[arch](a_in, b, device="cpu")
    jtrace = jmul.MULTIPLIERS[arch](jnp.asarray(a, jnp.int32), 171)
    np.testing.assert_array_equal(products.numpy(),
                                  np.asarray(jtrace.products))
    assert cycles == jtrace.cycles and products.device.type == "cpu"


def test_scalar_operand_is_one_lane():
    got = tmul.nibble_precompute(200, 7, device="cpu")
    want = jmul.nibble_precompute(200, 7)
    assert got.products.shape == (1,) and got.cycles == want.cycles
    assert int(got.products[0]) == int(want.products[0]) == 1400


def test_lanes_default_to_cuda():
    """Without a card, NumPy or Python lanes raise rather than running on
    the CPU (``device="cuda"`` is the default)."""
    if torch.cuda.is_available():
        assert tmul.shift_add([1, 2], 3).products.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tmul.shift_add([1, 2], 3)


@pytest.mark.parametrize("bs", [(0, 1, 15, 16, 171, 255),
                                tuple(range(2, 256, 37))])
def test_lut_array_16bit_matches_reference(bs):
    """Algorithm 1's 16-bit-A path on a seeded draw of A: Out1 and Out2
    equal the reference's, and Out1 + (Out2 << 8) == A * B."""
    a16 = np.random.default_rng(len(bs)).integers(0, 65536, 4096)
    for b in bs:
        j1, j2 = jmul.lut_array_16bit(jnp.asarray(a16, jnp.int32), b)
        t1, t2 = tmul.lut_array_16bit(torch.from_numpy(a16), b)
        np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
        np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))
        np.testing.assert_array_equal(
            t1.numpy().astype(np.int64) + (t2.numpy().astype(np.int64) << 8),
            a16 * b)


def test_lut_models_take_one_broadcast_operand():
    with pytest.raises(ValueError, match="one broadcast operand"):
        tmul.lut_array(torch.arange(4), torch.arange(4))
    with pytest.raises(NotImplementedError, match="8-bit"):
        tmul.lut_array(torch.arange(4), 3, width=16)


def test_hex_string_lut_matches_reference():
    got, want = tmul.build_hex_string_lut(), jmul.build_hex_string_lut()
    assert got.dtype == want.dtype == np.uint16
    np.testing.assert_array_equal(got, want)


def test_lane_wise_operand_matches_summed_products():
    """``b`` broadcast per row of a 2-D lane block (the link check of the
    card's smoke run): the per-row products of signed Algorithm 2 summed
    over rows equal an integer matmul row."""
    rng = np.random.default_rng(5)
    w = rng.integers(-128, 128, (32, 24))
    x = rng.integers(-128, 128, 32)
    got = tmul.nibble_precompute(torch.from_numpy(w),
                                 torch.from_numpy(x)[:, None], signed=True,
                                 device="cpu").products
    want = jmul.nibble_precompute(jnp.asarray(w, jnp.int32),
                                  jnp.asarray(x, jnp.int32)[:, None],
                                  signed=True).products
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.sum(0).numpy(), x @ w)


# ---------------------------------------------------------------------------
# The precompute logic (nibble.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["unsigned", "signed"])
def test_pl_scale_exhaustive_matches_reference(kind):
    """``pl_scale`` over every 8-bit ``a`` and every nibble ``k``: equal
    to the reference's, to ``pl_scale_reference`` and to ``k * a``."""
    a = (SIGNED if kind == "signed" else UNSIGNED)[:, None]
    k = np.arange(16)[None, :]
    got = tnib.pl_scale(torch.from_numpy(a), torch.from_numpy(k))
    want = np.asarray(jnib.pl_scale(jnp.asarray(a), jnp.asarray(k)))
    assert got.dtype == torch.int32 and got.shape == (a.size, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tnib.pl_scale_reference(torch.from_numpy(a),
                                torch.from_numpy(k)).numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jnib.pl_scale_reference(jnp.asarray(a), jnp.asarray(k))),
        want)
    np.testing.assert_array_equal(want, a * k)


@pytest.mark.parametrize("k", range(16))
def test_pl_recipes_match_reference(k):
    """The recipe table, the adder count and the NumPy recipe dataflow of
    nibble ``k`` (and ``k + 16``: only the low nibble selects)."""
    assert tnib.pl_recipe_table()[k] == jnib.pl_recipe_table()[k]
    assert sum(1 << s for s in tnib.pl_recipe_table()[k]) == k
    for kk in (k, k + 16):
        assert tnib.pl_adder_count(kk) == jnib.pl_adder_count(kk)
        a = np.arange(-128, 256)
        got = tnib.numpy_pl_scale(a, kk)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, jnib.numpy_pl_scale(a, kk))
        np.testing.assert_array_equal(got, a * k)


def test_pl_recipe_table_is_a_copy():
    table = tnib.pl_recipe_table()
    table[3] = ()
    assert tnib.pl_recipe_table()[3] == (1, 0)
