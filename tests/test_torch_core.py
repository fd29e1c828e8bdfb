"""Port parity: nibble decomposition, int4 packing and quantization must
match the JAX reference bit for bit (``repro.core`` vs ``repro_torch.core``);
quantization is held to the jitted reference, whose scales multiply by
the f32 reciprocal of qmax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nibble as jnib
from repro.core import quantize as jq
from repro_torch.core import nibble as tnib
from repro_torch.core import quantize as tq

torch.set_num_threads(1)

ALL_INT8 = np.arange(-128, 128, dtype=np.int8)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("kind", ["signed", "unsigned"])
def test_split_nibbles_exhaustive(kind):
    jfn = getattr(jnib, f"split_nibbles_{kind}")
    tfn = getattr(tnib, f"split_nibbles_{kind}")
    for j, t in zip(jfn(jnp.asarray(ALL_INT8)), tfn(torch.from_numpy(ALL_INT8))):
        np.testing.assert_array_equal(_np(j), _np(t))
        assert t.dtype == torch.int32


def test_combine_inverts_signed_split():
    lo, hi = tnib.split_nibbles_signed(torch.from_numpy(ALL_INT8))
    np.testing.assert_array_equal(_np(tnib.combine_nibbles(lo, hi)),
                                  ALL_INT8.astype(np.int32))
    jlo, jhi = jnib.split_nibbles_signed(jnp.asarray(ALL_INT8))
    np.testing.assert_array_equal(_np(jnib.combine_nibbles(jlo, jhi)),
                                  _np(tnib.combine_nibbles(lo, hi)))


@pytest.mark.parametrize("shape", [(16,), (3, 8), (2, 5, 6)])
def test_pack_unpack_int4_matches_reference(shape):
    w = np.random.default_rng(0).integers(-8, 8, shape).astype(np.int8)
    jp = _np(jnib.pack_int4(jnp.asarray(w)))
    tp = tnib.pack_int4(torch.from_numpy(w))
    assert tp.dtype == torch.int8
    np.testing.assert_array_equal(jp, _np(tp))
    np.testing.assert_array_equal(_np(tnib.unpack_int4(tp)), w)
    np.testing.assert_array_equal(_np(jnib.unpack_int4(jnp.asarray(jp))),
                                  _np(tnib.unpack_int4(tp)))


def test_pack_int4_rejects_odd_width():
    with pytest.raises(ValueError, match="even"):
        tnib.pack_int4(torch.zeros((3, 5), dtype=torch.int8))


# the reference as it runs: under jit XLA turns ``amax / qmax`` into a
# product with the f32 reciprocal of qmax
jquantize = jax.jit(jq.quantize, static_argnames=("bits", "granularity",
                                                  "axis"))


def _assert_quantize_equal(x, **kw):
    jt = jquantize(jnp.asarray(x), **kw)
    tt = tq.quantize(torch.from_numpy(x), **kw)
    np.testing.assert_array_equal(_np(jt.values), _np(tt.values))
    np.testing.assert_array_equal(_np(jt.scale).astype(np.float32),
                                  _np(tt.scale))
    assert tt.values.dtype == torch.int8 and tt.scale.dtype == torch.float32
    return tt


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("granularity,axis", [("per_tensor", -1),
                                              ("per_channel", -1),
                                              ("per_channel", 0)])
def test_quantize_random_exact(bits, granularity, axis):
    x = (np.random.default_rng(bits + axis).standard_normal((7, 33))
         * 3).astype(np.float32)
    _assert_quantize_equal(x, bits=bits, granularity=granularity, axis=axis)


@pytest.mark.parametrize("bits,qmax", [(8, 127.0), (4, 7.0)])
def test_quantize_half_boundaries_round_to_even(bits, qmax):
    # amax == qmax makes the scale exactly 1, so x / scale hits .5 exactly
    x = np.array([qmax, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -qmax],
                 np.float32)
    tt = _assert_quantize_equal(x, bits=bits, granularity="per_tensor")
    assert float(tt.scale) == 1.0
    np.testing.assert_array_equal(_np(tt.values)[1:8],
                                  [0, 2, 2, 0, -2, -2, 4])


@pytest.mark.parametrize("granularity", ["per_tensor", "per_channel"])
def test_quantize_all_zero_uses_floor(granularity):
    x = np.zeros((4, 6), np.float32)
    tt = _assert_quantize_equal(x, bits=8, granularity=granularity)
    assert not tt.values.any()
    np.testing.assert_array_equal(_np(tt.scale),
                                  np.float32(1e-8) * np.float32(1 / 127))


def test_quantize_clips_explicit_scale():
    x = np.array([[1000.0, -1000.0, 3.0]], np.float32)
    jt = jq.quantize(jnp.asarray(x), scale=jnp.float32(2.0))
    tt = tq.quantize(torch.from_numpy(x), scale=torch.tensor(2.0))
    np.testing.assert_array_equal(_np(jt.values), _np(tt.values))
    np.testing.assert_array_equal(_np(tt.values), [[127, -128, 2]])


def _scale_draw(rows=12800, width=64, seed=0):
    """f32 rows whose magnitudes span 1e-3 to 1e3 (log-uniform)."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-3.0, 3.0, (rows, 1))
    return (rng.standard_normal((rows, width)) * mag).astype(np.float32)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("granularity", ["per_tensor", "per_channel"])
def test_scales_match_jitted_reference(bits, granularity):
    """``abs_max_scale``, ``quantize`` and ``fake_quant``'s forward equal
    the jitted reference bit for bit on 12800 scales (one a row: per
    channel over the last axis, per tensor row by row)."""
    x = _scale_draw()
    tx = torch.from_numpy(x)

    def ref(a):
        return (jq.abs_max_scale(a, bits, granularity),
                jq.quantize(a, bits, granularity),
                jq.fake_quant(a, bits, granularity))

    def port(t):
        return (tq.abs_max_scale(t, bits, granularity),
                tq.quantize(t, bits, granularity),
                tq.fake_quant(t, bits, granularity))

    if granularity == "per_tensor":
        jscale, jqt, jfake = jax.jit(jax.vmap(ref))(jnp.asarray(x))
        rows = [port(r) for r in tx]
        scale = torch.stack([r[0] for r in rows])
        values = torch.stack([r[1].values for r in rows])
        fake = torch.stack([r[2] for r in rows])
    else:
        jscale, jqt, jfake = jax.jit(ref)(jnp.asarray(x))
        scale, qt, fake = port(tx)
        values = qt.values
        assert scale.shape == (12800, 1)
    np.testing.assert_array_equal(_np(scale), _np(jscale))
    np.testing.assert_array_equal(_np(values), _np(jqt.values))
    np.testing.assert_array_equal(_np(fake), _np(jfake))
