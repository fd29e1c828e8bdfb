"""Port parity for the LUT-array multiplier (``quant_mode="lut"``): the
plain LUT matmul and the ``lut`` linear against the reference.

The reference's LUT Pallas kernel cannot run under this JAX (no
``pltpu.TPUCompilerParams``), so the port is held to the functions it is
numerically identical to: ``repro.kernels.ref.nibble_matmul_ref`` and
``repro.core.linear.lut_matmul_xla`` (int32, exact) and
``linear_apply(mode="lut", backend="xla")`` (bf16-exact: the same int8
values, the exact int32 accumulator, the same two f32 multiplies and one
rounding).  The engine in ``lut`` mode is held to the reference engine in
``test_torch_engine.py``; the kernel against its plain version in
``test_torch_cuda.py`` (on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import linear as jlin
from repro.kernels import ref as jref
from repro_torch.core import linear as tlin
from repro_torch.kernels import lut_matmul as lm
from repro_torch.kernels import ops

torch.set_num_threads(1)

SHAPES = [(1, 16, 8), (5, 37, 22), (4, 64, 96), (33, 100, 50), (3, 1, 7)]


def _bf16_np(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_lut_plain_exact_against_reference(m, k, n):
    r = np.random.default_rng(m * 100 + k + n)
    x = r.integers(-128, 128, (m, k)).astype(np.int8)
    w = r.integers(-128, 128, (k, n)).astype(np.int8)
    x[0, 0], w[0, 0] = -128, -128                  # the extremes
    x[-1, -1], w[-1, -1] = 127, 127
    want = np.asarray(jref.nibble_matmul_ref(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_array_equal(
        np.asarray(jlin.lut_matmul_xla(jnp.asarray(x), jnp.asarray(w))), want)
    got = lm.lut_matmul_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the public dispatcher takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        ops.quant_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         w_format="lut").numpy(), want)


def test_lut_covers_every_int8_pair():
    vals = np.arange(-128, 128, dtype=np.int8)
    x = vals[:, None]                               # (256, 1)
    w = vals[None, :]                               # (1, 256)
    got = lm.lut_matmul_plain(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(
        got.numpy(), x.astype(np.int32) * w.astype(np.int32))


def test_quant_matmul_lut_int32_only():
    """``w_format="lut"`` keeps leading dims and returns exact int32; the
    epilogue belongs to the caller, so scales and a cast are refused."""
    r = np.random.default_rng(4)
    x = r.integers(-128, 128, (2, 3, 45)).astype(np.int8)
    w = r.integers(-128, 128, (45, 30)).astype(np.int8)
    want = np.asarray(jref.nibble_matmul_ref(jnp.asarray(x.reshape(6, 45)),
                                             jnp.asarray(w)))
    got = ops.quant_matmul(torch.from_numpy(x), torch.from_numpy(w),
                           w_format="lut")
    assert got.dtype == torch.int32 and got.shape == (2, 3, 30)
    np.testing.assert_array_equal(got.numpy().reshape(6, 30), want)
    for kw in (dict(x_scale=torch.tensor(0.013)),
               dict(w_scale=torch.ones(30)), dict(out_dtype=torch.float32)):
        with pytest.raises(ValueError, match="int32"):
            ops.quant_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             w_format="lut", **kw)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("shape", [(3, 7, 64), (4, 1, 64), (1, 128, 64)])
def test_lut_linear_bf16_exact_against_xla(backend, shape):
    r = np.random.default_rng(shape[1] + 3)
    x = _bf16_np(r.standard_normal(shape) * 2)
    w = _bf16_np(r.standard_normal((64, 96)) * 0.1)
    want = np.asarray(jlin.linear_apply(
        {"w": jnp.asarray(w, jnp.bfloat16)}, jnp.asarray(x, jnp.bfloat16),
        mode="lut", backend="xla").astype(jnp.float32))
    params = {"w": torch.from_numpy(w.copy()).bfloat16()}
    x_t = torch.from_numpy(x.copy()).bfloat16()
    got = tlin.linear_apply(params, x_t, mode="lut", backend=backend)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the prepared (serving) weight gives the same, and so does the nibble
    # path: both compute the same int32 product and epilogue
    tlin.prepare_quantized(params, "lut")
    assert "qt8" in params
    assert torch.equal(tlin.linear_apply(params, x_t, mode="lut",
                                         backend=backend), got)
    assert torch.equal(tlin.linear_apply(params, x_t, mode="w8a8_nibble",
                                         backend=backend), got)


def test_lut_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros((2, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        lm.lut_matmul_cuda(x, torch.zeros((16, 8), dtype=torch.int8))
