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


def test_swapped_identity_covers_every_int8_pair():
    """The kernel tables the activation and lets the weight's nibbles
    select: ``x * w == t_lo_x[w & 15] + t_hi_x[(w >> 4) & 15]`` with
    ``t_lo_x[v] = v * x`` and ``t_hi_x[v] = (v_signed << 4) * x``, built by
    addition as the kernel builds them, in int16, for all 256 x 256 pairs;
    equal to the plain version's products."""
    vals = np.arange(-128, 128, dtype=np.int64)
    x = vals[:, None]                               # (256, 1)
    lo, hi = [np.zeros((256, 16), np.int64) for _ in range(2)]
    for v in range(1, 16):                          # shifts and additions
        lo[:, v] = lo[:, v - 1] + vals
        hi[:, v] = -(vals << 7) if v == 8 else hi[:, v - 1] + (vals << 4)
    assert np.abs(np.concatenate([lo, hi])).max() <= 2 ** 14
    t_lo, t_hi = lo.astype(np.int16), hi.astype(np.int16)
    w = vals.astype(np.int8)[None, :]               # (1, 256)
    w_lo, w_hi = (w & 15).astype(np.int64), ((w >> 4) & 15).astype(np.int64)
    rows = np.arange(256)[:, None]
    got = t_lo[rows, w_lo].astype(np.int32) + t_hi[rows, w_hi]
    want = lm.lut_matmul_plain(torch.from_numpy(x.astype(np.int8)),
                               torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x * vals[None, :])


@pytest.mark.parametrize("m,k,n", [
    (4, 4096, 4096), (4, 4096, 512), (4, 4096, 11008), (4, 11008, 4096),
    (1, 4096, 512), (65, 4096, 4096), (128, 4096, 11008), (128, 4096, 4096),
    (4, 4096 + 24, 512), (5, 37, 22), (3, 1, 7), (1, 1, 1),
    (200, 11008 + 8, 260), (7, 100000, 3)])
@pytest.mark.parametrize("sms", [132, 1])
def test_lut_plan_splits_cover_k_once(m, k, n, sms):
    """The kernel's split of K (decode and prefill shapes, ragged ones):
    every k lies in exactly one split, no split is empty, splits start on
    the block's K tile, and the grid covers every row and column."""
    plan = lm.lut_plan(m, n, k, sms)
    rows, k_chunk = plan.rows, plan.k_chunk
    assert rows in (4, 8, 16) and (m <= rows or rows == 16)
    assert k_chunk % (256 // rows) == 0
    row_tiles, col_blocks, splits = plan.grid
    assert row_tiles * rows >= m > (row_tiles - 1) * rows
    assert col_blocks * lm.BLOCK_COLS >= n > (col_blocks - 1) * lm.BLOCK_COLS
    assert splits <= 65535 and col_blocks <= 65535
    hits = np.zeros(k, np.int64)
    for s in range(splits):
        lo, hi = s * k_chunk, min(k, (s + 1) * k_chunk)
        assert lo < hi, f"split {s} of {splits} is empty"
        hits[lo:hi] += 1
    np.testing.assert_array_equal(hits, 1)
    # small grids split K: a block per SM, or one K tile per block
    blocks = row_tiles * col_blocks * splits
    assert blocks >= min(sms, row_tiles * col_blocks * -(-k // (256 // rows)))


def test_quant_matmul_lut_int32_only():
    """``w_format="lut"`` keeps leading dims and returns exact int32 when
    given no scales and no ``out_dtype``.  With either scale, both, or an
    ``out_dtype`` alone it returns the reference's epilogue
    (``repro.kernels.ops.quant_matmul``'s "lut" branch: ``float(acc) *
    x_scale * w_scale`` in f32, cast to ``out_dtype`` or bf16; with no
    scales only the cast), computed here with ``jnp`` from the exact
    product, since the reference's LUT Pallas kernel cannot run under
    this JAX.  Bit-equal: the same f32 arithmetic."""
    r = np.random.default_rng(4)
    x = r.integers(-128, 128, (2, 3, 45)).astype(np.int8)
    w = r.integers(-128, 128, (45, 30)).astype(np.int8)
    want = np.asarray(jref.nibble_matmul_ref(jnp.asarray(x.reshape(6, 45)),
                                             jnp.asarray(w)))
    got = ops.quant_matmul(torch.from_numpy(x), torch.from_numpy(w),
                           w_format="lut")
    assert got.dtype == torch.int32 and got.shape == (2, 3, 30)
    np.testing.assert_array_equal(got.numpy().reshape(6, 30), want)
    xs = r.random((6, 1)).astype(np.float32) * 0.02 + 1e-3
    ws = r.random(30).astype(np.float32) * 0.02 + 1e-3
    cases = [
        (dict(x_scale=0.013), dict(xs=0.013)),
        (dict(x_scale=xs), dict(xs=xs)),
        (dict(w_scale=ws), dict(ws=ws)),
        (dict(x_scale=xs, w_scale=ws), dict(xs=xs, ws=ws)),
        (dict(x_scale=xs, w_scale=ws, out_dtype=torch.float32),
         dict(xs=xs, ws=ws, dt=jnp.float32)),
        (dict(out_dtype=torch.float32), dict(dt=jnp.float32)),
        (dict(out_dtype=torch.bfloat16), dict(dt=jnp.bfloat16)),
    ]
    for kw, ref in cases:
        acc = jnp.asarray(want)
        if "xs" in ref or "ws" in ref:
            acc = acc.astype(jnp.float32)
            if "xs" in ref:
                acc = acc * jnp.broadcast_to(jnp.asarray(
                    ref["xs"], jnp.float32).reshape(-1)[:, None], (6, 1))
            if "ws" in ref:
                acc = acc * jnp.broadcast_to(jnp.asarray(
                    ref["ws"], jnp.float32).reshape(-1)[None, :], (1, 30))
            acc = acc.astype(ref.get("dt", jnp.bfloat16))
        else:
            acc = acc.astype(ref["dt"])
        tkw = {key: (torch.from_numpy(val) if isinstance(val, np.ndarray)
                     else val) for key, val in kw.items()}
        got = ops.quant_matmul(torch.from_numpy(x), torch.from_numpy(w),
                               w_format="lut", **tkw)
        assert got.shape == (2, 3, 30), kw
        assert str(got.dtype).split(".")[-1] == str(acc.dtype), kw
        np.testing.assert_array_equal(
            got.float().numpy().reshape(6, 30),
            np.asarray(acc.astype(jnp.float32)), err_msg=str(kw))


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
