"""Port parity for the kernel layer: the plain versions of the three
ported kernels against the JAX reference (each CUDA kernel against its
plain version is in test_torch_cuda.py, which runs on the card).

Tolerances:
* integer products: exact (``torch.equal`` / ``assert_array_equal``);
* ``linear_apply`` in the nibble modes: bf16-exact against the reference's
  ``backend="xla"`` formula (same int8 values, exact int32 accumulator,
  the same two f32 multiplies, one rounding to bf16);
* attention in f32: atol/rtol 1e-5 (the reference kernels rescale online
  per block, the plain versions softmax over all keys at once: same
  arithmetic in another order);
* attention in bf16: atol 2e-2 (p is rounded to bf16 against a different
  running max, |o| < ~3).

The reference's fused nibble Pallas kernel cannot run under this JAX
(no ``pltpu.TPUCompilerParams``), so matmuls are held to
``repro.kernels.ref`` and to ``linear_apply(backend="xla")``, which are
numerically identical to it by construction.  The attention kernels are
held to the reference's interpret-mode Pallas kernels directly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import linear as jlin
from repro.core.nibble import pack_int4 as jpack
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import linear as tlin
from repro_torch.core.nibble import pack_int4
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import nibble_matmul as nm
from repro_torch.kernels import ops

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_ATOL = 2e-2


def _bf16_np(a):
    """Round to bf16 and back to f32 (the values both packages see)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# quant_matmul (plain version) against repro.kernels.ref
# ---------------------------------------------------------------------------

MM_SHAPES = [(1, 16, 8), (5, 37, 22), (4, 64, 96), (33, 100, 50)]


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
def test_quant_matmul_int8_exact(m, k, n):
    r = _rng(m * k)
    x = r.integers(-128, 128, (m, k)).astype(np.int8)
    w = r.integers(-128, 128, (k, n)).astype(np.int8)
    want = np.asarray(jref.nibble_matmul_ref(jnp.asarray(x), jnp.asarray(w)))
    got = ops.quant_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
def test_quant_matmul_int4_packed_exact(m, k, n):
    r = _rng(m + k + n)
    x = r.integers(-128, 128, (m, k)).astype(np.int8)
    w4 = r.integers(-8, 8, (k, n)).astype(np.int8)
    wp = np.asarray(jpack(jnp.asarray(w4)))
    np.testing.assert_array_equal(pack_int4(torch.from_numpy(w4)).numpy(), wp)
    want = np.asarray(jref.nibble_matmul_w4_ref(jnp.asarray(x),
                                                jnp.asarray(wp)))
    got = ops.quant_matmul(torch.from_numpy(x), torch.from_numpy(wp),
                           w_format="int4_packed")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w_format", ["int8", "int4_packed"])
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_quant_matmul_scaled_epilogue_exact(w_format, out_dtype):
    r = _rng(7)
    m, k, n = 6, 45, 30
    x = r.integers(-128, 128, (2, m // 2, k)).astype(np.int8)   # leading dims
    if w_format == "int8":
        w = r.integers(-128, 128, (k, n)).astype(np.int8)
        acc = jref.nibble_matmul_ref(jnp.asarray(x.reshape(m, k)),
                                     jnp.asarray(w))
    else:
        w = np.asarray(jpack(jnp.asarray(r.integers(-8, 8, (k, n)))))
        acc = jref.nibble_matmul_w4_ref(jnp.asarray(x.reshape(m, k)),
                                        jnp.asarray(w))
    xs = (r.random(m) * 0.01 + 1e-4).astype(np.float32)
    ws = (r.random(n) * 0.01 + 1e-4).astype(np.float32)
    jdt = jnp.bfloat16 if out_dtype is None else jnp.float32
    want = np.asarray((acc.astype(jnp.float32) * jnp.asarray(xs)[:, None]
                       * jnp.asarray(ws)[None, :]).astype(jdt)
                      .astype(jnp.float32)).reshape(2, m // 2, n)
    got = ops.quant_matmul(torch.from_numpy(x), torch.from_numpy(w),
                           x_scale=torch.from_numpy(xs),
                           w_scale=torch.from_numpy(ws), w_format=w_format,
                           out_dtype=out_dtype)
    assert got.dtype == (torch.bfloat16 if out_dtype is None
                         else torch.float32)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_quant_matmul_lut_not_ported():
    """Named for when "lut" raised here.  The LUT format now returns exact
    int32 unscaled and, given a scale, the reference's epilogue (bf16 by
    default); only an unknown format raises.  test_torch_lut.py holds the
    LUT product and every epilogue case to the reference."""
    x = torch.ones((2, 16), dtype=torch.int8)
    out = ops.quant_matmul(x, torch.ones((16, 8), dtype=torch.int8),
                           w_format="lut")
    assert out.dtype == torch.int32 and bool((out == 16).all())
    out = ops.quant_matmul(x, torch.ones((16, 8), dtype=torch.int8),
                           x_scale=torch.tensor(0.5), w_format="lut")
    assert out.dtype == torch.bfloat16 and bool((out == 8).all())
    with pytest.raises(ValueError):
        ops.quant_matmul(x, torch.zeros((16, 8), dtype=torch.int8),
                         w_format="int2")


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros((2, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        nm.nibble_matmul_cuda(x, torch.zeros((16, 8), dtype=torch.int8))
    q = torch.zeros((2, 4, 16), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="CUDA"):
        fa.flash_attention_fwd_cuda(q, q, q, scale=1.0)
    lse = torch.zeros((2, 4))
    with pytest.raises(TypeError, match="CUDA"):
        fa.flash_attention_bwd_cuda(q, q, q, lse, q, lse, scale=1.0)


# ---------------------------------------------------------------------------
# the nibble kernel's launch plan and its split-K reduction (plain Python)
# ---------------------------------------------------------------------------

NIBBLE_DECODE = [(4, 4096, 4096), (4, 4096, 512), (4, 4096, 512),
                 (4, 4096, 4096), (4, 4096, 11008), (4, 4096, 11008),
                 (4, 11008, 4096)]       # yi-6b wq wk wv wo gate up down


@pytest.mark.parametrize("m,k,n", sorted(set(NIBBLE_DECODE))
                         + [(128, 4096, 11008)])
@pytest.mark.parametrize("sms", [132, 114, 8])
def test_nibble_plan_splits_cover_k_once(m, k, n, sms):
    """Every k lies in exactly one split, no split is empty, splits start
    on the pipeline's K tile, at most one cluster of splits per tile, the
    grid covers every row and column, and a decode projection puts a block
    on every SM where a cluster of splits per tile allows it."""
    plan = nm.nibble_plan(m, n, k, sms)
    rows, k_chunk = plan.rows, plan.k_chunk
    assert rows in (8, 16, 64) and (m <= rows or rows == 64)
    assert k_chunk > 0 and k_chunk % nm.K_TILE == 0
    row_tiles, col_blocks, splits = plan.grid
    assert row_tiles * rows >= m > (row_tiles - 1) * rows
    assert col_blocks * nm.BLOCK_COLS >= n > (col_blocks - 1) * nm.BLOCK_COLS
    assert splits <= nm.MAX_SPLITS and col_blocks <= 65535
    hits = np.zeros(k, np.int64)
    for z in range(splits):
        lo, hi = z * k_chunk, min(k, (z + 1) * k_chunk)
        assert lo < hi, f"split {z} of {splits} is empty"
        hits[lo:hi] += 1
    np.testing.assert_array_equal(hits, 1)
    if m == 4:
        # decode: K is split until every SM has a block, or until the
        # splits of a tile fill one cluster (N = 512: 8 x 8 blocks)
        tiles = row_tiles * col_blocks
        assert tiles * splits >= min(sms, tiles * nm.MAX_SPLITS)


def _split_emulation(x, w, xs, ws, plan, out_dtype, w_packed=False):
    """The kernel's reduction in plain tensors: one int32 partial per split
    of K (the plain version's formula on that K range), summed, then the
    epilogue once on the total."""
    k = x.shape[1]
    total = torch.zeros((x.shape[0], 2 * w.shape[1] if w_packed
                         else w.shape[1]), dtype=torch.int32)
    for z in range(plan.grid[2]):
        lo, hi = z * plan.k_chunk, min(k, (z + 1) * plan.k_chunk)
        total += nm.nibble_matmul_plain(x[:, lo:hi], w[lo:hi],
                                        w_packed=w_packed)
    if xs is None:
        return total
    return (total.to(torch.float32) * xs * ws).to(out_dtype)


@pytest.mark.parametrize("m,k,n", [(1, 4096 + 16, 64), (9, 1040, 70),
                                   (65, 2048 + 16, 34)])
@pytest.mark.parametrize("out", ["int32", "bf16", "f32"])
@pytest.mark.parametrize("w_packed", [False, True])
def test_nibble_split_k_reduction_equals_plain(m, k, n, out, w_packed):
    r = _rng(m + k + n)
    x = torch.from_numpy(r.integers(-128, 128, (m, k)).astype(np.int8))
    x[:, 0] = -128                            # the hs plane's -128
    if w_packed:
        w4 = torch.from_numpy(r.integers(-8, 8, (k, n)).astype(np.int8))
        w4[0, :2] = torch.tensor([-8, 7], dtype=torch.int8)
        w = pack_int4(w4)
    else:
        w = torch.from_numpy(r.integers(-128, 128, (k, n)).astype(np.int8))
        w[0, :2] = torch.tensor([-128, 127], dtype=torch.int8)
    plan = nm.nibble_plan(m, n, k, 8)          # a small card: many splits
    assert plan.grid[2] > 1
    scaled = out != "int32"
    xs = torch.from_numpy((r.random((m, 1)) * 0.01 + 1e-4)
                          .astype(np.float32)) if scaled else None
    ws = torch.from_numpy((r.random((1, n)) * 0.01 + 1e-4)
                          .astype(np.float32)) if scaled else None
    dt = {"int32": None, "bf16": torch.bfloat16, "f32": torch.float32}[out]
    got = _split_emulation(x, w, xs, ws, plan, dt, w_packed)
    want = nm.nibble_matmul_plain(x, w, xs, ws, w_packed=w_packed,
                                  out_dtype=dt)
    assert got.dtype == want.dtype and torch.equal(got, want)
    if not scaled:
        ref = (jref.nibble_matmul_w4_ref if w_packed
               else jref.nibble_matmul_ref)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(ref(jnp.asarray(x.numpy()),
                                        jnp.asarray(w.numpy()))))


def test_nibble_scales_are_read_in_place():
    """The wrapper hands the kernel a pointer and a stride for each scale:
    a broadcast scalar or an (M, 1) / (1, N) f32 tensor is not copied."""
    dev = torch.device("cpu")
    one = torch.tensor(0.5)
    for s, size, stride in (
            (torch.broadcast_to(one.reshape(1, 1), (6, 1)), 6, 0),
            (one, 6, 0), (torch.ones((6, 1)), 6, 1), (torch.ones((1, 9)), 9, 1),
            (torch.ones(9), 9, 1), (torch.ones((1, 18))[:, ::2], 9, 2)):
        t, st = nm._scale(s, size, dev)
        assert st == stride and t.data_ptr() == s.data_ptr()
        read = torch.as_strided(t, (size,), (st,))     # t[i * stride]
        want = s.reshape(-1) if s.numel() > 1 else s.reshape(1).expand(size)
        assert torch.equal(read, want)
    assert nm._scale(None, 6, dev) == (None, 0)
    t, st = nm._scale(torch.ones((6, 1), dtype=torch.float64), 6, dev)
    assert t.dtype == torch.float32 and st == 1
    with pytest.raises(ValueError, match="broadcast"):
        nm._scale(torch.ones(5), 6, dev)


# ---------------------------------------------------------------------------
# linear_apply against the reference's xla backend: bf16-exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["w8a8_nibble", "w4a8_nibble", "dense"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("shape", [(3, 7, 64), (4, 1, 64), (1, 128, 64)])
def test_linear_apply_matches_xla(mode, backend, shape):
    r = _rng(len(shape) + shape[1])
    x = _bf16_np(r.standard_normal(shape) * 2)
    w = _bf16_np(r.standard_normal((64, 96)) * 0.1)
    want = np.asarray(jlin.linear_apply(
        {"w": jnp.asarray(w, jnp.bfloat16)}, jnp.asarray(x, jnp.bfloat16),
        mode=mode, backend="xla").astype(jnp.float32))
    params = {"w": torch.from_numpy(w).bfloat16()}
    got = tlin.linear_apply(params, torch.from_numpy(x).bfloat16(),
                            mode=mode, backend=backend)
    assert got.dtype == torch.bfloat16
    if mode == "dense":
        # a plain bf16 GEMM: XLA and torch sum K in another order, so a
        # result may round to the neighbouring bf16 value (1 ulp, 2**-7
        # relative at most)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(got.float().numpy(), want)
    # quantizing the weight once (serving) gives the same result
    tlin.prepare_quantized(params, mode)
    again = tlin.linear_apply(params, torch.from_numpy(x).bfloat16(),
                              mode=mode, backend=backend)
    assert torch.equal(again, got)


def test_prepared_weight_is_reference_quantization():
    from repro.core import quantize as jq
    w = _bf16_np(_rng(3).standard_normal((40, 24)))
    params = {"w": torch.from_numpy(w).bfloat16()}
    for mode, bits in (("w8a8_nibble", 8), ("w4a8_nibble", 4)):
        tlin.prepare_quantized(params, mode)
        jt = jq.quantize(jnp.asarray(w), bits=bits,
                         granularity="per_channel", axis=0)
        np.testing.assert_array_equal(params[f"qt{bits}"].t().numpy(),
                                      np.asarray(jt.values))
        np.testing.assert_array_equal(params[f"s{bits}"].numpy(),
                                      np.asarray(jt.scale))


def test_linear_unported_modes_raise():
    """Named for when ``qat`` and ``lut`` raised here.  Every mode of the
    reference is ported now (``qat`` and ``lut`` are held to it in
    test_torch_train.py / test_torch_lut.py); only an unknown mode
    raises."""
    params = {"w": torch.zeros((8, 8), dtype=torch.bfloat16)}
    for mode in ("qat", "lut"):
        out = tlin.linear_apply(params, torch.zeros((1, 8)), mode=mode)
        assert out.shape == (1, 8)
    with pytest.raises(NotImplementedError):
        tlin.linear_apply(params, torch.zeros((1, 8)), mode="w2a8_nibble")


# ---------------------------------------------------------------------------
# Flash forward (plain version) against ops.flash_mha (interpret Pallas)
# ---------------------------------------------------------------------------

FLASH_CASES = [
    dict(bkv=2, group=2, s=13, d=16, window=0, softcap=0.0),
    dict(bkv=1, group=4, s=40, d=32, window=7, softcap=0.0),
    dict(bkv=2, group=1, s=9, d=8, window=0, softcap=20.0),
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_forward_plain_matches_reference(case, dtype):
    r = _rng(case["s"])
    bh = case["bkv"] * case["group"]
    q = r.standard_normal((bh, case["s"], case["d"])).astype(np.float32)
    k = r.standard_normal((case["bkv"], case["s"], case["d"])) \
        .astype(np.float32)
    v = r.standard_normal((case["bkv"], case["s"], case["d"])) \
        .astype(np.float32)
    scale = case["d"] ** -0.5
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(jops.flash_mha(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        scale, True, case["window"], case["softcap"], case["group"], True)
        .astype(jnp.float32))
    got = ops.flash_mha(torch.from_numpy(q).to(tdt),
                        torch.from_numpy(k).to(tdt),
                        torch.from_numpy(v).to(tdt), scale, True,
                        case["window"], case["softcap"], case["group"])
    assert got.dtype == tdt
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL,
                                   rtol=F32_TOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL)


def test_flash_forward_lse_matches_reference():
    from repro.kernels.flash_attention import flash_attention_fwd_pallas
    r = _rng(11)
    q = r.standard_normal((4, 128, 128)).astype(np.float32)
    k = r.standard_normal((2, 128, 128)).astype(np.float32)
    v = r.standard_normal((2, 128, 128)).astype(np.float32)
    jo, jl = flash_attention_fwd_pallas(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), scale=0.1, group=2,
                                        interpret=True)
    to, tl = fa.flash_attention_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=0.1, group=2)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_TOL,
                               rtol=F32_TOL)


# ---------------------------------------------------------------------------
# Paged decode (plain version) against ops.paged_flash_decode
# ---------------------------------------------------------------------------

def _paged_inputs(seed, b=3, kvh=2, g=2, d=16, ps=4, per_slot=5):
    r = _rng(seed)
    num_pages = b * per_slot + 1
    kp = r.standard_normal((num_pages, ps, kvh, d)).astype(np.float32)
    vp = r.standard_normal((num_pages, ps, kvh, d)).astype(np.float32)
    q = r.standard_normal((b, 1, kvh * g, d)).astype(np.float32)
    q_pos = r.integers(0, per_slot * ps, b).astype(np.int32)
    perm = r.permutation(np.arange(1, num_pages)).reshape(b, per_slot)
    table = np.zeros((b, per_slot), np.int32)       # trash page past live
    for i in range(b):
        live = q_pos[i] // ps + 1
        table[i, :live] = perm[i, :live]
    return q, kp, vp, table, q_pos


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (6, 0.0), (0, 15.0)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_paged_decode_plain_matches_reference(window, softcap, dtype):
    q, kp, vp, table, q_pos = _paged_inputs(window + int(softcap))
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(jops.paged_flash_decode(
        jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
        jnp.asarray(table), jnp.asarray(q_pos), scale=0.25, window=window,
        softcap=softcap, interpret=True).astype(jnp.float32))
    got = ops.paged_flash_decode(
        torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
        torch.from_numpy(vp).to(tdt), torch.from_numpy(table),
        torch.from_numpy(q_pos), scale=0.25, window=window, softcap=softcap)
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL,
                                   rtol=F32_TOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL)


def test_paged_decode_ignores_trash_page_contents():
    q, kp, vp, table, q_pos = _paged_inputs(5)
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, q_pos)]
    base = ops.paged_flash_decode(*args, scale=0.25)
    args[1][0] = 1e4                   # poison the trash page
    args[2][0] = -1e4
    torch.testing.assert_close(ops.paged_flash_decode(*args, scale=0.25),
                               base, rtol=0, atol=0)

