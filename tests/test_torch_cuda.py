"""On the card: each CUDA kernel against its plain version, and the
``"cuda"`` linear route against the ``"torch"`` one.  Every test here
needs a CUDA device and skips without one; run them on the GPU machine
with ``python -m pytest -q -m cuda tests/test_torch_cuda.py`` (this file
imports only torch, numpy and the port, no JAX).

Tolerances: the nibble and LUT matmuls and the w8a8 / lut linears are
exact (int32 accumulation, the same two f32 multiplies and one bf16
rounding on every route); attention atol 2e-2 in bf16 (p is rounded to
bf16 against the kernel's running max, the plain version's final max;
|o| < ~3), lse 1e-3; the flash backward within BWD_RTOL = 1e-3 of the
plain backward in relative Frobenius norm per gradient (both accumulate
in f32 from the same bf16 inputs, in another order; a rounding of ds to
bf16 can flip by one ulp where the two f32 values straddle a midpoint).
The f32 attention routes round nothing, so only the order of the f32
sums differs from the plain versions: F32_TOL = 1e-4 (absolute on o and
lse, relative Frobenius norm on the gradients).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import linear as tlin
from repro_torch.core.nibble import pack_int4
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lut_matmul as lm
from repro_torch.kernels import nibble_matmul as nm
from repro_torch.kernels import ops

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

BF16_ATOL = 2e-2
BWD_RTOL = 1e-3
F32_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc and "
                    "run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [
    (4, 4096, 512), (5, 37, 22), (128, 256, 200), (17, 64, 64),
    # the kernel's row tiles (8 rows with both planes in one MMA, 16, 64,
    # 128 and a ragged 128), its split of K at decode and prefill, N off
    # the 64-column block, and K = 4096 + 16, off the 128-byte stage and
    # the split
    (1, 4096, 512), (65, 4096, 4096), (4, 11008, 4096), (128, 4096, 11008),
    (9, 4096, 200), (40, 1024, 70), (4, 4096 + 16, 4096),
    (1, 4096 + 16, 300)])
def test_nibble_kernel_equals_plain(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=cuda,
                      generator=g)
    w = torch.randint(-128, 128, (k, n), dtype=torch.int8, device=cuda,
                      generator=g)
    w4u = torch.randint(-8, 8, (k, n), dtype=torch.int8, device=cuda,
                        generator=g)
    # the extreme products: -128 (the hs plane's -128) in every row, at the
    # first and last k, against weights -128 and 127 (int4: -8 and 7), also
    # at the last columns
    x[:, 0] = -128
    x[:, -1] = -128
    w[0, :2] = torch.tensor([-128, 127][:n], dtype=torch.int8)
    w[-1, -2:] = torch.tensor([-128, 127][-n:], dtype=torch.int8)
    w4u[0, :2] = torch.tensor([-8, 7][:n], dtype=torch.int8)
    w4u[-1, -2:] = torch.tensor([-8, 7][-n:], dtype=torch.int8)
    w4 = pack_int4(w4u)
    xs = torch.rand((m, 1), device=cuda, generator=g)
    ws = torch.rand((1, n), device=cuda, generator=g)
    before = nm.launches
    assert torch.equal(nm.nibble_matmul_cuda(x, w),
                       nm.nibble_matmul_plain(x, w))
    assert torch.equal(nm.nibble_matmul_cuda(x, w, xs, ws),
                       nm.nibble_matmul_plain(x, w, xs, ws))
    assert torch.equal(
        nm.nibble_matmul_cuda(x, w, xs, ws, out_dtype=torch.float32),
        nm.nibble_matmul_plain(x, w, xs, ws, out_dtype=torch.float32))
    assert torch.equal(nm.nibble_matmul_cuda(x, w4, w_packed=True),
                       nm.nibble_matmul_plain(x, w4, w_packed=True))
    assert nm.launches == before + 4


def test_quant_matmul_dispatches_to_kernel(cuda):
    x = torch.randint(-128, 128, (2, 3, 64), dtype=torch.int8, device=cuda)
    w = torch.randint(-128, 128, (64, 48), dtype=torch.int8, device=cuda)
    before = nm.launches
    got = ops.quant_matmul(x, w, x_scale=torch.tensor(0.5, device=cuda),
                           w_scale=torch.full((48,), 0.25, device=cuda))
    assert nm.launches == before + 1
    want = nm.nibble_matmul_plain(
        x.reshape(6, 64), w, torch.full((6, 1), 0.5, device=cuda),
        torch.full((1, 48), 0.25, device=cuda)).reshape(2, 3, 48)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["w8a8_nibble", "w4a8_nibble"])
def test_linear_cuda_route_equals_torch_route(cuda, mode):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((4, 1, 256), device=cuda, generator=g).bfloat16()
    params = {"w": (torch.randn((256, 384), device=cuda, generator=g)
                    * 0.05).bfloat16()}
    tlin.prepare_quantized(params, mode)
    got = tlin.linear_apply(params, x, mode=mode, backend="cuda")
    want = tlin.linear_apply(params, x, mode=mode, backend="torch")
    assert torch.equal(got, want)


FLASH_CASES = [
    dict(bkv=2, group=2, s=13, d=16, dv=16, window=0, softcap=0.0),
    dict(bkv=1, group=4, s=40, d=32, dv=32, window=7, softcap=0.0),
    dict(bkv=2, group=1, s=9, d=8, dv=8, window=0, softcap=20.0),
    dict(bkv=4, group=8, s=128, d=128, dv=128, window=0, softcap=0.0),
    # the 256-wide instance: MLA's q/k 192 with v 128, and head_dim 256
    dict(bkv=2, group=2, s=70, d=192, dv=128, window=0, softcap=0.0),
    dict(bkv=2, group=4, s=100, d=256, dv=256, window=33, softcap=30.0),
    # the tensor-core forward's 64-row query tiles: a ragged last tile
    # (Sq 100 and 20), a window with softcap, no causal mask (Sq != Sk),
    # and the training shape with and without window and softcap
    dict(bkv=4, group=8, s=100, d=128, dv=128, window=0, softcap=0.0),
    dict(bkv=4, group=8, s=20, d=128, dv=128, window=0, softcap=0.0),
    dict(bkv=4, group=8, s=256, d=128, dv=128, window=40, softcap=30.0),
    dict(bkv=2, group=4, s=77, sk=130, causal=False, d=128, dv=128,
         window=0, softcap=0.0),
    dict(bkv=2, group=2, s=64, sk=200, causal=False, d=256, dv=256,
         window=0, softcap=20.0),
    dict(bkv=64, group=4, s=256, d=128, dv=128, window=0, softcap=0.0),
    dict(bkv=64, group=4, s=256, d=128, dv=128, window=64, softcap=30.0),
    # rows with no key in their window (q >= Sk + window - 1): o is the
    # mean of all Sk values and lse -1e30, as in the reference
    dict(bkv=2, group=2, s=100, sk=40, causal=False, d=128, dv=128,
         window=20, softcap=0.0),
]


def _flash_inputs(case, dtype):
    bh = case["bkv"] * case["group"]
    g = torch.Generator(device="cuda").manual_seed(case["s"])
    sk = case.get("sk", case["s"])
    q = torch.randn((bh, case["s"], case["d"]), device="cuda", generator=g)
    k = torch.randn((case["bkv"], sk, case["d"]), device="cuda", generator=g)
    v = torch.randn((case["bkv"], sk, case["dv"]), device="cuda",
                    generator=g)
    kw = dict(scale=case["d"] ** -0.5, window=case["window"],
              softcap=case["softcap"], group=case["group"],
              causal=case.get("causal", True))
    return q.to(dtype), k.to(dtype), v.to(dtype), kw


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, case):
    q, k, v, kw = _flash_inputs(case, torch.bfloat16)
    before = (fa.fwd_launches, fa.fwd_f32_launches)
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    assert (fa.fwd_launches, fa.fwd_f32_launches) == (before[0] + 1,
                                                      before[1])
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, **kw)
    assert o.shape == o_p.shape and o.dtype == torch.bfloat16
    torch.testing.assert_close(o.float(), o_p.float(), atol=BF16_ATOL,
                               rtol=0)
    torch.testing.assert_close(lse, lse_p, atol=1e-3, rtol=0)


@pytest.mark.parametrize("width", fa.BWD_WIDTHS)
def test_flash_kernel_every_instance(cuda, width):
    """Each head-width instance of the tensor-core forward, launched
    through its C entry, against the plain version: a ragged Sq (75: the
    second 64-row tile holds 11 rows), a window and a softcap."""
    q, k, v, kw = _flash_inputs(dict(bkv=2, group=2, s=75, d=width,
                                     dv=width, window=30, softcap=25.0),
                                torch.bfloat16)
    bh, sq, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=cuda)
    fn = fa._fn("flash_attention", "flash_attention_fwd", 5, 5, 2, 2)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), bh, sq, k.shape[1], width, kw["group"],
             kw["scale"], kw["softcap"], 1, kw["window"],
             torch.cuda.current_stream().cuda_stream)
    assert err == 0
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, **kw)
    torch.testing.assert_close(o.float(), o_p.float(), atol=BF16_ATOL,
                               rtol=0)
    torch.testing.assert_close(lse, lse_p, atol=1e-3, rtol=0)


F32_FLASH_CASES = [FLASH_CASES[i] for i in (0, 1, 2, 3, 4, 5, 9, 13)]


@pytest.mark.parametrize("case", F32_FLASH_CASES)
def test_flash_f32_route_matches_plain(cuda, case):
    q, k, v, kw = _flash_inputs(case, torch.float32)
    before = (fa.fwd_launches, fa.fwd_f32_launches)
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    assert (fa.fwd_launches, fa.fwd_f32_launches) == (before[0],
                                                      before[1] + 1)
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, **kw)
    assert o.shape == o_p.shape and o.dtype == torch.float32
    torch.testing.assert_close(o, o_p, atol=F32_TOL, rtol=0)
    torch.testing.assert_close(lse, lse_p, atol=F32_TOL, rtol=0)


def test_flash_refuses_mixed_dtypes(cuda):
    q, k, v, kw = _flash_inputs(FLASH_CASES[0], torch.float32)
    with pytest.raises(TypeError, match="bf16"):
        fa.flash_attention_fwd_cuda(q, k.bfloat16(), v, **kw)


def _paged_inputs(seed, b=3, kvh=2, g=4, d=32, ps=4, per_slot=5,
                  q_pos=None):
    r = np.random.default_rng(seed)
    num_pages = b * per_slot + 1
    kp = r.standard_normal((num_pages, ps, kvh, d)).astype(np.float32)
    vp = r.standard_normal((num_pages, ps, kvh, d)).astype(np.float32)
    q = r.standard_normal((b, kvh, g, d)).astype(np.float32)
    if q_pos is None:
        q_pos = r.integers(0, per_slot * ps, b)
    q_pos = np.asarray(q_pos, np.int32)
    perm = r.permutation(np.arange(1, num_pages)).reshape(b, per_slot)
    table = np.zeros((b, per_slot), np.int32)       # trash page past live
    for i in range(b):
        live = q_pos[i] // ps + 1
        table[i, :live] = perm[i, :live]
    return q, kp, vp, table, q_pos


# (kvh, G, d): today's shape; a group of 32 (two chunks of 16 query heads
# in one launch), a ragged group of 20, head_dim 256, d = 100 (padded) and
# d = 72 (no multiple of 16: the loads zero-fill the instance's columns)
PAGED_SHAPES = [(2, 4, 32), (1, 32, 128), (2, 20, 64), (2, 8, 256),
                (2, 4, 100), (2, 4, 72)]
# (page size, pages a slot, q_pos): 20 positions, one split (q_pos drawn);
# 1024 positions in pages of 16 and 400 in pages of 4, many splits
# (paged_plan), with q_pos in the first tile, on the table's last row and
# mid-cache; 8192 one-row pages, whose splits span more table entries
# than the kernel holds at once (it reloads them a window at a time)
PAGED_CACHES = [(4, 5, None), (16, 64, [3, 1023, 517]),
                (4, 100, [399, 2, 250]), (1, 8192, [8191, 5000, 700])]


@pytest.mark.parametrize("cache", PAGED_CACHES)
@pytest.mark.parametrize("shape", PAGED_SHAPES)
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (6, 0.0), (0, 15.0),
                                            (150, 10.0)])
def test_paged_kernel_matches_plain(cuda, window, softcap, shape, cache):
    """The bf16 kernel against its plain version; a window of 150 crosses
    the split boundaries of the long caches."""
    kvh, g, d = shape
    ps, per_slot, q_pos = cache
    q, kp, vp, table, q_pos = (torch.from_numpy(a).to(cuda)
                               for a in _paged_inputs(window, kvh=kvh, g=g,
                                                      d=d, ps=ps,
                                                      per_slot=per_slot,
                                                      q_pos=q_pos))
    q, kp, vp = q.bfloat16(), kp.bfloat16(), vp.bfloat16()
    kw = dict(scale=0.25, window=window, softcap=softcap)
    before = fa.paged_launches
    o = fa.paged_decode_attention_cuda(q, kp, vp, table, q_pos, **kw)
    assert fa.paged_launches == before + 1
    o_p = fa.paged_decode_attention_plain(q, kp, vp, table, q_pos, **kw)
    assert o.shape == o_p.shape
    torch.testing.assert_close(o.float(), o_p.float(), atol=BF16_ATOL,
                               rtol=0)


def test_paged_kernel_reads_the_pools_in_place(cuda):
    """One call allocates its output and nothing near the pools' size: the
    pools are not padded or copied (d = 72 is no MMA width, the kernel
    zero-fills the missing columns itself)."""
    b, kvh, g, d, ps, per_slot = 4, 8, 4, 72, 16, 256
    gen = torch.Generator(device=cuda).manual_seed(0)
    kp, vp = (torch.randn((b * per_slot + 1, ps, kvh, d), device=cuda,
                          generator=gen).bfloat16() for _ in range(2))
    q = torch.randn((b, kvh, g, d), device=cuda, generator=gen).bfloat16()
    table = torch.arange(1, b * per_slot + 1, device=cuda,
                         dtype=torch.int32).reshape(b, per_slot)
    q_pos = torch.tensor([4095, 100, 2047, 0], device=cuda,
                         dtype=torch.int32)
    fa.paged_decode_attention_cuda(q, kp, vp, table, q_pos, scale=0.1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = fa.paged_launches
    o = fa.paged_decode_attention_cuda(q, kp, vp, table, q_pos, scale=0.1)
    torch.cuda.synchronize()
    assert fa.paged_launches == before + 1
    grown = torch.cuda.max_memory_allocated() - base
    assert grown < kp.numel() * kp.element_size() // 100, grown
    o_p = fa.paged_decode_attention_plain(q, kp, vp, table, q_pos,
                                          scale=0.1)
    torch.testing.assert_close(o.float(), o_p.float(), atol=BF16_ATOL,
                               rtol=0)


@pytest.mark.parametrize("shape", [(2, 4, 32), (1, 32, 128), (2, 8, 256),
                                   (2, 4, 100)])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (6, 15.0)])
def test_paged_f32_route_matches_plain(cuda, window, softcap, shape):
    kvh, g, d = shape
    q, kp, vp, table, q_pos = (torch.from_numpy(a).to(cuda)
                               for a in _paged_inputs(window + 1, kvh=kvh,
                                                      g=g, d=d))
    kw = dict(scale=0.25, window=window, softcap=softcap)
    before = (fa.paged_launches, fa.paged_f32_launches)
    o = fa.paged_decode_attention_cuda(q, kp, vp, table, q_pos, **kw)
    assert (fa.paged_launches, fa.paged_f32_launches) == (before[0],
                                                          before[1] + 1)
    o_p = fa.paged_decode_attention_plain(q, kp, vp, table, q_pos, **kw)
    assert o.shape == o_p.shape and o.dtype == torch.float32
    torch.testing.assert_close(o, o_p, atol=F32_TOL, rtol=0)


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


BWD_CASES = [
    dict(bkv=2, group=2, s=13, d=16, dv=16, window=0, softcap=0.0),
    dict(bkv=1, group=4, s=70, d=32, dv=32, window=7, softcap=0.0),
    dict(bkv=2, group=1, s=9, d=8, dv=8, window=0, softcap=20.0),
    dict(bkv=2, group=4, s=256, d=128, dv=128, window=0, softcap=0.0),
    dict(bkv=2, group=4, s=200, d=128, dv=128, window=64, softcap=30.0),
    # each instance width (64, 128 with d padded from 100, 256), MLA's
    # 192 / 128, one query row, a ragged tile, group 8, and the training
    # head width under a window and a softcap at S = 256.  The one-row
    # case attends (not causally) to 33 keys: at Sq = Sk = 1 the softmax
    # is constant, dq and dk are 0 in exact arithmetic, and both sides
    # would hold only the rounding noise of dp - dmat.
    dict(bkv=2, group=4, s=130, d=64, dv=64, window=0, softcap=0.0),
    dict(bkv=2, group=2, s=97, d=100, dv=100, window=0, softcap=0.0),
    dict(bkv=2, group=2, s=90, d=192, dv=128, window=0, softcap=0.0),
    dict(bkv=2, group=2, s=150, d=256, dv=256, window=40, softcap=20.0),
    dict(bkv=2, group=4, s=1, sk=33, causal=False, d=128, dv=128, window=0,
         softcap=0.0),
    dict(bkv=2, group=4, s=65, d=128, dv=128, window=0, softcap=0.0),
    dict(bkv=1, group=8, s=128, d=128, dv=128, window=0, softcap=0.0),
    dict(bkv=2, group=4, s=256, d=128, dv=128, window=64, softcap=30.0),
    # rows with no key in their window (q >= Sk + window - 1): lse -1e30,
    # so p = 1 on every key there, and those rows add to dq, dk and dv
    dict(bkv=2, group=2, s=100, sk=40, causal=False, d=128, dv=128,
         window=20, softcap=0.0),
    dict(bkv=2, group=2, s=60, sk=40, d=64, dv=64, window=8, softcap=0.0),
]


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_bwd_kernel_matches_plain(cuda, case):
    bh = case["bkv"] * case["group"]
    g = torch.Generator(device=cuda).manual_seed(case["s"] + case["d"])
    s, d, dv = case["s"], case["d"], case["dv"]
    sk = case.get("sk", s)
    q = torch.randn((bh, s, d), device=cuda, generator=g).bfloat16()
    do = torch.randn((bh, s, dv), device=cuda, generator=g).bfloat16()
    k = torch.randn((case["bkv"], sk, d), device=cuda,
                    generator=g).bfloat16()
    v = torch.randn((case["bkv"], sk, dv), device=cuda,
                    generator=g).bfloat16()
    kw = dict(scale=d ** -0.5, window=case["window"],
              softcap=case["softcap"], group=case["group"],
              causal=case.get("causal", True))
    o, lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    dmat = (do.float() * o.float()).sum(-1)
    before = (fa.bwd_dq_launches, fa.bwd_dkv_launches)
    got = fa.flash_attention_bwd_cuda(q, k, v, lse, do, dmat, **kw)
    assert (fa.bwd_dq_launches, fa.bwd_dkv_launches) == (before[0] + 1,
                                                         before[1] + 1)
    want = fa.flash_attention_bwd_plain(q, k, v, lse, do, dmat, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert _rel(a, b) <= BWD_RTOL, (name, _rel(a, b))


F32_BWD_CASES = [BWD_CASES[i]
                 for i in (0, 1, 2, 3, 4, 7, 8, 9, 10, 13, 14)]


@pytest.mark.parametrize("case", F32_BWD_CASES)
def test_flash_bwd_f32_route_matches_plain(cuda, case):
    bh = case["bkv"] * case["group"]
    g = torch.Generator(device=cuda).manual_seed(case["s"] + case["d"])
    s, d, dv = case["s"], case["d"], case["dv"]
    sk = case.get("sk", s)
    q = torch.randn((bh, s, d), device=cuda, generator=g)
    do = torch.randn((bh, s, dv), device=cuda, generator=g)
    k = torch.randn((case["bkv"], sk, d), device=cuda, generator=g)
    v = torch.randn((case["bkv"], sk, dv), device=cuda, generator=g)
    kw = dict(scale=d ** -0.5, window=case["window"],
              softcap=case["softcap"], group=case["group"],
              causal=case.get("causal", True))
    o, lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    dmat = (do * o).sum(-1)
    before = (fa.bwd_dq_launches, fa.bwd_dkv_launches,
              fa.bwd_f32_dq_launches, fa.bwd_f32_dkv_launches)
    got = fa.flash_attention_bwd_cuda(q, k, v, lse, do, dmat, **kw)
    assert (fa.bwd_dq_launches, fa.bwd_dkv_launches, fa.bwd_f32_dq_launches,
            fa.bwd_f32_dkv_launches) == (before[0], before[1], before[2] + 1,
                                         before[3] + 1)
    want = fa.flash_attention_bwd_plain(q, k, v, lse, do, dmat, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert _rel(a, b) <= F32_TOL, (name, _rel(a, b))


def test_flash_mha_f32_forward_and_gradient(cuda):
    """``ops.flash_mha`` in f32 on the card (the f32 forward and backward
    kernels) against the same call on the CPU (the plain versions)."""
    r = np.random.default_rng(3)
    q = r.standard_normal((8, 50, 64)).astype(np.float32)
    k, v = (r.standard_normal((2, 50, 64)).astype(np.float32)
            for _ in range(2))
    w = r.standard_normal((8, 50, 64)).astype(np.float32)
    args = (0.125, True, 9, 20.0, 4)

    def run(device):
        leaves = [torch.from_numpy(a).to(device).requires_grad_(True)
                  for a in (q, k, v)]
        o = ops.flash_mha(*leaves, *args)
        loss = (o * torch.from_numpy(w).to(device)).sum()
        return [o.detach().cpu()] + [t.cpu() for t in
                                     torch.autograd.grad(loss, leaves)]

    before = (fa.fwd_f32_launches, fa.bwd_f32_dq_launches,
              fa.bwd_f32_dkv_launches)
    got = run(cuda)
    assert (fa.fwd_f32_launches, fa.bwd_f32_dq_launches,
            fa.bwd_f32_dkv_launches) == tuple(b + 1 for b in before)
    want = run("cpu")
    torch.testing.assert_close(got[0], want[0], atol=F32_TOL, rtol=0)
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        assert a.dtype == torch.float32
        assert _rel(a, b) <= F32_TOL, (name, _rel(a, b))


def test_flash_mha_backward_runs_the_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((8, 40, 64), device=cuda, generator=g).bfloat16()
    k, v = (torch.randn((2, 40, 64), device=cuda, generator=g).bfloat16()
            for _ in range(2))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
    o = ops.flash_mha(*leaves, 0.125, True, 0, 0.0, 4)
    grads = torch.autograd.grad((o.float() ** 2).sum(), leaves)
    assert (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == \
        tuple(b + 1 for b in before)
    ref = [t.cpu().float().requires_grad_(True) for t in (q, k, v)]
    o_r = ops.flash_mha(*ref, 0.125, True, 0, 0.0, 4)
    want = torch.autograd.grad((o_r ** 2).sum(), ref)
    for a, b in zip(grads, want):
        assert a.dtype == torch.bfloat16
        assert _rel(a.cpu(), b) <= 2e-2


@pytest.mark.parametrize("m,k,n", [
    (4, 4096, 512), (5, 37, 22), (128, 256, 200), (70, 64, 33),
    # the split of K and the activation tables' edges: one row, one row
    # group, a ragged row tile, a whole prefill tile; N = 512 and N off
    # the 256-column block; K = 11008, and K off the tile and the split
    (1, 4096, 512), (4, 11008, 4096), (65, 4096, 4096), (128, 4096, 600),
    (4, 4096 + 24, 512), (1, 4096 + 24, 300), (65, 11008 + 8, 260),
    (8, 1, 1), (16, 40, 257)])
def test_lut_kernel_equals_plain_and_nibble(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m * n + k)
    x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=cuda,
                      generator=g)
    wt = torch.randint(-128, 128, (n, k), dtype=torch.int8, device=cuda,
                       generator=g)
    x[0, :2] = torch.tensor([-128, 127][:k], dtype=torch.int8)
    wt[:2, 0] = torch.tensor([-128, 127][:n], dtype=torch.int8)
    # the extremes of both tables: weights -128 and 127 meet an activation
    # of -128 in every row (t_hi[8] = (-8 << 4) * -128 = 2**14), also at
    # the last column and the last k
    x[:, 0] = -128
    x[:, -1] = -128
    wt[-2:, -1] = torch.tensor([-128, 127][-n:], dtype=torch.int8)
    before = lm.lut_launches
    got = lm.lut_matmul_cuda(x, wt.t())
    assert lm.lut_launches == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, lm.lut_matmul_plain(x, wt.t()))
    assert torch.equal(got, nm.nibble_matmul_cuda(x, wt.t()))


def test_linear_lut_cuda_route_equals_nibble(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((4, 3, 256), device=cuda, generator=g).bfloat16()
    params = {"w": (torch.randn((256, 384), device=cuda, generator=g)
                    * 0.05).bfloat16()}
    tlin.prepare_quantized(params, "lut")
    got = tlin.linear_apply(params, x, mode="lut", backend="cuda")
    assert torch.equal(got, tlin.linear_apply(params, x, mode="lut",
                                              backend="torch"))
    assert torch.equal(got, tlin.linear_apply(params, x, mode="w8a8_nibble",
                                              backend="cuda"))


@pytest.mark.parametrize("kw", [
    dict(x_scale=0.013), dict(w_scale="cols"), dict(x_scale="rows",
                                                    w_scale="cols"),
    dict(x_scale="rows", w_scale="cols", out_dtype=torch.float32),
    dict(out_dtype=torch.float32)])
def test_quant_matmul_lut_scaled_equals_torch_route(cuda, kw):
    """``w_format="lut"`` with scales or an ``out_dtype`` on the card (the
    LUT kernel, then the reference's epilogue) equals the same call on
    the CPU (the plain version, the same epilogue)."""
    g = torch.Generator().manual_seed(7)
    x = torch.randint(-128, 128, (2, 3, 64), dtype=torch.int8, generator=g)
    w = torch.randint(-128, 128, (64, 48), dtype=torch.int8, generator=g)
    named = {"rows": torch.rand((6, 1), generator=g) * 0.02 + 1e-3,
             "cols": torch.rand(48, generator=g) * 0.02 + 1e-3}
    kw = {k_: named.get(v_, v_) if isinstance(v_, str) else v_
          for k_, v_ in kw.items()}
    want = ops.quant_matmul(x, w, w_format="lut", **kw)
    before = lm.lut_launches
    got = ops.quant_matmul(
        x.to(cuda), w.to(cuda), w_format="lut",
        **{k_: v_.to(cuda) if torch.is_tensor(v_) else v_
           for k_, v_ in kw.items()})
    assert lm.lut_launches == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# The shapes of the MLA and MoE families (deepseek-v3, llama4, gemma3-1b)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [
    (640, 512, 32768),       # wkv_b at decode: 4 slots x 160 latent rows
    (4, 1536, 24576),        # wq_b at decode
    (128, 1536, 24576),      # wq_b at prefill
    (4, 7168, 576),          # wkv_a
    (4, 16384, 7168),        # MLA's wo (128 heads x v 128)
    (4, 7168, 2048)])        # the shared expert's gate
def test_nibble_kernel_equals_plain_at_mla_shapes(cuda, m, k, n):
    """The model path's arguments (per-tensor activation scale, per-column
    weight scale, bf16 out) and the int32 product, ``torch.equal``."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=cuda,
                      generator=g)
    w = torch.randint(-128, 128, (n, k), dtype=torch.int8, device=cuda,
                      generator=g).t()
    xs = torch.tensor(1e-3, device=cuda)
    ws = torch.rand((1, n), device=cuda, generator=g) * 0.01
    assert torch.equal(nm.nibble_matmul_cuda(x, w),
                       nm.nibble_matmul_plain(x, w))
    assert torch.equal(nm.nibble_matmul_cuda(x, w, xs, ws),
                       nm.nibble_matmul_plain(x, w, xs, ws))


FAMILY_FLASH_CASES = [
    # deepseek-v3's MLA prefill: 128 heads (group 1), q/k 192, v 128 (the
    # 256-wide instance, zero-padded)
    dict(bkv=128, group=1, s=128, d=192, dv=128, window=0, softcap=0.0),
    dict(bkv=4, group=1, s=75, d=24, dv=16, window=0, softcap=0.0),
    # llama4: group 5
    dict(bkv=8, group=5, s=128, d=128, dv=128, window=0, softcap=0.0),
    # gemma3-1b: head_dim 256, group 4, a window across the sequence
    dict(bkv=1, group=4, s=160, d=256, dv=256, window=64, softcap=0.0),
]


@pytest.mark.parametrize("case", FAMILY_FLASH_CASES)
def test_flash_kernel_matches_plain_at_family_shapes(cuda, case):
    q, k, v, kw = _flash_inputs(case, torch.bfloat16)
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, **kw)
    assert o.shape == o_p.shape == (q.shape[0], q.shape[1], case["dv"])
    torch.testing.assert_close(o.float(), o_p.float(), atol=BF16_ATOL,
                               rtol=0)
    torch.testing.assert_close(lse, lse_p, atol=1e-3, rtol=0)


@pytest.mark.parametrize("shape,window", [((8, 5, 128), 0),
                                          ((1, 4, 256), 512),
                                          ((1, 4, 256), 40)])
def test_paged_kernel_matches_plain_at_family_shapes(cuda, shape, window):
    """llama4's group 5 and gemma3-1b's local layers (head_dim 256, group
    4, window 512; and a window shorter than the cache)."""
    kvh, g, d = shape
    q, kp, vp, table, q_pos = (torch.from_numpy(a).to(cuda)
                               for a in _paged_inputs(d + window, b=4,
                                                      kvh=kvh, g=g, d=d,
                                                      ps=16, per_slot=10))
    q, kp, vp = q.bfloat16(), kp.bfloat16(), vp.bfloat16()
    kw = dict(scale=d ** -0.5, window=window)
    o = fa.paged_decode_attention_cuda(q, kp, vp, table, q_pos, **kw)
    o_p = fa.paged_decode_attention_plain(q, kp, vp, table, q_pos, **kw)
    torch.testing.assert_close(o.float(), o_p.float(), atol=BF16_ATOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# The paper's multiplier models and the seed shims on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,signed", [
    ("shift_add", False), ("booth_radix2", True), ("wallace", False),
    ("lut_array", False), ("nibble_precompute", False),
    ("nibble_precompute", True)])
def test_multipliers_exhaustive_on_card(cuda, arch, signed):
    """Every 8-bit (a, b) (signed for Booth and signed Algorithm 2): the
    products stay on the card and equal a * b and the CPU run's, with the
    same cycles."""
    from repro_torch.core import multipliers as tmul
    kw = {"signed": True} if arch == "nibble_precompute" and signed else {}
    vals = torch.arange(-128, 128) if signed else torch.arange(256)
    lanes = vals.to(cuda)
    for b in vals.tolist():
        got = tmul.MULTIPLIERS[arch](lanes, b, **kw)
        host = tmul.MULTIPLIERS[arch](vals, b, **kw)
        assert got.products.device.type == "cuda"
        assert torch.equal(got.products.cpu(), host.products)
        assert torch.equal(host.products, (vals * b).int())
        assert (got.cycles, got.cycles_per_operand) == \
            (host.cycles, host.cycles_per_operand)


def test_lut_array_16bit_on_card(cuda):
    from repro_torch.core import multipliers as tmul
    a16 = torch.arange(65536, device=cuda)
    for b in (0, 1, 15, 16, 171, 255):
        o1, o2 = tmul.lut_array_16bit(a16, b)
        assert torch.equal(o1.long() + (o2.long() << 8), a16 * b)


@pytest.mark.parametrize("m,k,n", [(4, 4096, 512), (5, 37, 22),
                                   (128, 256, 200)])
def test_seed_shims_on_card(cuda, m, k, n):
    """``ops.nibble_matmul``, ``nibble_matmul_w4`` and ``lut_matmul``
    exact against ``kernels.ref``; ``quant_matmul_fused`` equal to its
    plain run on the CPU and to ``quant_matmul`` on ``quantize_rows``'s
    output, bit for bit."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant_matmul_fused import quantize_rows
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randint(-128, 128, (m, k), generator=g, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=g, device=cuda,
                      dtype=torch.int8)
    w4 = torch.randint(-8, 8, (k, n), generator=g, device=cuda,
                       dtype=torch.int8)
    want = ref.nibble_matmul_ref(x, w)
    assert torch.equal(ops.nibble_matmul(x, w), want)
    assert torch.equal(ops.lut_matmul(x, w), want)
    assert torch.equal(ops.nibble_matmul_w4(x, pack_int4(w4)),
                       ref.nibble_matmul_ref(x, w4))
    xf = torch.randn((m, k), generator=g, device=cuda) * 2
    ws = torch.rand((1, n), generator=g, device=cuda) * 0.01 + 1e-4
    for dtype in (torch.float32, torch.bfloat16):
        got = ops.quant_matmul_fused(xf, w, ws, out_dtype=dtype)
        xq, xs = quantize_rows(xf)
        assert torch.equal(got, ops.quant_matmul(xq, w, x_scale=xs,
                                                 w_scale=ws, out_dtype=dtype))
        assert torch.equal(got.cpu(), ops.quant_matmul_fused(
            xf.cpu(), w.cpu(), ws.cpu(), out_dtype=dtype))


@pytest.mark.parametrize("mode,rtol", [("dense", 5e-2), ("qat", 0.15)])
def test_mla_train_step_flash_equals_chunked(cuda, mode, rtol):
    """One train step of an MLA model (reduced deepseek-v3's first 2
    layers, dense MLA widened to the published head widths: q/k 128 + 64,
    v 128, 4 heads, so the backward runs its 256 instance) on the card,
    with the MTP term: the flash kernels' loss and every
    gradient leaf against the plain chunked attention's, within the
    bounds ``chip_smoke.py`` holds full-width models to (the two paths
    round p and ds to bf16 at other points; QAT turns a flipped rounding
    into a whole int8 step).  The forward, dq and dk/dv kernels launch
    once per MLA layer (twice for the forward: remat recomputes it)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import model_init
    from repro_torch.train.step import (TrainConfig, accumulate_grads,
                                        make_loss_fn)
    from repro_torch.tree import tree_paths
    cfg = reduced(get_config("deepseek-v3-671b"))
    cfg = cfg.replace(
        n_layers=2, prefix_pattern=cfg.prefix_pattern[:2], d_model=256,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128, kv_lora_rank=128,
        q_lora_rank=128, quant_mode=mode, remat=True)
    params = model_init(cfg, seed=0, device=cuda)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=96,
                                   global_batch=2), device=cuda).batch(0)
    runs = {}
    for impl in ("flash", "chunked"):
        before = (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
        c = cfg.replace(attn_impl=impl)
        loss, metrics, grads = accumulate_grads(
            make_loss_fn(c, TrainConfig(mtp_weight=0.3)), params, batch, 1)
        after = (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
        runs[impl] = (loss, metrics, dict(tree_paths(grads)),
                      tuple(a - b for a, b in zip(after, before)))
    n_mla = cfg.n_layers
    assert runs["flash"][3] == (2 * n_mla, n_mla, n_mla)
    assert runs["chunked"][3] == (0, 0, 0)
    assert abs(float(runs["flash"][0]) - float(runs["chunked"][0])) <= 1e-2
    for path, g in runs["flash"][2].items():
        assert torch.isfinite(g).all(), path
        assert _rel(g.float(), runs["chunked"][2][path].float()) <= rtol, \
            path


# ---------------------------------------------------------------------------
# Tensor parallelism on the card
# ---------------------------------------------------------------------------

def _row_shards(params, tp, bits):
    """A row-parallel split of one prepared linear: rows of ``w`` and the
    matching K columns of ``qt{bits}``, its scales whole."""
    h = params["w"].shape[0] // tp
    return [{"w": params["w"][i * h:(i + 1) * h],
             f"qt{bits}": params[f"qt{bits}"][:, i * h:(i + 1) * h]
             .contiguous(),
             f"s{bits}": params[f"s{bits}"]} for i in range(tp)]


@pytest.mark.parametrize("mode", ["w8a8_nibble", "w4a8_nibble", "lut"])
@pytest.mark.parametrize("m,k,n", [
    # yi-6b's wo and down at tp=2 (K 2048 and 5504 a shard), decode and
    # prefill rows
    (4, 4096, 4096), (128, 4096, 4096), (4, 11008, 4096),
    (128, 11008, 4096)])
def test_row_parallel_equals_fused_kernel_at_shard_shapes(cuda, mode, m, k,
                                                          n):
    """Each shard's exact int32 product (nibble kernel, or the LUT kernel
    in ``lut``), summed, then the epilogue once: bit for bit the
    unsharded projection through the fused kernel."""
    g = torch.Generator(device=cuda).manual_seed(m + k)
    params = tlin.linear_init(k, n, generator=g, device=cuda)
    tlin.prepare_quantized(params, mode)
    x = (torch.randn((m, k), generator=g, device=cuda) * 0.5).bfloat16()
    want = tlin.linear_apply(params, x, mode=mode, backend="cuda")
    before = (nm.launches, lm.lut_launches)
    got = tlin.linear_apply_row(
        _row_shards(params, 2, tlin.weight_bits(mode)),
        [x[:, :k // 2], x[:, k // 2:]], mode=mode, backend="cuda")
    assert (nm.launches - before[0], lm.lut_launches - before[1]) == \
        ((0, 2) if mode == "lut" else (2, 0))
    assert all(torch.equal(t, want) for t in got)


def test_tp2_engine_on_one_card_captures(cuda):
    """A tp=2 engine over ``[cuda:0, cuda:0]`` (the shards share the card)
    captures its decode chunk, launches twice tp=1's nibble and paged
    kernels on the same schedule, and serves tp=1's streams."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model_init
    from repro_torch.serve import Engine, ServeConfig
    cfg = reduced(get_config("yi-6b")).replace(
        n_layers=2, quant_mode="w8a8_nibble", quant_backend="cuda",
        attn_impl="flash", cache_mode="paged", page_size=8)
    params = model_init(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in (5, 8, 3, 7)]
    scfg = ServeConfig(batch=2, max_len=32, prefill_len=8, decode_chunk=4)
    out = {}
    for tp in (1, 2):
        eng = Engine(cfg, params, dataclasses.replace(scfg, tp=tp),
                     devices=[cuda, cuda][:tp] if tp > 1 else None,
                     device=cuda)
        before = (nm.launches, fa.paged_launches)
        ids = [eng.submit(p, 9) for p in prompts]
        done = eng.run()
        out[tp] = ([done[i].tokens for i in ids],
                   (nm.launches - before[0], fa.paged_launches - before[1]),
                   eng.capture_counts, eng.mesh_shape)
    assert out[2][0] == out[1][0]
    assert out[2][1] == tuple(2 * c for c in out[1][1])
    assert out[2][2] == out[1][2] == {"decode_chunk": 1}
    assert out[2][3] == (1, 2)
