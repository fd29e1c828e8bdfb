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
