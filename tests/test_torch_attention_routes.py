"""The attention kernels' routes and checks, in plain Python (no card
needed):

* every ``#include "..."`` of a CUDA source names a header in
  ``_build._HEADERS``, whose bytes feed each library's hash (a header left
  out would let an edit to it alone load a stale library);
* heads above 256 are refused by both routes;
* ``attn_dtype``, the wrappers' dtype check: all bf16 or all f32, never a
  mix or another dtype;
* ``paged_plan``, the bf16 paged kernel's split of the cache: every
  position of the table's capacity in exactly one split, at most one
  cluster's worth of splits, and a function of host-known shapes only.
"""

import inspect
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa

CUDA_FILES = sorted(p.name for p in _build.CSRC.iterdir()
                    if p.suffix in (".cu", ".cuh"))


def test_csrc_files_found():
    assert set(_build.SOURCES.values()) | set(_build._HEADERS) == \
        set(CUDA_FILES)


@pytest.mark.parametrize("name", CUDA_FILES)
def test_every_include_is_a_hashed_header(name):
    text = (_build.CSRC / name).read_text()
    local = re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, re.MULTILINE)
    missing = [h for h in local if h not in _build._HEADERS]
    assert not missing, f"{name} includes {missing}, not in _build._HEADERS"


@pytest.mark.parametrize("header", _build._HEADERS)
def test_hashed_headers_exist(header):
    assert (_build.CSRC / header).is_file()


@pytest.mark.parametrize("d,dv", [(264, 128), (128, 257), (512, 512)])
def test_heads_above_256_are_refused(d, dv):
    """Both routes' head checks: the tensor-core instance (``bwd_width``)
    and the SIMT kernels' bound (``_check_heads``)."""
    with pytest.raises(ValueError, match="256"):
        fa.bwd_width(d, dv)
    with pytest.raises(ValueError, match="256"):
        fa._check_heads(d, dv)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [3, 4])
def test_attn_dtype_takes_bf16_and_f32(dtype, n):
    ts = [torch.zeros((2, 3, 8), dtype=dtype) for _ in range(n)]
    assert fa.attn_dtype(*ts) == dtype


@pytest.mark.parametrize("dtypes", [
    (torch.bfloat16, torch.float32, torch.bfloat16),
    (torch.float32, torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.float32),
    (torch.float16, torch.float16, torch.float16),
    (torch.float64, torch.float64, torch.float64),
    (torch.int8, torch.int8, torch.int8),
])
def test_attn_dtype_refuses_a_mix_or_another_dtype(dtypes):
    ts = [torch.zeros((2, 3, 8), dtype=dt) for dt in dtypes]
    with pytest.raises(TypeError, match="bf16.*f32"):
        fa.attn_dtype(*ts)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_wrappers_refuse_cpu_tensors_of_either_dtype(dtype):
    q = torch.zeros((2, 4, 16), dtype=dtype)
    with pytest.raises(TypeError, match="CUDA"):
        fa.flash_attention_fwd_cuda(q, q, q, scale=1.0)
    lse = torch.zeros((2, 4))
    with pytest.raises(TypeError, match="CUDA"):
        fa.flash_attention_bwd_cuda(q, q, q, lse, q, lse, scale=1.0)
    qp = torch.zeros((1, 1, 2, 16), dtype=dtype)
    pool = torch.zeros((2, 4, 1, 16), dtype=dtype)
    with pytest.raises(TypeError, match="CUDA"):
        fa.paged_decode_attention_cuda(qp, pool, pool,
                                       torch.zeros((1, 2), dtype=torch.int32),
                                       torch.zeros(1, dtype=torch.int32),
                                       scale=1.0)


# (capacity = max_pages x page_size, B, KVH, G): the smoke shape (16 pages x
# 16), the serve run's 10 pages x 16, yi-6b's 4096-row context, page size 4
# (40 x 4, the reference serve_bench's), a group of 32 query heads (two
# 16-head chunks), a head_dim-256 model (gemma-7b: 16 KV heads, G 1), one
# tile, a ragged last tile, and a long cache of one-row pages
PLAN_SHAPES = [(256, 4, 4, 8), (160, 4, 4, 8), (4096, 4, 4, 8),
               (160, 4, 4, 8), (256, 4, 1, 32), (4096, 4, 16, 1),
               (20, 3, 2, 4), (1000, 3, 2, 20), (65536, 1, 1, 8),
               (4096, 64, 8, 4)]


@pytest.mark.parametrize("capacity,b,kvh,g", PLAN_SHAPES)
@pytest.mark.parametrize("sms", [132, 8])
def test_paged_plan_covers_every_position_once(capacity, b, kvh, g, sms):
    plan = fa.paged_plan(capacity, b, kvh, g, sms)
    assert 1 <= plan.n_split <= fa.PAGED_MAX_SPLITS
    assert plan.span >= fa.PAGED_TILE and plan.span % fa.PAGED_TILE == 0
    owner = np.full(capacity, -1)
    for s in range(plan.n_split):
        lo, hi = s * plan.span, min(capacity, (s + 1) * plan.span)
        assert lo < hi, f"split {s} is empty"
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = s
    assert (owner >= 0).all()
    assert plan.grid == (plan.n_split, b * kvh, -(-g // fa.PAGED_HEADS))


@pytest.mark.parametrize("capacity,b,kvh,g,n_split,span", [
    (256, 4, 4, 8, 4, 64),      # the smoke shape: one 64-row tile a split
    (160, 4, 4, 8, 3, 64),      # the serve run (and page size 4 x 40)
    (4096, 4, 4, 8, 8, 512),    # 4096 rows: a full cluster of 8 splits
    (256, 4, 1, 32, 4, 64),     # G 32: two head chunks, the same split
    (4096, 4, 16, 1, 5, 832),   # head_dim 256 (gemma-7b): 64 pairs x 5
    (20, 3, 2, 4, 1, 64),       # one tile: one split
    (4096, 64, 8, 4, 1, 4096),  # 512 (slot, KV head) pairs fill the card
])
def test_paged_plan_at_the_main_shapes(capacity, b, kvh, g, n_split, span):
    plan = fa.paged_plan(capacity, b, kvh, g, 132)
    assert (plan.n_split, plan.span) == (n_split, span)


def test_paged_plan_reads_host_shapes_only():
    """The plan takes integers the host knows (never q_pos, a device
    tensor: reading it would sync the decode loop and block its capture in
    a CUDA graph), and the wrapper reads nothing back from the device."""
    assert list(inspect.signature(fa.paged_plan).parameters) == [
        "capacity", "b", "kvh", "g", "sms"]
    src = inspect.getsource(fa.paged_decode_attention_cuda)
    for sync in (".item(", ".tolist(", ".cpu(", ".numpy(", "int(q_pos"):
        assert sync not in src
    assert fa.paged_plan(4096, 4, 4, 8) == fa.paged_plan(4096, 4, 4, 8, 132)
