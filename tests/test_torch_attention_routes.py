"""The attention kernels' routes and checks, in plain Python (no card
needed):

* every ``#include "..."`` of a CUDA source names a header in
  ``_build._HEADERS``, whose bytes feed each library's hash (a header left
  out would let an edit to it alone load a stale library);
* heads above 256 are refused by both routes;
* ``attn_dtype``, the wrappers' dtype check: all bf16 or all f32, never a
  mix or another dtype.
"""

import re

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
