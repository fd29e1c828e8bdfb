"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--out results.json]

Phases (any failure exits non-zero and prints no result line):

1. Device: the card's name and power limit (nvidia-smi); TF32 off for
   matmuls and cuDNN.
2. Kernels: build the six CUDA sources in ``src/repro_torch/csrc`` (one
   nvcc per source, in parallel), run each wrapper at its main path's
   shapes on the card and hold it against its plain PyTorch version
   (nibble and LUT matmuls: ``torch.equal``; attention forward and
   backward: stated tolerances, at the main paths' head width and at the
   256-wide instance; the forward also without the causal mask; paged
   decode also at a group of 32), and time kernel, plain version and a
   PyTorch library yardstick with CUDA events (the nibble and LUT kernels,
   the flash forward at the prefill and training shapes, the flash
   backward's two kernels together and apart, and paged decode, also in a
   CUDA graph: device time without host gaps; the nibble and paged
   wrappers' host time per call too).  Paged decode is also checked at
   4096 rows a slot (many splits, a window across them) and at page size
   4, and times a scaling line (1, 160, 1024 and 4096 live rows a slot,
   each call on pools that are cold in L2).  The backward is also held
   on rows with no key in their window.  The f32 routes of the three
   attention entry points (``csrc/attention_f32.cu``) are held to their
   plain versions at small shapes, each showing its own launch counter.
3. Serve: yi-6b at full published width (random weights from a seed),
   every projection ``w8a8_nibble`` on the CUDA backend, flash prefill,
   paged decode; 8 requests through ``Engine.submit`` / ``Engine.run``.
   Launch counters are zeroed just before and read just after; every
   kernel of the path must have launched.  Then the first request's
   prefill runs through the plain path (``quant_backend="torch"``,
   ``attn_impl="chunked"``) and its logits are held to the kernel path's.
4. LUT serve: the same weights with ``quant_mode="lut"`` (the LUT-selection
   kernel), 4 of the requests x 16 new tokens; the greedy streams must
   equal, token for token, what ``w8a8_nibble`` serves for the same
   requests (both compute the same int32 product and epilogue).
5. Train: full-width qwen3-4b (all 36 layers), QAT, flash attention
   (forward, remat recompute and the backward kernels), remat, batch 8 x
   seq 256, 4 AdamW steps through ``Trainer.run`` on ``SyntheticLM``
   data; losses must be finite and the flash forward, dq and dk/dv
   kernels must have launched.  Then, cut to 2 layers, one step's
   gradients through the kernels are held to the plain path's
   (``attn_impl="chunked"``) leaf by leaf.

The last three lines are the per-kernel JSON, the card's name and power
limit as nvidia-smi gives them, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# the training phase holds ~50 GB of long-lived state next to short-lived
# GB-sized temporaries: expandable segments keep them from fragmenting
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.nibble import pack_int4  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import _build, flash_attention as fa  # noqa: E402
from repro_torch.kernels import lut_matmul as lm  # noqa: E402
from repro_torch.kernels import nibble_matmul as nm  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import model_init, prefill  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402
from repro_torch.train import TrainConfig  # noqa: E402
from repro_torch.train.step import (accumulate_grads,  # noqa: E402
                                    make_loss_fn)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

DEV = "cuda"

# H100 SXM published peaks (dense): HBM bytes/s, int8 ops/s, bf16 FLOP/s
HBM_BPS = 3.35e12
INT8_OPS = 1.979e15
BF16_FLOPS = 989e12

# attention kernels vs their plain versions: same inputs in bf16; both
# accumulate in f32, but the kernel rescales online per 32-key tile and
# rounds p to bf16 against the running max, the plain version against the
# final max, so outputs (|o| < ~1, bf16 ulp <= 2**-8) differ by a few ulp
ATTN_ATOL = 2e-2
LSE_ATOL = 1e-3
# the f32 attention routes vs their plain versions: the same f32 function
# (no rounding of p or ds), only the order of the f32 sums differs; absolute
# on o and lse, relative Frobenius norm on the gradients
F32_TOL = 1e-4
# full-width prefill logits, kernel path vs plain path: the nibble kernel is
# bit-exact, but flash vs chunked attention round differently, which over
# 32 layers flips some int8 activation roundings; bound relative to the
# logits' own scale
LOGIT_RTOL = 0.1
# flash backward vs its plain version (same bf16 inputs, f32 sums in
# another order; ds rounded to bf16 may flip by one ulp where the two f32
# values straddle a midpoint): relative Frobenius norm per gradient
BWD_RTOL = 1e-3
# model-level gradients, kernel path (flash) vs plain path (chunked), per
# leaf in relative Frobenius norm.  The two attention paths round p and
# the outputs to bf16 at other points, and those ulps flip bf16 roundings
# downstream; in QAT a flipped activation moves a fake-quantized value by
# a whole int8 step.  On the CPU the reference's own flash and chunked
# paths differ by 1.8% (dense) and 3.6% (qat) on reduced qwen3-4b.
MODEL_GRAD_RTOL = {"dense": 0.05, "qat": 0.15}

MM_SHAPES_DECODE = [  # one decode layer's projections at 4 slots
    ("wq", 4, 4096, 4096), ("wk", 4, 4096, 512), ("wv", 4, 4096, 512),
    ("wo", 4, 4096, 4096), ("gate", 4, 4096, 11008),
    ("up", 4, 4096, 11008), ("down", 4, 11008, 4096)]
MM_CHECK_SHAPES = [(4, 4096, 4096), (4, 4096, 512), (4, 4096, 11008),
                   (4, 11008, 4096), (128, 4096, 11008)]
NIBBLE_CHECK_SHAPES = MM_CHECK_SHAPES + [(1, 4096, 512), (65, 4096, 4096),
                                         (4, 4096 + 16, 4096)]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Median milliseconds of ``fn`` over ``iters`` CUDA-event-timed runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def graph_ms(fn, reps=20) -> float:
    """Device milliseconds of one ``fn`` call: ``reps`` calls captured in
    one CUDA graph and replayed, so no host time falls between them (the
    median of 5 timed replays after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, iters=5, warmup=1) / reps


def bound_ms(n_bytes: float, ops: float, peak_ops: float):
    t_bytes = n_bytes / HBM_BPS * 1e3
    t_ops = ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"capability {torch.cuda.get_device_capability(0)}", flush=True)
    return line


def phase_build() -> None:
    t = time.perf_counter()
    logs = _build.build_all()
    print(f"built {sorted(_build.SOURCES)} in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    for name, log in logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  [{name}] {ln.strip()}")


def _int_mm_ms(x, wt, timer=cuda_ms):
    """torch._int_mm yardstick (M padded to at least 32 and to a multiple
    of 8: cuBLASLt needs M > 16), timed by ``timer``."""
    m = max(32, -(-x.shape[0] // 8) * 8)
    xp = torch.zeros((m, x.shape[1]), dtype=torch.int8, device=x.device)
    xp[:x.shape[0]] = x
    for b in (wt.t(), wt.t().contiguous()):
        try:
            torch._int_mm(xp, b)
        except RuntimeError as exc:
            err = exc
            continue
        return timer(lambda: torch._int_mm(xp, b))
    print(f"  torch._int_mm unavailable: {err}")
    return None


def host_us(fn, calls=200) -> float:
    """Host microseconds per call of ``fn``: ``calls`` calls enqueued back
    to back (no synchronisation between them), so a call whose device work
    is shorter than its host work is timed by its host work."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    return host / calls * 1e6


def check_nibble(gen) -> dict:
    dev = DEV
    for ln in _build.build_logs.get("nibble_matmul", "").splitlines():
        if "entry function" in ln or "registers" in ln or "spill" in ln:
            print(f"  [nibble_matmul ptxas] {ln.strip()}")
    # the main path's shapes, plus the kernel's edges: one row, a ragged
    # 64-row tile, and K = 4096 + 16 (off the 128-byte stage and the split)
    for m, k, n in NIBBLE_CHECK_SHAPES:
        x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=dev,
                          generator=gen)
        wt = torch.randint(-128, 128, (n, k), dtype=torch.int8, device=dev,
                           generator=gen)
        w4 = torch.randint(-8, 8, (k, n), dtype=torch.int8, device=dev,
                           generator=gen)
        # the extreme products: -128 (the hs plane's -128) in every row at
        # the first and last k, against -128 and 127 (int4: -8 and 7)
        x[:, 0] = -128
        x[:, -1] = -128
        wt[:2, 0] = torch.tensor([-128, 127], dtype=torch.int8)
        wt[-2:, -1] = torch.tensor([-128, 127], dtype=torch.int8)
        w4[0, :2] = torch.tensor([-8, 7], dtype=torch.int8)
        w4[-1, -2:] = torch.tensor([-8, 7], dtype=torch.int8)
        w = wt.t()
        w4p = pack_int4(w4)
        xs = torch.rand((m, 1), device=dev, generator=gen) * 0.01 + 1e-4
        ws = torch.rand((1, n), device=dev, generator=gen) * 0.01 + 1e-4
        f32 = torch.float32
        checks = {
            "int32": (nm.nibble_matmul_cuda(x, w), nm.nibble_matmul_plain(x, w)),
            "bf16": (nm.nibble_matmul_cuda(x, w, xs, ws),
                     nm.nibble_matmul_plain(x, w, xs, ws)),
            "f32": (nm.nibble_matmul_cuda(x, w, xs, ws, out_dtype=f32),
                    nm.nibble_matmul_plain(x, w, xs, ws, out_dtype=f32)),
            "int4": (nm.nibble_matmul_cuda(x, w4p, w_packed=True),
                     nm.nibble_matmul_plain(x, w4p, w_packed=True)),
        }
        torch.cuda.synchronize()
        for what, (got, want) in checks.items():
            if not torch.equal(got, want):
                err = (got.float() - want.float()).abs().max().item()
                raise AssertionError(f"nibble matmul {what} ({m},{k},{n}) "
                                     f"differs from plain: max err {err}")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        print(f"  nibble ({m},{k},{n}) {nm.nibble_plan(m, n, k, sms)}: "
              f"int32, bf16, f32, int4 torch.equal", flush=True)
    # time one decode layer's seven projections with the main path's
    # arguments (N-major int8 weight, a per-tensor activation scale, a
    # per-column weight scale, bf16 out): in a loop (host time of each
    # call included, as in earlier rows) and in a CUDA graph (device time)
    ms = plain = lib = dev_ms = lib_dev = 0.0
    n_bytes = ops = 0
    layer, prefill = [], {}
    for name, m, k, n in MM_SHAPES_DECODE + [("prefill-up", 128, 4096,
                                              11008)]:
        x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=dev,
                          generator=gen)
        wt = torch.randint(-128, 128, (n, k), dtype=torch.int8, device=dev,
                           generator=gen)
        xs = torch.tensor(1e-3, device=dev)
        ws = torch.full((1, n), 1e-3, device=dev)

        def call(x=x, wt=wt, xs=xs, ws=ws):
            return nm.nibble_matmul_cuda(x, wt.t(), xs, ws)

        t_k = cuda_ms(call)
        t_p = cuda_ms(lambda: nm.nibble_matmul_plain(x, wt.t(), xs, ws),
                      iters=5)
        t_l = _int_mm_ms(x, wt)
        t_g = graph_ms(call)
        t_gl = _int_mm_ms(x, wt, timer=graph_ms)
        print(f"  nibble {name} ({m},{k},{n}): kernel {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms, _int_mm {t_l} ms; in a CUDA graph: kernel "
              f"{t_g:.4f} ms, _int_mm {t_gl} ms", flush=True)
        if name == "prefill-up":
            pb, pby = bound_ms(m * k + k * n + 2 * m * n + 4 + 4 * n,
                               2 * m * n * k, INT8_OPS)
            prefill = {"prefill_ms": t_k, "prefill_graph_ms": t_g,
                       "prefill_int_mm_ms": t_l,
                       "prefill_int_mm_graph_ms": t_gl,
                       "prefill_bound_ms": pb}
            print(f"  nibble prefill bound {pb:.4f} ms ({pby})", flush=True)
            continue
        layer.append(call)
        ms += t_k
        plain += t_p
        dev_ms += t_g
        lib = None if (lib is None or t_l is None) else lib + t_l
        lib_dev = None if (lib_dev is None or t_gl is None) else \
            lib_dev + t_gl
        n_bytes += m * k + k * n + 2 * m * n + 4 + 4 * n
        ops += 2 * m * n * k
    layer_graph = graph_ms(lambda: [c() for c in layer], reps=5)
    b, by = bound_ms(n_bytes, ops, INT8_OPS)
    print(f"  nibble decode layer: kernel {ms:.4f} ms ({dev_ms:.4f} ms in a "
          f"CUDA graph per projection, {layer_graph:.4f} ms as one graph of "
          f"the layer), _int_mm {lib} ms ({lib_dev} ms in a CUDA graph), "
          f"bound {b:.4f} ms ({by})", flush=True)
    # host time per call at wq's shape: the wrapper, the entry point the
    # model calls, and the parts of a call
    x = torch.randint(-128, 128, (4, 4096), dtype=torch.int8, device=dev,
                      generator=gen)
    wt = torch.randint(-128, 128, (4096, 4096), dtype=torch.int8,
                       device=dev, generator=gen)
    xs = torch.tensor(1e-3, device=dev)
    ws = torch.full((1, 4096), 1e-3, device=dev)
    x3 = x[None]                       # (batch, tokens, d) as the model's
    o = torch.empty((4, 4096), dtype=torch.bfloat16, device=dev)
    plan = nm.nibble_plan(4, 4096, 4096,
                          torch.cuda.get_device_properties(0)
                          .multi_processor_count)
    fn = nm._lib()
    args = (x.data_ptr(), wt.data_ptr(), xs.data_ptr(), 0, ws.data_ptr(), 1,
            o.data_ptr(), 4, 4096, 4096, 0, 1, plan.rows, plan.k_chunk,
            torch.cuda.current_stream().cuda_stream)
    host = {
        "nibble_matmul_cuda": host_us(lambda: nm.nibble_matmul_cuda(
            x, wt.t(), xs, ws)),
        "ops.quant_matmul": host_us(lambda: kops.quant_matmul(
            x3, wt.t(), x_scale=xs, w_scale=ws,
            out_dtype=torch.bfloat16)),
        "C launch alone": host_us(lambda: fn(*args)),
        "torch.empty": host_us(lambda: torch.empty(
            (4, 4096), dtype=torch.bfloat16, device=dev)),
        "current_stream": host_us(
            lambda: torch.cuda.current_stream(x.device).cuda_stream),
    }
    print("  nibble host time per call (us): " + ", ".join(
        f"{k_} {v:.2f}" for k_, v in host.items()), flush=True)
    return {"name": "nibble_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/nibble_matmul.cu",
            "replaces": "src/repro/kernels/nibble_matmul.py:161",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": lib,
            "graph_ms": dev_ms, "layer_graph_ms": layer_graph,
            "library_graph_ms": lib_dev, **prefill, "host_us": host,
            "shapes": "one decode layer: wq,wk,wv,wo,gate,up,down at M=4"}


def _sdpa_gqa(q, k, v, **kw):
    try:
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, enable_gqa=True, **kw)
    except TypeError:               # torch without enable_gqa
        g = q.shape[1] // k.shape[1]
        return torch.nn.functional.scaled_dot_product_attention(
            q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1), **kw)


def _ptxas(name: str) -> list:
    """The ptxas lines of one library's build: entry, registers, spills."""
    lines = [ln.strip() for ln in _build.build_logs.get(name, "").splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    for ln in lines:
        print(f"  [{name} ptxas] {ln}")
    return lines


def _fwd_bound(bh, group, s, d):
    """Bytes (q, k, v, o in bf16, lse in f32) and useful causal FLOPs of
    the flash forward at one shape; the bound and what bounds it."""
    n_bytes = 2 * (2 * bh * s * d + 2 * (bh // group) * s * d) + 4 * bh * s
    flops = 2 * 2 * bh * (s * (s + 1) // 2) * d
    return bound_ms(n_bytes, flops, BF16_FLOPS), n_bytes, flops


def _time_fwd(q, k, v, kw, heads):
    """The forward kernel and SDPA's forward (GQA, ``heads`` query heads
    per sequence) at one shape, each in a loop and in a CUDA graph."""
    bh, s, d = q.shape
    nb = bh // heads
    q4 = q.reshape(nb, heads, s, d)
    k4, v4 = (t.reshape(nb, -1, s, t.shape[-1]) for t in (k, v))

    def kernel():
        return fa.flash_attention_fwd_cuda(q, k, v, **kw)

    def sdpa():
        return _sdpa_gqa(q4, k4, v4, is_causal=True, scale=kw["scale"])

    return {"ms": cuda_ms(kernel), "graph_ms": graph_ms(kernel),
            "library_ms": cuda_ms(sdpa), "library_graph_ms": graph_ms(sdpa)}


def _fwd_scaling(gen) -> dict:
    """The forward and SDPA's forward (device time, CUDA graphs) at three
    shapes of 1024 blocks of 64 query rows (group 4, d 128, causal) that
    walk 1, 2.5 and 8.5 K/V tiles per block on average: the per-block cost
    against the per-tile rate."""
    out = {}
    for bh, s in ((1024, 64), (256, 256), (64, 1024)):
        q = torch.randn((bh, s, 128), device=DEV, generator=gen).bfloat16()
        k, v = (torch.randn((bh // 4, s, 128), device=DEV, generator=gen)
                .bfloat16() for _ in range(2))
        kw = dict(scale=128 ** -0.5, causal=True, group=4)
        q4, k4, v4 = (t.reshape(bh // 32, -1, s, 128) for t in (q, k, v))
        out[f"BH={bh} S={s}"] = (
            graph_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v, **kw)),
            graph_ms(lambda: _sdpa_gqa(q4, k4, v4, is_causal=True,
                                       scale=kw["scale"])))
    print("  flash fwd scaling (1024 blocks of 64 rows), graph ms kernel / "
          "sdpa: " + ", ".join(f"{n} {a:.4f} / {b:.4f}"
                               for n, (a, b) in out.items()), flush=True)
    return out


def check_flash(gen) -> dict:
    dev = DEV
    ptxas = _ptxas("flash_attention")
    bh, group, s, d = 32, 8, 128, 128
    scale = 1.0 / math.sqrt(d)
    worst = 0.0
    # the main path's head width (two 64-row query tiles, the second
    # ragged at Sq 100), then the 256-wide instance (head_dim 256, and
    # MLA's q/k 192 with v 128), then no causal mask, Sq != Sk, and rows
    # with no key in their window (q >= Sk + window - 1: o is the mean of
    # all values, lse -1e30, as in the reference)
    cases = [dict(sq=s, window=0, softcap=0.0),
             dict(sq=100, window=0, softcap=0.0),
             dict(sq=s, window=40, softcap=30.0),
             dict(sq=s, window=0, softcap=0.0, d=256, dv=256),
             dict(sq=100, window=0, softcap=0.0, d=192, dv=128),
             dict(sq=100, sk=s, window=0, softcap=0.0, causal=False),
             dict(sq=100, sk=40, window=20, softcap=0.0, causal=False)]
    for c in cases:
        sq, dq_, dv_ = c["sq"], c.get("d", d), c.get("dv", d)
        sk = c.get("sk", sq)
        q = torch.randn((bh, sq, dq_), device=dev, generator=gen).bfloat16()
        k = torch.randn((bh // group, sk, dq_), device=dev,
                        generator=gen).bfloat16()
        v = torch.randn((bh // group, sk, dv_), device=dev,
                        generator=gen).bfloat16()
        kw = dict(scale=dq_ ** -0.5, causal=c.get("causal", True),
                  window=c["window"], softcap=c["softcap"], group=group)
        o, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
        o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (o.float() - o_p.float()).abs().max().item()
        err_l = (lse - lse_p).abs().max().item()
        print(f"  flash {c}: max|o err| {err:.3e} (atol {ATTN_ATOL}), "
              f"max|lse err| {err_l:.3e} (atol {LSE_ATOL})", flush=True)
        if not (err <= ATTN_ATOL and err_l <= LSE_ATOL):
            raise AssertionError(f"flash forward {c} disagrees with plain")
        worst = max(worst, err)
    q = torch.randn((bh, s, d), device=dev, generator=gen).bfloat16()
    k = torch.randn((bh // group, s, d), device=dev, generator=gen).bfloat16()
    v = torch.randn((bh // group, s, d), device=dev, generator=gen).bfloat16()
    kw = dict(scale=scale, causal=True, group=group)
    t = _time_fwd(q, k, v, kw, heads=32)
    plain = cuda_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, **kw))
    (b, by), _, _ = _fwd_bound(bh, group, s, d)
    print(f"  flash timing (BH={bh}, G={group}, S={s}, d={d}): "
          f"kernel {t['ms']:.4f} ms, graph {t['graph_ms']:.4f} ms, plain "
          f"{plain:.4f} ms, sdpa {t['library_ms']:.4f} ms, graph "
          f"{t['library_graph_ms']:.4f} ms, bound {b:.5f} ms ({by})",
          flush=True)
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:90",
            "max_abs_err": worst, "ms": t["ms"], "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": t["library_ms"],
            "graph_ms": t["graph_ms"],
            "library_graph_ms": t["library_graph_ms"], "ptxas": ptxas,
            "shapes": f"BH={bh} group={group} Sq=Sk={s} d={d} causal"}


def _paged_inputs(gen, rng, b, kvh, g, d, ps, per_slot, q_pos=None,
                  n_sets=1):
    """``n_sets`` pairs of random bf16 pools (one page per slot and table
    entry, plus the trash page 0), a query, a page table through a random
    permutation (trash page past each slot's live length) and q_pos (drawn
    with ``rng`` unless given)."""
    num_pages = b * per_slot + 1
    pools = [tuple(torch.randn((num_pages, ps, kvh, d), device=DEV,
                               generator=gen).bfloat16() for _ in range(2))
             for _ in range(n_sets)]
    q = torch.randn((b, kvh, g, d), device=DEV, generator=gen).bfloat16()
    if q_pos is None:
        q_pos = rng.integers(0, per_slot * ps, b).astype(np.int32)
    q_pos = np.asarray(q_pos, np.int32)
    perm = rng.permutation(np.arange(1, num_pages)).reshape(b, per_slot)
    table = np.zeros((b, per_slot), np.int32)      # trash page 0 past live
    for i in range(b):
        live = min(per_slot, q_pos[i] // ps + 1)
        table[i, :live] = perm[i, :live]
    return (q, pools, torch.as_tensor(table, device=DEV),
            torch.as_tensor(q_pos, device=DEV))


def _paged_bytes(q, table, q_pos, ps, dv):
    """Bytes paged decode must move (the live K/V rows once, q and o, the
    table and q_pos) and the live rows."""
    b, kvh, g, d = q.shape
    rows = int((q_pos.long() + 1).clamp(max=table.shape[1] * ps).sum())
    return 2 * (rows * kvh * (d + dv) + b * kvh * g * (d + dv)) \
        + 4 * table.numel() + 4 * b, rows


def _paged_sdpa(q, kp, vp, table, q_pos, scale):
    """The yardstick: gather the table's pages (as the plain version
    does) and run SDPA with the causal-by-position mask."""
    b, kvh, g, d = q.shape
    ps, dv = kp.shape[1], vp.shape[-1]
    L = table.shape[1] * ps
    mask = (torch.arange(L, device=DEV)[None, :]
            <= q_pos[:, None].long())[:, None, None, :]
    idx = table.long()

    def fn():
        kk = kp[idx].reshape(b, L, kvh, d).transpose(1, 2)
        vv = vp[idx].reshape(b, L, kvh, dv).transpose(1, 2)
        return _sdpa_gqa(q.reshape(b, kvh * g, 1, d), kk, vv, attn_mask=mask,
                         scale=scale)
    return fn


def _paged_graph(q, pools, table, q_pos, scale):
    """Graph times (ms) of the kernel and of the SDPA yardstick, each call
    on the next of ``pools`` in turn, so that every call finds its K/V
    rows cold in L2, as each layer's decode step does."""
    kernel = [lambda kp=kp, vp=vp: fa.paged_decode_attention_cuda(
        q, kp, vp, table, q_pos, scale=scale) for kp, vp in pools]
    sdpa = [_paged_sdpa(q, kp, vp, table, q_pos, scale) for kp, vp in pools]
    reps = max(20, len(pools))

    def cycle(fns):
        turn = itertools.count()
        return lambda: fns[next(turn) % len(fns)]()
    return graph_ms(cycle(kernel), reps), graph_ms(cycle(sdpa), reps)


def _sets_for(num_pages, ps, kvh, d):
    """Pool pairs whose bytes together exceed the 50 MB L2 twice over."""
    return max(1, math.ceil(100e6 / (2 * num_pages * ps * kvh * d * 2)))


def _paged_scaling(gen) -> dict:
    """Graph times of the kernel and of the yardstick at B 4, KVH 4, G 8,
    d 128, page 16 with every slot at 160 (the serve run's max_len), 1024
    and 4096 (yi-6b's published context) live rows, beside the bound; and
    first at one live row a slot (the fixed cost of a call)."""
    b, kvh, g, d, ps = 4, 4, 8, 128, 16
    rng = np.random.default_rng(2)
    out = {}
    # first the fixed cost: one live row a slot in a table of 160
    for live, cap in ((1, 160), (160, 160), (1024, 1024), (4096, 4096)):
        per_slot = cap // ps
        n_sets = _sets_for(b * per_slot + 1, ps, kvh, d)
        q, pools, table, q_pos = _paged_inputs(gen, rng, b, kvh, g, d, ps,
                                               per_slot,
                                               q_pos=[live - 1] * b,
                                               n_sets=n_sets)
        n_bytes, rows = _paged_bytes(q, table, q_pos, ps, d)
        bd, _ = bound_ms(n_bytes, 4 * rows * kvh * g * d, BF16_FLOPS)
        t_k, t_s = _paged_graph(q, pools, table, q_pos, d ** -0.5)
        plan = fa.paged_plan(cap, b, kvh, g, _sms())
        out[f"live={live}"] = {"graph_ms": t_k, "library_graph_ms": t_s,
                               "bound_ms": bd, "pool_sets": n_sets,
                               "splits": plan.n_split}
        del q, pools
    print("  paged scaling (B 4, KVH 4, G 8, d 128, page 16; every slot at "
          "the live rows; graph ms kernel / sdpa over gathered pages / "
          "bound): " + ", ".join(
              f"{n} {r['graph_ms']:.4f} / {r['library_graph_ms']:.4f} / "
              f"{r['bound_ms']:.5f}" for n, r in out.items()), flush=True)
    return out


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def check_paged(gen) -> dict:
    ptxas = _ptxas("paged_decode")
    b, kvh, g, d, ps, per_slot = 4, 4, 8, 128, 16, 16
    scale = 1.0 / math.sqrt(d)
    rng = np.random.default_rng(0)
    q, pools, table_t, qpos_t = _paged_inputs(gen, rng, b, kvh, g, d, ps,
                                              per_slot)
    kp, vp = pools[0]
    worst = 0.0
    # the main path's shape under three options, then head_dim 256, a group
    # of 32 query heads (two 16-head chunks in one launch), a long cache
    # (4096 rows a slot) with q_pos on the first tile, mid-cache and on the
    # table's last row under a window, and page size 4 (the reference
    # serve_bench's)
    wide = {"d=256": (kvh, g, 256), "G=32": (1, 32, d)}
    cases = [("", (0, 0.0)), ("", (48, 0.0)), ("", (0, 30.0)),
             ("d=256", (0, 0.0)), ("G=32", (0, 30.0)),
             ("4096 rows", (0, 0.0)), ("4096 rows", (700, 0.0)),
             ("page 4", (0, 0.0)), ("page 4", (50, 20.0))]
    for name, (window, softcap) in cases:
        kw = dict(scale=scale, window=window, softcap=softcap)
        qq, kpp, vpp, tt, pp = q, kp, vp, table_t, qpos_t
        if name in wide:
            kvh_, g_, d_ = wide[name]
            kpp, vpp = (torch.randn((b * per_slot + 1, ps, kvh_, d_),
                                    device=DEV, generator=gen).bfloat16()
                        for _ in range(2))
            qq = torch.randn((b, kvh_, g_, d_), device=DEV,
                             generator=gen).bfloat16()
            kw["scale"] = d_ ** -0.5
        elif name == "4096 rows":
            qq, ((kpp, vpp),), tt, pp = _paged_inputs(
                gen, rng, b, kvh, g, d, ps, 256, q_pos=[3, 2000, 4095, 3333])
        elif name == "page 4":
            qq, ((kpp, vpp),), tt, pp = _paged_inputs(gen, rng, b, kvh, g, d,
                                                      4, 40)
        o = fa.paged_decode_attention_cuda(qq, kpp, vpp, tt, pp, **kw)
        o_p = fa.paged_decode_attention_plain(qq, kpp, vpp, tt, pp, **kw)
        torch.cuda.synchronize()
        err = (o.float() - o_p.float()).abs().max().item()
        plan = fa.paged_plan(tt.shape[1] * kpp.shape[1], *qq.shape[:3],
                             _sms())
        print(f"  paged {name or 'main shape'} window={window} "
              f"softcap={softcap} (q_pos {pp.tolist()}, capacity "
              f"{tt.shape[1] * kpp.shape[1]}, {plan.n_split} splits of "
              f"{plan.span}): max|err| {err:.3e} (atol {ATTN_ATOL})",
              flush=True)
        if not err <= ATTN_ATOL:
            raise AssertionError("paged decode disagrees with plain")
        worst = max(worst, err)
    kw = dict(scale=scale)

    def call():
        return fa.paged_decode_attention_cuda(q, kp, vp, table_t, qpos_t,
                                              **kw)

    ms = cuda_ms(call)
    plain = cuda_ms(lambda: fa.paged_decode_attention_plain(
        q, kp, vp, table_t, qpos_t, **kw))
    lib = cuda_ms(_paged_sdpa(q, kp, vp, table_t, qpos_t, scale))
    # host time per call: the wrapper and its parts
    o = torch.empty((b, kvh, g, d), dtype=torch.bfloat16, device=DEV)
    plan = fa.paged_plan(per_slot * ps, b, kvh, g, _sms())
    fn = fa._fn("paged_decode", "paged_decode_attention", 6, 7, 2, 3)
    args = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table_t.data_ptr(),
            qpos_t.data_ptr(), o.data_ptr(), b, kvh, g, d, d, ps, per_slot,
            scale, 0.0, 0, plan.n_split, plan.span,
            torch.cuda.current_stream().cuda_stream)
    host = {"paged_decode_attention_cuda": host_us(call),
            "C launch alone": host_us(lambda: fn(*args)),
            "paged_plan": host_us(lambda: fa.paged_plan(
                per_slot * ps, b, kvh, g, _sms()))}
    sets = _paged_inputs(gen, np.random.default_rng(0), b, kvh, g, d, ps,
                         per_slot,
                         n_sets=_sets_for(kp.shape[0], ps, kvh, d))[1]
    g_ms, lib_g = _paged_graph(q, sets, table_t, qpos_t, scale)
    del sets
    n_bytes, rows = _paged_bytes(q, table_t, qpos_t, ps, d)
    bd, by = bound_ms(n_bytes, 4 * rows * kvh * g * d, BF16_FLOPS)
    print(f"  paged timing (B={b}, KVH={kvh}, G={g}, d={d}, live rows "
          f"{rows}): kernel {ms:.4f} ms, graph {g_ms:.4f} ms, plain "
          f"{plain:.4f} ms, sdpa over gathered pages {lib:.4f} ms, graph "
          f"{lib_g:.4f} ms, bound {bd:.5f} ms ({by}); host time per call "
          f"(us): " + ", ".join(f"{k_} {v:.2f}" for k_, v in host.items()),
          flush=True)
    scaling = _paged_scaling(gen)
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_decode.cu",
            "replaces": "src/repro/kernels/flash_attention.py:182",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain,
            "bound_ms": bd, "bound_by": by, "library_ms": lib,
            "graph_ms": g_ms, "library_graph_ms": lib_g, "host_us": host,
            "scaling_graph_ms": scaling, "ptxas": ptxas,
            "shapes": f"B={b} KVH={kvh} G={g} d={d} page_size={ps} "
                      f"{per_slot} pages/slot"}


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _bwd_parts(q, k, v, lse, do, dmat, **kw):
    """The dq kernel alone and the dk/dv kernel alone, launched as
    ``flash_attention_bwd_cuda`` launches them (head width already the
    instance's; no counters: these launches only time the two halves)."""
    bh, sq, d = q.shape
    bkv, sk, dv = v.shape
    w = fa.bwd_width(d, dv)
    if (d, dv) != (w, w):
        raise ValueError("time the kernels at an instance width")
    dq = torch.empty((bh, sq, w), dtype=torch.float32, device=q.device)
    dk, dvo = (torch.empty((bkv, sk, w), dtype=torch.float32,
                           device=q.device) for _ in range(2))
    ptrs = [t.data_ptr() for t in (q, k, v, do, lse, dmat)]
    fdq = fa._fn("flash_attention_bwd", "flash_attention_bwd_dq", 7, 5, 2, 2)
    fdkv = fa._fn("flash_attention_bwd", "flash_attention_bwd_dkv", 8, 5, 2,
                  2)

    def args():                    # the current stream: a graph captures
        return [bh, sq, sk, w, kw["group"], float(kw["scale"]),
                float(kw.get("softcap", 0.0)), int(bool(kw["causal"])),
                int(kw.get("window", 0)),
                torch.cuda.current_stream(q.device).cuda_stream]

    def run_dq():
        _build.check(fdq(*ptrs, dq.data_ptr(), *args()), "bwd dq")

    def run_dkv():
        _build.check(fdkv(*ptrs, dk.data_ptr(), dvo.data_ptr(), *args()),
                     "bwd dkv")

    return run_dq, run_dkv


def _check_bwd(q, k, v, do, kw, label) -> float:
    """The backward kernels against the plain backward on one input, in
    relative Frobenius norm per gradient; returns the largest |error|."""
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    dmat = (do.float() * o.float()).sum(-1)
    got = fa.flash_attention_bwd_cuda(q, k, v, lse, do, dmat, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, lse, do, dmat, **kw)
    torch.cuda.synchronize()
    errs = {n: _rel(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    print(f"  flash bwd {label}: rel-norm err "
          + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f" (bound {BWD_RTOL}); max|err| {err:.3e}", flush=True)
    if not max(errs.values()) <= BWD_RTOL:
        raise AssertionError(f"flash backward {label} disagrees with plain")
    return err


def check_flash_bwd(gen, fwd_row: dict) -> dict:
    """The backward at the training shape: qwen3-4b (32 query heads over
    8 KV heads, head_dim 128) at batch 8, seq 256.  The forward that feeds
    it is first held to its plain version at this shape too; its error is
    folded into ``fwd_row``, and its times at this shape (loop and CUDA
    graph, beside SDPA's forward both ways) and bound go into it as
    ``train_*``.  Then small checks of the 256-wide instance (head_dim
    256, MLA's 192 / 128)."""
    dev = DEV
    ptxas = _ptxas("flash_attention_bwd")
    bkv, group, s, d = 64, 4, 256, 128
    bh = bkv * group
    scale = 1.0 / math.sqrt(d)
    worst = 0.0
    for c in (dict(window=0, softcap=0.0), dict(window=64, softcap=30.0)):
        q, do = (torch.randn((bh, s, d), device=dev, generator=gen)
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn((bkv, s, d), device=dev, generator=gen)
                .bfloat16() for _ in range(2))
        kw = dict(scale=scale, causal=True, group=group, **c)
        o, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
        o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err_o = (o.float() - o_p.float()).abs().max().item()
        err_l = (lse - lse_p).abs().max().item()
        print(f"  flash fwd (training shape) {c}: max|o err| {err_o:.3e} "
              f"(atol {ATTN_ATOL}), max|lse err| {err_l:.3e} "
              f"(atol {LSE_ATOL})", flush=True)
        if not (err_o <= ATTN_ATOL and err_l <= LSE_ATOL):
            raise AssertionError(f"flash forward at the training shape {c} "
                                 f"disagrees with plain")
        fwd_row["max_abs_err"] = max(fwd_row["max_abs_err"], err_o)
        fwd_row["shapes"] += f"; checked at BH={bh} group={group} S={s} {c}"
        del o, lse, o_p, lse_p
        worst = max(worst, _check_bwd(q, k, v, do, kw,
                                      f"(training shape) {c}"))
    for dq_, dv_, s_ in ((256, 256, 200), (192, 128, 160)):
        qs = torch.randn((16, s_, dq_), device=dev, generator=gen).bfloat16()
        dos = torch.randn((16, s_, dv_), device=dev, generator=gen).bfloat16()
        ks = torch.randn((4, s_, dq_), device=dev, generator=gen).bfloat16()
        vs = torch.randn((4, s_, dv_), device=dev, generator=gen).bfloat16()
        kw = dict(scale=dq_ ** -0.5, causal=True, group=4, window=0,
                  softcap=0.0)
        worst = max(worst, _check_bwd(qs, ks, vs, dos, kw,
                                      f"(BH=16 group=4 S={s_} d={dq_} "
                                      f"dv={dv_})"))
    # rows with no key in their window (q >= Sk + window - 1): lse -1e30,
    # p = 1 on every key, as in the reference
    for causal, sq_, sk_, window in ((False, 100, 40, 20), (True, 60, 40, 8)):
        qs, dos = (torch.randn((16, sq_, d), device=dev, generator=gen)
                   .bfloat16() for _ in range(2))
        ks, vs = (torch.randn((4, sk_, d), device=dev, generator=gen)
                  .bfloat16() for _ in range(2))
        kw = dict(scale=scale, causal=causal, group=4, window=window,
                  softcap=0.0)
        worst = max(worst, _check_bwd(qs, ks, vs, dos, kw,
                                      f"no key in window (BH=16 group=4 "
                                      f"Sq={sq_} Sk={sk_} causal={causal} "
                                      f"window={window})"))
    kw = dict(scale=scale, causal=True, group=group)
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    dmat = (do.float() * o.float()).sum(-1)

    def pair():
        return fa.flash_attention_bwd_cuda(q, k, v, lse, do, dmat, **kw)

    ms = cuda_ms(pair)
    g_ms = graph_ms(pair)
    run_dq, run_dkv = _bwd_parts(q, k, v, lse, do, dmat, **kw)
    dq_ms, dkv_ms = graph_ms(run_dq), graph_ms(run_dkv)
    plain = cuda_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, lse, do,
                                                         dmat, **kw), iters=5)
    t = _time_fwd(q, k, v, kw, heads=32)
    (fb, fby), fbytes, fflops = _fwd_bound(bh, group, s, d)
    fwd_row.update(train_ms=t["ms"], train_graph_ms=t["graph_ms"],
                   library_train_ms=t["library_ms"],
                   library_train_graph_ms=t["library_graph_ms"],
                   train_bound_ms=fb)
    scaling = _fwd_scaling(gen)
    fwd_row["scaling_graph_ms"] = scaling
    print(f"  flash fwd timing (training shape, BH={bh}, G={group}, S={s}, "
          f"d={d}): kernel {t['ms']:.4f} "
          f"ms, graph {t['graph_ms']:.4f} ms; sdpa (GQA) {t['library_ms']:.4f}"
          f" ms, graph {t['library_graph_ms']:.4f} ms; bound {fb:.5f} ms "
          f"({fby}, {fbytes / 1e6:.1f} MB, {fflops / 1e9:.2f} GFLOP)",
          flush=True)
    # yardstick: SDPA forward + backward with the KV heads expanded, minus
    # SDPA's forward alone
    b = bkv // 8
    qq = q.reshape(b, 32, s, d).detach().requires_grad_(True)
    kk, vv = (t.reshape(b, 8, s, d).repeat_interleave(group, 1).detach()
              .requires_grad_(True) for t in (k, v))
    do4 = do.reshape(b, 32, s, d)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qq, kk, vv, is_causal=True, scale=scale)

    t_fb = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qq, kk, vv), do4))
    t_f = cuda_ms(sdpa)
    lib = t_fb - t_f
    n_bytes = 2 * (q.numel() + k.numel() + v.numel() + do.numel()) \
        + 4 * (lse.numel() + dmat.numel()) \
        + 4 * (q.numel() + k.numel() + v.numel())
    pairs = bh * s * (s + 1) // 2
    flops = 10 * d * pairs
    bd, by = bound_ms(n_bytes, flops, BF16_FLOPS)
    print(f"  flash bwd timing (BH={bh}, G={group}, S={s}, d={d}): kernels "
          f"{ms:.4f} ms in a loop, {g_ms:.4f} ms in a CUDA graph (dq "
          f"{dq_ms:.4f}, dk/dv {dkv_ms:.4f}), plain {plain:.4f} ms, sdpa "
          f"fwd+bwd {t_fb:.4f} - fwd {t_f:.4f} = {lib:.4f} ms, bound "
          f"{bd:.5f} ms ({by}, {n_bytes / 1e6:.1f} MB, {flops / 1e9:.2f} "
          f"GFLOP)", flush=True)
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:321",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain,
            "bound_ms": bd, "bound_by": by, "library_ms": lib,
            "graph_ms": g_ms, "dq_graph_ms": dq_ms, "dkv_graph_ms": dkv_ms,
            "ptxas": ptxas,
            "shapes": f"BH={bh} group={group} Sq=Sk={s} d={d} causal "
                      f"(dq + dk/dv kernels)"}


def check_attention_f32(gen) -> dict:
    """The f32 routes of the three attention entry points (the SIMT kernels
    of ``csrc/attention_f32.cu``) against their plain versions at small
    shapes: forward (causal with window and softcap, the 256-wide instance,
    no causal mask), paged decode (a group of 20 over two head chunks) and
    the backward.  Each route's own counter must show one launch per call
    and the bf16 counters none."""
    dev = DEV
    _ptxas("attention_f32")
    errs = {}

    def counted(names, fn):
        before = {attr: getattr(fa, attr)
                  for mod, attr in COUNTERS.values() if mod is fa}
        out = fn()
        torch.cuda.synchronize()
        got = {n: getattr(fa, n) - before[n] for n in before}
        want = {n: int(n in names) for n in before}
        if got != want:
            raise AssertionError(f"f32 route launches {got}, expected {want}")
        return out

    for name, (bkv, group, s, sk, d, dv, causal, window, softcap) in {
            "fwd": (2, 4, 100, 100, 128, 128, True, 40, 30.0),
            "fwd d=256": (2, 2, 70, 70, 256, 256, True, 0, 0.0),
            "fwd 192/128 non-causal": (2, 2, 50, 90, 192, 128, False, 0,
                                       0.0),
            "fwd no key in window": (2, 2, 100, 40, 128, 128, False, 20,
                                     0.0),
            "bwd": (2, 4, 130, 130, 128, 128, True, 64, 20.0),
            "bwd d=256": (2, 2, 70, 70, 256, 256, True, 0, 0.0),
            "bwd no key in window": (2, 2, 100, 40, 128, 128, False, 20,
                                     0.0)}.items():
        q = torch.randn((bkv * group, s, d), device=dev, generator=gen)
        k = torch.randn((bkv, sk, d), device=dev, generator=gen)
        v = torch.randn((bkv, sk, dv), device=dev, generator=gen)
        kw = dict(scale=d ** -0.5, causal=causal, window=window,
                  softcap=softcap, group=group)
        if name.startswith("fwd"):
            o, lse = counted(("fwd_f32_launches",),
                             lambda: fa.flash_attention_fwd_cuda(q, k, v,
                                                                 **kw))
            o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, **kw)
            errs[name] = max((o - o_p).abs().max().item(),
                             (lse - lse_p).abs().max().item())
            what = "max|o, lse err|"
        else:
            do = torch.randn((bkv * group, s, dv), device=dev, generator=gen)
            o, lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
            dmat = (do * o).sum(-1)
            got = counted(("bwd_f32_dq_launches", "bwd_f32_dkv_launches"),
                          lambda: fa.flash_attention_bwd_cuda(
                              q, k, v, lse, do, dmat, **kw))
            want = fa.flash_attention_bwd_plain(q, k, v, lse, do, dmat, **kw)
            errs[name] = max(_rel(a, b) for a, b in zip(got, want))
            what = "rel-norm err of dq, dk, dv"
        print(f"  f32 {name} (BKV={bkv} group={group} Sq={s} Sk={sk} d={d} "
              f"dv={dv} causal={causal} window={window} softcap={softcap}): "
              f"{what} {errs[name]:.3e} (tol {F32_TOL})", flush=True)
    rng = np.random.default_rng(1)
    b, kvh, g, d, ps, per_slot = 3, 2, 20, 128, 16, 6
    num_pages = b * per_slot + 1
    kp, vp = (torch.randn((num_pages, ps, kvh, d), device=dev, generator=gen)
              for _ in range(2))
    q = torch.randn((b, kvh, g, d), device=dev, generator=gen)
    q_pos = rng.integers(0, per_slot * ps, b).astype(np.int32)
    perm = rng.permutation(np.arange(1, num_pages)).reshape(b, per_slot)
    table = np.zeros((b, per_slot), np.int32)
    for i in range(b):
        table[i, :q_pos[i] // ps + 1] = perm[i, :q_pos[i] // ps + 1]
    args = (q, kp, vp, torch.as_tensor(table, device=dev),
            torch.as_tensor(q_pos, device=dev))
    kw = dict(scale=d ** -0.5, window=48, softcap=30.0)
    o = counted(("paged_f32_launches",),
                lambda: fa.paged_decode_attention_cuda(*args, **kw))
    errs["paged"] = (o - fa.paged_decode_attention_plain(*args, **kw)) \
        .abs().max().item()
    print(f"  f32 paged (B={b} KVH={kvh} G={g} d={d} window=48 softcap=30): "
          f"max|err| {errs['paged']:.3e} (tol {F32_TOL})", flush=True)
    bad = {n: e for n, e in errs.items() if not e <= F32_TOL}
    if bad:
        raise AssertionError(f"f32 attention routes disagree with plain: "
                             f"{bad}")
    return errs


def check_lut(gen) -> dict:
    dev = DEV
    for ln in _build.build_logs.get("lut_matmul", "").splitlines():
        if "entry function" in ln or "registers" in ln or "spill" in ln:
            print(f"  [lut_matmul ptxas] {ln.strip()}")
    # the main path's shapes, plus one decode row at N = 512 and a ragged
    # row tile at N = 4096 (the kernel's split of K and its row tiles)
    for m, k, n in MM_CHECK_SHAPES + [(1, 4096, 512), (65, 4096, 4096)]:
        x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=dev,
                          generator=gen)
        wt = torch.randint(-128, 128, (n, k), dtype=torch.int8, device=dev,
                           generator=gen)
        x[0, :2] = torch.tensor([-128, 127], dtype=torch.int8)
        wt[:2, 0] = torch.tensor([-128, 127], dtype=torch.int8)
        x[:, 0] = -128        # t_hi's extreme, (-8 << 4) * -128, in every row
        got = lm.lut_matmul_cuda(x, wt.t())
        plain = lm.lut_matmul_plain(x, wt.t())
        nib = nm.nibble_matmul_cuda(x, wt.t())
        torch.cuda.synchronize()
        if not (torch.equal(got, plain) and torch.equal(got, nib)):
            raise AssertionError(f"LUT matmul ({m},{k},{n}) differs from "
                                 f"its plain version or the nibble kernel")
        print(f"  lut ({m},{k},{n}): torch.equal to plain and to the nibble "
              f"kernel's int32", flush=True)
    ms = plain = lib = dev_ms = lib_dev = 0.0
    n_bytes = ops = 0
    prefill = {}
    for name, m, k, n in MM_SHAPES_DECODE + [("prefill-up", 128, 4096,
                                              11008)]:
        x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=dev,
                          generator=gen)
        wt = torch.randint(-128, 128, (n, k), dtype=torch.int8, device=dev,
                           generator=gen)
        t_k = cuda_ms(lambda: lm.lut_matmul_cuda(x, wt.t()))
        t_p = cuda_ms(lambda: lm.lut_matmul_plain(x, wt.t()), iters=5)
        t_l = _int_mm_ms(x, wt)
        # device time alone (host time of each call excluded), beside the
        # nibble kernel's and _int_mm's at the same shape
        t_g = graph_ms(lambda: lm.lut_matmul_cuda(x, wt.t()))
        t_gn = graph_ms(lambda: nm.nibble_matmul_cuda(x, wt.t()))
        t_gl = _int_mm_ms(x, wt, timer=graph_ms)
        print(f"  lut {name} ({m},{k},{n}): kernel {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms, _int_mm {t_l} ms; in a CUDA graph: kernel "
              f"{t_g:.4f} ms, nibble kernel {t_gn:.4f} ms, _int_mm {t_gl} "
              f"ms", flush=True)
        if name == "prefill-up":
            prefill = {"prefill_ms": t_k, "prefill_graph_ms": t_g,
                       "prefill_int_mm_ms": t_l, "prefill_int_mm_graph_ms":
                       t_gl}
            continue
        ms += t_k
        plain += t_p
        dev_ms += t_g
        lib = None if (lib is None or t_l is None) else lib + t_l
        lib_dev = None if (lib_dev is None or t_gl is None) else \
            lib_dev + t_gl
        n_bytes += m * k + k * n + 4 * m * n
        ops += 2 * m * n * k
    b, by = bound_ms(n_bytes, ops, INT8_OPS)
    print(f"  lut decode layer: kernel {ms:.4f} ms ({dev_ms:.4f} ms in a "
          f"CUDA graph), _int_mm {lib} ms ({lib_dev} ms in a CUDA graph), "
          f"bound {b:.4f} ms ({by})", flush=True)
    return {"name": "lut_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/lut_matmul.cu",
            "replaces": "src/repro/kernels/lut_matmul.py:87",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": lib,
            "graph_ms": dev_ms, "library_graph_ms": lib_dev, **prefill,
            "shapes": "one decode layer: wq,wk,wv,wo,gate,up,down at M=4"}


COUNTERS = {
    "nibble_matmul": (nm, "launches"),
    "flash_attention_fwd": (fa, "fwd_launches"),
    "paged_decode_attention": (fa, "paged_launches"),
    "flash_attention_bwd_dq": (fa, "bwd_dq_launches"),
    "flash_attention_bwd_dkv": (fa, "bwd_dkv_launches"),
    "lut_matmul": (lm, "lut_launches"),
    "flash_attention_fwd_f32": (fa, "fwd_f32_launches"),
    "paged_decode_attention_f32": (fa, "paged_f32_launches"),
    "flash_attention_bwd_dq_f32": (fa, "bwd_f32_dq_launches"),
    "flash_attention_bwd_dkv_f32": (fa, "bwd_f32_dkv_launches"),
}


def reset_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in COUNTERS.items()}


def require_launched(counts: dict, names) -> None:
    missing = [n for n in names if counts[n] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")


F32_ROUTES = ("flash_attention_fwd_f32", "paged_decode_attention_f32",
              "flash_attention_bwd_dq_f32", "flash_attention_bwd_dkv_f32")


def require_no_f32(counts: dict) -> None:
    """The model paths feed bf16: an f32 route launched there would be a
    path that fell onto the slow SIMT kernels."""
    used = {n: counts[n] for n in F32_ROUTES if counts[n]}
    if used:
        raise AssertionError(f"f32 attention routes launched on a bf16 "
                             f"main path: {used}")


def phase_serve() -> dict:
    cfg = get_config("yi-6b").replace(
        quant_mode="w8a8_nibble", quant_backend="cuda", attn_impl="flash",
        cache_mode="paged", page_size=16)
    print(f"serve: {cfg.name} n_layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} head_dim={cfg.head_dim} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} (full width, all layers)",
          flush=True)
    t = time.perf_counter()
    params = model_init(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    print(f"  weights built and quantized in {time.perf_counter() - t:.1f} s"
          f", {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    n_req, n_new, prefill_len = 8, 32, 128
    scfg = ServeConfig(batch=4, max_len=prefill_len + n_new,
                       prefill_len=prefill_len, decode_chunk=8)
    engine = Engine(cfg, params, scfg, device=DEV)
    rng = np.random.default_rng(0)
    lens = rng.integers(32, prefill_len + 1, n_req)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    # warm-up request (first-call allocations), not counted
    engine.submit(prompts[0], 2)
    engine.run()
    torch.cuda.synchronize()

    reset_counts()
    t = time.perf_counter()
    ids = [engine.submit(p, n_new) for p in prompts]
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = read_counts()

    for i in ids:
        toks = done[i].tokens
        if len(toks) != n_new or not all(0 <= x < cfg.vocab_size
                                         for x in toks):
            raise AssertionError(f"request {i}: bad stream {toks}")
    if engine.leaked_pages():
        raise AssertionError(f"{engine.leaked_pages()} pages leaked")
    n_tok = sum(len(done[i].tokens) for i in ids)
    print(f"  served {n_req} requests (prompt lengths {lens.tolist()}), "
          f"{n_tok} tokens in {wall:.3f} s: {n_tok / wall:.2f} tok/s "
          f"({engine.decode_chunks} decode chunks)", flush=True)
    print(f"  launches in the serve run: {counts}", flush=True)
    for i in ids[:2]:
        print(f"  request {i} first tokens: {done[i].tokens[:8]}")
    require_launched(counts, ("nibble_matmul", "flash_attention_fwd",
                              "paged_decode_attention"))
    require_no_f32(counts)

    # the first request's prefill: kernel path vs plain path
    p = prompts[0]
    padded = torch.zeros((1, prefill_len), dtype=torch.int64, device=DEV)
    padded[0, :p.size] = torch.as_tensor(p, device=DEV)
    plain_cfg = cfg.replace(quant_backend="torch", attn_impl="chunked")
    ref, _ = prefill(params, plain_cfg, padded, logits_index=p.size - 1)
    got, _ = prefill(params, cfg, padded, logits_index=p.size - 1)
    torch.cuda.synchronize()
    if not (torch.isfinite(ref).all() and torch.isfinite(got).all()):
        raise AssertionError("non-finite prefill logits")
    diff = (got - ref).abs().max().item()
    tol = LOGIT_RTOL * ref.abs().max().item()
    print(f"  prefill logits kernel vs plain path: max|diff| {diff:.4e}, "
          f"max|logit| {ref.abs().max().item():.4f}, tolerance {tol:.4e}; "
          f"argmax {int(got.argmax())} vs {int(ref.argmax())}; first "
          f"served token {done[ids[0]].tokens[0]}", flush=True)
    if not diff <= tol:
        raise AssertionError("kernel-path prefill logits disagree with the "
                             "plain path")
    return {"counts": counts, "tok_s": n_tok / wall, "wall_s": wall,
            "decode_chunks": engine.decode_chunks, "logit_diff": diff,
            "logit_tol": tol, "engine": engine, "prompts": prompts,
            "params": params}


def phase_lut_serve(params, prompts, n_req=4, n_new=16,
                    prefill_len=128) -> dict:
    """The serve phase's model and settings in ``quant_mode="lut"``: the
    streams must equal what ``w8a8_nibble`` serves for the same requests
    (the prepared int8 weights are the same for both modes)."""
    base = get_config("yi-6b").replace(
        quant_mode="w8a8_nibble", quant_backend="cuda", attn_impl="flash",
        cache_mode="paged", page_size=16)
    scfg = ServeConfig(batch=4, max_len=prefill_len + 32,
                       prefill_len=prefill_len, decode_chunk=8)

    def serve(cfg):
        engine = Engine(cfg, params, scfg, device=DEV)
        ids = [engine.submit(p, n_new) for p in prompts[:n_req]]
        done = engine.run()
        torch.cuda.synchronize()
        if engine.leaked_pages():
            raise AssertionError(f"{engine.leaked_pages()} pages leaked")
        return [done[i].tokens for i in ids]

    want = serve(base)
    print(f"lut serve: {base.name} full width, quant_mode=lut on the CUDA "
          f"backend, {n_req} requests x {n_new} new tokens (the serve "
          f"phase's settings; no layer cut)", flush=True)
    reset_counts()
    t = time.perf_counter()
    got = serve(base.replace(quant_mode="lut"))
    wall = time.perf_counter() - t
    counts = read_counts()
    n_tok = sum(len(x) for x in got)
    print(f"  served {n_tok} tokens in {wall:.3f} s: {n_tok / wall:.2f} "
          f"tok/s; launches {counts}", flush=True)
    require_launched(counts, ("lut_matmul", "flash_attention_fwd",
                              "paged_decode_attention"))
    require_no_f32(counts)
    if counts["nibble_matmul"]:
        raise AssertionError("the lut path launched the nibble kernel")
    same = sum(a == b for a, b in zip(got, want))
    print(f"  lut streams equal to w8a8_nibble streams: {same}/{n_req} "
          f"requests token for token; first: {got[0][:8]}", flush=True)
    if got != want:
        raise AssertionError(f"lut streams {got} differ from w8a8_nibble "
                             f"streams {want}")
    return {"counts": counts, "tok_s": n_tok / wall, "wall_s": wall}


def phase_train(profile: bool) -> dict:
    """Full-width qwen3-4b, QAT, flash attention, remat: 4 Trainer steps."""
    cfg = get_config("qwen3-4b").replace(quant_mode="qat", attn_impl="flash",
                                         remat=True)
    batch, seq, steps = 8, 256, 4
    print(f"train: {cfg.name} n_layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} head_dim={cfg.head_dim} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} tied head (full width, "
          f"all layers), quant_mode=qat attn_impl=flash remat=True, batch "
          f"{batch} x seq {seq}, {steps} steps", flush=True)
    tcfg = TrainConfig(optimizer=AdamWConfig(), total_steps=steps,
                       warmup_steps=max(1, steps // 10))
    rcfg = TrainerConfig(steps=steps, log_every=1)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    trainer = Trainer(cfg, tcfg, rcfg, dcfg, device=DEV)
    torch.cuda.synchronize()
    n_params = sum(t_.numel() for _, t_ in tree_paths(trainer.params))
    print(f"  {n_params / 1e9:.3f} B parameters, initialised in "
          f"{time.perf_counter() - t:.1f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
          f"(bf16 params + f32 moments)", flush=True)
    reset_counts()
    t = time.perf_counter()
    history = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    for h in history:
        print(f"  step {h['step']}: loss {h['loss']:.6f}, grad norm "
              f"{h['grad_norm']:.6f}, lr {h['lr']:.3e}, "
              f"{h['step_time_s']:.3f} s", flush=True)
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            raise AssertionError(f"non-finite loss at step {h['step']}")
    steady = [h["step_time_s"] for h in history[1:]]
    tok_s = batch * seq * len(steady) / sum(steady)
    print(f"  {steps} steps in {wall:.2f} s; steady {tok_s:.1f} tokens/s "
          f"(steps 1-{steps - 1}); peak memory allocated "
          f"{peak / 1e9:.2f} GB", flush=True)
    per_step = {k: v / steps for k, v in counts.items() if v}
    print(f"  launches in the train run: {counts}; per step {per_step}",
          flush=True)
    require_launched(counts, ("flash_attention_fwd",
                              "flash_attention_bwd_dq",
                              "flash_attention_bwd_dkv"))
    require_no_f32(counts)
    out = {"counts": counts, "history": history, "wall_s": wall,
           "tok_s": tok_s, "peak_bytes": peak, "n_params": n_params}
    if profile:
        out["profile"] = profile_train_step(trainer)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def profile_train_step(trainer) -> dict:
    """One more training step under torch.profiler: device time by
    kernel and the idle share."""
    from torch.profiler import ProfilerActivity, profile
    batch = trainer.data.batch(trainer.rcfg.steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.step_fn(trainer.params, trainer.opt_state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = _device_times(prof)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    print(f"profile: one train step, wall {wall_us / 1e3:.1f} ms, device "
          f"busy {busy / 1e3:.1f} ms, idle share {1 - busy / wall_us:.3f}",
          flush=True)
    for name, us in top:
        print(f"  {us / 1e3:9.2f} ms  {name[:90]}")
    # the attention kernels of the step, wherever they rank
    attn = {n: us / 1e3 for n, us in kernels.items()
            if "flash_" in n or "bwd_dq_kernel" in n or "bwd_dkv_kernel" in n}
    for name, t_ms in sorted(attn.items(), key=lambda kv: -kv[1]):
        print(f"  attention {t_ms:9.2f} ms ({t_ms / (busy / 1e3):.2%} of "
              f"device time)  {name[:70]}")
    fwd = sum(t_ms for n, t_ms in attn.items() if "flash_fwd" in n)
    print(f"  flash forward: {fwd:.2f} ms of {busy / 1e3:.1f} ms device "
          f"time ({fwd / (busy / 1e3):.2%})", flush=True)
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "top": [(n, us / 1e3) for n, us in top], "attention": attn,
            "flash_fwd_ms": fwd}


def check_train_grads() -> dict:
    """One step's gradients on full-width qwen3-4b cut to 2 layers:
    kernel path (flash) vs plain path (chunked), leaf by leaf."""
    out = {}
    for mode in ("qat", "dense"):
        cfg = get_config("qwen3-4b").replace(n_layers=2, quant_mode=mode,
                                             remat=True)
        print(f"train grads: {cfg.name} full width cut to n_layers=2 "
              f"(of 36), quant_mode={mode}, batch 8 x seq 256: flash "
              f"kernels vs plain chunked attention", flush=True)
        params = model_init(cfg, seed=1, device=DEV)
        batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=256, global_batch=8),
                            device=DEV).batch(0)
        res = {}
        for impl in ("flash", "chunked"):
            c = cfg.replace(attn_impl=impl)
            loss, _, g = accumulate_grads(make_loss_fn(c, TrainConfig()),
                                          params, batch, 1)
            res[impl] = (float(loss), dict(tree_paths(g)))
        errs = {p: _rel(a, res["chunked"][1][p])
                for p, a in res["flash"][1].items()}
        worst = sorted(errs.items(), key=lambda kv: -kv[1])
        print(f"  loss flash {res['flash'][0]:.6f} vs chunked "
              f"{res['chunked'][0]:.6f}; worst rel-norm errors: "
              + ", ".join(f"{p} {e:.3e}" for p, e in worst[:4])
              + f" (bound {MODEL_GRAD_RTOL[mode]})", flush=True)
        if not worst[0][1] <= MODEL_GRAD_RTOL[mode]:
            raise AssertionError(f"{mode}: kernel-path gradients disagree "
                                 f"with the plain path")
        out[mode] = {"loss": {k: v[0] for k, v in res.items()},
                     "worst": worst[:4]}
        del params, res
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _device_times(prof) -> dict:
    """Self device time (us) per CUDA kernel name from a profiler run."""
    kernels = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us
    return kernels


def phase_profile(engine, prompts, n_new=32) -> dict:
    """One wave of 4 requests under torch.profiler: wall time, device time
    per kernel (self device time of CUDA events) and the idle share."""
    from torch.profiler import ProfilerActivity, profile
    for p in prompts[:4]:
        engine.submit(p, n_new)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = _device_times(prof)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    print(f"profile: 4 requests x {n_new} tokens, wall {wall_us / 1e3:.1f} "
          f"ms, device busy {busy / 1e3:.1f} ms, idle share "
          f"{1 - busy / wall_us:.3f}", flush=True)
    for name, us in top:
        print(f"  {us / 1e3:9.2f} ms  {name[:90]}")
    # the paged decode kernel, wherever it ranks
    paged = {n: us / 1e3 for n, us in kernels.items() if "paged_decode" in n}
    for name, t_ms in paged.items():
        print(f"  paged decode {t_ms:9.2f} ms ({t_ms / (busy / 1e3):.2%} of "
              f"device time)  {name[:70]}", flush=True)
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "top": [(n, us / 1e3) for n, us in top], "paged": paged}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="after serving, profile one wave of 4 requests")
    ap.add_argument("--out", default=None, help="write details as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    gen = torch.Generator(device=DEV).manual_seed(0)
    rows = [check_nibble(gen), check_flash(gen), check_paged(gen)]
    rows += [check_flash_bwd(gen, rows[1]), check_lut(gen)]
    f32 = check_attention_f32(gen)
    serve = phase_serve()
    engine, prompts = serve.pop("engine"), serve.pop("prompts")
    params = serve.pop("params")
    for r in rows[:3]:
        r["launches"] = serve["counts"][r["name"]]
    if args.profile:
        serve["profile"] = phase_profile(engine, prompts)
    del engine
    lut = phase_lut_serve(params, prompts)
    rows[4]["launches"] = lut["counts"]["lut_matmul"]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(args.profile)
    rows[3]["launches"] = (train["counts"]["flash_attention_bwd_dq"]
                           + train["counts"]["flash_attention_bwd_dkv"])
    grads = check_train_grads()
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "kernels": rows,
                       "attention_f32_errors": f32, "serve": serve,
                       "lut_serve": lut, "train": train,
                       "train_grads": grads, "torch": torch.__version__},
                      f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # device times (CUDA graphs) and the forward's training shape, where a
    # row has them
    extra = ("graph_ms", "library_graph_ms", "train_ms", "train_graph_ms",
             "library_train_ms", "library_train_graph_ms", "train_bound_ms")
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + extra if k in r} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
