"""Port parity for the training slice: fake-quant and the QAT linear,
the flash backward, the loss, schedule, data, optimizer and compression
pieces, one train step and a short trajectory on reduced qwen3-4b, the
checkpointer and the launcher.  Inputs are made with numpy and go
through both packages.

Tolerances, each with its reason:
* ``fake_quant`` forward and backward: bit-exact (the same f32
  operations in the same order; the backward reproduces JAX's 0.5
  gradient where a value sits exactly on the clip bound);
* the QAT linear, forward and both gradients: within one bf16 ulp (the
  fake-quantized operands are bit-exact, but XLA and torch sum the f32
  product over K in another order; measured: 4 of 12288 outputs one ulp
  apart);
* flash backward in f32: atol/rtol 1e-5 against ``jax.grad`` of the
  reference's interpret-mode kernels (same arithmetic, the reference
  blocks it in 128-row tiles); in bf16: rel-norm 2e-2 per gradient (the
  cast points are the same, but bf16 rounding of p, ds and the final
  casts lands on other sides of a midpoint where the f32 values differ in
  the last ulp);
* cross-entropy, z-loss, schedule, compression: 1e-6 relative (f32
  ``exp``/``log``/``cos`` differ in the last ulp between XLA and torch);
* AdamW: parameters within one bf16 ulp, moments within 1e-6 relative;
* train step on reduced qwen3-4b: loss within LOSS_ATOL = 5e-4 and every
  gradient leaf within GRAD_RTOL[mode] in relative Frobenius norm.  The
  two packages' forwards differ by f32 ``sin``/``cos``/``exp`` ulps and
  the bf16 roundings they flip (logits agree to 0.08, see
  test_torch_model.py); measured on this CPU: loss 1.7e-4, gradients
  1.6% (dense) and 9.7% (qat, where a flipped activation rounding moves
  a fake-quantized value by a whole int8 step; the reference's own
  chunked and flash paths differ by 3.6% on the same leaf);
* a 3-step QAT trajectory at lr 1e-2: losses within TRAJ_ATOL = 5e-3 and
  gradient norms within 5% (the step differences above compound through
  Adam's normalised updates; measured: 1.1e-3 at step 1, 2.2e-3 at 2);
* remat on and off, and one checkpoint restart, are bit-exact inside the
  port (the same operations recomputed).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import linear as jlin
from repro.core import quantize as jq
from repro.kernels import ops as jops
from repro_torch.configs import get_config, reduced
from repro_torch.core import linear as tlin
from repro_torch.core import quantize as tq
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import load_jax_params
from repro_torch.tree import tree_paths

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_GRAD_RTOL = 2e-2
LOSS_ATOL = 5e-4
TRAJ_ATOL = 5e-3
GRAD_RTOL = {"dense": 5e-2, "qat": 0.15}


def _rng(seed):
    return np.random.default_rng(seed)


def _bf16_np(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# ---------------------------------------------------------------------------
# fake_quant and the QAT linear
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [-1, 0])
def test_fake_quant_matches_reference_including_clip_ties(axis):
    r = _rng(5)
    x = r.standard_normal((24, 16)).astype(np.float32)
    # an abs-max element of 127.0 makes its scale exactly 1, so the value
    # sits exactly on the bound: the tie case
    if axis == -1:
        x[3] = np.round(x[3] * 20)
        x[3, 5] = 127.0
    else:
        x[:, 3] = np.round(x[:, 3] * 20)
        x[5, 3] = 127.0
    g = r.standard_normal(x.shape).astype(np.float32)
    jy, vjp = jax.vjp(lambda a: jq.fake_quant(a, axis=axis), jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(g))
    jg = np.asarray(jg)
    tie = (3, 5) if axis == -1 else (5, 3)
    assert jg[tie] == np.float32(0.5) * g[tie]      # the reference's rule
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tq.fake_quant(xt, axis=axis)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(xt.grad.numpy(), jg)


def test_dequantize_matches_reference():
    x = _rng(6).standard_normal((8, 12)).astype(np.float32)
    want = jq.dequantize(jq.quantize(jnp.asarray(x), axis=0))
    got = tq.dequantize(tq.quantize(torch.from_numpy(x), axis=0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(3, 7, 64), (1, 128, 64)])
def test_qat_linear_matches_reference(shape):
    r = _rng(shape[1])
    x = _bf16_np(r.standard_normal(shape) * 2).copy()
    w = _bf16_np(r.standard_normal((64, 96)) * 0.1).copy()
    gy = r.standard_normal(shape[:-1] + (96,)).astype(np.float32)

    def jfn(x, w):
        return jlin.linear_apply({"w": w}, x, mode="qat") \
            .astype(jnp.float32)

    jy, vjp = jax.vjp(jfn, jnp.asarray(x, jnp.bfloat16),
                      jnp.asarray(w, jnp.bfloat16))
    jgx, jgw = vjp(jnp.asarray(gy))
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    wt = torch.from_numpy(w).bfloat16().requires_grad_(True)
    y = tlin.linear_apply({"w": wt}, xt, mode="qat")
    assert y.dtype == torch.bfloat16
    y.float().backward(torch.from_numpy(gy))
    np.testing.assert_allclose(y.detach().float().numpy(), np.asarray(jy),
                               rtol=2 ** -7, atol=1e-6)
    for got, want in ((xt.grad, jgx), (wt.grad, jgw)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=2 ** -7, atol=1e-6)


# ---------------------------------------------------------------------------
# Flash backward (plain) against jax.grad of the reference's flash_mha
# ---------------------------------------------------------------------------

BWD_CASES = [
    dict(bkv=2, group=1, sq=13, window=0, softcap=0.0, d=16),
    dict(bkv=1, group=2, sq=40, window=0, softcap=0.0, d=32),
    dict(bkv=2, group=2, sq=21, window=7, softcap=0.0, d=16),
    dict(bkv=1, group=2, sq=17, window=0, softcap=20.0, d=8),
]


def _bwd_inputs(case):
    r = _rng(case["sq"] + case["d"])
    bh = case["bkv"] * case["group"]
    q = r.standard_normal((bh, case["sq"], case["d"])).astype(np.float32)
    k = r.standard_normal((case["bkv"], case["sq"], case["d"])) \
        .astype(np.float32)
    v = r.standard_normal((case["bkv"], case["sq"], case["d"])) \
        .astype(np.float32)
    do = r.standard_normal((bh, case["sq"], case["d"])).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_backward_matches_reference(case, dtype):
    q, k, v, do = _bwd_inputs(case)
    scale = case["d"] ** -0.5
    args = (scale, True, case["window"], case["softcap"], case["group"])
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))

    def jloss(q, k, v):
        o = jops.flash_mha(q, k, v, *args, True)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(do))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_(True)
              for a in (q, k, v)]
    o = ops.flash_mha(*leaves, *args)
    got = torch.autograd.grad((o.float() * torch.from_numpy(do)).sum(),
                              leaves)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == tdt and g.shape == w.shape, name
        g = g.float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        if dtype == "f32":
            np.testing.assert_allclose(g, w, atol=F32_TOL, rtol=F32_TOL,
                                       err_msg=f"d{name}")
        else:
            assert _rel(g, w) <= BF16_GRAD_RTOL, (name, _rel(g, w))


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_backward_plain_is_the_forward_gradient(case):
    """The plain backward equals autograd through the plain forward (f32:
    the same function differentiated by hand and by the tape)."""
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(case))
    kw = dict(scale=case["d"] ** -0.5, causal=True, window=case["window"],
              softcap=case["softcap"], group=case["group"])
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = fa.flash_attention_fwd_plain(*leaves, **kw)
    want = torch.autograd.grad((o * do).sum(), leaves)
    dmat = (do * o.detach()).sum(-1)
    got = fa.flash_attention_bwd_plain(q, k, v, lse.detach(), do, dmat, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=F32_TOL, rtol=F32_TOL)


def test_flash_bwd_cuda_wrapper_refuses_cpu_tensors():
    q = torch.zeros((2, 4, 16), dtype=torch.bfloat16)
    lse = torch.zeros((2, 4))
    with pytest.raises(TypeError, match="CUDA"):
        fa.flash_attention_bwd_cuda(q, q, q, lse, q, lse, scale=1.0)


# ---------------------------------------------------------------------------
# Loss, schedule, data, optimizer, compression
# ---------------------------------------------------------------------------

def test_cross_entropy_and_z_loss_match_reference():
    from repro.train import step as jstep
    from repro_torch.train import step as tstep
    r = _rng(7)
    logits = (r.standard_normal((3, 9, 50)) * 3).astype(np.float32)
    labels = r.integers(0, 50, (3, 9))
    labels[0, :4] = -1
    labels[2, -1] = -1
    for fn in ("cross_entropy", "z_loss"):
        want = float(getattr(jstep, fn)(jnp.asarray(logits),
                                        jnp.asarray(labels)))
        got = float(getattr(tstep, fn)(torch.from_numpy(logits),
                                       torch.from_numpy(labels)))
        assert math.isclose(got, want, rel_tol=1e-6), (fn, got, want)


def test_schedules_match_reference():
    from repro.optim import schedule as jsched
    from repro_torch.optim import schedule as tsched
    for step in (0, 1, 5, 9, 10, 11, 57, 99, 100, 150):
        want = float(jsched.warmup_cosine(step, warmup=10, total=100))
        got = float(tsched.warmup_cosine(torch.tensor(step, dtype=torch.int32),
                                         warmup=10, total=100))
        assert math.isclose(got, want, rel_tol=1e-6, abs_tol=1e-7), step
        assert float(tsched.warmup_constant(step, warmup=10)) == \
            float(jsched.warmup_constant(step, warmup=10))


@pytest.mark.parametrize("host_id,n_hosts", [(0, 1), (1, 2), (3, 4)])
def test_synthetic_batches_equal_reference(host_id, n_hosts):
    from repro.data import DataConfig as JDataConfig
    from repro.data import SyntheticLM as JSyntheticLM
    from repro_torch.data import DataConfig, SyntheticLM
    kw = dict(vocab_size=151936, seq_len=24, global_batch=8, seed=99)
    jd = JSyntheticLM(JDataConfig(**kw), host_id, n_hosts)
    td = SyntheticLM(DataConfig(**kw), host_id, n_hosts, device="cpu")
    for step in (0, 1, 7, 1000):
        jb, tb = jd.batch(step), td.batch(step)
        for key in ("tokens", "labels"):
            assert tb[key].dtype == torch.int64
            np.testing.assert_array_equal(tb[key].numpy(),
                                          np.asarray(jb[key]))


def _opt_tree(seed):
    r = _rng(seed)
    return {"a": {"w": _bf16_np(r.standard_normal((6, 5)))},
            "b": [_bf16_np(r.standard_normal((4, 3, 2))),
                  r.standard_normal((7,)).astype(np.float32)]}


@pytest.mark.parametrize("quantize_moments", [False, True])
def test_adamw_matches_reference(quantize_moments):
    from repro.optim import AdamWConfig as JCfg
    from repro.optim import adamw_init as jinit
    from repro.optim import adamw_update as jupdate
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    kw = dict(lr=1e-2, grad_clip=0.5, quantize_moments=quantize_moments)
    params = _opt_tree(0)

    def to_j(t):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.bfloat16 if a.ndim >= 2
                                  else jnp.float32), t)

    def to_t(t):
        return jax.tree_util.tree_map(
            lambda a: torch.from_numpy(np.array(a)).to(
                torch.bfloat16 if a.ndim >= 2 else torch.float32), t)

    jp, tp = to_j(params), to_t(params)
    js, ts = jinit(jp, JCfg(**kw)), adamw_init(tp, AdamWConfig(**kw))
    for step in range(3):
        grads = _opt_tree(10 + step)
        jp, js, jm = jupdate(jp, to_j(grads), js, JCfg(**kw),
                             jnp.float32(0.7))
        tp, ts, tm = adamw_update(tp, to_t(grads), ts, AdamWConfig(**kw),
                                  torch.tensor(0.7))
        assert math.isclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                            rel_tol=1e-6)
        assert int(ts["step"]) == int(js["step"])
        jflat = dict(tree_paths(jax.tree_util.tree_map(
            lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32)),
            {"p": jp, "mu": js["mu"], "nu": js["nu"]})))
        for path, t in tree_paths({"p": tp, "mu": ts["mu"], "nu": ts["nu"]}):
            got, want = t.float().numpy(), jflat[path]
            if path.startswith("p/") and t.dtype == torch.bfloat16:
                np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0,
                                           err_msg=path)
            elif path.endswith("/q"):
                assert np.abs(got - want).max() <= 1, path
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12,
                                           err_msg=path)


def test_compression_matches_reference():
    from repro.distributed import compression as jc
    from repro_torch.distributed import compression as tc
    tree = _opt_tree(3)
    jdeq, jpacked = jc.compress_tree_int8(
        jax.tree_util.tree_map(jnp.asarray, tree))
    tdeq, tpacked = tc.compress_tree_int8(
        jax.tree_util.tree_map(torch.from_numpy, tree))
    jflat = dict(tree_paths(jax.tree_util.tree_map(np.asarray,
                                                   {"d": jdeq,
                                                    "p": jpacked})))
    for path, t in tree_paths({"d": tdeq, "p": tpacked}):
        np.testing.assert_array_equal(t.numpy(), jflat[path], err_msg=path)
    ttree = jax.tree_util.tree_map(torch.from_numpy, tree)
    assert tc.compressed_bytes(ttree) == jc.compressed_bytes(
        jax.tree_util.tree_map(jnp.asarray, tree))
    deq, _, res = tc.ef_compress(ttree, None)
    for (_, d), (_, rr), (_, g) in zip(tree_paths(deq), tree_paths(res),
                                       tree_paths(ttree)):
        torch.testing.assert_close(d + rr, g.float(), rtol=0, atol=0)
    back = tc.decompress_tree_int8(tpacked)
    for (_, a), (_, b) in zip(tree_paths(back), tree_paths(tdeq)):
        assert torch.equal(a, b)


def test_fault_tolerance_matches_reference():
    from repro.runtime import fault_tolerance as jft
    from repro_torch.runtime import fault_tolerance as tft
    jh, th = jft.HeartbeatMonitor(3, 10.0), tft.HeartbeatMonitor(3, 10.0)
    js, ts = jft.StragglerDetector(3), tft.StragglerDetector(3)
    times = _rng(8).random((6, 3)) + np.array([0.1, 0.1, 0.6])
    for i, row in enumerate(times):
        for h, t in enumerate(row):
            if not (h == 1 and i > 2):
                jh.beat(h, 5.0 * i)
                th.beat(h, 5.0 * i)
            js.record(h, float(t))
            ts.record(h, float(t))
        assert js.stragglers() == ts.stragglers()
    assert jh.dead_hosts(30.0) == th.dead_hosts(30.0) == [1]
    assert jh.healthy(26.0) == th.healthy(26.0)
    assert js.rebalance_microbatches(16) == ts.rebalance_microbatches(16)


# ---------------------------------------------------------------------------
# One train step on reduced qwen3-4b
# ---------------------------------------------------------------------------

jmodel_init = jax.jit(jmodels.model_init, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _jax_params():
    cfg = jreduced(jget_config("qwen3-4b")).replace(n_layers=2)
    jp = jmodel_init(jax.random.PRNGKey(0), cfg)
    return jp, jax.tree_util.tree_map(
        lambda a: np.array(a.astype(jnp.float32)), jp)


def _batch(seed, b=2, s=16):
    toks = _rng(seed).integers(0, 256, (b, s)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)], 1)
    return toks, labels


def _jax_leaf(tree, path):
    """The reference leaf of a port path (its blocks are stacked)."""
    parts = path.split("/")
    node = tree
    if parts[0] == "layers":
        node, parts = tree["stack"]["blocks"]["0"], parts[2:] + [parts[1]]
    for p in parts:
        node = node[int(p)] if p.isdigit() else node[p]
    return node


@pytest.mark.parametrize("mode,impl", [("dense", "chunked"),
                                       ("dense", "flash"),
                                       ("qat", "chunked"), ("qat", "flash")])
def test_train_step_loss_and_grads_match_reference(mode, impl):
    from repro.train.step import TrainConfig as JTrainConfig
    from repro.train.step import make_loss_fn as jmake_loss_fn
    from repro_torch.train.step import (TrainConfig, accumulate_grads,
                                        make_loss_fn)
    over = dict(n_layers=2, quant_mode=mode, attn_impl=impl)
    jcfg = jreduced(jget_config("qwen3-4b")).replace(**over)
    jp, tree = _jax_params()
    toks, labels = _batch(0)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmake_loss_fn(jcfg, JTrainConfig()), has_aux=True))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    jgrads = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jgrads)
    tbatch = {"tokens": torch.from_numpy(toks).long(),
              "labels": torch.from_numpy(labels).long()}
    runs = {}
    for remat in (True, False):
        tcfg = reduced(get_config("qwen3-4b")).replace(remat=remat, **over)
        params = load_jax_params(tree, tcfg, device="cpu")
        runs[remat] = accumulate_grads(make_loss_fn(tcfg, TrainConfig()),
                                       params, tbatch, 1)
    loss, _, grads = runs[True]
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    assert torch.equal(loss, runs[False][0])
    paths = tree_paths(grads)
    assert len(paths) == 2 + 11 * 2          # embed, final norm, 2 layers
    for (path, g), (_, g_off) in zip(paths, tree_paths(runs[False][2])):
        assert torch.equal(g, g_off), path            # remat is exact
        want = _jax_leaf(jgrads, path)
        assert g.dtype == (torch.float32 if path.endswith("scale")
                           else torch.bfloat16)
        err = _rel(g.float().numpy(), want)
        assert err <= GRAD_RTOL[mode], (path, err)


def test_microbatches_match_single_batch():
    from repro_torch.train.step import (TrainConfig, accumulate_grads,
                                        make_loss_fn)
    _, tree = _jax_params()
    tcfg = reduced(get_config("qwen3-4b")).replace(n_layers=2,
                                                   quant_mode="qat")
    params = load_jax_params(tree, tcfg, device="cpu")
    toks, labels = _batch(1, b=4)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    loss_fn = make_loss_fn(tcfg, TrainConfig())
    l1, _, g1 = accumulate_grads(loss_fn, params, batch, 1)
    l2, _, g2 = accumulate_grads(loss_fn, params, batch, 2)
    # every microbatch has the same number of labelled positions, so the
    # mean of the halves' losses is the whole batch's loss
    assert math.isclose(float(l1), float(l2), rel_tol=1e-5)
    for (path, a), (_, b) in zip(tree_paths(g1), tree_paths(g2)):
        assert b.dtype == torch.float32
        # micro=1 grads are rounded to the parameters' dtype (bf16)
        assert _rel(a.float().numpy(), b.numpy()) <= 1e-2, path


def test_train_step_applies_grad_compression():
    """``compress_grads`` hands the optimizer the int8 round trip of the
    gradients (``compress_tree_int8``), and nothing else changes."""
    from repro_torch.distributed.compression import compress_tree_int8
    from repro_torch.models import model_init
    from repro_torch.optim import adamw_init, adamw_update, warmup_cosine
    from repro_torch.train.step import (TrainConfig, accumulate_grads,
                                        make_loss_fn, make_train_step)
    cfg = reduced(get_config("qwen3-4b")).replace(n_layers=1)
    tcfg = TrainConfig(compress_grads=True, warmup_steps=0, total_steps=4)
    toks, labels = _batch(2)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    got = model_init(cfg, seed=3, device="cpu")
    got, got_state, got_m = make_train_step(cfg, tcfg)(
        got, adamw_init(got, tcfg.optimizer), batch)
    want = model_init(cfg, seed=3, device="cpu")
    _, _, grads = accumulate_grads(make_loss_fn(cfg, tcfg), want, batch, 1)
    want, want_state, want_m = adamw_update(
        want, compress_tree_int8(grads)[0], adamw_init(want, tcfg.optimizer),
        tcfg.optimizer, warmup_cosine(0, warmup=0, total=4))
    assert torch.equal(got_m["grad_norm"], want_m["grad_norm"])
    for tree_a, tree_b in ((got, want), (got_state, want_state)):
        for (path, a), (_, b) in zip(tree_paths(tree_a), tree_paths(tree_b)):
            assert torch.equal(a, b), path


# ---------------------------------------------------------------------------
# Trainer, checkpoint restart, launcher
# ---------------------------------------------------------------------------

def _trainer(steps, ckpt_dir=None, every=50, quant="dense", total=None):
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = reduced(get_config("qwen3-4b")).replace(n_layers=2,
                                                  quant_mode=quant)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-2),
                       total_steps=total or steps, warmup_steps=1)
    rcfg = TrainerConfig(steps=steps, log_every=1, checkpoint_dir=ckpt_dir,
                         checkpoint_every=every)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    return cfg, tcfg, rcfg, dcfg, Trainer(cfg, tcfg, rcfg, dcfg,
                                          device="cpu")


def test_trainer_trajectory_matches_reference(capsys):
    from repro.data import DataConfig as JDataConfig
    from repro.optim import AdamWConfig as JAdamWConfig
    from repro.train.step import TrainConfig as JTrainConfig
    from repro.train.trainer import Trainer as JTrainer
    from repro.train.trainer import TrainerConfig as JTrainerConfig
    from repro_torch.optim import adamw_init
    cfg, tcfg, rcfg, dcfg, trainer = _trainer(3, quant="qat")
    jcfg = jreduced(jget_config("qwen3-4b")).replace(n_layers=2,
                                                     quant_mode="qat")
    jtrainer = JTrainer(
        jcfg, JTrainConfig(optimizer=JAdamWConfig(lr=1e-2), total_steps=3,
                           warmup_steps=1),
        JTrainerConfig(steps=3, log_every=1),
        JDataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2))
    tree = jax.tree_util.tree_map(lambda a: np.array(a.astype(jnp.float32)),
                                  jtrainer.params)
    trainer.params = load_jax_params(tree, cfg, device="cpu")
    trainer.opt_state = adamw_init(trainer.params, tcfg.optimizer)
    want = jtrainer.run()
    got = trainer.run()
    assert [h["step"] for h in got] == [0, 1, 2]
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= TRAJ_ATOL, (g, w)
        assert math.isclose(g["lr"], w["lr"], rel_tol=1e-6)
        assert math.isclose(g["grad_norm"], w["grad_norm"], rel_tol=0.05)


def test_checkpoint_restart_is_bit_exact(tmp_path):
    *_, straight = _trainer(4, quant="qat")
    full = straight.run()
    *_, first = _trainer(2, ckpt_dir=str(tmp_path), every=2, quant="qat",
                         total=4)
    first.run()
    assert first.ckpt.latest_step() == 2
    *_, resumed = _trainer(4, ckpt_dir=str(tmp_path), every=50, quant="qat")
    assert resumed.start_step == 2
    rest = resumed.run()
    assert [h["step"] for h in rest] == [2, 3]
    for a, b in zip(rest, full[2:]):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    for (path, a), (_, b) in zip(tree_paths(resumed.params),
                                 tree_paths(straight.params)):
        assert torch.equal(a, b), path
    for (path, a), (_, b) in zip(tree_paths(resumed.opt_state),
                                 tree_paths(straight.opt_state)):
        assert torch.equal(a, b), path


def test_checkpointer_keeps_layout_and_refuses_mismatch(tmp_path):
    from repro_torch.checkpoint import Checkpointer
    state = {"w": torch.randn(3, 4).bfloat16(), "n": [torch.arange(5)],
             "s": torch.zeros((), dtype=torch.int32)}
    ck = Checkpointer(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        ck.save(step, state, mesh_shape=(1, 1))
    ck.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2",
                                                          "step_3"]
    back, step = ck.restore(state, mesh_shape=(1, 1))
    assert step == 3 and back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], state["w"])
    with pytest.raises(NotImplementedError):
        ck.restore(state, mesh_shape=(2, 1))
    with pytest.raises(ValueError, match="mismatch"):
        ck.restore({"w": state["w"]}, mesh_shape=(1, 1))


def test_launcher_runs_on_cpu(tmp_path, capsys):
    import json

    from repro_torch.launch.train import main
    out = tmp_path / "hist.json"
    assert main(["--reduced", "--steps", "2", "--device", "cpu", "--seq",
                 "16", "--batch", "2", "--quant", "qat", "--out",
                 str(out)]) == 0
    hist = json.loads(out.read_text())
    assert len(hist) == 2 and all(math.isfinite(h["loss"]) for h in hist)


def test_trainer_defaults_to_cuda():
    from repro_torch.data import DataConfig
    from repro_torch.train import TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch import resolve_device
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    cfg = reduced(get_config("qwen3-4b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, TrainConfig(), TrainerConfig(steps=1),
                DataConfig(vocab_size=256, seq_len=8, global_batch=2))
