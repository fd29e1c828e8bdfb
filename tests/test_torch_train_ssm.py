"""Port parity for training the Mamba2 SSD families: reduced mamba2-780m
(two mixer layers, no FFN) and jamba-v0.1-52b (the whole 8-layer block:
7 mamba mixers, attention at index 4, MoE on the odd layers), random
weights from the reference's seed through the weight bridge; the SSD
scan's backward and ``_segsum``'s mask at module level; a reduced jamba
``Trainer`` trajectory against the reference's ``Trainer``; the launcher
on both archs; the layer bisection of reduced jamba's w8a8 prefill.

* Loss and gradients against ``jax.value_and_grad`` of the reference's
  ``make_loss_fn`` compiled without excess precision, in ``dense`` and
  ``qat``, with the bounds of ``test_torch_train_families.py`` (LOSS_ATOL,
  GRAD_RTOL), remat on equal to remat off bit for bit, and every jamba
  MoE call's top-k margin above the routing tie bound (the token seed is
  pinned where it is: one sequence of 16 tokens, the four MoE layers'
  64 routings).  Sequences span several chunks (``ssm_chunk`` 16 over 48
  tokens for mamba2, 8 over 16 for jamba).  Measured on a CPU: losses at
  most 1e-6 apart, gradient leaves at most 2.7% (jamba's ``A_log``,
  ``dense``).
* ``_ssd_chunked`` in f32 over 4 chunks and ``_segsum``: gradients
  within SSD_RTOL = 1e-5 of ``jax.grad`` of the reference's (the same f32
  function; the frameworks sum ``cumsum`` and the products in other
  orders); the ``-inf`` mask gives exact zeros, never NaN.
* The jamba ``Trainer`` (QAT, lr 1e-3, 3 steps) against the reference's
  ``Trainer`` with its step compiled without excess precision, both
  routing alike at every step: see the test.  It found that the port's
  AdamW left the block layers' vectors undecayed where the reference,
  whose blocks are stacked into matrices, decays them
  (``train.step.weight_decay_mask`` now marks them).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_model as tm
import test_torch_train_families as tf
import torch_layer_bisect as lb
from repro import models as jmodels
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import mamba as jmamba
from repro_torch.configs import get_config, reduced
from repro_torch.models import load_jax_params
from repro_torch.models import mamba as tmamba

torch.set_num_threads(1)

MAMBA2 = "mamba2-780m"
JAMBA = "jamba-v0.1-52b"
SSD_RTOL = 1e-5

# (arch, n_layers, batch, seq, token seed, config overrides)
CASES = [(MAMBA2, 2, 2, 48, 0, {}),
         (JAMBA, 8, 1, 16, 1, dict(ssm_chunk=8))]


@pytest.mark.parametrize("mode", ["dense", "qat"])
@pytest.mark.parametrize("arch,n_layers,b,s,seed,over", CASES,
                         ids=[c[0] for c in CASES])
def test_train_loss_and_grads_match_reference(monkeypatch, arch, n_layers,
                                              b, s, seed, over, mode):
    tf.check_against_reference(arch, mode, "flash", seed=seed, b=b, s=s,
                               n_layers=n_layers, cfg_over=over,
                               monkeypatch=monkeypatch)


# ---------------------------------------------------------------------------
# The SSD scan and its mask
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, b=2, s=32, h=4, p=8, n=16):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, s, h, p)).astype(np.float32),
            (r.random((b, s, h)) * 0.5 + 0.01).astype(np.float32),
            -np.arange(1, h + 1, dtype=np.float32),
            r.standard_normal((b, s, h, n)).astype(np.float32),
            r.standard_normal((b, s, h, n)).astype(np.float32),
            r.standard_normal((b, s, h, p)).astype(np.float32),
            r.standard_normal((b, h, n, p)).astype(np.float32))


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_scan_backward_matches_reference(chunk):
    """Gradients of <y, gy> + <final state, gs> with respect to x, dt,
    A, B and C over 4 chunks of 8 (and one of 32)."""
    x, dt, a, bb, cc, gy, gs = _ssd_inputs(chunk)

    def jloss(*args):
        y, st = jmamba._ssd_chunked(*args, chunk)
        return jnp.sum(y * gy) + jnp.sum(st * gs)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        x, dt, a, bb, cc)
    ts = [torch.from_numpy(v).requires_grad_(True)
          for v in (x, dt, a, bb, cc)]
    y, st = tmamba._ssd_chunked(*ts, chunk)
    (torch.sum(y * torch.from_numpy(gy))
     + torch.sum(st * torch.from_numpy(gs))).backward()
    for name, t, w in zip("x dt A B C".split(), ts, want):
        assert torch.isfinite(t.grad).all(), name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=SSD_RTOL,
                                   atol=SSD_RTOL * np.abs(w).max(),
                                   err_msg=name)


def test_segsum_mask_gives_zero_gradients_not_nan():
    """exp(segsum(a)) above the diagonal is exp(-inf) = 0; its gradient
    there is an exact zero in both packages, and the values below agree
    with the reference's."""
    a = -np.random.default_rng(3).random((3, 8)).astype(np.float32)
    w = np.random.default_rng(4).standard_normal((3, 8, 8)) \
        .astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jnp.exp(jmamba._segsum(v)) * w))(a)
    at = torch.from_numpy(a).requires_grad_(True)
    seg = tmamba._segsum(at)
    seg.retain_grad()
    torch.sum(torch.exp(seg) * torch.from_numpy(w)).backward()
    assert torch.isfinite(at.grad).all()
    upper = ~torch.ones((8, 8), dtype=torch.bool).tril()
    assert torch.equal(seg.grad[:, upper], torch.zeros_like(
        seg.grad[:, upper]))
    assert torch.isinf(seg.detach()[:, upper]).all()
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(want),
                               rtol=SSD_RTOL, atol=SSD_RTOL)


# ---------------------------------------------------------------------------
# Trainer, launcher, bisection
# ---------------------------------------------------------------------------

def jamba_trajectory(data_seed, monkeypatch):
    """3 steps of a reduced jamba QAT ``Trainer`` (lr 1e-3, one sequence of 8
    tokens in two chunks a step) and the reference's ``Trainer`` from the
    same weights, its step compiled without excess precision.  Returns
    both histories and both packages' expert choices, call by call (the
    forward calls; the port's remat recomputes are left out)."""
    from repro.data import DataConfig as JDataConfig
    from repro.optim import AdamWConfig as JAdamWConfig
    from repro.train import step as jstep
    from repro.train.trainer import Trainer as JTrainer
    from repro.train.trainer import TrainerConfig as JTrainerConfig
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    steps = 3
    over = dict(quant_mode="qat", attn_impl="flash", ssm_chunk=4)
    data = dict(seq_len=8, global_batch=1, seed=data_seed)
    cfg = reduced(get_config(JAMBA)).replace(**over)
    jcfg = jreduced(jget_config(JAMBA)).replace(**over)
    jtcfg = jstep.TrainConfig(optimizer=JAdamWConfig(lr=1e-3),
                              total_steps=steps, warmup_steps=1)
    jtrainer = JTrainer(jcfg, jtcfg, JTrainerConfig(steps=steps,
                                                    log_every=1),
                        JDataConfig(vocab_size=cfg.vocab_size, **data))
    jtrainer.step_fn = _jamba_step(jcfg, jtcfg)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3), total_steps=steps,
                       warmup_steps=1)
    trainer = Trainer(cfg, tcfg, TrainerConfig(steps=steps, log_every=1),
                      DataConfig(vocab_size=cfg.vocab_size, **data),
                      device="cpu")
    tree = jax.tree_util.tree_map(lambda a: np.array(a.astype(jnp.float32)),
                                  jtrainer.params)
    trainer.params = load_jax_params(tree, cfg, device="cpu")
    trainer.opt_state = adamw_init(trainer.params, tcfg.optimizer)
    _REF_ROUTES.clear()
    want = jtrainer.run()
    routes = tf.PortRoutes(monkeypatch)
    got = trainer.run()
    n_moe = sum(spec.ffn == "moe" for spec in cfg.layer_specs)

    def forward_calls(calls):
        # a step's calls: the forward's, then remat's recomputes
        return [calls[i] for st in range(steps)
                for i in range(2 * n_moe * st, 2 * n_moe * st + n_moe)]

    return (got, want, routes, forward_calls(routes.top_e),
            forward_calls(list(_REF_ROUTES)))


_REF_ROUTES = []


@functools.lru_cache(maxsize=None)
def _jamba_step(jcfg, jtcfg):
    """The reference's train step, compiled once, with its expert choices
    recorded through ``jax.debug.callback`` (called in the forward pass
    and again where remat recomputes it)."""
    from repro.models import moe as jmoe
    from repro.train import step as jstep
    orig = jmoe._route

    def route(params, cfg, xt):
        out = orig(params, cfg, xt)
        jax.debug.callback(lambda e: _REF_ROUTES.append(np.asarray(e)),
                           out[1])
        return out

    def step(*args):
        jmoe._route = route
        try:
            return jstep.make_train_step(jcfg, jtcfg)(*args)
        finally:
            jmoe._route = orig

    return tm.exact_jit(step)


def test_jamba_trainer_trajectory_matches_reference(monkeypatch):
    """Three QAT steps at lr 1e-3 from data seed 0, where every step
    routes every token to the same experts in both packages (the port's
    margins above the tie bound, and the reference's recorded choices
    equal to the port's).  The warmup's first step has lr 0, so steps 0
    and 1 run on the same weights and hold LOSS_ATOL; step 2 follows one
    update, which moves the loss by ~0.4 while the two packages' updates
    differ by their gradients' rounding (GRAD_RTOL): its change from step
    1 is held within GRAD_RTOL of the reference's (measured: 2.9%)."""
    got, want, routes, port, ref = jamba_trajectory(0, monkeypatch)
    assert routes.min_margin() > tf.ROUTE_TIE, routes.margins
    assert len(ref) == len(port) == 12
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(np.sort(a.numpy(), -1),
                                      np.sort(b, -1))
    assert [h["step"] for h in got] == [0, 1, 2]
    for g, w in zip(got[:2], want[:2]):
        assert abs(g["loss"] - w["loss"]) <= tf.LOSS_ATOL, (g, w)
        assert abs(g["aux"] - w["aux"]) <= tf.LOSS_ATOL, (g, w)
    moved, want_moved = (got[2]["loss"] - got[1]["loss"],
                         want[2]["loss"] - want[1]["loss"])
    print(f"step 2: loss moved {moved} (reference {want_moved})")
    assert abs(moved - want_moved) <= tf.GRAD_RTOL * abs(want_moved)
    for g, w in zip(got, want):
        assert g["aux"] > 0
        assert math.isclose(g["lr"], w["lr"], rel_tol=1e-6)
        assert math.isclose(g["grad_norm"], w["grad_norm"],
                            rel_tol=tf.GRAD_RTOL)


@pytest.mark.parametrize("arch", [MAMBA2, JAMBA])
def test_launcher_trains_ssm_archs_on_cpu(tmp_path, arch):
    hist = tf.run_launcher(tmp_path, "--arch", arch, "--quant", "qat")
    assert all((h["aux"] > 0) == (arch == JAMBA) for h in hist)


def test_jamba_w8a8_layer_states_equal_reference():
    """The bisection that found jamba's w8a8 residue, kept as a check:
    weight seed 1, prompt seed 0 (the case that was 0.0254 off), every
    layer's prefill output equal to the reference's prefix compiled on
    its own."""
    over = dict(quant_mode="w8a8_nibble", attn_impl="flash")
    jcfg = jreduced(jget_config(JAMBA)).replace(**over)
    tcfg = reduced(get_config(JAMBA)).replace(**over)
    jp = jax.jit(jmodels.model_init, static_argnums=1)(
        jax.random.PRNGKey(1), jcfg)
    tp = load_jax_params(
        jax.tree_util.tree_map(lambda a: np.array(a.astype(jnp.float32)),
                               jp), tcfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, 256, (1, 11)) \
        .astype(np.int32)
    want = lb.reference_prefix_outputs(jp, jcfg, toks)
    got = lb.port_layer_outputs(tp, tcfg, toks)
    assert len(got) == len(want) == 8
    assert lb.first_difference(got, want) is None
