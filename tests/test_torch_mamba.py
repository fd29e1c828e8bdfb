"""Port parity for the Mamba2 SSD mixer (``repro_torch.models.mamba``) and
the engine's rules for models that carry one (reduced mamba2-780m: 2
mixer layers, no FFN; reduced jamba-v0.1-52b: 8 layers, one attention,
four MoE).

* Mixer, against the reference (``repro.models.mamba``, weights from its
  ``mamba_init`` through numpy, the same numpy inputs): ``mamba_apply``
  at ``ssm_chunk`` 4 and 8 over S = 16 (the multi-chunk loop), in ``dense`` and ``w8a8_nibble`` (the reference on its ``xla``
  backend, the port on its plain ``torch`` one), at reduced width and at
  the two other contraction orders of the reference's einsums (N < P, as
  jamba's state 16 and head 64; N > P, as mamba2's state 128 and head
  64); ``mamba_step`` over a sequence; prefill then decode.  Outputs are
  bf16: OUT_ATOL is one bf16 ulp at |y| in [2, 4) (measured on a CPU: at
  most 1.2e-7 in ``dense``, equal in ``w8a8_nibble``); the f32 state
  within STATE_RTOL of its largest entry (measured: at most 3.6e-7; the
  frameworks round ``exp``, ``cumsum`` and the products' sums in other
  orders); the bf16 conv history (the last ``in_proj`` rows) equal in
  ``w8a8_nibble`` (integer product, the same epilogue) and within one
  bf16 ulp (CONV_RTOL) in ``dense``, where the two bf16 matmuls sum in
  other orders (measured: 3.5e-4 of the largest entry).
* The reference's own invariants (``tests/test_moe_mamba.py``), held in
  the port with the reference's tolerances: chunk invariance, decode
  equals the full sequence, prefill state continues decode, a bounded
  state.
* The bridge keeps ``A_log``, ``D`` and ``dt_bias`` f32, bit for bit;
  ``model_init`` quantizes ``in_proj`` and ``out_proj``; reduced jamba's
  w8a8 prefill logits equal the reference's over four weight seeds.
* The reference runs compiled without excess precision
  (``test_torch_model.exact_jit``).
* Engine, inside the port: paged equals dense (jamba, prompts 3 and 6,
  as the reference's ``tests/test_paging.py``), an overcommitted
  incremental pool that preempts and replays equals a reserve pool,
  a prompt longer than ``prefill_len`` is served, the prefill counts one
  signature per distinct prompt length, the four refusals, and
  ``cache_token_bytes`` counts no recurrent state; the launcher serves
  ``--arch mamba2-780m`` on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_model as tmodel
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import mamba as jm
from repro_torch.configs import get_config, reduced
from repro_torch.models import (
    decode_step,
    init_caches,
    load_jax_params,
    merge_slot_caches,
    model_init,
    prefill,
)
from repro_torch.models import mamba as tm
from repro_torch.serve import Engine, ServeConfig

torch.set_num_threads(1)

OUT_ATOL = 2.0 ** -6
STATE_RTOL = 1e-5
CONV_RTOL = 2.0 ** -7

MAMBA2 = "mamba2-780m"
JAMBA = "jamba-v0.1-52b"

# The reference mixer runs compiled without excess precision
# (``test_torch_model.exact_jit``); with excess precision its w8a8 outputs
# came out up to 0.045 from its own eager run at |y| ~ 3.
jmamba_apply = tmodel.exact_jit(jm.mamba_apply, static_argnums=1,
                                static_argnames=("return_cache",))
jmamba_step = tmodel.exact_jit(jm.mamba_step, static_argnums=1)

# the reduced widths (N = P = 16), and the two other contraction orders
DIMS = {"reduced": {}, "n<p": {"ssm_head_dim": 32},
        "n>p": {"ssm_state": 32}}


def _cfgs(chunk=8, mode="dense", dims="reduced"):
    over = dict(ssm_chunk=chunk, quant_mode=mode, **DIMS[dims])
    return (jreduced(jget_config(MAMBA2)).replace(**over),
            reduced(get_config(MAMBA2)).replace(**over))


def _to_torch(node):
    """A reference mixer's numpy leaves as the port keeps them."""
    f32 = ("A_log", "D", "dt_bias", "scale")
    return {k: _to_torch(v) if isinstance(v, dict) else
            torch.as_tensor(v).to(torch.float32 if k in f32
                                  else torch.bfloat16)
            for k, v in node.items()}


def _params(jcfg):
    jp = jm.mamba_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.array(a.astype(jnp.float32)),
                                  jp)
    return jp, _to_torch(tree)


def _x(d, s=16, b=2, seed=1, scale=0.3):
    x = (np.random.default_rng(seed).standard_normal((b, s, d)) * scale) \
        .astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close_out(got, want):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=OUT_ATOL, rtol=0)


def _close_cache(got, want, mode):
    if mode == "dense":
        np.testing.assert_allclose(_f32(got["conv"]), _f32(want["conv"]),
                                   rtol=CONV_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(_f32(got["conv"]), _f32(want["conv"]))
    w = _f32(want["ssm"])
    np.testing.assert_allclose(_f32(got["ssm"]), w, rtol=0,
                               atol=STATE_RTOL * np.abs(w).max())


# ---------------------------------------------------------------------------
# The mixer against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", list(DIMS))
@pytest.mark.parametrize("mode", ["dense", "w8a8_nibble"])
@pytest.mark.parametrize("chunk", [4, 8])
def test_mamba_apply_matches_reference(chunk, mode, dims):
    jcfg, tcfg = _cfgs(chunk, mode, dims)
    jp, tp = _params(jcfg)
    xj, xt = _x(jcfg.d_model)
    want, jc = jmamba_apply(jp, jcfg, xj, return_cache=True)
    got, tc = tm.mamba_apply(tp, tcfg, xt, return_cache=True)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert tc["conv"].dtype == torch.bfloat16
    assert tc["ssm"].dtype == torch.float32
    _close_out(got, want)
    _close_cache(tc, jc, mode)


@pytest.mark.parametrize("dims", list(DIMS))
@pytest.mark.parametrize("mode", ["dense", "w8a8_nibble"])
def test_mamba_step_matches_reference(mode, dims):
    """16 decode steps from a zero state; the port's state is written into
    the cache tensors in place (same storage every step)."""
    jcfg, tcfg = _cfgs(8, mode, dims)
    jp, tp = _params(jcfg)
    xj, xt = _x(jcfg.d_model, seed=2)
    jc = jm.init_mamba_cache(jcfg, 2)
    tc = tm.init_mamba_cache(tcfg, 2, "cpu")
    ptrs = {k: v.data_ptr() for k, v in tc.items()}
    for t in range(16):
        want, jc = jmamba_step(jp, jcfg, xj[:, t:t + 1], jc)
        got, out_cache = tm.mamba_step(tp, tcfg, xt[:, t:t + 1], tc)
        assert out_cache is tc
        _close_out(got, want)
        _close_cache(tc, jc, mode)
    assert {k: v.data_ptr() for k, v in tc.items()} == ptrs


def test_prefill_then_decode_matches_reference():
    """The first 8 tokens through ``mamba_apply`` (two chunks of 4), the
    next 8 through ``mamba_step`` from its cache, in both packages."""
    jcfg, tcfg = _cfgs(4)
    jp, tp = _params(jcfg)
    xj, xt = _x(jcfg.d_model, seed=4)
    _, jc = jmamba_apply(jp, jcfg, xj[:, :8], return_cache=True)
    _, tc = tm.mamba_apply(tp, tcfg, xt[:, :8], return_cache=True)
    for t in range(8, 16):
        want, jc = jmamba_step(jp, jcfg, xj[:, t:t + 1], jc)
        got, tc = tm.mamba_step(tp, tcfg, xt[:, t:t + 1], tc)
        _close_out(got, want)
    _close_cache(tc, jc, "dense")


def test_step_refuses_more_than_one_token():
    _, tcfg = _cfgs()
    _, tp = _params(_cfgs()[0])
    with pytest.raises(ValueError, match="one token"):
        tm.mamba_step(tp, tcfg, _x(tcfg.d_model, s=2)[1],
                      tm.init_mamba_cache(tcfg, 2, "cpu"))


# ---------------------------------------------------------------------------
# The reference's invariants, in the port
# ---------------------------------------------------------------------------

def _port_mixer(chunk=8, seed=0):
    cfg = reduced(get_config(MAMBA2)).replace(ssm_chunk=chunk)
    gen = torch.Generator().manual_seed(seed)
    return cfg, tm.mamba_init(cfg, generator=gen, device="cpu")


def _port_x(cfg, s=16, seed=1, scale=0.3):
    return _x(cfg.d_model, s=s, b=2, seed=seed, scale=scale)[1]


def test_ssd_chunk_invariance():
    """Any chunk size gives the same output (the reference's 0.05)."""
    x = _port_x(_port_mixer()[0], s=32)
    outs = []
    for chunk in (4, 8, 16, 32):
        cfg, params = _port_mixer(chunk)
        outs.append(tm.mamba_apply(params, cfg, x)[0].float().numpy())
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=0.05, atol=0.05)


def test_ssd_decode_matches_full_sequence():
    """Step-by-step recurrence equals the chunked scan (the reference's
    0.08)."""
    cfg, params = _port_mixer(8)
    x = _port_x(cfg, seed=3)
    full, _ = tm.mamba_apply(params, cfg, x)
    cache = tm.init_mamba_cache(cfg, 2, "cpu")
    steps = [tm.mamba_step(params, cfg, x[:, t:t + 1], cache)[0]
             for t in range(16)]
    np.testing.assert_allclose(torch.cat(steps, 1).float().numpy(),
                               full.float().numpy(), rtol=0.08, atol=0.08)


def test_ssd_prefill_state_continues_decode():
    cfg, params = _port_mixer(4)
    x = _port_x(cfg, seed=4)
    full, _ = tm.mamba_apply(params, cfg, x)
    _, cache = tm.mamba_apply(params, cfg, x[:, :8], return_cache=True)
    outs = [tm.mamba_step(params, cfg, x[:, t:t + 1], cache)[0]
            for t in range(8, 16)]
    np.testing.assert_allclose(torch.cat(outs, 1).float().numpy(),
                               full[:, 8:].float().numpy(), rtol=0.08,
                               atol=0.08)


@pytest.mark.parametrize("seed", range(10))
def test_ssd_state_bounded(seed):
    """Negative A makes the recurrence contractive: the state stays
    finite for inputs of scale 2."""
    cfg, params = _port_mixer(8)
    _, cache = tm.mamba_apply(params, cfg, _port_x(cfg, seed=seed,
                                                   scale=2.0),
                              return_cache=True)
    assert torch.isfinite(cache["ssm"]).all()


# ---------------------------------------------------------------------------
# Bridge and init
# ---------------------------------------------------------------------------

def test_bridge_keeps_mamba_scalars_f32_exactly():
    cfg = jreduced(jget_config(MAMBA2)).replace(n_layers=2)
    from repro import models as jmodels
    jp = jax.jit(jmodels.model_init, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)
    tree = jax.tree_util.tree_map(lambda a: np.array(a.astype(jnp.float32)),
                                  jp)
    tp = load_jax_params(tree, reduced(get_config(MAMBA2)).replace(
        n_layers=2), device="cpu")
    blk = jp["stack"]["blocks"]["0"]["mamba"]
    for i in range(2):
        mix = tp["layers"][i]["mamba"]
        assert set(tp["layers"][i]) == {"mixer_norm", "mamba"}
        for name in ("A_log", "D", "dt_bias"):
            assert mix[name].dtype == torch.float32
            np.testing.assert_array_equal(mix[name].numpy(),
                                          np.asarray(blk[name][i]))
        for name in ("conv_w", "conv_b"):
            assert mix[name].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                mix[name].float().numpy(),
                np.asarray(blk[name][i].astype(jnp.float32)))
        np.testing.assert_array_equal(
            mix["in_proj"]["w"].float().numpy(),
            np.asarray(blk["in_proj"]["w"][i].astype(jnp.float32)))
        assert mix["norm"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("wseed", range(4))
def test_jamba_w8a8_prefill_equals_eager_reference(wseed):
    """Reduced jamba in ``w8a8_nibble``, weight seed ``wseed`` x prompt
    seeds 0-1: the port's prefill logits equal the reference's compiled
    without excess precision (``test_torch_model.exact_jit``), bit for
    bit.  Named for when the port equalled the reference's eager run: it
    no longer does, since its int8 scales multiply by the f32 reciprocal
    of 127 as the jitted reference's do, and eager the reference divides.
    Printed beside it (``-s``): the jitted run with excess precision
    (0.074-0.152 from the exact one).  This test held LOGIT_ATOL while
    weight seed 1 (prompt seed 0) kept a residue of 0.0254 and weight
    seed 3 one of 0.00098; the layer bisection
    (``tests/torch_layer_bisect.py``) put the first in layer 3's MoE
    experts, one of 2816 ``w_gate`` outputs one bf16 ulp off (torch's
    bf16 CPU product sums K in another order than XLA's), and the second
    in the untied head.  Both now run ``models.layers.bf16_matmul``."""
    from repro import models as jmodels
    over = dict(quant_mode="w8a8_nibble", attn_impl="flash")
    jcfg = jreduced(jget_config(JAMBA)).replace(**over)
    jp = jax.jit(jmodels.model_init, static_argnums=1)(
        jax.random.PRNGKey(wseed), jcfg)
    tp = load_jax_params(
        jax.tree_util.tree_map(lambda a: np.array(a.astype(jnp.float32)),
                               jp),
        reduced(get_config(JAMBA)).replace(**over), device="cpu")
    jprefill = jax.jit(jmodels.prefill, static_argnums=1)
    for pseed in range(2):
        toks = np.random.default_rng(pseed).integers(0, 256, (1, 11))\
            .astype(np.int32)
        jitted = _f32(jprefill(jp, jcfg, jnp.asarray(toks))[0])
        exact = _f32(tmodel.jprefill(jp, jcfg, jnp.asarray(toks))[0])
        got = _f32(prefill(tp, reduced(get_config(JAMBA)).replace(**over),
                           torch.from_numpy(toks))[0])
        print(f"jamba w8a8 weight seed {wseed} prompt seed {pseed}: "
              f"|port - exact| {np.abs(got - exact).max()}, "
              f"|jit with excess precision - exact| "
              f"{np.abs(jitted - exact).max()}")
        np.testing.assert_array_equal(got, exact)


def test_model_init_follows_reference_rules_and_quantizes():
    cfg = reduced(get_config(MAMBA2)).replace(quant_mode="w8a8_nibble")
    p = model_init(cfg, seed=3, device="cpu")
    mix = p["layers"][0]["mamba"]
    h, d_in = cfg.ssm_heads, cfg.d_inner
    proj_out = 2 * d_in + 2 * cfg.ssm_groups * cfg.ssm_state + h
    assert mix["in_proj"]["qt8"].shape == (proj_out, cfg.d_model)
    assert mix["out_proj"]["qt8"].shape == (cfg.d_model, d_in)
    assert torch.equal(mix["A_log"], torch.log(torch.arange(1.0, h + 1)))
    assert torch.equal(mix["D"], torch.ones(h))
    assert torch.equal(mix["dt_bias"], torch.zeros(h))
    assert mix["conv_w"].dtype == torch.bfloat16
    assert not mix["conv_b"].any()
    assert torch.equal(mix["conv_w"],
                       model_init(cfg, seed=3, device="cpu")["layers"][0]
                       ["mamba"]["conv_w"])


# ---------------------------------------------------------------------------
# Model caches
# ---------------------------------------------------------------------------

def test_caches_keep_state_per_slot_beside_pools():
    cfg = reduced(get_config(JAMBA)).replace(cache_mode="paged",
                                             page_size=4)
    caches = init_caches(cfg, 3, 16, device="cpu")
    for spec, c in zip(cfg.layer_specs, caches):
        if spec.mixer == "mamba":
            assert c["conv"].shape == (3, cfg.conv_width - 1,
                                       cfg.d_inner + 2 * cfg.ssm_state)
            assert c["ssm"].shape == (3, cfg.ssm_heads, cfg.ssm_state,
                                      cfg.ssm_head_dim)
        else:
            assert c["k"].shape == (13, 4, cfg.n_kv_heads, cfg.head_dim)


def test_prefill_grows_sequence_leaves_only_and_decode_writes_in_place():
    cfg = reduced(get_config(JAMBA))
    params = model_init(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 5)))
    _, one, _ = prefill(params, cfg, toks, max_len=12)
    big = init_caches(cfg, 2, 12, device="cpu")
    for spec, c in zip(cfg.layer_specs, one):
        if spec.mixer == "mamba":
            assert c["conv"].shape[0] == 1 and c["ssm"].shape[0] == 1
        else:
            assert c["k"].shape[1] == 12
    merge_slot_caches(big, one, 1)
    ptrs = [{k: v.data_ptr() for k, v in c.items()} for c in big]
    ssm = big[0]["ssm"].clone()
    _, out = decode_step(params, cfg, torch.tensor([[3], [4]]), big,
                         torch.tensor([0, 5]))
    assert [{k: v.data_ptr() for k, v in c.items()} for c in out] == ptrs
    assert not torch.equal(big[0]["ssm"], ssm)


# ---------------------------------------------------------------------------
# Engine rules, inside the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba2():
    cfg = reduced(get_config(MAMBA2)).replace(n_layers=2)
    return cfg, model_init(cfg, seed=0, device="cpu")


@pytest.fixture(scope="module")
def jamba():
    cfg = reduced(get_config(JAMBA))
    return cfg, model_init(cfg, seed=0, device="cpu")


def _scfg(**over):
    kw = dict(batch=2, max_len=16, prefill_len=8, decode_chunk=3,
              cache_mode="paged", page_size=4)
    kw.update(over)
    return ServeConfig(**kw)


def _drive(cfg, params, prompts, budgets, scfg):
    engine = Engine(cfg, params, scfg, device="cpu")
    ids = [engine.submit(p, n) for p, n in zip(prompts, budgets)]
    done = engine.run()
    return engine, [done[i].tokens for i in ids]


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


SLAB = dict(cache_mode="dense", page_size=None)


@pytest.mark.parametrize("model", ["mamba2", "jamba"])
def test_paged_matches_dense(request, model):
    """``tests/test_paging.py::test_paged_mla_and_hybrid_match_dense`` in
    the port: exact-length prefill, per-slot state beside paged attention
    layers (jamba), bit for bit against the dense slab."""
    cfg, params = request.getfixturevalue(model)
    prompts = _prompts(cfg.vocab_size, (3, 6), seed=2)
    _, want = _drive(cfg, params, prompts, [4, 4], _scfg(**SLAB))
    engine, got = _drive(cfg, params, prompts, [4, 4], _scfg())
    assert got == want
    assert engine.leaked_pages() == 0


@pytest.mark.parametrize("model", ["mamba2", "jamba"])
def test_overcommit_replay_matches_reserve(request, model):
    """An overcommitted incremental pool preempts; the evicted requests
    re-prefill and replay their tokens through the decode chunk, which
    rebuilds the state: streams equal a reserve pool's (dense: rows are
    independent)."""
    cfg, params = request.getfixturevalue(model)
    prompts = _prompts(cfg.vocab_size, (4, 6, 5, 7), seed=4)
    budgets = [8] * 4
    over = dict(batch=3)
    _, want = _drive(cfg, params, prompts, budgets, _scfg(**over))
    replay, got = _drive(cfg, params, prompts, budgets, _scfg(
        alloc_mode="incremental", num_pages=7, **over))
    assert got == want
    assert replay.stats["preemptions"] >= 1
    assert replay.leaked_pages() == 0


def test_long_prompt_and_one_signature_per_length(mamba2):
    """A prompt longer than ``prefill_len`` is served (prefilled at its
    exact length), and the prefill counts one signature per distinct
    prompt length; the decode chunk keeps one."""
    cfg, params = mamba2
    prompts = _prompts(cfg.vocab_size, (11, 3, 5, 3), seed=6)
    engine, got = _drive(cfg, params, prompts, [4] * 4, _scfg(max_len=24))
    assert [len(t) for t in got] == [4] * 4
    assert engine.compile_counts == {"prefill": 3, "decode_chunk": 1}
    assert engine.stats["prefill_tokens"] == 22
    _, alone = _drive(cfg, params, prompts[:1], [4], _scfg(max_len=24))
    assert alone[0] == got[0]


def test_attention_model_still_refuses_long_prompt():
    cfg = reduced(get_config("yi-6b"))
    engine = Engine(cfg, model_init(cfg, seed=0, device="cpu"), _scfg(),
                    device="cpu")
    with pytest.raises(ValueError, match="prefill_len"):
        engine.submit(np.arange(9, dtype=np.int32), 2)


@pytest.mark.parametrize("over", [
    dict(prefix_cache=True), dict(swap_mode="host"),
    dict(spec_decode=True), dict(prefill_chunk=4)],
    ids=["prefix", "swap", "spec", "wave"])
def test_mechanisms_refuse_mamba(jamba, over):
    cfg, params = jamba
    with pytest.raises(ValueError, match="mamba"):
        Engine(cfg, params, _scfg(**over), device="cpu")


@pytest.mark.parametrize("model", ["mamba2", "jamba"])
def test_cache_token_bytes_counts_no_state(request, model):
    """Bytes per cached token: the attention layers' K and V rows only
    (none on mamba2); the per-slot state is not a token's row."""
    cfg, params = request.getfixturevalue(model)
    for over in ({}, SLAB):
        engine = Engine(cfg, params, _scfg(**over), device="cpu")
        n_attn = sum(s.mixer == "attn" for s in cfg.layer_specs)
        assert engine.cache_token_bytes == \
            n_attn * 2 * cfg.n_kv_heads * cfg.head_dim * 2


def test_launcher_serves_mamba2_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--arch", MAMBA2, "--workload", "bursty",
          "--cache-mode", "paged", "--page-size", "4", "--alloc-mode",
          "incremental", "--num-pages", "6", "--batch", "2",
          "--prompt-len", "8", "--new-tokens", "8", "--requests", "4",
          "--quant", "w8a8_nibble", "--verify"])
    out = capsys.readouterr().out
    assert "arch=mamba2-780m" in out and "preemptions" in out
    assert "streams bit-match" in out
