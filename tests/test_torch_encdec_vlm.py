"""Port parity for the encoder-decoder (whisper-base) and VLM
(phi-3-vision-4.2b) families at the reference's reduced size (whisper: 2
encoder and 2 decoder layers over 32 stub frames; phi-3-vision: 2 layers
behind 8 stub patch embeddings), random weights from the reference's seed
through the weight bridge, the same numpy frames and patches (N(0, 1),
bf16-exact) on both sides.

Tolerances, each with its reason:
* configs, ``reduced()``, the bridge (encoder stack, cross-attention
  leaves): exact;
* the reference side is compiled by ``tm.exact_jit`` (its engine's
  stages by ``tm.exact_engine``; see ``test_torch_model.py``);
* ``encode``'s output: ENC_ATOL = 2**-6, one bf16 ulp at |x| in [2, 4)
  (bf16 after the encoder's final norm).  Measured on a CPU: equal in
  both modes, wherever it is compared (it was 0.05 in ``dense`` and 0.16
  in ``w8a8_nibble`` while the reference ran with excess precision);
* logits (``forward``, ``prefill``, teacher-forced ``decode_step``):
  ``test_torch_model.LOGIT_ATOL`` in ``dense`` (measured: at most 0.0273,
  phi-3-vision's paged decode) and W8A8_ATOL = 0.08 in ``w8a8_nibble``
  (measured: at most 0.0625, phi-3-vision's paged decode; a margin of
  1.28x; it was 0.16);
* the port's decode against its own forward: the reference's rule in
  ``tests/test_models.py::test_decode_matches_forward`` (rtol = atol =
  0.02: the cache path recomputes the same math, bf16 noise only);
* text-only engine streams against the reference engine's, greedy,
  ``dense``: token for token, a divergence held to
  ``test_torch_engine.py``'s tie rule;
* ``make_loss_fn`` loss and gradients: TRAIN_LOSS_ATOL = 5e-3 and
  TRAIN_GRAD_RTOL[mode] (relative Frobenius norm per leaf: 0.05 in
  ``dense``, as ``test_torch_train.py``; 0.25 in ``qat``).  These inputs
  make the loss more sensitive than qwen3-4b's tokens alone: measured on
  a CPU, the reference's own loss moves by up to 1.5e-3 (``dense``) and
  4.0e-3 (``qat``, phi-3-vision) when 20 of its 4096 patch or frame
  values are nudged by one bf16 ulp, and its ``qat`` gradient of
  whisper's second encoder ``ffn_norm`` gain by 9-22%; the port was
  6.2e-4 / 2.7e-3 and 22% from it while the reference ran with excess
  precision.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.engine as jengine
import test_torch_engine as te
import test_torch_model as tm
import test_torch_train as tt
from repro import models as jmodels
from repro.configs import ARCH_NAMES as JARCH_NAMES
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro_torch.configs import ARCH_NAMES, get_config, reduced
from repro_torch.models import (
    decode_step,
    encode,
    forward,
    init_caches,
    merge_slot_paged_caches,
    model_init,
    prefill,
)
from repro_torch.serve import Engine, ServeConfig
from repro_torch.tree import tree_paths

torch.set_num_threads(1)

WHISPER = "whisper-base"
PHI3V = "phi-3-vision-4.2b"
ARCHS = [WHISPER, PHI3V]
W8A8_ATOL = 0.08
ATOL = {"dense": tm.LOGIT_ATOL, "w8a8_nibble": W8A8_ATOL}
ENC_ATOL = 2.0 ** -6
TRAIN_LOSS_ATOL = 5e-3
TRAIN_GRAD_RTOL = {"dense": 5e-2, "qat": 0.25}

jencode = tm.exact_jit(jmodels.encode, static_argnums=1)


def _bf16(a):
    """float32 numpy values that bf16 holds exactly."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _extras(cfg, b, seed=7):
    """The family's extra input, as (keyword, bf16-exact numpy): a VLM's
    patch embeddings or an encoder-decoder's frames, N(0, 1)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return "extra_embeds", _bf16(rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)))
    return "frames", _bf16(rng.standard_normal(
        (b, cfg.enc_seq_len, cfg.d_model)))


def _both(key, x):
    return ({key: jnp.asarray(x, jnp.bfloat16)},
            {key: torch.from_numpy(x).bfloat16()})


def _n_pre(cfg):
    return cfg.n_patches if cfg.family == "vlm" else 0


# ---------------------------------------------------------------------------
# Configs and the bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """Every field holds the reference's value, at full size and reduced
    (the reference's ``reduced()`` rules: 2 encoder layers over 32 frames
    and 2 decoder layers; 8 patches)."""
    def val(v):
        if isinstance(v, (list, tuple)):
            return tuple(dataclasses.astuple(x) for x in v)
        return v

    assert ARCH_NAMES == JARCH_NAMES
    for jcfg, tcfg in ((jget_config(arch), get_config(arch)),
                       (jreduced(jget_config(arch)),
                        reduced(get_config(arch)))):
        for f in tcfg.__dataclass_fields__:
            if f == "quant_backend":
                continue
            assert val(getattr(tcfg, f)) == val(getattr(jcfg, f)), (arch, f)
        assert tcfg.is_encdec == jcfg.is_encdec == (arch == WHISPER)
        assert val(tcfg.layer_specs) == val(jcfg.layer_specs)
    full = get_config(arch)
    assert (full.n_enc_layers, full.enc_seq_len, full.n_patches,
            full.head_dim) == ((6, 1500, 0, 64) if arch == WHISPER
                               else (0, 0, 576, 96))


def test_bridge_carries_encoder_and_cross_leaves():
    jcfg, jp, tcfg, tp = tm._pair(WHISPER)
    assert len(tp["layers"]) == 2 and len(tp["encoder"]["layers"]) == 2
    dec = jp["stack"]["blocks"]["0"]
    enc = jp["encoder"]["stack"]["blocks"]["0"]
    for i in range(2):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(
                tp["layers"][i]["cross"][name]["w"].float().numpy(),
                np.asarray(dec["cross"][name]["w"][i].astype(jnp.float32)))
            np.testing.assert_array_equal(
                tp["encoder"]["layers"][i]["attn"][name]["w"].float()
                .numpy(),
                np.asarray(enc["attn"][name]["w"][i].astype(jnp.float32)))
        assert "cross" not in tp["encoder"]["layers"][i]
        assert tp["layers"][i]["cross_norm"]["scale"].dtype == torch.float32
    assert tp["encoder"]["norm"]["scale"].dtype == torch.float32


def test_model_init_builds_encoder_and_prepares_every_projection():
    cfg = reduced(get_config(WHISPER)).replace(quant_mode="w8a8_nibble")
    p = model_init(cfg, seed=1, device="cpu")
    assert len(p["encoder"]["layers"]) == cfg.n_enc_layers
    for layer in p["layers"]:
        assert set(layer) == {"mixer_norm", "attn", "cross_norm", "cross",
                              "ffn_norm", "mlp"}
        assert layer["cross"]["wk"]["qt8"].dtype == torch.int8
    assert p["encoder"]["layers"][0]["attn"]["wq"]["qt8"].dtype \
        == torch.int8
    vlm = model_init(reduced(get_config(PHI3V)), device="cpu")
    assert "encoder" not in vlm and "lm_head" in vlm


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_encode_matches_reference(impl):
    """The encoder is bidirectional: under ``attn_impl="flash"`` it still
    attends in ``attention_core`` (the causal flash forward would mask the
    later frames).  Measured on a CPU: equal."""
    jcfg, jp, tcfg, tp = tm._pair(WHISPER, attn_impl=impl)
    _, frames = _extras(tcfg, 2)
    want = jencode(jp, jcfg, jnp.asarray(frames, jnp.bfloat16))
    got = encode(tp, tcfg, torch.from_numpy(frames).bfloat16())
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    tm._close(got.float(), np.asarray(want.astype(jnp.float32)),
              atol=ENC_ATOL)


@pytest.mark.parametrize("mode", ["dense", "w8a8_nibble"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match(arch, mode):
    """Frames through the encoder and the decoder's cross-attention, or
    patches prepended (logits over P + S positions).  Measured on a CPU:
    equal in all four cases."""
    jcfg, jp, tcfg, tp = tm._pair(arch, quant_mode=mode, attn_impl="flash")
    toks = np.random.default_rng(0).integers(0, 256, (2, 11)).astype(np.int32)
    jkw, tkw = _both(*_extras(tcfg, 2))
    want, _ = tm.jforward(jp, jcfg, jnp.asarray(toks), **jkw)
    got, aux = forward(tp, tcfg, torch.from_numpy(toks), **tkw)
    assert float(aux) == 0.0
    assert got.shape == want.shape == (2, 11 + _n_pre(tcfg), 256)
    tm._close(got, want, atol=ATOL[mode])


@pytest.mark.parametrize("cache_mode", ["dense", "paged"])
@pytest.mark.parametrize("mode", ["dense", "w8a8_nibble"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match(arch, mode, cache_mode):
    """Each of two requests prefilled alone (its patches prepended, or its
    frames through the encoder) over its first 5 tokens and moved into a
    2-slot cache (slab rows, or pool pages out of order through a table),
    then 4 teacher-forced ``decode_step``s against the reference's: the
    encoder outputs ``prefill`` returns are what the steps cross-attend.
    Measured on a CPU: the dense slab equal; paged up to 0.0273 (dense)
    and 0.0625 (w8a8) on phi-3-vision, 0.0049 and 0.0099 on whisper."""
    from repro.models import init_caches as jinit_caches
    from repro.models import merge_slot_caches as jmerge
    from repro.models import merge_slot_paged_caches as jmerge_paged
    from repro_torch.models import merge_slot_caches
    over = dict(quant_mode=mode, attn_impl="flash", cache_mode=cache_mode,
                page_size=4)
    jcfg, jp, tcfg, tp = tm._pair(arch, **over)
    b, s, split, max_len = 2, 9, 5, 32
    n_pre = _n_pre(tcfg)
    toks = np.random.default_rng(1).integers(0, 256, (b, s)).astype(np.int32)
    key, x = _extras(tcfg, b)
    grow = max_len if cache_mode == "dense" else n_pre + 8
    table = np.arange(1, 1 + b * max_len // 4, dtype=np.int32) \
        .reshape(b, -1)[:, ::-1].copy()
    jc = jinit_caches(jcfg, b, max_len)
    tc = init_caches(tcfg, b, max_len, device="cpu")
    jencs, tencs = [], []
    for slot in range(b):
        jkw, tkw = _both(key, x[slot:slot + 1])
        p = toks[slot:slot + 1, :split]
        jl, jone, jenc = tm.jprefill(jp, jcfg, jnp.asarray(p), max_len=grow,
                                     **jkw)
        tl, tone, tenc = prefill(tp, tcfg, torch.from_numpy(p),
                                 max_len=grow, **tkw)
        tm._close(tl, jl, atol=ATOL[mode])
        if cache_mode == "dense":
            jc = jmerge(jc, jone, slot)
            merge_slot_caches(tc, tone, slot)
        else:
            jc = jmerge_paged(jc, jone, slot, jnp.asarray(table[slot]))
            merge_slot_paged_caches(tc, tone, slot, table[slot])
        if tcfg.is_encdec:
            tm._close(tenc.float(), np.asarray(jenc.astype(jnp.float32)),
                      atol=ENC_ATOL)
            jencs.append(jenc)
            tencs.append(tenc)
        else:
            assert tenc is None and jenc is None
    jenc = jnp.concatenate(jencs) if jencs else None
    tenc = torch.cat(tencs) if tencs else None
    jkw_d = tkw_d = {}
    if cache_mode == "paged":
        jkw_d = {"page_table": jnp.asarray(table)}
        tkw_d = {"page_table": torch.from_numpy(table)}
    for t in range(split, s):
        tok = toks[:, t:t + 1]
        jl, jc = tm.jdecode(jp, jcfg, jnp.asarray(tok), jc, n_pre + t,
                            enc_out=jenc, **jkw_d)
        tl, tc = decode_step(tp, tcfg, torch.from_numpy(tok), tc, n_pre + t,
                             enc_out=tenc, **tkw_d)
        tm._close(tl, jl, atol=ATOL[mode])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_forward(arch):
    """The reference's rule (``tests/test_models.py::
    test_decode_matches_forward``) on the port: prefill half the tokens,
    decode the rest teacher-forced, against the parallel forward."""
    cfg = reduced(get_config(arch))
    params = model_init(cfg, seed=2, device="cpu")
    b, s, split = 1, 8, 4
    n_pre = _n_pre(cfg)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (b, s)))
    key, x = _extras(cfg, b, seed=4)
    kw = {key: torch.from_numpy(x).bfloat16()}
    full, _ = forward(params, cfg, toks, **kw)
    logits, caches, enc = prefill(params, cfg, toks[:, :split],
                                  max_len=s + n_pre, **kw)
    got = [logits[:, -1]]
    for t in range(split, s):
        lg, caches = decode_step(params, cfg, toks[:, t:t + 1], caches,
                                 n_pre + t, enc_out=enc)
        got.append(lg[:, -1])
    want = full[:, n_pre + split - 1:].numpy()
    got = torch.stack(got, 1)[:, :want.shape[1]].numpy()
    np.testing.assert_allclose(got, want, rtol=0.02, atol=0.02)


def test_decode_without_enc_out_skips_cross_attention():
    """Text-only (the engine's use): no frames, no cross-attention; the
    logits equal a model whose cross leaves are gone."""
    cfg = reduced(get_config(WHISPER))
    params = model_init(cfg, seed=5, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (2, 6)))
    want, _ = forward(params, cfg, toks)
    bare = dict(params, layers=[{k: v for k, v in layer.items()
                                 if k not in ("cross", "cross_norm")}
                                for layer in params["layers"]])
    got, _ = forward(bare, cfg, toks)
    assert torch.equal(got, want)
    with_frames, _ = forward(params, cfg, toks, frames=torch.ones(
        (2, cfg.enc_seq_len, cfg.d_model), dtype=torch.bfloat16))
    assert not torch.equal(with_frames, want)


# ---------------------------------------------------------------------------
# Engine: text-only, as the reference serves these families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache_mode", ["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_text_only_streams_match_reference(monkeypatch, arch, cache_mode):
    """The staggered workload of ``test_torch_engine.py`` (greedy, dense,
    flash attention) through both packages' engines, no frames and no
    patches: equal streams, each divergence at a tie."""
    over = dict(quant_mode="dense", attn_impl="flash", cache_mode=cache_mode,
                page_size=4)
    jcfg, jparams, tcfg, tparams = tm._pair(arch, **over)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab_size, p).astype(np.int32)
               for p, _ in te.SPEC]
    records = te._recorders(monkeypatch)
    tm.exact_engine(monkeypatch)
    kw = dict(batch=3, max_len=24, prefill_len=8, decode_chunk=3)
    jeng = jengine.Engine(jcfg, jparams, jengine.ServeConfig(**kw))
    jids = [jeng.submit(p, n) for p, (_, n) in zip(prompts, te.SPEC)]
    jdone = jeng.run()
    teng = Engine(tcfg, tparams, ServeConfig(**kw), device="cpu")
    tids = [teng.submit(p, n) for p, (_, n) in zip(prompts, te.SPEC)]
    tdone = teng.run()
    assert teng.leaked_pages() == 0
    for jid, tid, prompt, (_, n) in zip(jids, tids, prompts, te.SPEC):
        want, got = jdone[jid].tokens, tdone[tid].tokens
        assert len(got) == len(want) == n
        diff = [i for i in range(n) if want[i] != got[i]]
        if diff:
            i = diff[0]
            _, logits = te._reference_logits(records, prompt, want, i)
            margin = logits[want[i]] - logits[got[i]]
            assert margin <= te.LOGIT_TOL, (arch, i, margin)


# ---------------------------------------------------------------------------
# Training inputs
# ---------------------------------------------------------------------------

def _jax_leaf(tree, path):
    """The reference leaf of a port path: the decoder's and the encoder's
    repeated layers are stacked on a block axis there."""
    parts = path.split("/")
    if parts[0] == "encoder" and parts[1] == "layers":
        tree, parts = tree["encoder"], parts[1:]
    if parts[0] == "layers":
        node = tree["stack"]["blocks"]["0"]
        for p in parts[2:]:
            node = node[p]
        return node[int(parts[1])]
    node = tree
    for p in parts:
        node = node[p]
    return node


@pytest.mark.parametrize("mode", ["dense", "qat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, mode):
    """``make_loss_fn`` with the family's batch (``patch_embeds``, whose
    logits are cut back to the token grid, or ``frames``) against the
    reference's: the loss, and every gradient leaf (the encoder's and
    the cross-attention's included)."""
    from repro.train.step import TrainConfig as JTrainConfig
    from repro.train.step import make_loss_fn as jmake_loss_fn
    from repro_torch.train.step import (TrainConfig, accumulate_grads,
                                        make_loss_fn)
    jcfg, jp, tcfg, tp = tm._pair(arch, quant_mode=mode, attn_impl="flash")
    toks, labels = tt._batch(0)
    key, x = _extras(tcfg, 2, seed=8)
    key = "patch_embeds" if key == "extra_embeds" else key
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
              key: jnp.asarray(x, jnp.bfloat16)}
    (jloss, _), jgrads = tm.exact_jit(jax.value_and_grad(
        jmake_loss_fn(jcfg, JTrainConfig()), has_aux=True))(jp, jbatch)
    jgrads = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jgrads)
    tbatch = {"tokens": torch.from_numpy(toks).long(),
              "labels": torch.from_numpy(labels).long(),
              key: torch.from_numpy(x).bfloat16()}
    loss, _, grads = accumulate_grads(make_loss_fn(tcfg, TrainConfig()), tp,
                                      tbatch, 1)
    assert abs(float(loss) - float(jloss)) <= TRAIN_LOSS_ATOL
    paths = tree_paths(grads)
    # embed, final norm [, lm_head]; 9 leaves a layer (norms, wq/wk/wv/wo,
    # gate/up/down), a decoder layer of whisper 5 more (cross_norm, cross);
    # whisper's encoder: 2 layers and its norm
    assert len(paths) == (2 + 2 * 14 + 2 * 9 + 1 if arch == WHISPER
                          else 3 + 2 * 9)
    for path, g in paths:
        err = tt._rel(g.float().numpy(), _jax_leaf(jgrads, path))
        assert err <= TRAIN_GRAD_RTOL[mode], (path, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_merges_extra_batch(arch):
    """``Trainer(extra_batch_fn=)`` merges the stub inputs into each step's
    batch (the launcher's: N(0, 1) x 0.02 in bf16, seeded by the step, so
    a step's inputs repeat) and trains: finite losses."""
    from repro_torch.data import DataConfig
    from repro_torch.launch.train import stub_extras
    from repro_torch.train import TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = reduced(get_config(arch)).replace(quant_mode="qat")
    extra = stub_extras(cfg, 2, "cpu")
    trainer = Trainer(cfg, TrainConfig(), TrainerConfig(steps=2, log_every=1),
                      DataConfig(vocab_size=cfg.vocab_size, seq_len=12,
                                 global_batch=2),
                      extra_batch_fn=extra, device="cpu")
    batch = trainer._batch(1)
    key = "frames" if arch == WHISPER else "patch_embeds"
    rows = cfg.enc_seq_len if arch == WHISPER else cfg.n_patches
    assert batch[key].shape == (2, rows, cfg.d_model)
    assert batch[key].dtype == torch.bfloat16
    assert torch.equal(batch[key], extra(1)[key])
    assert not torch.equal(batch[key], extra(0)[key])
    assert 0.0 < float(batch[key].float().std()) < 0.05
    hist = trainer.run()
    assert len(hist) == 2 and all(math.isfinite(h["loss"]) for h in hist)


def test_stub_extras_only_for_vlm_and_encdec():
    from repro_torch.launch.train import stub_extras
    assert stub_extras(reduced(get_config("yi-6b")), 2, "cpu") is None


# ---------------------------------------------------------------------------
# Launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_takes_the_new_archs(capsys, arch):
    """``--arch`` serves reduced whisper-base and phi-3-vision text-only
    over an overcommitted pool that must preempt; ``--verify`` re-runs
    and bit-matches the streams."""
    from repro_torch.launch.serve import main
    assert main(["--device", "cpu", "--arch", arch, "--workload", "bursty",
                 "--cache-mode", "paged", "--page-size", "4",
                 "--alloc-mode", "incremental", "--num-pages", "6",
                 "--batch", "2", "--prompt-len", "8", "--new-tokens", "8",
                 "--requests", "4", "--verify"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "verify: 4 streams bit-match" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_takes_the_new_archs(tmp_path, arch):
    import json

    from repro_torch.launch.train import main
    out = tmp_path / "hist.json"
    assert main(["--arch", arch, "--reduced", "--steps", "2", "--device",
                 "cpu", "--seq", "16", "--batch", "2", "--quant", "qat",
                 "--out", str(out)]) == 0
    hist = json.loads(out.read_text())
    assert len(hist) == 2 and all(math.isfinite(h["loss"]) for h in hist)
