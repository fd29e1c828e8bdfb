"""Tensor parallelism for MLA, MoE (expert parallelism), the
encoder-decoder and the VLM, against the single-device port and the
reference.

The shards share the CPU (``devices=["cpu", "cpu"]``), as in
``tests/test_torch_tp.py``.  What is held:

* Models: reduced deepseek-v3 (MLA, 3 dense + 1 MoE of 4 experts, top-2,
  1 shared) and reduced llama4 (GQA + MoE, top-1): a prefill and three
  decode steps at tp=2 against tp=1 (caches from ``init_shard_caches``
  and from ``shard_caches`` of tp=1's), over paged pools and the slab:
  bit for bit in ``w8a8_nibble``, and in ``dense`` within a rounding of
  the row-parallel f32 sum (``_same``); both hold the reference compiled
  by ``test_torch_model.exact_jit`` within LOGIT_ATOL (a routing flip
  held to a router-logit tie, as ``tests/test_torch_families.py`` holds
  it).  Reduced whisper-base with frames and reduced phi-3-vision with
  patches the same way (the encoder output too).
* The expert-parallel combine equals ``moe_apply`` bit for bit over 200
  seeded token sets, capacity overflow and every assignment on one shard
  among them; experts that do not divide tp (6 at tp=4) run replicated.
* Engines: tp=2 greedy streams equal the port's tp=1 engine's and, under
  the tie rule of ``tests/test_torch_engine.py``, the reference engine's;
  every mechanism rule of ``tests/test_torch_tp.py`` holds inside tp=2 on
  reduced deepseek-v3; a ``--dp 2 --tp 2`` fleet of reduced llama4 runs.
* Layout: expert stacks split on a shared device are views, MLA's heads
  split whole, the latent parts whole; a replicated latent page's host
  payload equals tp=1's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.engine as jengine
import test_torch_engine as te
import test_torch_families as tf
import test_torch_model as tm
import test_torch_tp as ttp
from repro import models as jmodels
from repro.models import init_caches as jinit_caches
from repro.models import merge_slot_caches as jmerge
from repro.models import merge_slot_paged_caches as jmerge_paged
from repro_torch.configs import get_config, reduced
from repro_torch.distributed.sharding import shard_caches, shard_params
from repro_torch.models import (decode_step, extract_cache_pages,
                                init_caches, insert_cache_pages,
                                merge_slot_caches, merge_slot_paged_caches,
                                model_init, prefill)
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import cache_bytes, init_shard_caches
from repro_torch.serve import Engine, Router, ServeConfig

torch.set_num_threads(1)

DEEPSEEK, LLAMA4 = tf.DEEPSEEK, tf.LLAMA4
WHISPER, PHI3V = "whisper-base", "phi-3-vision-4.2b"
MODES = ["w8a8_nibble", "dense"]
CACHES = ["paged", "dense"]
CPU2 = ttp.CPU2
_mesh = ttp._mesh


def _same(got, want, mode, atol=tm.LOGIT_ATOL):
    """tp=2 against tp=1: bit for bit in the integer modes.  In ``dense``
    a row-parallel projection sums f32 partial products in shard order
    and rounds once, where tp=1's bf16 product sums K in its kernel's
    order (``test_dense_projections_within_one_rounding`` in
    ``tests/test_torch_tp.py``), so the logits may move by a bf16 rounding carried through the
    layers: within ``atol`` (LOGIT_ATOL; an encoder output ENC_ATOL).
    Measured on a CPU: every dense case here equal but reduced
    phi-3-vision's (0.0078, one prefill)."""
    if mode == "dense":
        tm._close(got, want, atol=atol)
    else:
        assert torch.equal(got, want)


def _moe_layer(cfg) -> int:
    return next(i for i, s in enumerate(cfg.layer_specs) if s.ffn == "moe")


# ---------------------------------------------------------------------------
# Prefill and decode steps
# ---------------------------------------------------------------------------

def _both_port(routes, fn1, fn2):
    """``fn1()`` (tp=1) then ``fn2()`` (tp=2), keeping only tp=2's MoE
    routings in the recorder (the reference ran one call)."""
    n = len(routes.t)
    one = fn1()
    del routes.t[n:]
    return one, fn2()


@pytest.mark.parametrize("cache_mode", CACHES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", [DEEPSEEK, LLAMA4])
def test_moe_models_tp2_match_tp1_and_reference(monkeypatch, arch, mode,
                                                cache_mode):
    """Two prompts prefilled alone into slots 0 and 2 of a 3-slot cache
    (pool pages or slab rows), then three decode steps at per-slot
    positions: tp=2's logits equal tp=1's bit for bit, from caches made
    by ``init_shard_caches`` and by ``shard_caches`` of tp=1's, and hold
    the reference's within LOGIT_ATOL on the rows no routing flip
    touched."""
    over = dict(quant_mode=mode, attn_impl="flash", cache_mode=cache_mode,
                page_size=4)
    jcfg, jp, tcfg, tp1 = tf._pair(arch, **over)
    tcfg = tcfg.replace(quant_backend="cuda")
    tp2 = shard_params(tp1, tcfg, _mesh())
    routes = tf._Routes(monkeypatch)
    jprefill = tf._fresh(jmodels.prefill, static_argnames=("max_len",))
    jdecode = tf._fresh(jmodels.decode_step)
    rng = np.random.default_rng(1)
    max_len, pad, lens = 16, 8, [5, 8]
    prompts = np.zeros((2, pad), np.int32)
    for i, n in enumerate(lens):
        prompts[i, :n] = rng.integers(0, 256, n)
    table = np.zeros((3, max_len // 4), np.int32)
    table[0, :4] = [1, 2, 3, 4]
    table[2, :4] = [8, 7, 6, 5]
    grow = max_len if cache_mode == "dense" else pad
    jc = jinit_caches(jcfg, 3, max_len)
    c1 = init_caches(tcfg, 3, max_len, device="cpu")
    c2 = init_shard_caches(tcfg, 3, max_len, tp2)
    for slot, row in ((0, 0), (2, 1)):
        p = prompts[row:row + 1]
        jl, jone, _ = jprefill(jp, jcfg, jnp.asarray(p), max_len=grow,
                               logits_index=lens[row] - 1)
        outs = _both_port(routes, *[
            lambda w=w: prefill(w, tcfg, torch.from_numpy(p), max_len=grow,
                                logits_index=lens[row] - 1)
            for w in (tp1, tp2)])
        _same(outs[1][0], outs[0][0], mode)
        skip = routes.flipped(1, pad)[:, lens[row] - 1:lens[row]]
        tf._close_unflipped(outs[1][0], jl, skip)
        if cache_mode == "dense":
            jc = jmerge(jc, jone, slot)
            merge_slot_caches(c1, outs[0][1], slot)
            merge_slot_caches(c2, outs[1][1], slot)
        else:
            jc = jmerge_paged(jc, jone, slot, jnp.asarray(table[slot]))
            for c, one in ((c1, outs[0][1]), (c2, outs[1][1])):
                merge_slot_paged_caches(c, one, slot,
                                        torch.from_numpy(table[slot]))
    c3 = shard_caches(c1, tcfg, _mesh(), batch=3)
    pos = np.array([lens[0], 3, lens[1]], np.int32)
    tok = rng.integers(0, 256, (3, 1)).astype(np.int32)
    page_j = jnp.asarray(table) if cache_mode == "paged" else None
    page_t = torch.from_numpy(table) if cache_mode == "paged" else None
    for _ in range(3):
        jl, jc = jdecode(jp, jcfg, jnp.asarray(tok), jc, jnp.asarray(pos),
                         page_table=page_j)
        got = [decode_step(w, tcfg, torch.from_numpy(tok), c,
                           torch.from_numpy(pos), page_table=page_t)[0]
               for w, c in ((tp1, c1), (tp2, c3), (tp2, c2))]
        jax.effects_barrier()                   # the reference's routings
        del routes.t[:-len(routes.j)]           # the last call's routings
        _same(got[1], got[0], mode)
        assert torch.equal(got[1], got[2])
        tf._close_unflipped(got[2], jl, routes.flipped(3, 1))
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        pos = pos + 1


def _extras(cfg, b, mode):
    """The enc-dec tests' stub input, helpers and tolerances: their
    encoder output tolerance, and their logit tolerance (LOGIT_ATOL in
    ``dense``; 0.08 in w8a8, where phi-3-vision's paged decode measured
    up to 0.0703 against the reference here, at tp=1 as at tp=2)."""
    import test_torch_encdec_vlm as ev
    return (ev._extras(cfg, b), ev._both, ev._n_pre(cfg), ev.ENC_ATOL,
            ev.ATOL[mode])


@pytest.mark.parametrize("cache_mode", CACHES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", [WHISPER, PHI3V])
def test_encdec_vlm_tp2_match_tp1_and_reference(arch, mode, cache_mode):
    """Each of two requests prefilled alone with its frames (through the
    encoder over the shards) or its patches (prepended on every device)
    over its first 5 tokens, moved into a 2-slot cache, then three
    decode steps cross-attending the encoder output: tp=2 holds tp=1 as
    ``_same`` says (logits and encoder output), and the reference as
    ``tests/test_torch_encdec_vlm.py`` holds tp=1 (``_extras``)."""
    over = dict(quant_mode=mode, attn_impl="flash", cache_mode=cache_mode,
                page_size=4)
    jcfg, jp, tcfg, tp1 = tm._pair(arch, **over)
    tcfg = tcfg.replace(quant_backend="cuda")
    tp2 = shard_params(tp1, tcfg, _mesh())
    b, s, split, max_len = 2, 8, 5, 32
    (key, x), both, n_pre, enc_atol, atol = _extras(tcfg, b, mode)
    toks = np.random.default_rng(1).integers(0, 256, (b, s)) \
        .astype(np.int32)
    grow = max_len if cache_mode == "dense" else n_pre + 8
    table = np.arange(1, 1 + b * max_len // 4, dtype=np.int32) \
        .reshape(b, -1)[:, ::-1].copy()
    jc = jinit_caches(jcfg, b, max_len)
    c1 = init_caches(tcfg, b, max_len, device="cpu")
    c2 = init_shard_caches(tcfg, b, max_len, tp2)
    jencs, encs = [], []
    for slot in range(b):
        jkw, tkw = both(key, x[slot:slot + 1])
        p = toks[slot:slot + 1, :split]
        jl, jone, jenc = tm.jprefill(jp, jcfg, jnp.asarray(p), max_len=grow,
                                     **jkw)
        outs = [prefill(w, tcfg, torch.from_numpy(p), max_len=grow, **tkw)
                for w in (tp1, tp2)]
        _same(outs[1][0], outs[0][0], mode)
        tm._close(outs[1][0], jl, atol=atol)
        if cache_mode == "dense":
            jc = jmerge(jc, jone, slot)
            for c, o in ((c1, outs[0]), (c2, outs[1])):
                merge_slot_caches(c, o[1], slot)
        else:
            jc = jmerge_paged(jc, jone, slot, jnp.asarray(table[slot]))
            for c, o in ((c1, outs[0]), (c2, outs[1])):
                merge_slot_paged_caches(c, o[1], slot, table[slot])
        if tcfg.is_encdec:
            _same(outs[1][2].float(), outs[0][2].float(), mode,
                  atol=enc_atol)
            tm._close(outs[1][2].float(),
                      np.asarray(jenc.astype(jnp.float32)), atol=enc_atol)
            jencs.append(jenc)
            encs.append(outs[1][2])
        else:
            assert outs[1][2] is None
    jenc = jnp.concatenate(jencs) if jencs else None
    enc = torch.cat(encs) if encs else None
    jkw_d = tkw_d = {}
    if cache_mode == "paged":
        jkw_d = {"page_table": jnp.asarray(table)}
        tkw_d = {"page_table": torch.from_numpy(table)}
    for t in range(split, s):
        tok = toks[:, t:t + 1]
        jl, jc = tm.jdecode(jp, jcfg, jnp.asarray(tok), jc, n_pre + t,
                            enc_out=jenc, **jkw_d)
        got = [decode_step(w, tcfg, torch.from_numpy(tok), c, n_pre + t,
                           enc_out=enc, **tkw_d)[0]
               for w, c in ((tp1, c1), (tp2, c2))]
        _same(got[1], got[0], mode)
        tm._close(got[1], jl, atol=atol)


# ---------------------------------------------------------------------------
# The expert-parallel combine
# ---------------------------------------------------------------------------

def _moe_shards(arch, tp, **over):
    cfg = reduced(get_config(arch)).replace(quant_mode="w8a8_nibble",
                                            quant_backend="cuda", **over)
    params = model_init(cfg, device="cpu")
    li = _moe_layer(cfg)
    shards = shard_params(params, cfg, _mesh(tp))
    return cfg, params["layers"][li]["moe"], \
        [s["layers"][li]["moe"] for s in shards], shards.layout


def _token_set(cfg, whole, seed):
    """Set ``seed``'s tokens (1-48 of them), by ``seed % 4``: plain;
    overflowing the capacity (a 0.25 capacity factor over >= 40 tokens);
    every assignment on shard 0's experts; every one on shard 1's (a
    large first feature that the router's column for the other shard's
    experts weighs negatively)."""
    rng = np.random.default_rng(seed)
    kind = seed % 4
    t = int(rng.integers(40, 49)) if kind == 1 else int(rng.integers(1, 49))
    x = rng.standard_normal((1, t, cfg.d_model)) * 0.5
    router = whole["router"].clone()
    if kind >= 2:
        half = cfg.n_experts // 2
        mine = slice(0, half) if kind == 2 else slice(half, None)
        x[..., 0] = 8.0
        router[0] = -1.0
        router[0, mine] = 1.0
    return (torch.from_numpy(x).bfloat16(), router,
            cfg.replace(capacity_factor=0.25) if kind == 1 else cfg)


@pytest.mark.parametrize("arch", [DEEPSEEK, LLAMA4])
def test_ep_combine_equals_moe_apply(arch):
    """100 token sets a model (200 in all) through the expert-parallel
    path at tp=2 and through ``moe_apply``: output and aux loss equal bit
    for bit.  The sets that overflow drop assignments (counted), and the
    one-shard sets route every assignment to that shard's experts."""
    cfg, whole, parts, layout = _moe_shards(arch, 2)
    assert layout.experts and layout.shared
    dropped = 0
    for seed in range(100):
        x, router, c = _token_set(cfg, whole, seed)
        w = dict(whole, router=router)
        ps = [dict(p, router=router) for p in parts]
        want, aux = tmoe.moe_apply(w, c, x)
        got, got_aux = tmoe.moe_apply_shards(ps, c, [x, x], layout)
        assert got[0] is got[1]
        assert torch.equal(got[0], want) and torch.equal(got_aux, aux), seed
        _, top_e, _ = tmoe._route(w, c, x.reshape(-1, cfg.d_model))
        counts = torch.bincount(top_e.reshape(-1), minlength=cfg.n_experts)
        cap = tmoe._capacity(c, x.shape[1], cfg.n_experts)
        if seed % 4 == 1:
            dropped += int((counts - cap).clamp(min=0).sum())
        elif seed % 4 >= 2:
            half = cfg.n_experts // 2
            other = counts[half:] if seed % 4 == 2 else counts[:half]
            assert int(other.sum()) == 0, seed
    assert dropped > 0


@pytest.mark.parametrize("mode", MODES)
def test_experts_that_do_not_divide_run_replicated(mode):
    """Reduced llama4 with 6 experts at tp=4: the stacks stay whole (the
    caller's tensors), the engine reports ``experts`` off, and a prefill
    and three decode steps equal tp=1 bit for bit."""
    cfg = reduced(get_config(LLAMA4)).replace(
        n_experts=6, quant_mode=mode, quant_backend="cuda",
        attn_impl="flash", cache_mode="paged", page_size=4)
    params = model_init(cfg, device="cpu")
    tp4 = shard_params(params, cfg, _mesh(4))
    assert not tp4.layout.experts and tp4.layout.shared
    li = _moe_layer(cfg)
    for key in ("w_gate", "w_up", "w_down", "router"):
        assert all(s["layers"][li]["moe"][key]
                   is params["layers"][li]["moe"][key] for s in tp4)
    rng = np.random.default_rng(3)
    tok = torch.from_numpy(rng.integers(0, 256, (1, 8)).astype(np.int64))
    table = torch.tensor([[1, 2, 3, 4]])
    logits, caches = [], []
    for w in (params, tp4):
        lg, one, _ = prefill(w, cfg, tok)
        pool = (init_caches(cfg, 1, 16, device="cpu") if w is params
                else init_shard_caches(cfg, 1, 16, w))
        merge_slot_paged_caches(pool, one, 0, table[0])
        logits.append(lg)
        caches.append(pool)
    assert torch.equal(logits[0], logits[1])
    nxt = torch.argmax(logits[0][:, -1], -1)[:, None]
    for step in range(3):
        got = [decode_step(w, cfg, nxt, c, torch.tensor([8 + step]),
                           page_table=table)[0]
               for w, c in ((params, caches[0]), (tp4, caches[1]))]
        assert torch.equal(got[0], got[1])
        nxt = torch.argmax(got[0][:, -1], -1)[:, None]
    eng = Engine(cfg, params, ServeConfig(batch=2, max_len=16, tp=4),
                 device="cpu", devices=["cpu"] * 4)
    assert eng.tp_layout == tp4.layout


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", [DEEPSEEK, LLAMA4])
def test_tp2_engine_streams_equal_tp1_and_reference(monkeypatch, arch,
                                                    mode):
    """The staggered workload of ``test_torch_engine.py`` (6 requests
    through 3 paged slots): the tp=2 engine's greedy streams equal the
    port's tp=1 engine's token for token, with the same counters, and the
    reference's tp=1 engine's under that file's tie rule."""
    over = dict(quant_mode=mode, attn_impl="flash", cache_mode="paged",
                page_size=4)
    jcfg, jparams, tcfg, tparams = tf._pair(arch, **over)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab_size, p).astype(np.int32)
               for p, _ in te.SPEC]
    records = te._recorders(monkeypatch)
    kw = dict(batch=3, max_len=24, prefill_len=8, decode_chunk=3)
    tm.exact_engine(monkeypatch)
    jeng = jengine.Engine(jcfg, jparams, jengine.ServeConfig(**kw))
    jids = [jeng.submit(p, n) for p, (_, n) in zip(prompts, te.SPEC)]
    jdone = jeng.run()
    runs = {}
    for tp in (1, 2):
        eng = Engine(tcfg, tparams, ServeConfig(tp=tp, **kw), device="cpu",
                     devices=CPU2[:tp] if tp > 1 else None)
        ids = [eng.submit(p, n) for p, (_, n) in zip(prompts, te.SPEC)]
        done = eng.run()
        assert eng.leaked_pages() == 0
        runs[tp] = ([done[i].tokens for i in ids], eng.stats)
    assert runs[2][0] == runs[1][0]
    skip = ("occupancy", "concurrency")
    assert {k: v for k, v in runs[2][1].items() if k not in skip} \
        == {k: v for k, v in runs[1][1].items() if k not in skip}
    firsts = []
    for jid, got, prompt, (_, n) in zip(jids, runs[2][0], prompts, te.SPEC):
        want = jdone[jid].tokens
        assert len(got) == len(want) == n
        diff = [i for i in range(n) if want[i] != got[i]]
        if diff:
            rec, logits = te._reference_logits(records, prompt, want,
                                               diff[0])
            firsts.append((rec, logits[want[diff[0]]]
                           - logits[got[diff[0]]], diff[0]))
    firsts.sort()
    for rec, margin, i in (firsts if mode == "dense" else firsts[:1]):
        assert margin <= te.LOGIT_TOL, (
            f"streams diverge at token {i} where the reference's margin "
            f"is {margin} > {te.LOGIT_TOL}: not a tie")


@pytest.fixture(scope="module")
def deepseek_mech():
    # a capacity factor of E / k gives every expert a capacity of at
    # least the call's token count: nothing overflows, so a row's value
    # does not depend on its batch and each rule's bit-match holds
    cfg = reduced(get_config(DEEPSEEK)).replace(attn_impl="chunked")
    cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg, model_init(cfg, device="cpu")


@pytest.mark.parametrize("name", sorted(ttp.MECHANISMS))
def test_deepseek_mechanisms_keep_their_rule_at_tp2(deepseek_mech, name):
    """``tests/test_torch_tp.py``'s mechanism rules on reduced deepseek-v3
    (MLA latent pools, one MoE layer), in ``dense``: at tp=2 each
    mechanism's streams equal its baseline's, its counters fire, and the
    tp=1 engine with the same knobs gives the same streams and
    counters; no leak."""
    cfg, params = deepseek_mech
    knobs, base, counters = ttp.MECHANISMS[name]
    prompts = ttp._shared_prompts(cfg.vocab_size)
    runs = {}
    for tp in (1, 2):
        for label, over in (("mech", knobs), ("base", base)):
            scfg = ServeConfig(**{**ttp.MECH_BASE, **over, "tp": tp})
            streams, eng = ttp._serve(cfg, params, scfg, prompts, n_new=7,
                                      devices=CPU2[:tp] if tp > 1 else None)
            assert eng.leaked_pages() == 0, (name, tp, label)
            runs[tp, label] = (streams, eng.stats)
    assert runs[2, "mech"][0] == runs[2, "base"][0]
    assert runs[2, "mech"][0] == runs[1, "mech"][0]
    for key in counters:
        assert runs[2, "mech"][1][key] > 0, key
    skip = ("occupancy", "concurrency")
    assert {k: v for k, v in runs[2, "mech"][1].items() if k not in skip} \
        == {k: v for k, v in runs[1, "mech"][1].items() if k not in skip}


def test_router_dp2_tp2_llama4_fleet(capsys):
    """``Router(replicas=2)`` of reduced llama4 at tp=2 over four repeated
    CPU devices serves one engine's streams; the launcher's ``--dp 2 --tp
    2`` prints the layout and holds its streams to tp=1's."""
    cfg = reduced(get_config(LLAMA4)).replace(attn_impl="flash")
    params = model_init(cfg, device="cpu")
    prompts = ttp._mesh_prompts(cfg.vocab_size)
    scfg = ServeConfig(tp=2, **ttp.MESH_KW)
    fleet = Router(cfg, params, scfg, replicas=2, devices=["cpu"] * 4)
    assert fleet.device_count == 4 and fleet.tp_layout.experts
    ids = [fleet.submit(p, 8) for p in prompts]
    done = fleet.run()
    want, _ = ttp._serve(cfg, params, ServeConfig(**ttp.MESH_KW), prompts)
    assert [done[i].tokens for i in ids] == want
    assert fleet.leaked_pages() == 0
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--arch", LLAMA4, "--workload", "uniform",
          "--cache-mode", "paged", "--page-size", "4", "--batch", "2",
          "--prompt-len", "8", "--new-tokens", "6", "--requests", "4",
          "--quant", "dense", "--dp", "2", "--tp", "2", "--verify"])
    out = capsys.readouterr().out
    assert "tp layout: TPLayout(tp=2" in out and "experts=True" in out
    assert "bit-match" in out


# ---------------------------------------------------------------------------
# Layout and host payloads
# ---------------------------------------------------------------------------

def test_deepseek_shards_split_heads_and_experts_as_views():
    """At tp=2 on one device: each shard's expert stacks are views of the
    caller's (its experts' rows, no copy), ``wq_b`` / ``wkv_b`` split by
    whole heads (head-major columns), ``wo`` along K by heads, and the
    latent part (``wq_a``, ``wkv_a``, their norms) and the router stay the
    caller's tensors."""
    cfg = reduced(get_config(DEEPSEEK)).replace(quant_mode="w8a8_nibble")
    params = model_init(cfg, device="cpu")
    shards = shard_params(params, cfg, _mesh())
    assert shards.layout.mla_heads and shards.layout.experts
    li = _moe_layer(cfg)
    whole = params["layers"][li]["moe"]
    e = cfg.n_experts // 2
    for s, tree in enumerate(shards):
        moe = tree["layers"][li]["moe"]
        for key in ("w_gate", "w_up", "w_down"):
            part = moe[key]
            assert part.untyped_storage().data_ptr() \
                == whole[key].untyped_storage().data_ptr()
            assert torch.equal(part, whole[key][s * e:(s + 1) * e])
        assert moe["router"] is whole["router"]
    attn = params["layers"][0]["attn"]
    h = cfg.n_heads // 2
    for name, width in (("wq_b", cfg.qk_nope_dim + cfg.qk_rope_dim),
                        ("wkv_b", cfg.qk_nope_dim + cfg.v_head_dim)):
        for s, tree in enumerate(shards):
            got = tree["layers"][0]["attn"][name]
            assert torch.equal(got["w"], attn[name]["w"][
                :, s * h * width:(s + 1) * h * width])
            assert torch.equal(got["qt8"], attn[name]["qt8"][
                s * h * width:(s + 1) * h * width])
    for s, tree in enumerate(shards):
        assert torch.equal(tree["layers"][0]["attn"]["wo"]["w"],
                           attn["wo"]["w"][s * h * cfg.v_head_dim:
                                           (s + 1) * h * cfg.v_head_dim])
        for name in ("wq_a", "wkv_a", "q_a_norm", "kv_a_norm"):
            assert tree["layers"][0]["attn"][name] is attn[name] or all(
                t is attn[name][k]
                for k, t in tree["layers"][0]["attn"][name].items())


@pytest.mark.parametrize("arch", [DEEPSEEK, LLAMA4])
def test_host_payloads_keep_the_unsharded_layout(arch):
    """Pages extracted from tp=2 caches are tp=1's bytes (a replicated
    latent page once; llama4's head-split K/V side by side), insert into
    fresh tp=2 caches to every shard, and ``cache_bytes`` counts the
    unsharded layout."""
    cfg = reduced(get_config(arch)).replace(cache_mode="paged", page_size=4)
    caches = init_caches(cfg, 2, 16, device="cpu")
    g = torch.Generator().manual_seed(0)
    for c in caches:
        for pool in c.values():
            pool.copy_((torch.randn(pool.shape, generator=g) * 50)
                       .to(pool.dtype))
    shards = shard_caches(caches, cfg, _mesh(), batch=2)
    if arch == DEEPSEEK:
        assert shards[0][0]["c_kv"] is shards[1][0]["c_kv"]
    assert cache_bytes(shards) == cache_bytes(caches)
    pages = [3, 1, 7]
    want = extract_cache_pages(caches, pages, pad_to=5)
    got = extract_cache_pages(shards, pages, pad_to=5)
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(got, want))
    params = shard_params(model_init(cfg, device="cpu"), cfg, _mesh())
    fresh = init_shard_caches(cfg, 2, 16, params)
    assert cache_bytes(fresh) == cache_bytes(caches)
    insert_cache_pages(fresh, pages, got, pad_to=5)
    for tree, ref in zip(fresh, shards):
        for c, r in zip(tree, ref):
            for key in c:
                assert torch.equal(c[key][pages].view(torch.int16),
                                   r[key][pages].view(torch.int16))
    eng = Engine(cfg, model_init(cfg, device="cpu"),
                 ServeConfig(batch=2, max_len=16, tp=2), device="cpu",
                 devices=CPU2)
    one = Engine(cfg, model_init(cfg, device="cpu"),
                 ServeConfig(batch=2, max_len=16), device="cpu")
    assert eng.cache_token_bytes == one.cache_token_bytes
    assert dataclasses.asdict(eng.tp_layout)["tp"] == 2
