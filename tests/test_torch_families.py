"""Port parity for the model families added to the port: gemma3-1b (5:1
local/global, MQA, head_dim 256 at full width), gemma-7b (MHA, GeGLU),
deepseek-v3-671b (MLA + MoE), llama4-maverick-400b-a17b (GQA + MoE,
top-1), mamba2-780m (Mamba2 SSD mixers, no FFN; 2 layers here) and
jamba-v0.1-52b (7 mamba : 1 attention, MoE every other layer), all at
the reference's reduced size, random weights from the reference's seed
through the weight bridge.  Models with mamba mixers prefill at the
exact prompt length, as the reference's engine runs them.

* Model: ``forward`` and prefill + decode logits (dense slab and paged
  pools) within ``test_torch_model.py``'s LOGIT_ATOL, in ``dense`` and
  ``w8a8_nibble``, against the reference compiled by ``tm.exact_jit``
  (its engine's stages too: ``tm.exact_engine``); the bridge copies MLA
  and MoE leaves exactly and keeps the router f32.
* Engine, cross-package: reduced deepseek-v3 and llama4 greedy streams
  against the reference engine under ``test_torch_engine.py``'s tie rule.
* Engine, inside the port, on reduced deepseek-v3 in ``dense``: paged
  against the dense slab, the prefix cache, the overcommitted pool with
  replay and with the host swap, speculative decoding, the wave prefill
  and sampling each give the uncontended engine's streams token for
  token, as ``tests/test_paging.py`` and ``tests/test_prefix_cache.py``
  hold the reference; an MLA page round-trips through the host tier bit
  for bit.

The MoE capacity is taken over each call's token count (frozen and pad
rows included), so a stream depends on its batch wherever an expert
overflows, in the reference as here.  Every engine call below runs at
most 8 tokens (prefill_len 8, 2-3 slots, a spec verify of 2 x 4, a wave
of 2 x 4), and the capacity floor of 8 rows an expert then keeps every
assignment, so rows stay independent and the bit-match rules of the
dense models apply.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.engine as jengine
import test_torch_engine as te
import test_torch_model as tm
from repro import models as jmodels
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import init_caches as jinit_caches
from repro.models import merge_slot_caches as jmerge
from repro.models import merge_slot_paged_caches as jmerge_paged
from repro.models import moe as jmoe
from repro_torch.configs import get_config, reduced
from repro_torch.models import (
    decode_step,
    extract_cache_pages,
    forward,
    init_caches,
    insert_cache_pages,
    merge_slot_caches,
    merge_slot_paged_caches,
    model_init,
    prefill,
)
from repro_torch.models import moe as tmoe
from repro_torch.serve import Engine, ServeConfig

torch.set_num_threads(1)

# Routing ties.  The reduced router (0.02-scaled, d_model 64, 4 experts)
# gives logits of ~0.1, so the second and third choices are often close,
# and the MoE layer's input carries the earlier layers' rounding
# differences (see LOGIT_ATOL): a token may pick another expert in the
# port.  Such a flip is held to a tie: the reference's router logits of
# the two experts at most ROUTE_TIE apart (one bf16 ulp of a logit in
# [0.125, 0.25) is 2**-10; an input row perturbed by bf16 roundings moves
# a logit by ~|h| * 2**-8 * 0.02 * sqrt(64) ~ 1e-3).  The flipped rows are
# then left out of the logit comparison (a different expert's output is
# a different value, not a rounding), and so are the later positions of
# their sequence when a layer follows.  The aux loss sums the router's
# probabilities, which move with the input the same way: AUX_ATOL.
ROUTE_TIE = 4e-3
AUX_ATOL = 5e-3

# Every logit below holds ``tm.LOGIT_ATOL``.  The w8a8 decode on the MLA
# and MoE models held 0.16 while the reference ran with excess precision
# (a decode step quantizes each projection's input per tensor over the
# whole batch, so a rounding difference upstream moves a scale); against
# ``tm.exact_jit`` it measured (on a CPU) 0 on deepseek-v3 and at most
# 0.0430 on llama4 (paged), within LOGIT_ATOL with a margin of 1.45x.

ARCHS = ["gemma3-1b", "gemma-7b", "deepseek-v3-671b",
         "llama4-maverick-400b-a17b", "mamba2-780m", "jamba-v0.1-52b"]
DEEPSEEK = "deepseek-v3-671b"
LLAMA4 = "llama4-maverick-400b-a17b"
MAMBA2 = "mamba2-780m"
JAMBA = "jamba-v0.1-52b"


def _n_layers(arch):
    # reduced mamba2 is one layer; two run the stack
    return 2 if arch == MAMBA2 else reduced(get_config(arch)).n_layers


def _has_mamba(cfg):
    return any(s.mixer == "mamba" for s in cfg.layer_specs)


def _pair(arch, **over):
    return tm._pair(arch, n_layers=_n_layers(arch), **over)


class _Routes:
    """Records every MoE routing of both packages, call by call (the
    reference's through ``jax.debug.callback``, so it runs inside jit
    and the block scan)."""

    def __init__(self, monkeypatch):
        self.j, self.t = [], []
        orig_j, orig_t = jmoe._route, tmoe._route

        def jroute(params, cfg, xt):
            out = orig_j(params, cfg, xt)
            logits = jnp.dot(xt, params["router"].astype(xt.dtype),
                             preferred_element_type=jnp.float32)
            jax.debug.callback(
                lambda e, lg: self.j.append((np.asarray(e), np.asarray(lg))),
                out[1], logits, ordered=True)
            return out

        def troute(params, cfg, xt):
            out = orig_t(params, cfg, xt)
            self.t.append(out[1].numpy())
            return out

        monkeypatch.setattr(jmoe, "_route", jroute)
        monkeypatch.setattr(tmoe, "_route", troute)

    def flipped(self, b, s):
        """(B, S) mask of rows to leave out of this call's logit check:
        each flipped choice held to a tie, later positions of a flipped
        row's sequence left out too.  Clears the records."""
        # the reference's callbacks run asynchronously: wait for them
        jax.effects_barrier()
        assert len(self.j) == len(self.t), (len(self.j), len(self.t))
        mask = np.zeros(b * s, bool)
        for li, ((je, lg), te_) in enumerate(zip(self.j, self.t)):
            for t in np.nonzero((np.sort(je, -1) != np.sort(te_, -1))
                                .any(-1))[0]:
                only_j = np.setdiff1d(je[t], te_[t])
                only_t = np.setdiff1d(te_[t], je[t])
                gap = np.abs(lg[t, only_j][:, None]
                             - lg[t, only_t][None, :]).max()
                assert gap <= ROUTE_TIE, (
                    f"MoE layer {li}: token {t} routes to {te_[t]} in the "
                    f"port, {je[t]} in the reference, router logits "
                    f"{gap} apart: not a tie")
                mask[t] = True
        self.j.clear()
        self.t.clear()
        mask = mask.reshape(b, s)
        return np.maximum.accumulate(mask, axis=1) if len(mask) else mask


def _close_unflipped(got, want, skip, atol=tm.LOGIT_ATOL):
    """Logits (B, S, V) within ``atol`` on the rows not in ``skip``."""
    keep = ~skip
    tm._close(np.asarray(got, np.float32)[keep],
              np.asarray(want, np.float32)[keep], atol=atol)
    return int(skip.sum())


def _fresh(fn, **kw):
    """A new compile of a reference entry point (``tm.exact_jit``) through
    a new function object, so this test's routing recorder is traced in
    (JAX caches traces by function and static arguments)."""
    def call(*args, **kwargs):
        return fn(*args, **kwargs)

    return tm.exact_jit(call, static_argnums=1, **kw)


# ---------------------------------------------------------------------------
# Configs and the bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """Every field the port has holds the reference's value, at full
    size and reduced (layer specs compared as tuples: each package has
    its own ``LayerSpec`` class)."""
    def val(v):
        if isinstance(v, (list, tuple)):
            return tuple(dataclasses.astuple(x) for x in v)
        return v

    for jcfg, tcfg in ((jget_config(arch), get_config(arch)),
                       (jreduced(jget_config(arch)),
                        reduced(get_config(arch)))):
        for f in tcfg.__dataclass_fields__:
            if f == "quant_backend":
                continue
            assert val(getattr(tcfg, f)) == val(getattr(jcfg, f)), (arch, f)
        assert val(tcfg.layer_specs) == val(jcfg.layer_specs)


def test_bridge_copies_mla_and_moe_leaves_exactly():
    jcfg, jp, tcfg, tp = _pair(DEEPSEEK)
    assert len(tp["layers"]) == 4
    stack = jp["stack"]
    for i in range(3):
        for name in ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo"):
            np.testing.assert_array_equal(
                tp["layers"][i]["attn"][name]["w"].float().numpy(),
                np.asarray(stack["prefix"][i]["attn"][name]["w"]
                           .astype(jnp.float32)))
        assert "mlp" in tp["layers"][i] and "moe" not in tp["layers"][i]
    moe_j = stack["blocks"]["0"]["moe"]
    moe_t = tp["layers"][3]["moe"]
    assert moe_t["router"].dtype == torch.float32
    np.testing.assert_array_equal(moe_t["router"].numpy(),
                                  np.asarray(moe_j["router"][0]))
    for name in ("w_gate", "w_up", "w_down"):
        assert moe_t[name].dtype == torch.bfloat16
        assert moe_t[name].shape == moe_j[name].shape[1:]
        np.testing.assert_array_equal(
            moe_t[name].float().numpy(),
            np.asarray(moe_j[name][0].astype(jnp.float32)))
    np.testing.assert_array_equal(
        moe_t["shared"]["down"]["w"].float().numpy(),
        np.asarray(moe_j["shared"]["down"]["w"][0].astype(jnp.float32)))
    assert tp["layers"][3]["attn"]["q_a_norm"]["scale"].dtype \
        == torch.float32


def test_prepare_quantizes_projections_not_expert_stacks():
    cfg = reduced(get_config(DEEPSEEK)).replace(quant_mode="w8a8_nibble")
    p = model_init(cfg, seed=1, device="cpu")
    for name in ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo"):
        assert p["layers"][0]["attn"][name]["qt8"].dtype == torch.int8
    moe = p["layers"][3]["moe"]
    assert "qt8" in moe["shared"]["gate"]
    assert set(moe) == {"router", "w_gate", "w_up", "w_down", "shared"}


# ---------------------------------------------------------------------------
# Model: forward, prefill + decode
# ---------------------------------------------------------------------------

MODES = ["dense", "w8a8_nibble"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match(monkeypatch, arch, mode):
    """Measured on a CPU: equal in 10 of 12 cases, 3.7e-5 (gemma3-1b) and
    0.0156 (deepseek-v3), both ``dense``."""
    jcfg, jp, tcfg, tp = _pair(arch, quant_mode=mode, attn_impl="flash")
    routes = _Routes(monkeypatch)
    toks = np.random.default_rng(0).integers(0, 256, (2, 11)).astype(np.int32)
    want, jaux = _fresh(jmodels.forward)(jp, jcfg, jnp.asarray(toks))
    got, aux = forward(tp, tcfg, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close_unflipped(got, want, routes.flipped(2, 11))
    assert abs(float(aux) - float(jaux)) <= AUX_ATOL
    assert (float(aux) > 0) == (tcfg.n_experts > 0)


@pytest.mark.parametrize("cache_mode", ["dense", "paged"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match(monkeypatch, arch, mode, cache_mode):
    """Two prompts prefilled alone (padded, per-row ``logits_index``; at
    their exact length on mamba models, whose state pad tokens would
    run through), moved into a 3-slot cache (slab rows or pages, mamba
    state at the slot's row), then 3 decode steps at per-slot positions,
    flash attention (the paged kernel's plain version on GQA pools; MLA
    gathers its latent pages).  Measured on a CPU: every w8a8 dense-slab
    case equal but llama4's (3.1e-5); the largest, 0.0547 (jamba, dense,
    paged), 0.0469 (jamba, dense, slab), 0.0430 (llama4, w8a8, paged)."""
    over = dict(quant_mode=mode, attn_impl="flash", cache_mode=cache_mode,
                page_size=4)
    jcfg, jp, tcfg, tp = _pair(arch, **over)
    routes = _Routes(monkeypatch)
    jprefill = _fresh(jmodels.prefill, static_argnames=("max_len",))
    jdecode = _fresh(jmodels.decode_step)
    rng = np.random.default_rng(1)
    max_len, pad = 16, 8
    lens = [5, 8]
    prompts = np.zeros((2, pad), np.int32)
    for i, n in enumerate(lens):
        prompts[i, :n] = rng.integers(0, 256, n)
    jcaches = jinit_caches(jcfg, 3, max_len)
    tcaches = init_caches(tcfg, 3, max_len, device="cpu")
    table = np.zeros((3, max_len // 4), np.int32)
    table[0, :4] = [1, 2, 3, 4]
    table[2, :4] = [8, 7, 6, 5]
    grow = max_len if cache_mode == "dense" else pad
    for slot, row in ((0, 0), (2, 1)):
        p = prompts[row:row + 1]
        if _has_mamba(tcfg):
            p = p[:, :lens[row]]
        jl, jone, _ = jprefill(jp, jcfg, jnp.asarray(p), max_len=grow,
                               logits_index=lens[row] - 1)
        tl, tone, _ = prefill(tp, tcfg, torch.from_numpy(p), max_len=grow,
                              logits_index=lens[row] - 1)
        skip = routes.flipped(1, p.shape[1])[:, lens[row] - 1:lens[row]]
        _close_unflipped(tl, jl, skip)
        if cache_mode == "dense":
            jcaches = jmerge(jcaches, jone, slot)
            merge_slot_caches(tcaches, tone, slot)
        else:
            jcaches = jmerge_paged(jcaches, jone, slot,
                                   jnp.asarray(table[slot]))
            merge_slot_paged_caches(tcaches, tone, slot,
                                    torch.from_numpy(table[slot]))
    pos = np.array([lens[0], 3, lens[1]], np.int32)
    tok = rng.integers(0, 256, (3, 1)).astype(np.int32)
    page_j = jnp.asarray(table) if cache_mode == "paged" else None
    page_t = torch.from_numpy(table) if cache_mode == "paged" else None
    for _ in range(3):
        jl, jcaches = jdecode(jp, jcfg, jnp.asarray(tok), jcaches,
                              jnp.asarray(pos), page_table=page_j)
        tl, tcaches = decode_step(tp, tcfg, torch.from_numpy(tok), tcaches,
                                  torch.from_numpy(pos), page_table=page_t)
        _close_unflipped(tl, jl, routes.flipped(3, 1))
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        pos = pos + 1


def test_mla_caches_are_latent_pools():
    cfg = reduced(get_config(DEEPSEEK)).replace(cache_mode="paged",
                                                page_size=4)
    caches = init_caches(cfg, 2, 8, device="cpu")
    assert len(caches) == 4
    for c in caches:
        assert set(c) == {"c_kv", "k_rope"}
        assert c["c_kv"].shape == (5, 4, cfg.kv_lora_rank)
        assert c["k_rope"].shape == (5, 4, cfg.qk_rope_dim)


# ---------------------------------------------------------------------------
# Engine against the reference engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,cache_mode,mode", [
    (a, c, m) for a, c in ((DEEPSEEK, "dense"), (DEEPSEEK, "paged"),
                           (LLAMA4, "paged"), (MAMBA2, "dense"),
                           (MAMBA2, "paged"), (JAMBA, "paged"))
    for m in MODES])
def test_engine_streams_match_reference(monkeypatch, arch, cache_mode, mode):
    """The staggered workload of ``test_torch_engine.py`` (6 requests
    through 3 slots) through both engines, under the same batch
    composition; the tie rule of that file.  The reference engine's
    stages compile as ``tm.exact_jit`` does (``tm.exact_engine``)."""
    over = dict(quant_mode=mode, attn_impl="flash", cache_mode=cache_mode,
                page_size=4)
    jcfg, jparams, tcfg, tparams = _pair(arch, **over)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab_size, p).astype(np.int32)
               for p, _ in te.SPEC]
    records = te._recorders(monkeypatch)
    kw = dict(batch=3, max_len=24, prefill_len=8, decode_chunk=3)
    tm.exact_engine(monkeypatch)
    jeng = jengine.Engine(jcfg, jparams, jengine.ServeConfig(**kw))
    jids = [jeng.submit(p, n) for p, (_, n) in zip(prompts, te.SPEC)]
    jdone = jeng.run()
    teng = Engine(tcfg, tparams, ServeConfig(**kw), device="cpu")
    tids = [teng.submit(p, n) for p, (_, n) in zip(prompts, te.SPEC)]
    tdone = teng.run()
    assert teng.leaked_pages() == 0
    firsts = []
    for jid, tid, prompt, (_, n) in zip(jids, tids, prompts, te.SPEC):
        want, got = jdone[jid].tokens, tdone[tid].tokens
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


# ---------------------------------------------------------------------------
# Engine invariants inside the port (reduced deepseek-v3, dense)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def deepseek():
    cfg = reduced(get_config(DEEPSEEK))
    return cfg, model_init(cfg, seed=0, device="cpu")


def _scfg(**over):
    kw = dict(batch=3, max_len=16, prefill_len=8, decode_chunk=3,
              cache_mode="paged", page_size=4)
    kw.update(over)
    return ServeConfig(**kw)


SLAB = dict(cache_mode="dense", page_size=None)
OVERCOMMIT = dict(alloc_mode="incremental", num_pages=7)


def _drive(cfg, params, prompts, budgets, scfg):
    engine = Engine(cfg, params, scfg, device="cpu")
    ids = [engine.submit(p, n) for p, n in zip(prompts, budgets)]
    done = engine.run()
    return engine, [done[i].tokens for i in ids]


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _leaks(engine) -> int:
    engine.release_prefix_cache()
    return engine.leaked_pages()


@pytest.mark.parametrize("arch", [DEEPSEEK, LLAMA4])
def test_paged_mla_and_moe_match_dense(arch):
    """``tests/test_paging.py::test_paged_mla_and_hybrid_match_dense`` in
    the port: latent pools (deepseek) and MoE over GQA pools (llama4)
    bit-match their dense slabs."""
    cfg = reduced(get_config(arch))
    params = model_init(cfg, seed=0, device="cpu")
    prompts = _prompts(cfg.vocab_size, (3, 6), seed=2)
    _, want = _drive(cfg, params, prompts, [4, 4], _scfg(batch=2, **SLAB))
    engine, got = _drive(cfg, params, prompts, [4, 4], _scfg(batch=2))
    assert got == want
    assert engine.leaked_pages() == 0


def test_mla_shared_prefix_bitmatch(deepseek):
    """``tests/test_prefix_cache.py::test_mla_shared_prefix_bitmatch`` in
    the port: latent pools share prefix pages; the spliced latents
    decompress bit-identically."""
    cfg, params = deepseek
    rng = np.random.default_rng(9)
    head = rng.integers(0, cfg.vocab_size, 4)
    prompts = [np.concatenate([head, rng.integers(0, cfg.vocab_size, t)])
               .astype(np.int32) for t in (2, 3)]
    _, want = _drive(cfg, params, prompts, [4, 4], _scfg(batch=2))
    engine, got = _drive(cfg, params, prompts, [4, 4],
                         _scfg(batch=2, prefix_cache=True))
    assert got == want
    assert engine.stats["prefix_hits"] >= 1
    assert _leaks(engine) == 0


def test_mla_overcommit_replay_and_swap_bitmatch(deepseek):
    """An overcommitted pool preempts; replay and the host swap both give
    the slab's streams, the swap in fewer decode chunks."""
    cfg, params = deepseek
    prompts = _prompts(cfg.vocab_size, (4, 6, 5, 7), seed=4)
    budgets = [8] * 4
    _, want = _drive(cfg, params, prompts, budgets, _scfg(**SLAB))
    replay, got = _drive(cfg, params, prompts, budgets, _scfg(**OVERCOMMIT))
    swap, got_swap = _drive(cfg, params, prompts, budgets,
                            _scfg(swap_mode="host", **OVERCOMMIT))
    assert got == want and got_swap == want
    assert replay.stats["preemptions"] >= 1
    st = swap.stats
    assert st["swap_out"] >= 1 and st["swap_in"] == st["swap_out"]
    assert st["decode_chunks"] < replay.stats["decode_chunks"]
    assert _leaks(replay) == 0 and _leaks(swap) == 0
    assert swap.host_pool.in_use == 0


def test_mla_spec_decode_bitmatches(deepseek):
    """A ``w8a8_nibble`` draft proposes 3 tokens a round; the dense verify
    (2 slots x 4 rows) emits the non-spec dense engine's streams."""
    cfg, params = deepseek
    prompts = _prompts(cfg.vocab_size, (5, 3, 6), seed=5)
    budgets = [6] * 3
    _, want = _drive(cfg, params, prompts, budgets, _scfg(batch=2))
    engine, got = _drive(cfg, params, prompts, budgets, _scfg(
        batch=2, alloc_mode="incremental", spec_decode=True, spec_k=3,
        spec_quant_mode="w8a8_nibble"))
    assert got == want
    assert engine.stats["spec_rounds"] > 0
    assert engine.compile_counts == {"prefill": 1, "decode_chunk": 0,
                                     "draft": 1, "verify": 1}
    assert _leaks(engine) == 0


def test_mla_wave_prefill_bitmatches(deepseek):
    cfg, params = deepseek
    prompts = _prompts(cfg.vocab_size, (7, 5, 6, 4), seed=6)
    _, want = _drive(cfg, params, prompts, [6] * 4, _scfg())
    engine, got = _drive(cfg, params, prompts, [6] * 4,
                         _scfg(prefill_chunk=4, admit_group=2))
    assert got == want
    assert engine.compile_counts == {"prefill": 0, "decode_chunk": 1,
                                     "prefill_chunk": 1}
    assert engine.stats["prefill_waves"] >= 1
    assert _leaks(engine) == 0


def test_mla_sampled_streams_stable_under_replay_and_swap(deepseek):
    cfg, params = deepseek
    prompts = _prompts(cfg.vocab_size, (4, 6, 5, 7), seed=7)
    budgets = [8] * 4
    samp = dict(temperature=0.7)
    _, want = _drive(cfg, params, prompts, budgets, _scfg(**samp))
    replay, got = _drive(cfg, params, prompts, budgets,
                         _scfg(**samp, **OVERCOMMIT))
    swap, got_swap = _drive(cfg, params, prompts, budgets,
                            _scfg(swap_mode="host", **samp, **OVERCOMMIT))
    assert replay.stats["preemptions"] >= 1 and swap.stats["swap_in"] >= 1
    assert got == want and got_swap == want
    assert _leaks(replay) == 0 and _leaks(swap) == 0


@pytest.mark.parametrize("pad_to", [None, 4])
def test_mla_page_roundtrip_through_host(pad_to):
    """MLA pools (latents (ps, 16) and rope keys (ps, 8)) in one flat
    payload a page: pages 3, 6, 1 out to the host and back into 2, 5, 8
    bit for bit; pad rows land on the trash page only."""
    cfg = reduced(get_config(DEEPSEEK)).replace(cache_mode="paged",
                                                page_size=4)
    caches = init_caches(cfg, 2, 16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for c in caches:
        for pool in c.values():
            pool.copy_(torch.randn(pool.shape, generator=gen))
    before = [{k: v.clone() for k, v in c.items()} for c in caches]
    src, dst = [3, 6, 1], [2, 5, 8]
    pay = extract_cache_pages(caches, src, pad_to=pad_to)
    assert len(pay) == 3
    assert all(p.shape == (4 * 4 * (16 + 8),) for p in pay)
    insert_cache_pages(caches, dst, pay, pad_to=pad_to)
    untouched = [p for p in range(caches[0]["c_kv"].shape[0])
                 if p not in dst and p != 0]
    for c, b in zip(caches, before):
        for key in c:
            assert torch.equal(c[key][dst].view(torch.int16),
                               b[key][src].view(torch.int16))
            assert torch.equal(c[key][untouched], b[key][untouched])
    with pytest.raises(ValueError, match="payloads"):
        insert_cache_pages(caches, dst[:2], pay)


def test_launcher_serves_deepseek_on_cpu(capsys):
    """``--arch`` takes the new names (reduced deepseek-v3, an
    overcommitted incremental pool that must preempt)."""
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--arch", DEEPSEEK, "--workload", "bursty",
          "--cache-mode", "paged", "--page-size", "4", "--alloc-mode",
          "incremental", "--num-pages", "6", "--batch", "2",
          "--prompt-len", "8", "--new-tokens", "8", "--requests", "4",
          "--quant", "w8a8_nibble"])
    out = capsys.readouterr().out
    assert "arch=deepseek-v3-671b" in out and "preemptions" in out
