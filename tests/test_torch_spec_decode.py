"""Self-speculative decoding in the port (greedy), against the reference.

* ``spec_split`` and the engine's draft weights: the draft mode's int8
  copies are prepared once, at construction, beside the bf16 ``w`` the
  dense verifier reads; ``linear_apply`` in the draft mode then never
  quantizes a weight.
* The greedy contracts of the reference's ``tests/test_spec_decode.py``
  held inside the port (reduced yi-6b, the port's own weights, CPU,
  plain kernel versions): a spec stream equals the non-spec dense
  engine's token for token, also on the dense slab and after a
  preemption mid-stream; zero leaks; the stage pins
  ``{"prefill": 1, "decode_chunk": 0, "draft": 1, "verify": 1}``.
* Cross-package: the port's spec engine and the reference's on the same
  seed-pinned prompts and the reference's weights (``load_jax_params``),
  with a ``w8a8_nibble`` draft, paged and incremental: equal streams
  under ``test_torch_engine.py``'s tie rule, and equal spec counters
  where no stream diverges.

``reference_margin`` finds, in the reference's own run, the logits with
which it emitted a token (a plain decode step, a verify row, a wave row
or a prefill) for the tie rule; ``test_torch_wave.py`` uses it too.
"""

import jax
import numpy as np
import pytest
import torch

import repro.serve.engine as jengine
import test_torch_engine as te
import test_torch_model as tm
from repro.configs.base import QUANT_MODES as JQUANT_MODES
from repro_torch.configs import QUANT_MODES, get_config, reduced, spec_split
from repro_torch.core import linear as tlin
from repro_torch.models import model_init
from repro_torch.serve import Engine, ServeConfig, run_timed_workload

torch.set_num_threads(1)

SPEC_COUNTS = {"prefill": 1, "decode_chunk": 0, "draft": 1, "verify": 1}
SPEC_COUNTERS = ("spec_rounds", "spec_proposed", "spec_accepted",
                 "spec_rollback_pages", "prefill_waves")


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config("yi-6b"))
    return cfg, model_init(cfg, device="cpu")


def _scfg(**over):
    kw = dict(batch=2, max_len=16, prefill_len=8, decode_chunk=3,
              cache_mode="paged", page_size=4)
    kw.update(over)
    return ServeConfig(**kw)


def _drive(cfg, params, prompts, budgets, scfg):
    engine = Engine(cfg, params, scfg, device="cpu")
    ids = [engine.submit(p, n) for p, n in zip(prompts, budgets)]
    done = engine.run()
    return engine, [done[i] for i in ids]


def _prompts(vocab, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(3, 7))).astype(np.int32)
            for _ in range(n)]


# ---------------------------------------------------------------------------
# The split and the draft weights
# ---------------------------------------------------------------------------

def test_spec_split_pins_dense_verifier():
    cfg = reduced(get_config("yi-6b")).replace(quant_mode="w4a8_nibble")
    draft, verify = spec_split(cfg)
    assert draft.quant_mode == "w4a8_nibble"
    assert verify.quant_mode == "dense"
    draft2, _ = spec_split(cfg, "w8a8_nibble")
    assert draft2.quant_mode == "w8a8_nibble"
    with pytest.raises(ValueError, match="unknown draft quant mode"):
        spec_split(cfg, "int2")
    assert QUANT_MODES == JQUANT_MODES


def test_draft_weights_prepared_once(monkeypatch, model):
    """The draft's int8 weights are prepared at construction; serving
    then quantizes no weight, and the verifier's bf16 ``w`` stays."""
    cfg, _ = model
    params = model_init(cfg, device="cpu")          # dense: no int8 copy
    calls = []
    orig = tlin._quantize_weight
    monkeypatch.setattr(tlin, "_quantize_weight",
                        lambda w, bits: calls.append(bits) or orig(w, bits))
    engine = Engine(cfg, params, _scfg(spec_decode=True,
                                       spec_quant_mode="w8a8_nibble"),
                    device="cpu")
    n_linears = 7 * cfg.n_layers
    assert calls == [8] * n_linears
    for layer in params["layers"]:
        for lin in (*layer["attn"].values(), *layer["mlp"].values()):
            if "w" in lin:
                assert lin["w"].dtype == torch.bfloat16 and "qt8" in lin
    ids = [engine.submit(p, 6) for p in _prompts(cfg.vocab_size, 2)]
    done = engine.run()
    assert all(len(done[i].tokens) == 6 for i in ids)
    assert engine.spec_rounds > 0
    assert len(calls) == n_linears               # none per call
    # a second engine over the same params prepares nothing again
    Engine(cfg, params, _scfg(spec_decode=True,
                              spec_quant_mode="w8a8_nibble"), device="cpu")
    assert len(calls) == n_linears


# ---------------------------------------------------------------------------
# Greedy spec == non-spec dense, inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant,backend", [
    ("dense", "torch"), ("w8a8_nibble", "torch"), ("w8a8_nibble", "cuda")])
def test_spec_greedy_bitmatches_dense_engine(model, quant, backend):
    """Whatever the draft proposes, the emitted greedy stream is the
    non-spec dense engine's (the ``cuda`` backend runs the wrappers'
    plain versions on these CPU tensors)."""
    cfg, params = model
    prompts = _prompts(cfg.vocab_size, 3)
    budgets = [6, 6, 6]
    _, want = _drive(cfg, params, prompts, budgets,
                     _scfg(quant_mode="dense", quant_backend=backend))
    engine, got = _drive(
        cfg, params, prompts, budgets,
        _scfg(quant_mode="dense", quant_backend=backend,
              alloc_mode="incremental", spec_decode=True, spec_k=3,
              spec_quant_mode=quant))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert engine.leaked_pages() == 0
    assert engine.compile_counts == SPEC_COUNTS
    st = engine.stats
    assert st["spec_rounds"] > 0
    assert 0.0 <= st["acceptance_rate"] <= 1.0
    assert 1.0 <= st["tokens_per_step"] <= 3 + 1
    # no replay: every token but each request's first went through a round
    assert engine.spec_tokens == sum(len(r.tokens) - 1 for r in got)


def test_spec_dense_cache_mode_bitmatches(model):
    """The dense slab works too (rollback is a no-op there)."""
    cfg, params = model
    prompts = _prompts(cfg.vocab_size, 2, seed=3)
    _, want = _drive(cfg, params, prompts, [5, 5],
                     _scfg(cache_mode="dense", page_size=None))
    engine, got = _drive(cfg, params, prompts, [5, 5],
                         _scfg(cache_mode="dense", page_size=None,
                               spec_decode=True, spec_k=4,
                               spec_quant_mode="w8a8_nibble"))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert engine.compile_counts == SPEC_COUNTS


def test_spec_rejected_drafts_roll_back(model):
    """A ``w4a8_nibble`` draft disagrees with the dense argmax often
    enough to reject: the round's over-booked tail pages go back to the
    pool (``spec_rollback_pages``), the stream still equals the dense
    engine's, and nothing leaks."""
    cfg, params = model
    prompts = _prompts(cfg.vocab_size, 4, seed=1)
    budgets = [10] * 4
    _, want = _drive(cfg, params, prompts, budgets, _scfg(max_len=24))
    engine, got = _drive(cfg, params, prompts, budgets,
                         _scfg(max_len=24, alloc_mode="incremental",
                               spec_decode=True, spec_k=4,
                               spec_quant_mode="w4a8_nibble"))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    st = engine.stats
    assert st["acceptance_rate"] < 1.0
    assert st["spec_rollback_pages"] >= 1
    assert engine.leaked_pages() == 0


def test_spec_stream_preempted_mid_draft_resumes_bitmatch(model):
    """A spec request evicted between rounds resumes through prefill and
    forced-draft replay and still emits the non-spec dense stream;
    replayed tokens stay out of the acceptance statistics."""
    cfg, params = model
    rng = np.random.default_rng(7)
    lo_p = rng.integers(0, cfg.vocab_size, 5).astype(np.int32)
    hi_p = rng.integers(0, cfg.vocab_size, 4).astype(np.int32)
    engine = Engine(cfg, params,
                    _scfg(batch=1, alloc_mode="incremental",
                          spec_decode=True, spec_k=3,
                          spec_quant_mode="w8a8_nibble"), device="cpu")
    lo = engine.submit(lo_p, 7)
    engine.start()
    engine._admit(0.0)
    assert engine._slots[0] is not None and engine._slots[0].id == lo
    engine._run_spec_round(0.0)
    assert len(engine._slots[0].tokens) >= 1
    proposed_before = engine.spec_proposed
    hi = engine.submit(hi_p, 5, priority=5)
    engine._admit(0.0)                     # full batch: lo is evicted
    assert engine._slots[0].id == hi
    assert engine.preemptions == 1
    done = engine.run()
    assert engine.leaked_pages() == 0
    assert done[lo].preemptions == 1
    for rid, prompt, n in ((lo, lo_p, 7), (hi, hi_p, 5)):
        _, (ref,) = _drive(cfg, params, [prompt], [n],
                           _scfg(batch=1, quant_mode="dense"))
        assert done[rid].tokens == ref.tokens, rid
    assert engine.compile_counts == SPEC_COUNTS
    assert engine.spec_proposed <= engine.spec_rounds * 3
    assert engine.spec_proposed > proposed_before


def test_spec_rejects_bad_k_and_temperature_stays_unported(model):
    """Bad ``spec_k`` and draft modes raise.  Temperature is ported now
    (the name predates it): a sampled engine, spec or not, builds and
    serves, and its streams depend on the base key alone."""
    cfg, params = model
    with pytest.raises(ValueError, match="spec_k"):
        Engine(cfg, params, _scfg(spec_decode=True, spec_k=0), device="cpu")
    with pytest.raises(ValueError, match="unknown draft quant mode"):
        Engine(cfg, params, _scfg(spec_decode=True, spec_quant_mode="int2"),
               device="cpu")
    prompts = _prompts(cfg.vocab_size, 2, seed=4)
    for over in ({}, {"spec_decode": True}):
        runs = [[r.tokens for r in _drive(cfg, params, prompts, [5, 5],
                                          _scfg(temperature=0.7, **over))[1]]
                for _ in range(2)]
        assert runs[0] == runs[1]
        assert all(len(t) == 5 for t in runs[0])


def test_bursty_workload_reports_spec_columns(model):
    """Bursty arrivals drain through the spec engine; run_timed_workload's
    spec columns carry the engine's counters."""
    cfg, params = model
    engine = Engine(cfg, params,
                    _scfg(alloc_mode="incremental", spec_decode=True,
                          spec_k=3, spec_quant_mode="w8a8_nibble"),
                    device="cpu")
    r = run_timed_workload(engine, cfg.vocab_size, requests=4,
                           prompt_budget=6, new_tokens=4, stagger_s=0.005,
                           seed=3, arrival_mode="bursty")
    assert r["spec"] is True
    st = engine.stats
    assert r["acceptance_rate"] == round(st["acceptance_rate"], 3)
    assert r["tokens_per_step"] == round(st["tokens_per_step"], 3) >= 1.0
    assert r["spec_rollback_pages"] == st["spec_rollback_pages"]
    assert r["compile_counts"] == SPEC_COUNTS


# ---------------------------------------------------------------------------
# Cross-package parity
# ---------------------------------------------------------------------------

def recorders(monkeypatch):
    """Wrap the reference engine's model calls so that each reports its
    token block, positions, mode and full logits back to the host."""
    records = []
    orig_decode, orig_prefill = jengine.decode_step, jengine.prefill

    def decode_step(params, cfg, token, caches, index, **kw):
        logits, caches = orig_decode(params, cfg, token, caches, index,
                                     **kw)
        mode = cfg.quant_mode
        jax.debug.callback(
            lambda t, p, lg: records.append(
                ("decode", mode, np.asarray(t),
                 np.broadcast_to(np.asarray(p), (t.shape[0],)),
                 np.asarray(lg, np.float32))),
            token, index, logits, ordered=True)
        return logits, caches

    def prefill(params, cfg, tokens, **kw):
        out = orig_prefill(params, cfg, tokens, **kw)
        mode = cfg.quant_mode
        jax.debug.callback(
            lambda t, lg: records.append(
                ("prefill", mode, np.asarray(t)[0], None,
                 np.asarray(lg, np.float32)[0, -1])),
            tokens, out[0], ordered=True)
        return out

    monkeypatch.setattr(jengine, "decode_step", decode_step)
    monkeypatch.setattr(jengine, "prefill", prefill)
    return records


def reference_margin(records, mode, prompt, want, got, i):
    """``logit(want[i]) - logit(got[i])`` in the reference's own run: the
    logits of the ``mode`` call whose row at the input position of token
    ``i`` sees ``prompt + want[:i]`` there and emitted ``want[i]``."""
    seq = np.concatenate([prompt, np.asarray(want, np.int64)])
    pos = len(prompt) + i - 1
    for kind, m, tok, idx, lg in records:
        if m != mode:
            continue
        if kind == "prefill":
            if i == 0 and int(lg.argmax()) == want[0] and any(
                    np.array_equal(tok[:len(prompt) - s], prompt[s:])
                    for s in range(len(prompt))):
                return float(lg[want[i]] - lg[got[i]])
            continue
        for b in range(tok.shape[0]):
            j = pos - int(idx[b])
            if (0 <= j < tok.shape[1]
                    and np.array_equal(tok[b, :j + 1], seq[idx[b]:pos + 1])
                    and int(lg[b, j].argmax()) == want[i]):
                return float(lg[b, j, want[i]] - lg[b, j, got[i]])
    raise AssertionError(f"no reference call emitted token {i}")


def assert_streams_tie(records, mode, prompts, want, got, coupled):
    """The tie rule: each stream's first divergence must sit where the
    reference's own margin is within LOGIT_TOL; with ``coupled`` rows
    (integer modes: one activation scale per batch) only the first
    divergence in time is held.  Returns the number of equal streams."""
    firsts = []
    for prompt, w, g in zip(prompts, want, got):
        assert len(g) == len(w)
        diff = [i for i in range(len(w)) if w[i] != g[i]]
        if diff:
            i = diff[0]
            firsts.append((len(prompt) + i,
                           reference_margin(records, mode, prompt, w, g, i),
                           i))
    firsts.sort()
    for _, margin, i in (firsts[:1] if coupled else firsts):
        assert margin <= te.LOGIT_TOL, (
            f"streams diverge at token {i} where the reference's margin "
            f"is {margin} > {te.LOGIT_TOL}: not a tie")
    return len(prompts) - len(firsts)


def _draft_recorder(monkeypatch, mode):
    """The port engine's ``mode`` decode calls (the draft steps): token
    block, positions and greedy token per row, in order."""
    import repro_torch.serve.engine as tengine
    calls = []
    orig = tengine.decode_step

    def decode_step(params, cfg, token, caches, index, **kw):
        logits, caches = orig(params, cfg, token, caches, index, **kw)
        if cfg.quant_mode == mode:
            calls.append((token.numpy().copy(), index.numpy().copy(),
                          logits[:, -1].argmax(-1).numpy()))
        return logits, caches

    monkeypatch.setattr(tengine, "decode_step", decode_step)
    return calls


def _drafts_agree(records, calls, mode) -> bool:
    """Whether the port's draft steps equal the reference's call for call;
    the first that differs must differ only at a tie of the reference's
    own draft logits (within LOGIT_TOL)."""
    ref = [r for r in records if r[0] == "decode" and r[1] == mode]
    for (_, _, tok, idx, lg), (ptok, pidx, parg) in zip(ref, calls):
        if not (np.array_equal(tok, ptok) and np.array_equal(idx, pidx)):
            return False              # a stream or a schedule moved before
        jarg = lg[:, -1].argmax(-1)
        for b in np.nonzero(jarg != parg)[0]:
            margin = lg[b, -1, jarg[b]] - lg[b, -1, parg[b]]
            assert margin <= te.LOGIT_TOL, (
                f"draft tokens differ where the reference's margin is "
                f"{margin} > {te.LOGIT_TOL}: not a tie")
        if (jarg != parg).any():
            return False
    return len(ref) == len(calls)


def cross_package(monkeypatch, mode, prompts, n_new, emit_mode, **kw):
    """The prompts through the reference's engine (``xla``) and the port's
    (CPU), both on the reference's weights (reduced yi-6b, 2 layers,
    chunked attention); checks leaks, stage pins and the streams (tie
    rule).  The counters (``SPEC_COUNTERS``, preemptions) must be equal
    where every stream is equal and, with a draft, every draft step too
    (a draft at a tie of its own logits may be accepted on one side and
    rejected on the other without changing a stream).  Returns the port's
    engine and whether the counters were compared."""
    jcfg, jp, tcfg, tp = tm._pair("yi-6b", quant_mode=mode)
    records = recorders(monkeypatch)
    draft_mode = kw.get("spec_quant_mode") if kw.get("spec_decode") else None
    calls = _draft_recorder(monkeypatch, draft_mode)
    jeng = jengine.Engine(jcfg, jp, jengine.ServeConfig(**kw))
    jids = [jeng.submit(p, n_new) for p in prompts]
    jdone = jeng.run()
    teng = Engine(tcfg, tp, ServeConfig(**kw), device="cpu")
    tids = [teng.submit(p, n_new) for p in prompts]
    tdone = teng.run()
    teng.release_prefix_cache()
    assert teng.leaked_pages() == 0
    assert teng.compile_counts == jeng.compile_counts
    want = [jdone[i].tokens for i in jids]
    got = [tdone[i].tokens for i in tids]
    same = assert_streams_tie(records, emit_mode, prompts, want, got,
                              coupled=emit_mode != "dense")
    compared = same == len(prompts) and (
        draft_mode is None or _drafts_agree(records, calls, draft_mode))
    if compared:
        for key in SPEC_COUNTERS + ("preemptions",):
            assert getattr(teng, key) == getattr(jeng, key), key
    return teng, compared


@pytest.mark.parametrize("draft,seed", [
    ("w8a8_nibble", 0), ("w8a8_nibble", 2), ("w4a8_nibble", 1)])
@pytest.mark.parametrize("alloc_mode", ["reserve", "incremental"])
def test_spec_engine_matches_reference(monkeypatch, alloc_mode, draft,
                                       seed):
    """A dense engine with a quantized draft, paged, 3 slots, 6 prompts of
    3-8 tokens x 7 new tokens.  With the ``w8a8_nibble`` draft and seed 0
    every stream and every draft step is equal, so the counters are held
    equal; with seed 2 two streams meet exact bf16 ties (tie rule); the
    ``w4a8_nibble`` draft rejects, so incremental pages roll back."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 256, n).astype(np.int32)
               for n in (5, 8, 3, 6, 4, 7)]
    teng, compared = cross_package(
        monkeypatch, "dense", prompts, 7, "dense", batch=3, max_len=16,
        prefill_len=8, decode_chunk=3, cache_mode="paged", page_size=4,
        alloc_mode=alloc_mode, spec_decode=True, spec_k=3,
        spec_quant_mode=draft)
    assert teng.stats["spec_rounds"] > 0
    if (draft, seed) == ("w8a8_nibble", 0):
        assert compared
    if draft == "w4a8_nibble":
        assert teng.stats["acceptance_rate"] < 1.0
        assert (teng.stats["spec_rollback_pages"] >= 1) == (
            alloc_mode == "incremental")
