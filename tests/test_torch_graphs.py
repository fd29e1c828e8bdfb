"""The engine's captured stages (``_CapturedStage``: the decode chunk, and
under ``spec_decode`` the draft and the verify, from static buffers and,
on the card, CUDA graphs).

On the CPU (reduced yi-6b, plain kernel versions): ``capture=True``
raises, ``capture_counts`` reads 0 per captured stage, every call of a
stage through its static buffers equals the stage body called directly on
fresh tensors (the eager path) across refills, preemptions, prefix hits,
COW, swap-ins, spec rounds and sampling, cache and weight tensors keep
their storage across ``reset``, swap-ins and COW copies (a graph holds
raw pointers), and the launch-counter registry covers every counter.

Marked ``cuda`` (skipped without a card; no JAX): a captured engine's
streams equal a ``capture=False`` engine's token for token at reduced
width in each mode (yi-6b, on the bf16 and the int8 KV cache; the MLA,
MoE and SSD mixer families and whisper-base and phi-3-vision served
text-only too),
one capture per stage once warm, equal launch counters; the MoE block on
the card repeats bit for bit and routes as on the CPU; the sampler on the
card equals the sampler on the CPU.  Run on
the GPU machine with ``python -m pytest -q -m cuda
tests/test_torch_graphs.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lut_matmul as lm
from repro_torch.kernels import nibble_matmul as nm
from repro_torch.kernels import ops
from repro_torch.models import model_init
from repro_torch.serve import Engine, Router, ServeConfig
from repro_torch.serve import engine as eng
from repro_torch.serve import sampling
from repro_torch.tree import tree_paths

torch.set_num_threads(1)

SPEC_CAPTURES = {"decode_chunk": 0, "draft": 1, "verify": 1}


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config("yi-6b"))
    return cfg, model_init(cfg, device="cpu")


def _scfg(**over):
    kw = dict(batch=2, max_len=16, prefill_len=8, decode_chunk=3,
              cache_mode="paged", page_size=4)
    kw.update(over)
    return ServeConfig(**kw)


def _prompts(vocab, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(3, 8))).astype(np.int32)
            for _ in range(n)]


def _serve(engine, prompts, n_new=7):
    ids = [engine.submit(p, n_new) for p in prompts]
    done = engine.run()
    return [done[i].tokens for i in ids]


def _flat(x):
    return list(x) if isinstance(x, tuple) else [x]


def test_capture_true_on_cpu_raises(model):
    cfg, params = model
    with pytest.raises(ValueError, match="capture=True needs a CUDA"):
        Engine(cfg, params, _scfg(), device="cpu", capture=True)
    assert Engine(cfg, params, _scfg(), device="cpu",
                  capture=False).capture_counts == {"decode_chunk": 0}


@pytest.mark.parametrize("over,want", [
    ({}, {"decode_chunk": 0}),
    ({"spec_decode": True}, {"decode_chunk": 0, "draft": 0, "verify": 0})],
    ids=["chunk", "spec"])
def test_capture_counts_read_zero_on_cpu(model, over, want):
    cfg, params = model
    engine = Engine(cfg, params, _scfg(**over), device="cpu")
    _serve(engine, _prompts(cfg.vocab_size, 3))
    assert engine.capture_counts == want
    # every stage ran, under one signature each
    assert {k: engine.compile_counts[k] for k in want} == {
        k: int(not (over and k == "decode_chunk")) for k in want}


SHARED = np.arange(1, 9, dtype=np.int32)       # two full pages of 4


@pytest.mark.parametrize("over", [
    dict(alloc_mode="incremental", num_pages=6),
    dict(alloc_mode="incremental", num_pages=6, swap_mode="host"),
    dict(prefix_cache=True),
    dict(alloc_mode="incremental", num_pages=7, spec_decode=True,
         spec_quant_mode="w8a8_nibble"),
    dict(alloc_mode="incremental", num_pages=6, temperature=0.7),
    dict(alloc_mode="incremental", num_pages=7, spec_decode=True,
         temperature=0.7, swap_mode="host"),
    dict(cache_mode="dense", page_size=None)],
    ids=["preempt", "swap", "prefix-cow", "spec", "sampled",
         "spec-sampled-swap", "dense-slab"])
def test_static_stage_equals_direct_body(model, monkeypatch, over):
    """Every stage call through the static buffers returns what the stage
    body returns on fresh tensors made from the same host arrays (the
    eager path), call by call, over workloads that refill, preempt,
    swap, hit the prefix cache and copy on write.  The caches are
    restored between the two runs (a frozen slot reads the trash page,
    which the first run rewrote, and in w8a8 its rows move the batch's
    activation scale)."""
    cfg, params = model
    calls = []
    orig = eng._CapturedStage.__call__

    def checked(self, *args):
        pools = [t for c in self._fn.__self__._caches for t in c.values()]
        saved = [t.clone() for t in pools]
        fresh = [torch.tensor(a) if isinstance(a, np.ndarray) else a
                 for a in args]
        want = [t.clone() for t in _flat(self._fn(*fresh))]
        for t, v in zip(pools, saved):
            t.copy_(v)
        res = orig(self, *args)
        got = _flat(res)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        calls.append(self)
        return res

    monkeypatch.setattr(eng._CapturedStage, "__call__", checked)
    engine = Engine(cfg, params, _scfg(**over), device="cpu")
    prompts = _prompts(cfg.vocab_size, 5, seed=1) + [SHARED, SHARED]
    streams = _serve(engine, prompts)
    assert all(len(s) == 7 for s in streams)
    st = engine.stats
    assert len(calls) >= 4
    if "num_pages" in over:
        assert st["preemptions"] >= 1
    if over.get("swap_mode") == "host":
        assert st["swap_in"] >= 1
    if over.get("prefix_cache"):
        assert st["prefix_hits"] >= 1 and st["cow_copies"] >= 1
    engine.release_prefix_cache()
    assert engine.leaked_pages() == 0


def test_storage_kept_across_reset_swap_and_cow(model):
    """A captured graph holds raw pointers: the cache pools and the
    weights (the draft's prepared int8 copies included) keep their
    storage across a run with swap-ins and COW copies and a ``reset``."""
    cfg, params = model
    engine = Engine(cfg, params, _scfg(
        alloc_mode="incremental", num_pages=6, swap_mode="host",
        prefix_cache=True, spec_decode=True,
        spec_quant_mode="w8a8_nibble"), device="cpu")

    def storage():
        return ([t.data_ptr() for c in engine._caches for t in c.values()]
                + [t.data_ptr() for _, t in tree_paths(engine.params)])

    caches, before = engine._caches, storage()
    prompts = _prompts(cfg.vocab_size, 4, seed=2) + [SHARED, SHARED]
    _serve(engine, prompts)
    st = engine.stats
    assert st["swap_in"] >= 1 and st["cow_copies"] >= 1
    engine.reset()
    _serve(engine, prompts)
    assert engine._caches is caches and storage() == before


def test_launch_counter_registry_covers_every_counter():
    """``ops.LAUNCH_COUNTERS`` names every wrapper's counter (a replay adds
    to each), and ``add_launch_counts`` adds to them in order."""
    named = {(m.__name__, a) for m in (nm, lm, fa) for a in vars(m)
             if a.endswith("launches") and isinstance(getattr(m, a), int)}
    assert {(m.__name__, a) for m, a in ops.LAUNCH_COUNTERS} == named
    before = ops.launch_counts()
    delta = list(range(1, len(before) + 1))
    ops.add_launch_counts(delta)
    try:
        assert ops.launch_counts() == [b + d for b, d in zip(before, delta)]
    finally:
        ops.add_launch_counts([-d for d in delta])
    assert ops.launch_counts() == before


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the kernels run "
                    "only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode,over", [
    ("w8a8_nibble", {}),
    ("dense", {}),
    ("lut", {}),
    ("w8a8_nibble", {"alloc_mode": "incremental", "num_pages": 6,
                     "swap_mode": "host", "prefix_cache": True}),
    ("w8a8_nibble", {"temperature": 0.7}),
    ("dense", {"cache_mode": "dense", "page_size": None}),
    ("dense", {"spec_decode": True, "spec_quant_mode": "w8a8_nibble",
               "alloc_mode": "incremental"}),
    ("dense", {"spec_decode": True, "spec_quant_mode": "w8a8_nibble",
               "temperature": 0.7})],
    ids=["nibble", "dense", "lut", "nibble-swap-prefix", "nibble-sampled",
         "dense-slab", "spec", "spec-sampled"])
def test_captured_streams_equal_eager(cuda, mode, over):
    """The same requests through a captured engine and a ``capture=False``
    one on the card: equal streams token for token, one capture per
    captured stage once warm (a second run captures nothing new), and
    equal launch counters (a replay adds its capture's counts)."""
    _captured_vs_eager(cuda, reduced(get_config("yi-6b")).replace(
        quant_mode=mode, quant_backend="cuda", attn_impl="flash"), over)


def _captured_vs_eager(cuda, cfg, over, launches=True):
    """``launches``: some kernel must launch (a dense MLA engine whose
    prefills are context prefills or waves runs none: MLA decodes through
    gathered pages, dense projections are plain matmuls)."""
    params = model_init(cfg, seed=0, device=cuda)
    prompts = _prompts(cfg.vocab_size, 5, seed=3) + [SHARED, SHARED]
    out = {}
    for capture in (False, True):
        engine = Engine(cfg, params, _scfg(**over), device=cuda,
                        capture=capture)
        before = ops.launch_counts()
        first = _serve(engine, prompts)
        torch.cuda.synchronize()
        counts = [a - b for a, b in zip(ops.launch_counts(), before)]
        engine.release_prefix_cache()
        assert engine.leaked_pages() == 0
        again = _serve(engine, prompts[:3])
        out[capture] = (first, again, counts, engine.capture_counts,
                        engine.compile_counts)
    eager, captured = out[False], out[True]
    assert captured[0] == eager[0] and captured[1] == eager[1]
    assert captured[2] == eager[2] and (sum(captured[2]) > 0) == launches
    assert set(eager[3].values()) == {0}
    want = (SPEC_CAPTURES if over.get("spec_decode")
            else {"decode_chunk": 1})
    assert captured[3] == want
    assert captured[4] == eager[4]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,mode,over", [
    ("deepseek-v3-671b", "w8a8_nibble", {}),
    ("deepseek-v3-671b", "dense", {"alloc_mode": "incremental",
                                   "num_pages": 6, "swap_mode": "host",
                                   "prefix_cache": True}),
    ("deepseek-v3-671b", "dense", {"spec_decode": True,
                                   "spec_quant_mode": "w8a8_nibble",
                                   "alloc_mode": "incremental"}),
    ("deepseek-v3-671b", "dense", {"prefill_chunk": 4, "admit_group": 2}),
    ("llama4-maverick-400b-a17b", "w8a8_nibble", {"temperature": 0.7}),
    ("gemma3-1b", "w8a8_nibble", {})],
    ids=["deepseek-nibble", "deepseek-swap-prefix", "deepseek-spec",
         "deepseek-wave", "llama4-sampled", "gemma3"])
def test_captured_family_streams_equal_eager(cuda, arch, mode, over):
    """The MLA and MoE families (reduced) through a captured and an eager
    engine: the MoE dispatch reads nothing on the host, so its decode
    chunk, draft and verify capture; streams and launch counters equal
    (the MoE combine sums in a fixed order, never by atomics)."""
    _captured_vs_eager(cuda, reduced(get_config(arch)).replace(
        quant_mode=mode, quant_backend="cuda", attn_impl="flash"), over,
        launches=not (mode == "dense" and (over.get("prefix_cache")
                                           or over.get("prefill_chunk"))))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,mode,over", [
    ("mamba2-780m", "w8a8_nibble", {}),
    ("mamba2-780m", "dense", {"alloc_mode": "incremental",
                              "num_pages": 6}),
    ("jamba-v0.1-52b", "w8a8_nibble", {}),
    ("jamba-v0.1-52b", "dense", {"cache_mode": "dense",
                                 "page_size": None})],
    ids=["mamba2-nibble", "mamba2-overcommit", "jamba-nibble",
         "jamba-slab"])
def test_captured_ssm_streams_equal_eager(cuda, arch, mode, over):
    """The SSD mixer models (reduced) through a captured and an eager
    engine: ``mamba_step`` writes the conv and ssm state into the cache
    tensors in place, so the replayed decode chunk carries the state;
    streams and launch counters equal (a dense mamba2 engine launches no
    kernel: its projections are plain matmuls and it has no attention)."""
    _captured_vs_eager(cuda, reduced(get_config(arch)).replace(
        quant_mode=mode, quant_backend="cuda", attn_impl="flash"), over,
        launches=mode != "dense" or arch == "jamba-v0.1-52b")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,mode,cfg_over,over", [
    ("yi-6b", "w8a8_nibble", {"kv_cache_dtype": "int8"}, {}),
    ("yi-6b", "dense", {"kv_cache_dtype": "int8"},
     {"alloc_mode": "incremental", "num_pages": 6, "swap_mode": "host"}),
    ("yi-6b", "dense", {"kv_cache_dtype": "int8"},
     {"spec_decode": True, "spec_quant_mode": "w8a8_nibble",
      "alloc_mode": "incremental"}),
    ("phi-3-vision-4.2b", "w8a8_nibble", {}, {}),
    ("whisper-base", "w8a8_nibble", {}, {}),
    ("whisper-base", "dense", {}, {"cache_mode": "dense",
                                   "page_size": None})],
    ids=["int8-nibble", "int8-swap", "int8-spec", "phi3v-nibble",
         "whisper-nibble", "whisper-slab"])
def test_captured_int8_and_text_only_streams_equal_eager(cuda, arch, mode,
                                                         cfg_over, over):
    """The int8 KV cache (its decode gathers and dequantizes pages; the
    paged kernel stays off) and the encoder-decoder and VLM families
    served text-only (reduced) through a captured and an eager engine:
    streams and launch counters equal, one capture per stage."""
    _captured_vs_eager(cuda, reduced(get_config(arch)).replace(
        quant_mode=mode, quant_backend="cuda", attn_impl="flash",
        **cfg_over), over)


@pytest.mark.cuda
def test_moe_on_card_equals_cpu_routing_and_repeats(cuda):
    """``moe_apply`` on the card at reduced deepseek-v3 with drops (64
    tokens, capacity factor 0.01): two calls equal bit for bit, routing
    equal to the CPU's, outputs within 2e-2 of the CPU's."""
    from repro_torch.models import moe as tmoe
    cfg = reduced(get_config("deepseek-v3-671b")).replace(
        capacity_factor=0.01)
    p = tmoe.moe_init(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1)).bfloat16()
    pc = {k: ({n: {w: t.to(cuda) for w, t in v.items()} for n, v in
               t_.items()} if isinstance(t_, dict) else t_.to(cuda))
          for k, t_ in p.items()}
    a, aux_a = tmoe.moe_apply(pc, cfg, x.to(cuda))
    b, aux_b = tmoe.moe_apply(pc, cfg, x.to(cuda))
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    want, aux = tmoe.moe_apply(p, cfg, x)
    xt = x.reshape(-1, cfg.d_model)
    assert torch.equal(tmoe._route(pc, cfg, xt.to(cuda))[1].cpu(),
                       tmoe._route(p, cfg, xt)[1])
    torch.testing.assert_close(a.float().cpu(), want.float(), atol=2e-2,
                               rtol=0)
    assert abs(float(aux_a) - float(aux)) <= 1e-5


@pytest.mark.cuda
def test_sampler_on_card_equals_cpu(cuda):
    """The same keys give the same key words and uniform bits on the card
    as on the CPU; categorical draws from the same f32 logits agree
    except where the perturbed scores' top two lie within 1e-5."""
    keys = sampling.fold_in(sampling.prng_key(7)[None],
                            torch.arange(64))             # (64, 2)
    sub = sampling.fold_in(keys, 5)
    assert torch.equal(sampling.fold_in(keys.to(cuda), 5).cpu(), sub)
    assert torch.equal(sampling.random_bits(keys.to(cuda), (1000,)).cpu(),
                       sampling.random_bits(keys, (1000,)))
    logits = torch.randn((64, 64000), generator=torch.Generator()
                         .manual_seed(0)) * 3
    want = sampling.categorical(keys, logits)
    got = sampling.categorical(keys.to(cuda), logits.to(cuda)).cpu()
    scores = sampling.gumbel(keys, (64000,)) + logits
    top2 = scores.topk(2, dim=-1).values
    near = (top2[:, 0] - top2[:, 1]) < 1e-5
    assert torch.equal(got[~near], want[~near])


@pytest.mark.cuda
@pytest.mark.parametrize("quant_mode", ["dense", "w8a8_nibble"])
def test_captured_fleet_on_card(cuda, quant_mode):
    """Two replicas behind one ``Router`` on one card, captured: one CUDA
    graph per replica's decode chunk, one signature per stage, kernel
    launches, no leak after the prefix index is released, and the same
    streams when the fleet serves them again; in ``dense`` they equal one
    captured engine's (w8a8 activation scales span the batch, so
    placement moves quantized streams)."""
    cfg = reduced(get_config("yi-6b")).replace(
        quant_mode=quant_mode, quant_backend="cuda", attn_impl="flash")
    params = model_init(cfg, seed=0, device=cuda)
    scfg = _scfg(alloc_mode="incremental", num_pages=9, prefix_cache=True)
    prompts = _prompts(cfg.vocab_size, 6, seed=5) + [SHARED, SHARED]
    solo = _serve(Engine(cfg, params, scfg, device=cuda), prompts)
    fleet = Router(cfg, params, scfg, replicas=2, device=cuda)
    runs = []
    for _ in range(2):
        before = ops.launch_counts()
        fleet.reset()
        gids = [fleet.submit(p, 7) for p in prompts]
        done = fleet.run()
        torch.cuda.synchronize()
        runs.append(([done[g].tokens for g in gids],
                     [a - b for a, b in zip(ops.launch_counts(), before)]))
        fleet.release_prefix_cache()
        assert fleet.leaked_pages() == 0
    assert runs[0] == runs[1] and sum(runs[0][1]) > 0
    assert fleet.device_count == 1 and sum(fleet.placements) == 8
    assert fleet.compile_counts == {"prefill": 1, "decode_chunk": 1}
    assert fleet.capture_counts == {"decode_chunk": 1}
    if quant_mode == "dense":
        assert runs[0][0] == solo
