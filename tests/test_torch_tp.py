"""Tensor parallelism inside one engine, against the single-device port
and the reference.

The shards share the CPU (``devices=["cpu", "cpu"]``): torch has one
``cpu`` device and fakes no more, so this is the port's counterpart of
the reference tests' forced host device count.  What is held:

* Projections: column- and row-parallel at tp=2 (and the row path at
  tp=4) are bit-equal to tp=1 in ``w8a8_nibble``, ``w4a8_nibble`` and
  ``lut`` on both backends; ``dense`` row-parallel sums f32 partials and
  rounds once, within one bf16 rounding (2**-7 relative) of tp=1's bf16
  product, and column-parallel is exact; ``qat`` row-parallel (the
  shards' amaxes reduced by max) within the same rounding.
* A prefill and decode steps at tp=2 against tp=1 (equal bit for bit,
  measured on a CPU) and against the reference compiled by
  ``test_torch_model.exact_jit`` (within its LOGIT_ATOL), over paged
  pools and the dense slab.
* Engine greedy streams at tp=2 on the reference mesh test's workload
  (reduced qwen3-4b, 4 seeded prompts of 4-8 tokens, batch 2, paged page
  4, incremental, 10 pages) equal the port's tp=1 engine and the
  reference's tp=1 engine (``xla``, its stages compiled by
  ``exact_engine``), with the pins, no leak, ``mesh_shape`` (1, 2) and 2
  devices.
* Every engine mechanism keeps its rule inside tp=2 (paged = slab,
  preempted = reserve, swap = replay, prefix hits = misses, spec =
  non-spec, wave = monolithic, in ``dense``), and equals tp=1 with the
  same counters; gemma3-1b (KVH 1: attention replicated, tied head) at
  tp=2; a ``--dp 2 --tp 2`` fleet over four repeated CPU devices; the
  host payloads keep the unsharded layout; the families and the quant
  mode once refused (MLA, MoE, the encoder-decoder, the VLM, the mamba
  mixers, ``qat``) serve at tp=2; the refusal that remains (a data
  axis).  MLA, MoE, whisper and phi-3-vision at tp=2 in depth:
  ``tests/test_torch_tp_families.py``; the mamba mixers and ``qat``:
  ``tests/test_torch_tp_ssm.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.serve.engine as jengine
import test_torch_model as tm
from repro.models import init_caches as jinit_caches
from repro.models import merge_slot_caches as jmerge
from repro.models import merge_slot_paged_caches as jmerge_paged
from repro_torch.configs import get_config, reduced
from repro_torch.core.linear import (linear_apply, linear_apply_row,
                                     linear_init, prepare_quantized)
from repro_torch.distributed.sharding import TP_ROADMAP, shard_caches, \
    shard_params
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import (decode_step, extract_cache_pages,
                                init_caches, insert_cache_pages,
                                merge_slot_caches,
                                merge_slot_paged_caches, model_init, prefill)
from repro_torch.models.transformer import cache_bytes, init_shard_caches
from repro_torch.serve import Engine, Router, ServeConfig

torch.set_num_threads(1)

CPU2 = ["cpu", "cpu"]
INT_MODES = ["w8a8_nibble", "w4a8_nibble", "lut"]


def _mesh(tp=2):
    return make_local_mesh(tp=tp, devices=["cpu"] * tp)


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------

def _linear(mode, k=96, n=80, seed=0):
    g = torch.Generator().manual_seed(seed)
    p = linear_init(k, n, generator=g, device="cpu")
    prepare_quantized(p, mode)
    x = (torch.randn((3, 5, k), generator=g) * 0.7).bfloat16()
    return p, x


def _split(p, tp, dim_w):
    """Column (``dim_w`` 1) or row (0) shards of one prepared linear,
    as ``shard_params`` cuts them."""
    out = []
    for i in range(tp):
        part = {}
        for key, t in p.items():
            if key == "w":
                d = dim_w
            elif key.startswith("qt"):
                d = 1 - dim_w
            else:                           # the (1, N) scale
                d = 1 if dim_w == 1 else None
            if d is None:
                part[key] = t
            else:
                n = t.shape[d] // tp
                part[key] = t.narrow(d, i * n, n).contiguous()
        out.append(part)
    return out


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("mode", INT_MODES)
def test_column_and_row_projections_bit_equal(mode, backend):
    p, x = _linear(mode)
    want = linear_apply(p, x, mode=mode, backend=backend)
    cols = [linear_apply(s, x, mode=mode, backend=backend)
            for s in _split(p, 2, 1)]
    assert torch.equal(torch.cat(cols, dim=-1), want)
    for tp in (2, 4):
        k = x.shape[-1] // tp
        got = linear_apply_row(_split(p, tp, 0),
                               [x[..., i * k:(i + 1) * k] for i in range(tp)],
                               mode=mode, backend=backend)
        assert len(got) == tp
        assert all(torch.equal(t, want) for t in got)
        assert got[0] is got[1]             # one tensor per device


def test_dense_projections_within_one_rounding():
    """Column-parallel ``dense`` is exact; row-parallel sums f32 partials
    in shard order and rounds once, against tp=1's bf16 product (f32
    accumulation, another sum order): within one bf16 rounding, 2**-7
    relative."""
    p, x = _linear("dense")
    want = linear_apply(p, x, mode="dense")
    cols = [linear_apply(s, x, mode="dense") for s in _split(p, 2, 1)]
    assert torch.equal(torch.cat(cols, dim=-1), want)
    got = linear_apply_row(_split(p, 2, 0), [x[..., :48], x[..., 48:]],
                           mode="dense")[0]
    assert got.dtype == want.dtype
    diff = (got.float() - want.float()).abs()
    assert (diff <= 2.0 ** -7 * want.float().abs()).all()


def test_qat_has_no_row_parallel_projection():
    """``qat`` was refused a row-parallel projection until its scales
    were shared; now each of the activation's per-row and the weight's
    per-column fake-quant scales is the max of the shards' amaxes (the
    unsharded scale), and the f32 partial products summed in shard order
    and rounded once are within one bf16 rounding (2**-7 relative) of the
    unsharded ``qat`` projection, at tp=2 and tp=4."""
    p, x = _linear("dense")
    want = linear_apply(p, x, mode="qat")
    for tp in (2, 4):
        k = x.shape[-1] // tp
        got = linear_apply_row(_split(p, tp, 0),
                               [x[..., i * k:(i + 1) * k]
                                for i in range(tp)], mode="qat")
        assert len(got) == tp and got[0] is got[1]
        assert got[0].dtype == want.dtype
        diff = (got[0].float() - want.float()).abs()
        assert (diff <= 2.0 ** -7 * want.float().abs()).all()


# ---------------------------------------------------------------------------
# Prefill and decode steps
# ---------------------------------------------------------------------------

STEP_CASES = [("qwen3-4b", "w8a8_nibble", "paged"),
              ("qwen3-4b", "dense", "paged"),
              ("yi-6b", "w8a8_nibble", "dense"),
              ("yi-6b", "lut", "paged")]


@pytest.mark.parametrize("arch,mode,cache_mode", STEP_CASES)
def test_prefill_and_decode_tp2_match_tp1_and_reference(arch, mode,
                                                        cache_mode):
    """Prefill two prompts into slots 0 and 2 of a 3-slot cache (paged
    pools or the dense slab) at tp=1, tp=2 and in the reference, then
    three decode steps at per-slot positions: tp=2's logits equal
    tp=1's, and both hold the reference's within LOGIT_ATOL.  The tp=2
    caches come from ``init_shard_caches`` and, once, ``shard_caches`` of
    tp=1's: both decode the same."""
    over = dict(quant_mode=mode, attn_impl="flash", cache_mode=cache_mode,
                page_size=4, quant_backend="cuda")
    jcfg, jp, tcfg, tp1 = tm._pair(arch, **{k: v for k, v in over.items()
                                            if k != "quant_backend"})
    tcfg = tcfg.replace(quant_backend="cuda")
    tp2 = shard_params(tp1, tcfg, _mesh())
    rng = np.random.default_rng(1)
    max_len, pad, lens = 16, 8, [5, 8]
    prompts = np.zeros((2, pad), np.int32)
    for i, n in enumerate(lens):
        prompts[i, :n] = rng.integers(0, 256, n)
    table = np.zeros((3, max_len // 4), np.int32)
    table[0, :4] = [1, 2, 3, 4]
    table[2, :4] = [5, 6, 7, 8]
    grow = max_len if cache_mode == "dense" else pad
    jc = jinit_caches(jcfg, 3, max_len)
    c1 = init_caches(tcfg, 3, max_len, device="cpu")
    c2 = init_shard_caches(tcfg, 3, max_len, tp2)
    for slot, row in ((0, 0), (2, 1)):
        p = prompts[row:row + 1]
        jl, jone, _ = tm.jprefill(jp, jcfg, jax.numpy.asarray(p),
                                  max_len=grow, logits_index=lens[row] - 1)
        outs = [prefill(w, tcfg, torch.from_numpy(p), max_len=grow,
                        logits_index=lens[row] - 1) for w in (tp1, tp2)]
        assert torch.equal(outs[0][0], outs[1][0])
        tm._close(outs[1][0], jl)
        if cache_mode == "dense":
            jc = jmerge(jc, jone, slot)
            merge_slot_caches(c1, outs[0][1], slot)
            merge_slot_caches(c2, outs[1][1], slot)
        else:
            jc = jmerge_paged(jc, jone, slot, jax.numpy.asarray(table[slot]))
            for c, one in ((c1, outs[0][1]), (c2, outs[1][1])):
                merge_slot_paged_caches(c, one, slot,
                                        torch.from_numpy(table[slot]))
    c3 = shard_caches(c1, tcfg, _mesh(), batch=3)
    pos = np.array([lens[0], 3, lens[1]], np.int32)
    tok = rng.integers(0, 256, (3, 1)).astype(np.int32)
    page_j = jax.numpy.asarray(table) if cache_mode == "paged" else None
    page_t = torch.from_numpy(table) if cache_mode == "paged" else None
    for _ in range(3):
        jl, jc = tm.jdecode(jp, jcfg, jax.numpy.asarray(tok), jc,
                            jax.numpy.asarray(pos), page_table=page_j)
        got = [decode_step(w, tcfg, torch.from_numpy(tok), c,
                           torch.from_numpy(pos), page_table=page_t)[0]
               for w, c in ((tp1, c1), (tp2, c2), (tp2, c3))]
        assert torch.equal(got[0], got[1]) and torch.equal(got[1], got[2])
        tm._close(got[1], jl)
        tok = np.asarray(jax.numpy.argmax(jl[:, -1], -1)) \
            .astype(np.int32)[:, None]
        pos = pos + 1


@pytest.mark.parametrize("arch,kv_dtype", [("qwen3-4b", "bf16"),
                                           ("qwen3-4b", "int8"),
                                           ("gemma3-1b", "bf16")])
def test_host_payloads_keep_the_unsharded_layout(arch, kv_dtype):
    """A page extracted from tp=2 pools is the tp=1 page's bytes (the
    shards' heads side by side; a replicated pool once), and inserting
    it into fresh tp=2 pools rebuilds every shard; ``cache_bytes``
    counts the unsharded layout."""
    cfg = reduced(get_config(arch)).replace(
        cache_mode="paged", page_size=4, kv_cache_dtype=kv_dtype)
    caches = init_caches(cfg, 2, 16, device="cpu")
    g = torch.Generator().manual_seed(0)
    for c in caches:
        for pool in c.values():
            pool.copy_((torch.randn(pool.shape, generator=g) * 50)
                       .to(pool.dtype))
    shards = shard_caches(caches, cfg, _mesh(), batch=2)
    assert cache_bytes(shards) == cache_bytes(caches)
    pages = [3, 1, 7]
    want = extract_cache_pages(caches, pages, pad_to=5)
    got = extract_cache_pages(shards, pages, pad_to=5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    params = shard_params(model_init(cfg, device="cpu"), cfg, _mesh())
    fresh = init_shard_caches(cfg, 2, 16, params)
    insert_cache_pages(fresh, pages, got, pad_to=5)
    for tree, ref in zip(fresh, shards):
        for c, r in zip(tree, ref):
            for key in c:
                assert torch.equal(c[key][pages], r[key][pages])


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def _mesh_prompts(vocab):
    """The reference mesh test's prompts (tests/test_mesh_serve.py)."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, rng.integers(4, 9)) for _ in range(4)]


MESH_KW = dict(batch=2, max_len=24, prefill_len=8, decode_chunk=4,
               cache_mode="paged", page_size=4, alloc_mode="incremental",
               num_pages=10)


def _serve(cfg, params, scfg, prompts, n_new=8, **engine_kw):
    eng = Engine(cfg, params, scfg, device="cpu", **engine_kw)
    ids = [eng.submit(p, n_new) for p in prompts]
    done = eng.run()
    eng.release_prefix_cache()
    return [done[i].tokens for i in ids], eng


@pytest.mark.parametrize("quant", ["dense", "w8a8_nibble"])
def test_tp2_engine_equals_tp1_and_reference_engine(monkeypatch, quant):
    """The reference's tp=2 acceptance (its own test fails under JAX
    0.9.0's missing TPU compiler params in the pallas cells), held to the
    reference's tp=1 engine on ``xla``: equal greedy streams, pins
    ``{prefill: 1, decode_chunk: 1}``, no leak, mesh (1, 2), 2 devices."""
    jcfg, jp, tcfg, tparams = tm._pair("qwen3-4b", n_layers=1)
    prompts = _mesh_prompts(tcfg.vocab_size)
    tm.exact_engine(monkeypatch)
    jeng = jengine.Engine(jcfg, jp, jengine.ServeConfig(
        quant_mode=quant, quant_backend="xla", **MESH_KW))
    jids = [jeng.submit(p, 8) for p in prompts]
    jdone = jeng.run()
    want = [jdone[i].tokens for i in jids]
    pins = {"prefill": 1, "decode_chunk": 1}
    for tp in (1, 2):
        scfg = ServeConfig(quant_mode=quant, tp=tp, **MESH_KW)
        got, eng = _serve(tcfg, tparams, scfg, prompts,
                          devices=CPU2[:tp] if tp > 1 else None)
        assert got == want, tp
        assert eng.compile_counts == pins and eng.leaked_pages() == 0
        assert eng.mesh_shape == ((1, 2) if tp > 1 else (1, 1))
        assert eng.device_count == tp


def _shared_prompts(vocab, n=6, seed=0):
    """Prompts of 1-10 tokens, most opening with one 4-token head (a page
    at page size 4), then the head alone (fully cached: a copy-on-write)
    and an earlier 8-token prompt grown by 2 (its second chunk, demoted
    by then under a 1-page cap, comes back from the cold tier)."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, 4)
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, int(rng.integers(1, 5)))
        out.append(np.concatenate([head, tail]) if i % 3 else tail)
    out.append(head.copy())
    out.append(np.concatenate([out[2], rng.integers(0, vocab, 2)]))
    return out


MECH_BASE = dict(batch=2, max_len=24, prefill_len=12, decode_chunk=3,
                 cache_mode="paged", page_size=4, alloc_mode="incremental",
                 num_pages=6, quant_mode="dense")
MECHANISMS = {
    # name: (engine knobs, the baseline knobs its streams equal, counters
    # that must be > 0)
    "preemption": ({}, dict(alloc_mode="reserve", num_pages=0),
                   ("preemptions",)),
    "slab": (dict(cache_mode="dense", alloc_mode="reserve", num_pages=None),
             dict(alloc_mode="reserve", num_pages=0), ()),
    "swap": (dict(swap_mode="host"), {}, ("swap_in", "replay_steps_saved")),
    "prefix": (dict(prefix_cache=True, num_pages=0), dict(num_pages=0),
               ("prefix_hits", "cow_copies")),
    "prefix_cold": (dict(prefix_cache=True, swap_mode="host",
                         prefix_cache_pages=1, num_pages=0),
                    dict(num_pages=0),
                    ("prefix_demotions", "prefix_cold_hits")),
    "spec": (dict(spec_decode=True, spec_k=3),
             dict(decode_chunk=1), ("spec_rounds",)),
    "wave": (dict(prefill_chunk=3, admit_group=2), {}, ("prefill_waves",)),
}


@pytest.mark.parametrize("name", sorted(MECHANISMS))
def test_mechanisms_keep_their_rule_at_tp2(name):
    """Each mechanism at tp=2: its streams equal its baseline's at tp=2
    (the mechanism's bit-match rule, in ``dense``), its counters fire,
    and the tp=1 engine with the same knobs gives the same streams and
    counters; no leak."""
    knobs, base, counters = MECHANISMS[name]
    # attention_core on both sides of every rule: the paged kernel's
    # plain version sums in another order than the slab's attention
    cfg = reduced(get_config("yi-6b")).replace(n_layers=2,
                                               attn_impl="chunked")
    params = model_init(cfg, device="cpu")
    prompts = _shared_prompts(cfg.vocab_size)
    runs = {}
    for tp in (1, 2):
        for label, over in (("mech", knobs), ("base", base)):
            scfg = ServeConfig(**{**MECH_BASE, **over, "tp": tp})
            streams, eng = _serve(cfg, params, scfg, prompts, n_new=7,
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


@pytest.mark.parametrize("quant", ["dense", "w8a8_nibble"])
def test_gemma3_tp2_replicated_attention_and_tied_head(quant):
    """gemma3-1b (KVH 1, tied embedding, 5 local : 1 global): at tp=2 its
    attention runs replicated with whole pools, its MLP and head split;
    the streams equal tp=1's, the cache bytes too."""
    cfg = reduced(get_config("gemma3-1b")).replace(quant_mode=quant,
                                                   attn_impl="flash")
    params = model_init(cfg, device="cpu")
    prompts = _mesh_prompts(cfg.vocab_size)
    out = {}
    for tp in (1, 2):
        scfg = ServeConfig(tp=tp, **MESH_KW)
        out[tp] = _serve(cfg, params, scfg, prompts,
                         devices=CPU2[:tp] if tp > 1 else None)
    assert out[2][0] == out[1][0]
    assert not out[2][1].params.layout.heads
    assert out[2][1].cache_token_bytes == out[1][1].cache_token_bytes


def test_router_dp2_tp2_over_four_devices():
    """``Router(replicas=2)`` at tp=2 puts each replica on its own pair of
    the four devices (the reference's ``_device_groups``), serves one
    engine's streams (``dense``), and raises with the reference's message
    when the devices are too few."""
    cfg = reduced(get_config("qwen3-4b")).replace(attn_impl="flash")
    params = model_init(cfg, device="cpu")
    prompts = _mesh_prompts(cfg.vocab_size)
    scfg = ServeConfig(tp=2, **MESH_KW)
    fleet = Router(cfg, params, scfg, replicas=2, devices=["cpu"] * 4)
    assert fleet.mesh_shape == (1, 2) and fleet.device_count == 4
    assert [e.device_count for e in fleet.replicas] == [2, 2]
    ids = [fleet.submit(p, 8) for p in prompts]
    done = fleet.run()
    want, _ = _serve(cfg, params, ServeConfig(**MESH_KW), prompts)
    assert [done[i].tokens for i in ids] == want
    assert fleet.leaked_pages() == 0
    with pytest.raises(ValueError, match="needs 4 devices but only 3"):
        Router(cfg, params, scfg, replicas=2, devices=["cpu"] * 3)
    cpu_default = Router(cfg, params, dataclasses.replace(scfg, tp=1),
                         replicas=2, device="cpu")
    assert cpu_default.device_count == 1
    with pytest.raises(ValueError, match="needs 2 devices but only 1"):
        Engine(cfg, params, scfg, device="cpu")


@pytest.mark.parametrize("arch,over,match", [
    ("yi-6b", dict(mesh_shape=(2, 1)), "needs 2 devices but only 1"),
    ("yi-6b", dict(mesh_shape=(2, 2)), "needs 4 devices but only 3"),
])
def test_tp_refusals_name_the_roadmap(arch, over, match):
    """A data axis above 1 is no longer refused: the (2, 1) and (2, 2)
    engines build over four CPU entries, and what remains of the mesh
    inside one engine (capture across cards, a multi-process backend) is
    named by ROADMAP items 4d and 4e; a mesh larger than its devices
    raises the reference's message."""
    cfg = reduced(get_config(arch))
    params = model_init(cfg, device="cpu")
    scfg = ServeConfig(batch=2, max_len=16, **over)
    eng = Engine(cfg, params, scfg, device="cpu", devices=["cpu"] * 4)
    assert eng.mesh_shape == over["mesh_shape"]
    assert "ROADMAP queue 1 item 4d" in TP_ROADMAP and "4e" in TP_ROADMAP
    n = over["mesh_shape"][0] * over["mesh_shape"][1]
    with pytest.raises(ValueError, match=match):
        Engine(cfg, params, scfg, device="cpu", devices=["cpu"] * (n - 1))


@pytest.mark.parametrize("arch,mode", [
    ("deepseek-v3-671b", "dense"), ("llama4-maverick-400b-a17b", "dense"),
    ("whisper-base", "dense"), ("phi-3-vision-4.2b", "dense"),
    ("mamba2-780m", "dense"), ("jamba-v0.1-52b", "dense"),
    ("yi-6b", "qat")])
def test_tp2_serves_the_families_once_refused(arch, mode):
    """The families and the quant mode tp=2 refused until they were
    sharded (MLA, MoE, the encoder-decoder and the VLM; the mamba mixers
    and ``qat``): each engine builds at tp=2 over four repeated CPU
    devices (the mesh takes two) and serves tp=1's greedy streams
    (reduced, 4 prompts of 4-8 tokens x 6)."""
    cfg = reduced(get_config(arch)).replace(attn_impl="flash",
                                            quant_mode=mode)
    params = model_init(cfg, device="cpu")
    prompts = _mesh_prompts(cfg.vocab_size)
    kw = dict(batch=2, max_len=16, prefill_len=8, decode_chunk=3)
    want, _ = _serve(cfg, params, ServeConfig(**kw), prompts, n_new=6)
    got, eng = _serve(cfg, params, ServeConfig(tp=2, **kw), prompts,
                      n_new=6, devices=["cpu"] * 4)
    assert got == want
    assert eng.mesh_shape == (1, 2) and eng.leaked_pages() == 0


def test_mesh_config_errors():
    """The reference's checks: tp >= 1, a (data, model) pair, and a
    mesh_shape that agrees with tp; capture=True asks for the card."""
    cfg = reduced(get_config("yi-6b"))
    params = model_init(cfg, device="cpu")
    for over, match in ((dict(tp=0), "tp must be >= 1"),
                        (dict(mesh_shape=(1, 2, 1)), "data, model"),
                        (dict(tp=4, mesh_shape=(1, 2)), "disagrees")):
        with pytest.raises(ValueError, match=match):
            Engine(cfg, params, ServeConfig(batch=2, max_len=16, **over),
                   device="cpu", devices=CPU2)
    with pytest.raises(ValueError, match="CUDA"):
        Engine(cfg, params, ServeConfig(batch=2, max_len=16, tp=2),
               device="cpu", devices=CPU2, capture=True)
    eng = Engine(cfg, params, ServeConfig(batch=2, max_len=16, tp=2,
                                          mesh_shape=(1, 2)),
                 device="cpu", devices=CPU2)
    assert eng.mesh_shape == (1, 2) and eng.capture_counts == {
        "decode_chunk": 0}
