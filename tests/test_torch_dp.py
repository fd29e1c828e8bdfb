"""A data axis above 1 inside one engine: FSDP weight storage and slots
split over data rows, against the reference's (2, 1) and (2, 2) engines
and the port's own dp=1.

The entries share the CPU (``devices=["cpu"] * 4``), as the tensor-
parallel tests do.  What is held:

* The reference's ``Engine`` at ``mesh_shape`` (1, 1), (2, 1) and (2, 2)
  (one subprocess under ``--xla_force_host_platform_device_count=4``,
  ``quant_backend="xla"``, its stages compiled without excess precision
  as ``test_torch_model.exact_engine`` compiles them) and the port's at
  the same shapes, on the same weights and seeded prompts, in
  ``w8a8_nibble``: every stream equal, on reduced yi-6b over paged pools
  and the dense slab, llama4, deepseek-v3 and mamba2.
* Prefill and decode steps at (2, 1) and (2, 2) against (1, 1) and
  (1, 2) on every family: the integer modes bit for bit (logits, and an
  encoder-decoder's encoder output), ``dense`` and ``qat`` within
  ``ROUNDING``.
* Engines at (2, 1) and (2, 2) serve every family's (1, 1) streams; the
  prefix cache (a prefix a row-0 slot wrote, hit by a row-1 slot), the
  host swap, evict-and-resume preemption, the wave, speculative decoding
  and sampling keep (1, 1)'s streams at (2, 1) and (2, 2), with no
  leak; a batch of 3 at dp=2 runs unsplit on data row 0.
* Storage: each entry holds piece ``d`` of its leaves along the FSDP
  dimension ``param_specs`` names, the gather rebuilds every leaf bit for
  bit, and the entries' bytes sum to the tree's plus the copies of the
  whole leaves.
* The launcher's ``--mesh 2x1 --verify`` and ``--dp 2 --mesh 2x1``.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import test_torch_launch_serve as tls
from repro_torch.configs import get_config, reduced
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (data_dim, gather_rows,
                                              param_specs, shard_params,
                                              stored_bytes)
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import (decode_step, init_caches, merge_slot_caches,
                                merge_slot_paged_caches, model_init,
                                prefill, prepare_params)
from repro_torch.models.attention import mirror_paged_rows, \
    scatter_paged_rows
from repro_torch.models.transformer import init_shard_caches
from repro_torch.serve import Engine, ServeConfig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU4 = ["cpu"] * 4
INT_MODES = ["w8a8_nibble", "w4a8_nibble", "lut"]
# ``dense`` and ``qat`` at (2, 2) against (1, 2): a data row's dense
# products run at its own row count; one bf16 rounding of logits of
# order 1 (the CPU measures 0 here)
ROUNDING = 2.0 ** -7

# ---------------------------------------------------------------------------
# Against the reference's engines
# ---------------------------------------------------------------------------

_CHILD = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    import test_torch_model as tm
    import repro.serve.engine as jengine
    from repro_torch.serve import Engine, ServeConfig

    class _Patch:
        def setattr(self, obj, name, value):
            setattr(obj, name, value)

    tm.exact_engine(_Patch())
    torch.set_num_threads(1)
    PAGED = dict(cache_mode="paged", page_size=4, alloc_mode="incremental",
                 num_pages=10)
    CASES = {"yi-6b/paged": ("yi-6b", 2, PAGED),
             "yi-6b/dense": ("yi-6b", 2, dict(cache_mode="dense")),
             "llama4": ("llama4-maverick-400b-a17b", 2, PAGED),
             "deepseek-v3": ("deepseek-v3-671b", 4, PAGED),
             "mamba2": ("mamba2-780m", 2, PAGED)}
    out = {}
    for name, (arch, layers, cache) in CASES.items():
        jcfg, jp, tcfg, tparams = tm._pair(arch, n_layers=layers,
                                           quant_mode="w8a8_nibble")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, jcfg.vocab_size, rng.integers(4, 9))
                   for _ in range(4)]
        kw = dict(batch=2, max_len=24, prefill_len=8, decode_chunk=4,
                  quant_mode="w8a8_nibble", **cache)
        res = {}
        for shape in ((1, 1), (2, 1), (2, 2)):
            eng = jengine.Engine(jcfg, jp, jengine.ServeConfig(
                quant_backend="xla", mesh_shape=shape, **kw))
            ids = [eng.submit(p, 8) for p in prompts]
            done = eng.run()
            res[f"ref{shape}"] = [list(map(int, done[i].tokens))
                                  for i in ids]
            eng = Engine(tcfg, tparams, ServeConfig(mesh_shape=shape, **kw),
                         device="cpu", devices=["cpu"] * 4)
            ids = [eng.submit(p, 8) for p in prompts]
            done = eng.run()
            res[f"port{shape}"] = [done[i].tokens for i in ids]
            res[f"port{shape}/leaks"] = eng.leaked_pages()
        out[name] = res
    print(json.dumps(out))
""")


def test_engines_equal_the_reference_at_21_and_22():
    """One subprocess: the reference's engines keep their (1, 1) streams
    at (2, 1) and (2, 2) in ``w8a8_nibble``, and the port's engines at
    all three shapes give those streams, with no leak."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", _CHILD,
                          os.path.join(REPO, "tests")], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    results = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(results) == {"yi-6b/paged", "yi-6b/dense", "llama4",
                            "deepseek-v3", "mamba2"}
    for name, r in results.items():
        want = r["ref(1, 1)"]
        for shape in ("(1, 1)", "(2, 1)", "(2, 2)"):
            assert r[f"ref{shape}"] == want, (name, "reference", shape)
            assert r[f"port{shape}"] == want, (name, "port", shape)
            assert r[f"port{shape}/leaks"] == 0, (name, shape)


# ---------------------------------------------------------------------------
# Prefill and decode steps against dp=1
# ---------------------------------------------------------------------------

def _mesh(dp, tp):
    return make_local_mesh(dp=dp, tp=tp, devices=CPU4[:dp * tp])


def _extras(cfg, b):
    """Per-slot stub inputs: an encoder-decoder's frames, a VLM's patches
    (as prefill's keyword), else none."""
    g = torch.Generator().manual_seed(3)
    if cfg.is_encdec:
        x = (torch.randn((b, 6, cfg.d_model), generator=g) * 0.5).bfloat16()
        return lambda i: {"frames": x[i:i + 1]}
    if cfg.family == "vlm":
        x = (torch.randn((b, 3, cfg.d_model), generator=g) * 0.5).bfloat16()
        return lambda i: {"extra_embeds": x[i:i + 1]}
    return lambda i: {}


def _steps(cfg, params, shape, cache_mode):
    """Two prompts prefilled alone into slots 0 and 1 (data rows 0 and 1
    at dp=2), then three decode steps at per-slot positions; returns every
    logits tensor and encoder output in order."""
    b, max_len, s = 2, 16, 5
    if shape != (1, 1):
        params = shard_params(params, cfg, _mesh(*shape))
        caches = init_shard_caches(cfg, b, max_len, params)
    else:
        caches = init_caches(cfg, b, max_len, device="cpu")
    extra = _extras(cfg, b)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s + 3)))
    table = torch.arange(1, 1 + b * max_len // 4).reshape(b, -1).flip(1)
    mamba = any(sp.mixer == "mamba" for sp in cfg.layer_specs)
    grow = max_len if cache_mode == "dense" or mamba else 8
    outs, encs = [], []
    for slot in range(b):
        logits, one, enc = prefill(params, cfg, toks[slot:slot + 1, :s],
                                   max_len=grow, **extra(slot))
        outs.append(logits)
        if cache_mode == "dense":
            merge_slot_caches(caches, one, slot)
        else:
            merge_slot_paged_caches(caches, one, slot, table[slot])
        if enc is not None:
            encs.append(enc)
            outs.append(enc.float())
    n_pre = 3 if cfg.family == "vlm" else 0
    kw = {"page_table": table} if cache_mode == "paged" else {}
    if encs:
        kw["enc_out"] = torch.cat(encs)
    for t in range(s, s + 3):
        logits, _ = decode_step(params, cfg, toks[:, t:t + 1], caches,
                                torch.tensor([n_pre + t, n_pre + t - 1]),
                                **kw)
        outs.append(logits)
    return outs


STEP_CASES = ([("yi-6b", m, "paged") for m in INT_MODES]
              + [("yi-6b", "w8a8_nibble", "dense"),
                 ("gemma3-1b", "w8a8_nibble", "paged"),
                 ("deepseek-v3-671b", "w8a8_nibble", "paged"),
                 ("llama4-maverick-400b-a17b", "w8a8_nibble", "paged"),
                 ("mamba2-780m", "w8a8_nibble", "paged"),
                 ("jamba-v0.1-52b", "w8a8_nibble", "dense"),
                 ("whisper-base", "w8a8_nibble", "paged"),
                 ("phi-3-vision-4.2b", "w8a8_nibble", "dense"),
                 ("yi-6b", "dense", "paged"), ("yi-6b", "qat", "dense"),
                 ("llama4-maverick-400b-a17b", "dense", "paged")])


@pytest.mark.parametrize("arch,mode,cache_mode", STEP_CASES)
def test_steps_at_21_and_22_hold_dp1(arch, mode, cache_mode):
    """(2, 1) against (1, 1) and (2, 2) against (1, 2): bit for bit in
    the integer modes, within ``ROUNDING`` in ``dense`` and ``qat``."""
    cfg = reduced(get_config(arch)).replace(
        quant_mode=mode, attn_impl="flash", cache_mode=cache_mode,
        page_size=4)
    params = model_init(cfg, device="cpu")
    for shape, base in (((2, 1), (1, 1)), ((2, 2), (1, 2))):
        want = _steps(cfg, params, base, cache_mode)
        got = _steps(cfg, params, shape, cache_mode)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if mode in INT_MODES:
                assert torch.equal(g, w), (shape, mode)
            else:
                diff = (g.float() - w.float()).abs().max().item()
                assert diff <= ROUNDING, (shape, diff)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

def _prompts(vocab, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, rng.integers(4, 9)) for _ in range(n)]


MESH_KW = dict(batch=2, max_len=24, prefill_len=8, decode_chunk=4,
               cache_mode="paged", page_size=4, alloc_mode="incremental",
               num_pages=10)


def _serve(cfg, params, scfg, prompts, n_new=8):
    eng = Engine(cfg, params, scfg, device="cpu", devices=CPU4)
    ids = [eng.submit(p, n_new) for p in prompts]
    done = eng.run()
    eng.release_prefix_cache()
    assert eng.leaked_pages() == 0
    return [done[i].tokens for i in ids], eng


@pytest.mark.parametrize("arch,mode", [
    ("yi-6b", "w8a8_nibble"), ("gemma3-1b", "w8a8_nibble"),
    ("deepseek-v3-671b", "w8a8_nibble"),
    ("llama4-maverick-400b-a17b", "lut"), ("mamba2-780m", "w8a8_nibble"),
    ("jamba-v0.1-52b", "w4a8_nibble"), ("whisper-base", "w8a8_nibble"),
    ("phi-3-vision-4.2b", "w8a8_nibble"), ("yi-6b", "qat"),
    ("yi-6b", "dense")])
def test_engines_at_21_and_22_serve_the_dp1_streams(arch, mode):
    """Every family at (2, 1) and (2, 2): (1, 1)'s greedy streams, the
    mesh's shape and entry count, (1, 1)'s pins, no leak."""
    cfg = reduced(get_config(arch)).replace(quant_mode=mode,
                                            attn_impl="flash")
    params = model_init(cfg, device="cpu")
    prompts = _prompts(cfg.vocab_size)
    want, base = _serve(cfg, params, ServeConfig(**MESH_KW), prompts)
    for shape in ((2, 1), (2, 2)):
        got, eng = _serve(cfg, params,
                          ServeConfig(mesh_shape=shape, **MESH_KW), prompts)
        assert got == want, shape
        assert eng.mesh_shape == shape
        assert eng.device_count == shape[0] * shape[1]
        # a mamba model prefills at the exact prompt length: one
        # signature per distinct length, as at (1, 1)
        assert eng.compile_counts == base.compile_counts
        assert [eng.slot_row(s) for s in range(2)] == [0, 1]


def _shared_prompts(vocab, n=6, seed=0):
    """Most prompts open with one 4-token head (a page at page size 4)."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, 4)
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, int(rng.integers(1, 5)))
        out.append(np.concatenate([head, tail]) if i % 3 else tail)
    out.append(head.copy())
    return out


MECH_BASE = dict(batch=2, max_len=24, prefill_len=12, decode_chunk=3,
                 cache_mode="paged", page_size=4, alloc_mode="incremental",
                 num_pages=6, quant_mode="w8a8_nibble")
MECHANISMS = {
    # name: (engine knobs, counters that must be > 0)
    "preemption": ({}, ("preemptions",)),
    "swap": (dict(swap_mode="host"), ("swap_in", "replay_steps_saved")),
    "prefix": (dict(prefix_cache=True, num_pages=0),
               ("prefix_hits", "cow_copies")),
    "wave": (dict(prefill_chunk=3, admit_group=2), ("prefill_waves",)),
    "spec": (dict(spec_decode=True, spec_k=3), ("spec_rounds",)),
    "sampled": (dict(temperature=0.7), ("preemptions",)),
}


@pytest.mark.parametrize("name", sorted(MECHANISMS))
def test_mechanisms_at_21_and_22_keep_the_dp1_streams(name):
    """Each mechanism at (2, 1) and (2, 2) in ``w8a8_nibble`` (spec: a
    nibble draft and a dense verifier; sampled: temperature 0.7 under the
    request keys) gives the (1, 1) engine's streams and counters with the
    same knobs, no leak.  The prefix case holds a hit by a row-1 slot on
    pages a row-0 slot wrote."""
    knobs, counters = MECHANISMS[name]
    cfg = reduced(get_config("yi-6b")).replace(n_layers=2,
                                               attn_impl="chunked")
    params = model_init(cfg, device="cpu")
    prompts = _shared_prompts(cfg.vocab_size)
    runs, hits = {}, []
    for shape in ((1, 1), (2, 1), (2, 2)):
        scfg = ServeConfig(**{**MECH_BASE, **knobs, "mesh_shape": shape})
        eng = Engine(cfg, params, scfg, device="cpu", devices=CPU4)
        orig = eng._map_prefix

        def spy(slot, req, eng=eng, orig=orig):
            out = orig(slot, req)
            hits.append((eng.mesh_shape, eng.slot_row(slot), out[0]))
            return out

        eng._map_prefix = spy
        ids = [eng.submit(p, 7) for p in prompts]
        done = eng.run()
        eng.release_prefix_cache()
        assert eng.leaked_pages() == 0, shape
        runs[shape] = ([done[i].tokens for i in ids], eng.stats)
    skip = ("occupancy", "concurrency")
    want = {k: v for k, v in runs[(1, 1)][1].items() if k not in skip}
    for shape in ((2, 1), (2, 2)):
        assert runs[shape][0] == runs[(1, 1)][0], shape
        for key in counters:
            assert runs[shape][1][key] > 0, (shape, key)
        assert {k: v for k, v in runs[shape][1].items()
                if k not in skip} == want, shape
        if name == "prefix":
            assert any(s == shape and row == 1 and start > 0
                       for s, row, start in hits), shape


def test_batch_of_three_at_dp2_runs_unsplit_on_row_0():
    """B = 3 does not split over two data rows: every slot lives on data
    row 0 (its slab rows there, the other row storing only its weight
    pieces), and the streams are (1, 1)'s, bit for bit."""
    cfg = reduced(get_config("yi-6b")).replace(quant_mode="w8a8_nibble")
    params = model_init(cfg, device="cpu")
    prompts = _prompts(cfg.vocab_size, n=5)
    kw = dict(MESH_KW, batch=3, cache_mode="dense", alloc_mode="reserve",
              num_pages=None)
    want, _ = _serve(cfg, params, ServeConfig(**kw), prompts)
    got, eng = _serve(cfg, params, ServeConfig(mesh_shape=(2, 1), **kw),
                      prompts)
    assert got == want
    assert [eng.slot_row(s) for s in range(3)] == [0, 0, 0]
    assert eng._caches.dp == 1 and eng.params.dp == 2
    assert eng._caches[0][0]["k"].shape[0] == 3


# ---------------------------------------------------------------------------
# Storage and the gather
# ---------------------------------------------------------------------------

def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


@pytest.mark.parametrize("arch", ["yi-6b", "llama4-maverick-400b-a17b"])
def test_entries_store_fsdp_pieces_and_the_gather_rebuilds_them(arch):
    """At (2, 1): entry ``d`` holds piece ``d`` of every leaf along the
    dimension ``param_specs`` puts on the data axis (a leaf whose spec
    has none, whole); ``gather_rows`` rebuilds each leaf a mode reads bit
    for bit, counting the bytes it writes; the entries' bytes sum to the
    tree's plus one more copy of each whole leaf."""
    cfg = reduced(get_config(arch)).replace(quant_mode="w8a8_nibble")
    tree = prepare_params(model_init(cfg, device="cpu"), cfg)
    mesh = _mesh(2, 1)
    params = shard_params(tree, cfg, mesh)
    specs = param_specs(tree, mesh)
    whole = split = 0
    for path, leaf in _leaves(tree):
        dim = data_dim(_at(specs, path))
        assert _at(params.fsdp, path) == dim
        pieces = [_at(params.trees[d], path) for d in range(2)]
        if dim is None:
            assert all(torch.equal(p, leaf) for p in pieces)
            whole += leaf.numel() * leaf.element_size()
        else:
            assert torch.equal(torch.cat(pieces, dim=dim), leaf)
            assert pieces[0].shape[dim] * 2 == leaf.shape[dim]
            split += leaf.numel() * leaf.element_size()
    assert split > whole > 0
    assert sum(stored_bytes(params.trees)) == split + 2 * whole
    before = collectives.gathered_bytes()
    layers = gather_rows(params, lambda t: t["layers"], 2, cfg.quant_mode)
    assert layers[0][0] is layers[1][0]        # one gather a device
    gathered = 0
    for path, leaf in _leaves(layers[0][0]):
        want = _at(tree["layers"], path)
        assert torch.equal(leaf, want), path
        # a prepared linear's bf16 ``w`` is not gathered in an int mode
        assert path[-1] != "w" or "qt8" not in _at(tree["layers"],
                                                   path[:-1])
        if data_dim(_at(specs["layers"], path)) is not None:
            gathered += leaf.numel() * leaf.element_size()
    assert collectives.gathered_bytes() - before == gathered > 0
    eng = Engine(cfg, tree, ServeConfig(batch=2, max_len=16,
                                        mesh_shape=(2, 1)),
                 device="cpu", devices=CPU4)
    assert eng.param_bytes == stored_bytes(params.trees)
    assert eng.gathered_bytes_per_step > 0


def test_pool_writes_mirror_into_another_copy():
    """A decode step's pool rows written through the table reach a
    second copy of the pools (the rows of a data row on another device)
    exactly, and nothing else of the copy changes."""
    g = torch.Generator().manual_seed(0)
    pool = torch.zeros((9, 4, 2, 8), dtype=torch.bfloat16)
    copy = torch.randn((9, 4, 2, 8), generator=g).bfloat16()
    before = copy.clone()
    table = torch.tensor([[3, 5, 0, 0], [7, 1, 2, 0]])
    index = torch.tensor([5, 2])
    new = torch.randn((2, 1, 2, 8), generator=g).bfloat16()
    scatter_paged_rows(pool, new, table, index)
    mirror_paged_rows(pool, copy, table, index, 1)
    assert torch.equal(copy[5, 1], new[0, 0])
    assert torch.equal(copy[7, 2], new[1, 0])
    changed = (copy != before).flatten(1).any(1)
    assert changed.nonzero().flatten().tolist() == [5, 7]


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["--mesh", "2x1", "--quant", "w8a8_nibble", "--verify"],
    ["--tp", "2", "--mesh", "2x2", "--quant", "w8a8_nibble", "--verify"],
    ["--dp", "2", "--mesh", "2x1", "--quant", "dense", "--verify"]],
    ids=["mesh2x1", "tp2-mesh2x2", "dp2-mesh2x1"])
def test_launcher_serves_a_data_axis(monkeypatch, capsys, flags):
    """``--mesh 2x1`` / ``--tp 2 --mesh 2x2`` (one engine) and ``--dp 2
    --mesh 2x1`` (two such replicas behind the router) on the CPU: the
    streams bit-match the single-device build, the topology and the
    ``fsdp`` lines report the mesh and the bytes."""
    r, engine = tls._run_requests(monkeypatch, "uniform", *tls.OVERCOMMIT,
                                  *flags)
    out = capsys.readouterr().out
    dp = 2 if "--dp" in flags else 1
    shape = (2, 2) if "2x2" in flags else (2, 1)
    assert tuple(r["mesh_shape"]) == shape
    assert r["device_count"] == dp * shape[0] * shape[1]
    assert "verify: 5 streams bit-match" in out
    assert "MiB gathered per decode step" in out
    assert r["preemptions"] >= 1 and engine.leaked_pages() == 0
    assert serve.main(tls.BASE + ["--workload", "uniform", "--mesh",
                                  "2x1", "--batch", "3"]) == 0
