"""Tensor parallelism for the mamba mixers and for ``qat``, and the
head-count independence of ``attention_core``, against the single-device
port and the reference.

The shards share the CPU (``devices=["cpu", "cpu"]``), as in
``tests/test_torch_tp.py``.  What is held:

* Models: reduced mamba2-780m (2 mixer layers, 8 SSD heads, 1 group) and
  reduced jamba (8 layers: one attention, seven mamba, four MoE), a
  prefill and three decode steps at tp=2 (caches from
  ``init_shard_caches`` and from ``shard_caches`` of tp=1's) against tp=1:
  bit for bit in ``w8a8_nibble``, in ``dense`` within a rounding of the
  row-parallel f32 sum (``test_torch_tp_families._same``); against the
  reference compiled by ``test_torch_model.exact_jit`` within LOGIT_ATOL
  (a MoE routing flip held to a router-logit tie).  A reduced mamba2
  with ``ssm_groups=2`` splits B and C by group.
* Engines: tp=2 greedy streams equal the port's tp=1 engine's and, under
  the tie rule of ``tests/test_torch_engine.py``, the reference engine's;
  an overcommitted incremental pool evicts and resumes at tp=2 and equals
  a reserve pool; ``--tp 2 --arch mamba2-780m --verify`` through the
  launcher.
* ``qat`` at tp=2 on reduced yi-6b and deepseek-v3: a prefill and three
  decode steps within LOGIT_ATOL of tp=1 (a row-parallel ``qat``
  projection sums f32 partials).
* ``attention_core`` over a subset of the heads equals those heads' rows
  of the whole call bit for bit; ``fixed_bmm`` and ``fixed_cumsum`` give
  each entry the result it has alone.
* Layout: a mamba layer's shards, concatenated per segment in shard
  order, rebuild the unsharded ``in_proj`` (weight, int8 copy, scales),
  conv and per-head scalars exactly; ``in_proj``'s gathered columns are
  copies, jamba's expert stacks stay views.
"""

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
import test_torch_tp_families as ttf
from repro import models as jmodels
from repro.models import init_caches as jinit_caches
from repro.models import merge_slot_caches as jmerge
from repro.models import merge_slot_paged_caches as jmerge_paged
from repro_torch.configs import get_config, reduced
from repro_torch.distributed.sharding import (shard_caches, shard_params,
                                              ssm_segments)
from repro_torch.models import (decode_step, init_caches, load_jax_params,
                                merge_slot_caches, merge_slot_paged_caches,
                                model_init, prefill)
from repro_torch.models.attention import attention_core
from repro_torch.models.layers import (entries_per_call, fixed_bmm,
                                       fixed_cumsum)
from repro_torch.models.transformer import init_shard_caches
from repro_torch.serve import Engine, ServeConfig

torch.set_num_threads(1)

MAMBA2, JAMBA = tf.MAMBA2, tf.JAMBA
CPU2 = ttp.CPU2
_mesh = ttp._mesh
_same = ttf._same


# ---------------------------------------------------------------------------
# Prefill and decode steps
# ---------------------------------------------------------------------------

def _pair(arch, **over):
    """``tf._pair``, or with a width override (``ssm_groups``) reference
    weights of that shape, seeded as ``tm._jax_params`` seeds them."""
    if "ssm_groups" not in over:
        return tf._pair(arch, **over)
    jcfg, _, tcfg, _ = tf._pair(arch, **{k: v for k, v in over.items()
                                         if k != "ssm_groups"})
    jcfg = jcfg.replace(ssm_groups=over["ssm_groups"])
    tcfg = tcfg.replace(ssm_groups=over["ssm_groups"])
    jp = tm.jmodel_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.array(a.astype(jnp.float32)),
                                  jp)
    return jcfg, jp, tcfg, load_jax_params(tree, tcfg, device="cpu")


def _steps(monkeypatch, arch, mode, cache_mode, reference=True,
           **cfg_over):
    """Two prompts prefilled alone at their exact lengths (5 and 8) into
    slots 0 and 2 of a 3-slot cache, then three decode steps at per-slot
    positions, at tp=1, at tp=2 from ``init_shard_caches`` and at tp=2
    from ``shard_caches`` of tp=1's; tp=2 held to tp=1 (``_same``) and,
    with ``reference``, to the reference."""
    over = dict(quant_mode=mode, attn_impl="flash", cache_mode=cache_mode,
                page_size=4, **cfg_over)
    jcfg, jp, tcfg, tp1 = _pair(arch, **over)
    tcfg = tcfg.replace(quant_backend="cuda")
    tp2 = shard_params(tp1, tcfg, _mesh())
    assert tp2.layout.ssm_heads
    routes = tf._Routes(monkeypatch)
    jprefill = tf._fresh(jmodels.prefill, static_argnames=("max_len",))
    jdecode = tf._fresh(jmodels.decode_step)
    rng = np.random.default_rng(1)
    max_len, lens = 16, [5, 8]
    table = np.zeros((3, max_len // 4), np.int32)
    table[0, :4] = [1, 2, 3, 4]
    table[2, :4] = [8, 7, 6, 5]
    jc = jinit_caches(jcfg, 3, max_len)
    c1 = init_caches(tcfg, 3, max_len, device="cpu")
    c2 = init_shard_caches(tcfg, 3, max_len, tp2)
    for slot, n in ((0, lens[0]), (2, lens[1])):
        p = rng.integers(0, 256, (1, n)).astype(np.int32)
        grow = max_len if cache_mode == "dense" else 8
        if reference:
            jl, jone, _ = jprefill(jp, jcfg, jnp.asarray(p), max_len=grow)
        outs = ttf._both_port(routes, *[
            lambda w=w: prefill(w, tcfg, torch.from_numpy(p), max_len=grow)
            for w in (tp1, tp2)])
        _same(outs[1][0], outs[0][0], mode)
        if reference:
            tf._close_unflipped(outs[1][0], jl,
                                routes.flipped(1, n)[:, n - 1:n])
        routes.t.clear()
        row = torch.from_numpy(table[slot])
        for c, one in ((c1, outs[0][1]), (c2, outs[1][1])):
            if cache_mode == "dense":
                merge_slot_caches(c, one, slot)
            else:
                merge_slot_paged_caches(c, one, slot, row)
        if reference:
            jc = (jmerge(jc, jone, slot) if cache_mode == "dense" else
                  jmerge_paged(jc, jone, slot, jnp.asarray(table[slot])))
    c3 = shard_caches(c1, tcfg, _mesh(), batch=3)
    pos = np.array([lens[0], 3, lens[1]], np.int32)
    tok = rng.integers(0, 256, (3, 1)).astype(np.int32)
    page_j = jnp.asarray(table) if cache_mode == "paged" else None
    page_t = torch.from_numpy(table) if cache_mode == "paged" else None
    for _ in range(3):
        got = [decode_step(w, tcfg, torch.from_numpy(tok), c,
                           torch.from_numpy(pos), page_table=page_t)[0]
               for w, c in ((tp1, c1), (tp2, c3), (tp2, c2))]
        _same(got[1], got[0], mode)
        _same(got[2], got[1], mode)
        if reference:
            jl, jc = jdecode(jp, jcfg, jnp.asarray(tok), jc,
                             jnp.asarray(pos), page_table=page_j)
            jax.effects_barrier()               # the reference's routings
            del routes.t[:-len(routes.j)]       # the last call's routings
            tf._close_unflipped(got[2], jl, routes.flipped(3, 1))
        routes.t.clear()
        tok = got[0][:, -1].argmax(-1)[:, None].numpy().astype(np.int32)
        pos = pos + 1
    return tp2


@pytest.mark.parametrize("cache_mode", ["paged", "dense"])
@pytest.mark.parametrize("mode", ["w8a8_nibble", "dense"])
def test_mamba2_tp2_matches_tp1_and_reference(monkeypatch, mode,
                                              cache_mode):
    """Reduced mamba2-780m: 4 SSD heads a shard, B and C whole on both
    (one group)."""
    tp2 = _steps(monkeypatch, MAMBA2, mode, cache_mode)
    assert not tp2.layout.ssm_groups


@pytest.mark.parametrize("mode", ["w8a8_nibble", "dense"])
def test_jamba_tp2_matches_tp1_and_reference(monkeypatch, mode):
    """Reduced jamba over paged pools: mamba layers by SSD head, the
    attention layer by kv head, the MoE layers by expert; the reference
    holds the ``w8a8_nibble`` case (its ``dense`` one is
    ``tests/test_torch_families.py``'s at tp=1)."""
    tp2 = _steps(monkeypatch, JAMBA, mode, "paged",
                 reference=mode == "w8a8_nibble")
    assert tp2.layout.heads and tp2.layout.experts


def test_mamba2_groups_split_by_group(monkeypatch):
    """``ssm_groups=2`` at tp=2: each shard holds one group's B and C and
    that group's heads, bit for bit tp=1 in ``w8a8_nibble``."""
    tp2 = _steps(monkeypatch, MAMBA2, "w8a8_nibble", "paged", ssm_groups=2)
    assert tp2.layout.ssm_groups
    seg = ssm_segments(reduced(get_config(MAMBA2)).replace(ssm_groups=2),
                       tp2.layout, 1)
    assert (seg.group_lo, seg.groups, seg.head_lo) == (1, 1, 4)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [MAMBA2, JAMBA])
def test_tp2_engine_streams_equal_tp1_and_reference(monkeypatch, arch):
    """The staggered workload of ``test_torch_engine.py`` (6 requests
    through 3 paged slots, prompts at their exact lengths) in
    ``w8a8_nibble``: tp=2's streams and counters equal the port's tp=1
    engine's, and on mamba2 the reference engine's under that file's tie
    rule (jamba's tp=1 engine is held to the reference's in
    ``tests/test_torch_families.py``)."""
    over = dict(quant_mode="w8a8_nibble", attn_impl="flash",
                cache_mode="paged", page_size=4)
    jcfg, jparams, tcfg, tparams = tf._pair(arch, **over)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab_size, p).astype(np.int32)
               for p, _ in te.SPEC]
    kw = dict(batch=3, max_len=24, prefill_len=8, decode_chunk=3)
    if arch == MAMBA2:
        records = te._recorders(monkeypatch)
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
    if arch != MAMBA2:
        return
    for jid, got, prompt, (_, n) in zip(jids, runs[2][0], prompts, te.SPEC):
        want = jdone[jid].tokens
        diff = [i for i in range(n) if want[i] != got[i]]
        if diff:
            _, logits = te._reference_logits(records, prompt, want, diff[0])
            assert logits[want[diff[0]]] - logits[got[diff[0]]] \
                <= te.LOGIT_TOL
            break                   # w8a8: later streams share the batch


def test_tp2_evict_and_resume_matches_reserve():
    """Reduced jamba at tp=2 over an overcommitted incremental pool:
    requests are evicted, re-prefilled and replayed, and the streams
    equal a tp=2 reserve pool's and tp=1's (``dense``: rows are
    independent)."""
    cfg = reduced(get_config(JAMBA))
    params = model_init(cfg, seed=0, device="cpu")
    prompts = [np.random.default_rng(4).integers(0, cfg.vocab_size, n)
               .astype(np.int32) for n in (4, 6, 5, 7)]
    kw = dict(batch=3, max_len=16, prefill_len=8, decode_chunk=3,
              cache_mode="paged", page_size=4)
    want, _ = ttp._serve(cfg, params, ServeConfig(**kw), prompts)
    reserve, _ = ttp._serve(cfg, params, ServeConfig(tp=2, **kw), prompts,
                            devices=CPU2)
    got, eng = ttp._serve(cfg, params, ServeConfig(
        tp=2, alloc_mode="incremental", num_pages=7, **kw), prompts,
        devices=CPU2)
    assert got == reserve == want
    assert eng.stats["preemptions"] >= 1 and eng.leaked_pages() == 0


def test_launcher_tp2_mamba2_verify(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--device", "cpu", "--arch", MAMBA2, "--batch", "2",
                       "--prompt-len", "8", "--new-tokens", "6",
                       "--requests", "4", "--workload", "uniform",
                       "--cache-mode", "paged", "--page-size", "4",
                       "--quant", "w8a8_nibble", "--tp", "2",
                       "--verify"]) == 0
    out = capsys.readouterr().out
    assert "per-engine mesh (1, 2)" in out
    assert "verify: 4 streams bit-match" in out
    assert "ssm_heads=True" in out


# ---------------------------------------------------------------------------
# qat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-6b", "deepseek-v3-671b"])
def test_qat_tp2_within_dense_tolerance_of_tp1(arch):
    """A prefill and three decode steps over paged pools in ``qat``: tp=2
    within LOGIT_ATOL of tp=1 (column-parallel fake-quant is per output
    column, so local; a row-parallel one takes the shards' amaxes by max
    and sums f32 partials)."""
    cfg = reduced(get_config(arch)).replace(
        quant_mode="qat", attn_impl="flash", cache_mode="paged",
        page_size=4)
    tp1 = model_init(cfg, seed=0, device="cpu")
    tp2 = shard_params(tp1, cfg, _mesh())
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 8)))
    table = torch.tensor([[1, 2, 3, 4]])
    runs, feed = [], None
    for w, caches in ((tp1, init_caches(cfg, 1, 16, device="cpu")),
                      (tp2, init_shard_caches(cfg, 1, 16, tp2))):
        lp, one, _ = prefill(w, cfg, toks, max_len=8)
        merge_slot_paged_caches(caches, one, 0, table[0])
        steps, pos = [lp], torch.tensor([8])
        for i in range(3):
            # tp=1's greedy tokens feed both
            tok = steps[-1][:, -1].argmax(-1)[:, None] if feed is None \
                else feed[i]
            steps.append(decode_step(w, cfg, tok, caches, pos,
                                     page_table=table)[0])
            pos = pos + 1
        feed = [st[:, -1].argmax(-1)[:, None] for st in steps[:3]]
        runs.append(steps)
    for got, want in zip(runs[1], runs[0]):
        tm._close(got, want)


# ---------------------------------------------------------------------------
# attention_core, fixed_bmm, fixed_cumsum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,sq,h,kvh,d,dv,sk,kw", [
    (4, 1, 16, 16, 24, 16, 40, {}),                   # MLA-like decode
    (4, 1, 8, 8, 12, 12, 33, {}),                     # d 12, odd Sk
    (2, 5, 8, 2, 16, 16, 20, {"window": 6}),          # verify, group 4
    (1, 7, 8, 4, 16, 16, 7, {"softcap": 30.0}),       # prefill
    (3, 2, 6, 2, 8, 8, 9, {"causal": False})])
def test_attention_core_rows_independent_of_heads(b, sq, h, kvh, d, dv, sk,
                                                  kw):
    """Each shard's heads alone (halves, and single kv heads) give those
    heads' rows of the whole call bit for bit."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((b, sq, h, d), generator=g).bfloat16()
    k = torch.randn((b, sk, kvh, d), generator=g).bfloat16()
    v = torch.randn((b, sk, kvh, dv), generator=g).bfloat16()
    qp = torch.arange(sk - sq, sk)[None].expand(b, sq)
    kp = torch.arange(sk)[None].expand(b, sk)
    whole = attention_core(q, k, v, qp, kp, scale=0.3, **kw)
    grp = h // kvh
    for parts in (2, kvh):
        n = kvh // parts
        got = torch.cat([attention_core(
            q[:, :, i * n * grp:(i + 1) * n * grp],
            k[:, :, i * n:(i + 1) * n], v[:, :, i * n:(i + 1) * n], qp, kp,
            scale=0.3, **kw) for i in range(parts)], dim=2)
        assert torch.equal(got, whole)


@pytest.mark.parametrize("n", [1, 5, 64, 65, 130])
def test_fixed_calls_give_each_entry_its_own_result(n):
    """``fixed_bmm`` and ``fixed_cumsum`` at 1 to 130 entries (padded,
    exact, overlapping last call): every entry equals that entry run
    alone, and the values are ``torch.bmm`` / ``torch.cumsum``'s."""
    g = torch.Generator().manual_seed(n)
    a = torch.randn((n, 3, 8), generator=g)
    b = torch.randn((n, 8, 5), generator=g)
    assert entries_per_call(3, 8, 5) == 64
    got = fixed_bmm(a, b)
    alone = torch.cat([fixed_bmm(a[i:i + 1], b[i:i + 1]) for i in range(n)])
    assert torch.equal(got, alone)
    torch.testing.assert_close(got, torch.bmm(a, b))
    rows = torch.randn((n, 2, 7), generator=g)
    got = fixed_cumsum(rows)
    assert torch.equal(got, torch.cat([fixed_cumsum(rows[i:i + 1])
                                       for i in range(n)]))
    torch.testing.assert_close(got, torch.cumsum(rows, -1))


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

def test_mamba_shards_rebuild_the_unsharded_layer():
    """Reduced jamba at tp=2 in ``w8a8_nibble`` on one device: a mamba
    layer's shards, each leaf's segments (``ssm_segments``) put back in
    shard order, rebuild ``in_proj``'s weight, int8 copy and scales, the
    conv and the per-head scalars exactly; ``in_proj``'s pieces are
    copies, ``out_proj`` splits by rows, the norm stays the caller's;
    the expert stacks are views."""
    cfg = reduced(get_config(JAMBA)).replace(quant_mode="w8a8_nibble")
    params = model_init(cfg, device="cpu")
    shards = shard_params(params, cfg, _mesh())
    li = next(i for i, s in enumerate(cfg.layer_specs) if s.mixer == "mamba")
    whole = params["layers"][li]["mamba"]
    parts = [t["layers"][li]["mamba"] for t in shards]
    segs = [ssm_segments(cfg, shards.layout, s) for s in range(2)]
    for key, dim, which in (("w", 1, "proj"), ("qt8", 0, "proj"),
                            ("s8", 1, "proj")):
        rebuilt = whole["in_proj"][key].clone().zero_()
        for seg, part in zip(segs, parts):
            off = 0
            for a, ln in getattr(seg, which):
                rebuilt.narrow(dim, a, ln).copy_(
                    part["in_proj"][key].narrow(dim, off, ln))
                off += ln
            assert part["in_proj"][key].untyped_storage().data_ptr() \
                != whole["in_proj"][key].untyped_storage().data_ptr()
        assert torch.equal(rebuilt, whole["in_proj"][key])
    for key, dim in (("conv_w", 1), ("conv_b", 0)):
        rebuilt = whole[key].clone().zero_()
        for seg, part in zip(segs, parts):
            off = 0
            for a, ln in seg.conv:
                rebuilt.narrow(dim, a, ln).copy_(part[key].narrow(dim, off,
                                                                  ln))
                off += ln
        assert torch.equal(rebuilt, whole[key])
    for key in ("A_log", "D", "dt_bias"):
        assert torch.equal(torch.cat([p[key] for p in parts]), whole[key])
    assert torch.equal(torch.cat([p["out_proj"]["w"] for p in parts]),
                       whole["out_proj"]["w"])
    assert all(p["norm"]["scale"] is whole["norm"]["scale"] for p in parts)
    moe = next(i for i, s in enumerate(cfg.layer_specs) if s.ffn == "moe")
    for t in shards:
        assert t["layers"][moe]["moe"]["w_gate"].untyped_storage() \
            .data_ptr() == params["layers"][moe]["moe"]["w_gate"] \
            .untyped_storage().data_ptr()
