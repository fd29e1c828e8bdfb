"""The sharded training step: ``make_train_step`` over ``Shards``, held to
the reference's step under a mesh, and its parts held to the port's own
unsharded step.

**Against the reference** (one subprocess under
``--xla_force_host_platform_device_count=4``): the reference trains on a
mesh only as its dry run builds the step, ``jax.jit(step,
in_shardings=...)`` under ``ambient_mesh``; the mesh is made with
``jax.sharding.Mesh`` (``jax.make_mesh`` makes ``Explicit`` axes on this
JAX, which ``maybe_shard`` refuses), and every step is compiled without
excess precision (``test_torch_model.EXACT_OPTIONS``).  Reduced
qwen3-4b, gemma3-1b, mamba2-780m and llama4 (2 layers) and deepseek-v3
(4 layers), batch 4 x 32, seed 0, AdamW at lr 1e-2 with no warmup (so
one step's update shows in the bf16 weights), at (2, 1), (1, 2) and
(2, 2): the port's step, from the same numpy weights and batch, gives the
reference mesh step's

* loss within ``LOSS_ATOL`` = 1e-3 (largest measured: 3.1e-4, llama4 at
  (1, 2): the reference's sharded products round in another order);
* aux within ``AUX_ATOL`` = 1e-3 (largest 1.3e-4, llama4 at (2, 2));
* grad norm within ``GNORM_RTOL`` = 5e-3 (largest 2.0e-3, deepseek-v3 at
  (2, 2));
* updated parameters: the share of all elements whose new values differ
  by more than half the learning rate (a sign the first AdamW step took
  the other way) at most ``UPDATE_FRAC`` = 0.025 (largest 1.2%,
  deepseek-v3 at (2, 2); against the unsharded reference step the MoE
  families at dp = 2 reach 3.7-7.3%).

**The MoE cases follow the reference's mesh semantics**
(``moe.moe_apply_mesh``, its ``_moe_sharded``): at dp = 2 each data row
routes its own tokens with its own capacity, and the aux is row 0's.  So
on llama4 and deepseek-v3 at (2, 1) and (2, 2) the reference's mesh aux
differs from its unsharded aux by more than ``10 * AUX_ATOL`` (llama4:
1.0305 against 1.0046), and the port gives the mesh value.
"""

import copy
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import piece_groups, shard_params, \
    train_shards
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.train import stub_extras
from repro_torch.models import forward, model_init
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.step import TrainConfig, make_train_step
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU4 = ["cpu"] * 4
LOSS_ATOL = 1e-3
AUX_ATOL = 1e-3
GNORM_RTOL = 5e-3
UPDATE_FRAC = 0.025
LR = 1e-2
FAMILIES = {"qwen3-4b": ("qwen3-4b", 2), "gemma3-1b": ("gemma3-1b", 2),
            "mamba2-780m": ("mamba2-780m", 2),
            "llama4": ("llama4-maverick-400b-a17b", 2),
            "deepseek-v3": ("deepseek-v3-671b", 4)}
SHAPES = ["(2, 1)", "(1, 2)", "(2, 2)"]

_CHILD = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import jax, jax.numpy as jnp
    import torch
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    import test_torch_model as tm
    from repro.configs import get_config as jget, reduced as jred
    from repro.models import model_init as jinit
    from repro.optim import AdamWConfig as JAdamW, adamw_init as jadam_init
    from repro.train import TrainConfig as JTrain, make_train_step as jstep
    from repro.distributed.sharding import (ambient_mesh, batch_specs,
                                            opt_state_specs, param_specs)
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed.sharding import shard_params, train_shards
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import load_jax_params
    from repro_torch.models.transformer import unstack_jax_tree
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.step import TrainConfig, make_train_step
    from repro_torch.tree import tree_leaves
    torch.set_num_threads(1)
    LR = float(sys.argv[3])
    SHAPES = [(2, 1), (1, 2), (2, 2)]

    def to_np(tree):
        return jax.tree_util.tree_map(
            lambda a: np.array(a.astype(jnp.float32)), tree)

    out = {}
    for name, (arch, nl) in json.loads(sys.argv[2]).items():
        jcfg = jred(jget(arch)).replace(n_layers=nl)
        tcfg = reduced(get_config(arch)).replace(n_layers=nl)
        jp = jax.jit(jinit, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
        tree = to_np(jp)
        rng = np.random.default_rng(0)
        toks = rng.integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
        labels = np.concatenate([toks[:, 1:], np.full((4, 1), -1, np.int32)],
                                1)
        jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
        tbatch = {"tokens": torch.from_numpy(toks).long(),
                  "labels": torch.from_numpy(labels).long()}
        jt = JTrain(optimizer=JAdamW(lr=LR), warmup_steps=0, total_steps=10)
        tt = TrainConfig(optimizer=AdamWConfig(lr=LR), warmup_steps=0,
                         total_steps=10)
        step = jstep(jcfg, jt)
        jopt = jadam_init(jp, jt.optimizer)
        refs = {}
        for shape in [None] + SHAPES:
            if shape is None:
                comp = jax.jit(step).lower(jp, jopt, jbatch).compile(
                    compiler_options=tm.EXACT_OPTIONS)
                newp, _, m = comp(jp, jopt, jbatch)
            else:
                mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]])
                            .reshape(shape), ("data", "model"))
                ns = lambda t: jax.tree_util.tree_map(
                    lambda sp: NamedSharding(mesh, sp), t,
                    is_leaf=lambda x: isinstance(x, P))
                ps = param_specs(jp, mesh)
                specs = (ns(ps), ns(opt_state_specs(jopt, ps)),
                         ns(batch_specs(jcfg, mesh)))
                with mesh, ambient_mesh(mesh):
                    comp = jax.jit(step, in_shardings=specs).lower(
                        jp, jopt, jbatch).compile(
                        compiler_options=tm.EXACT_OPTIONS)
                    newp, _, m = comp(jp, jopt, jbatch)
            refs[str(shape)] = (
                unstack_jax_tree(to_np(newp), tcfg,
                                 lambda k, v: torch.as_tensor(v)),
                {k: float(v) for k, v in m.items()})
        res = {"None": refs["None"][1]}
        for shape in SHAPES:
            mesh = make_local_mesh(dp=shape[0], tp=shape[1],
                                   devices=["cpu"] * 4)
            sh = train_shards(load_jax_params(tree, tcfg, device="cpu"),
                              tcfg, mesh)
            st = adamw_init(sh, tt.optimizer)
            sh, st, m = make_train_step(tcfg, tt)(sh, st, tbatch)
            row = {"port": {k: float(v) for k, v in m.items()}}
            for key in (str(shape), "None"):
                want = shard_params(refs[key][0], tcfg, mesh)
                bad = total = 0
                for got_t, want_t in zip(sh.trees, want.trees):
                    for g, w in zip(tree_leaves(got_t), tree_leaves(want_t)):
                        diff = (g.detach().float() - w.float()).abs()
                        bad += int((diff > 0.5 * LR).sum())
                        total += diff.numel()
                row["ref" + key] = dict(refs[key][1],
                                        update_mismatch=bad / total)
            res[str(shape)] = row
        out[name] = res
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def against_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _CHILD,
                          os.path.join(REPO, "tests"), json.dumps(FAMILIES),
                          str(LR)], env=env, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_mesh_step_equals_the_reference_mesh_step(against_reference, family,
                                                  shape):
    row = against_reference[family][shape]
    got, want = row["port"], row["ref" + shape]
    assert abs(got["loss"] - want["loss"]) <= LOSS_ATOL, (got, want)
    assert abs(got["aux"] - want["aux"]) <= AUX_ATOL, (got, want)
    assert abs(got["grad_norm"] / want["grad_norm"] - 1) <= GNORM_RTOL, \
        (got, want)
    assert want["update_mismatch"] <= UPDATE_FRAC, want


@pytest.mark.parametrize("shape", ["(2, 1)", "(2, 2)"])
@pytest.mark.parametrize("family", ["llama4", "deepseek-v3"])
def test_mesh_moe_follows_the_reference_mesh_semantics(against_reference,
                                                       family, shape):
    """At dp = 2 the mesh MoE routes each row alone: the reference's own
    aux moves off its unsharded value, and the port's follows it."""
    row = against_reference[family][shape]
    unsharded = against_reference[family]["None"]
    assert abs(row["ref" + shape]["aux"] - unsharded["aux"]) \
        > 10 * AUX_ATOL, (row, unsharded)
    assert abs(row["port"]["aux"] - unsharded["aux"]) > 10 * AUX_ATOL
    assert abs(row["port"]["aux"] - row["ref" + shape]["aux"]) <= AUX_ATOL
    # the unsharded reference's update is not the mesh's
    assert row["refNone"]["update_mismatch"] > max(
        UPDATE_FRAC, 2 * row["ref" + shape]["update_mismatch"]), row


# ---------------------------------------------------------------------------
# The port's mesh step against its own unsharded step
# ---------------------------------------------------------------------------

def _batch(cfg, b=4, s=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1)], 1)
    return {"tokens": torch.from_numpy(toks).long(),
            "labels": torch.from_numpy(labels).long()}


def _steps(cfg, tcfg, shape, batch, params=None):
    """One unsharded step and one step at ``shape`` from the same weights:
    (unsharded metrics and params, mesh metrics and Shards)."""
    params = params or model_init(cfg, seed=0, device="cpu")
    mesh = make_local_mesh(dp=shape[0], tp=shape[1], devices=CPU4)
    sh = train_shards(params, cfg, mesh)
    step = make_train_step(cfg, tcfg)
    sh, _, m_mesh = step(sh, adamw_init(sh, tcfg.optimizer), batch)
    p = copy.deepcopy(params)
    p, _, m = step(p, adamw_init(p, tcfg.optimizer), batch)
    return m, p, m_mesh, sh, mesh


def test_mesh_step_at_11_is_the_unsharded_step_bit_for_bit():
    cfg = reduced(get_config("qwen3-4b")).replace(n_layers=2)
    tcfg = TrainConfig(warmup_steps=0, total_steps=10)
    m, p, m_mesh, sh, mesh = _steps(cfg, tcfg, (1, 1), _batch(cfg))
    for k in ("loss", "grad_norm", "aux", "lr"):
        assert torch.equal(m[k], m_mesh[k]), k
    for a, b in zip(tree_leaves(p), tree_leaves(sh.trees[0])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,n_layers,shape", [
    ("qwen3-4b", 2, (2, 2)), ("gemma3-1b", 2, (1, 2)),
    ("phi-3-vision-4.2b", 2, (2, 2)), ("whisper-base", 2, (2, 2)),
    ("mamba2-780m", 2, (2, 2))])
def test_mesh_step_stays_within_a_rounding_of_unsharded(arch, n_layers,
                                                        shape):
    """Dense families (a VLM's patches and an encoder-decoder's frames
    included) train at any mesh within a rounding of the unsharded step;
    every entry's copy of a piece takes the same update, and so does each
    shard's copy of a mamba mixer's B and C (its groups do not divide
    the shards: their gradients sum over the row)."""
    cfg = reduced(get_config(arch)).replace(n_layers=n_layers)
    tcfg = TrainConfig(warmup_steps=0, total_steps=10)
    batch = _batch(cfg)
    extra = stub_extras(cfg, 4, device="cpu")
    if extra is not None:
        batch.update(extra(0))
    m, p, m_mesh, sh, mesh = _steps(cfg, tcfg, shape, batch)
    assert abs(float(m["loss"]) - float(m_mesh["loss"])) <= LOSS_ATOL
    assert abs(float(m["grad_norm"]) / float(m_mesh["grad_norm"]) - 1) \
        <= GNORM_RTOL
    leaves = [tree_leaves(t) for t in sh.trees]
    for j, groups in enumerate(piece_groups(sh)):
        for g in groups:
            for e in g[1:]:
                assert torch.equal(leaves[e][j], leaves[g[0]][j]), (j, g)
    assert bool(sh.shared) == (arch == "mamba2-780m")
    tp = mesh.shape["model"]
    for j, ranges in sh.shared.items():
        for e in range(len(sh.trees)):
            for dim, start, ln in ranges:
                first = leaves[e - e % tp][j].narrow(dim, start, ln)
                assert torch.equal(leaves[e][j].narrow(dim, start, ln),
                                   first), (j, e)


def test_remat_and_microbatches_over_the_mesh():
    """Per-layer remat over the mesh is exact; two microbatches give the
    one-batch loss and gradients within a rounding."""
    cfg = reduced(get_config("qwen3-4b")).replace(n_layers=2)
    batch = _batch(cfg)
    got = {}
    for remat, micro in ((True, 1), (False, 1), (True, 2)):
        c = cfg.replace(remat=remat)
        tcfg = TrainConfig(warmup_steps=0, total_steps=10,
                           microbatches=micro)
        sh = train_shards(model_init(c, seed=0, device="cpu"), c,
                          make_local_mesh(dp=2, tp=2, devices=CPU4))
        sh, _, m = make_train_step(c, tcfg)(
            sh, adamw_init(sh, tcfg.optimizer), batch)
        got[(remat, micro)] = (m, tree_leaves(sh.trees[3]))
    for a, b in zip(got[(True, 1)][1], got[(False, 1)][1]):
        assert torch.equal(a, b)
    assert torch.equal(got[(True, 1)][0]["grad_norm"],
                       got[(False, 1)][0]["grad_norm"])
    assert abs(float(got[(True, 2)][0]["loss"])
               - float(got[(True, 1)][0]["loss"])) <= 1e-4
    assert abs(float(got[(True, 2)][0]["grad_norm"])
               / float(got[(True, 1)][0]["grad_norm"]) - 1) <= 1e-2


def test_mtp_and_compression_over_the_mesh():
    """The MTP term and int8 gradient compression: within a rounding of
    the unsharded step at (2, 2) (dense qwen3-4b; the compression scale is
    each whole tensor's, shared by its pieces)."""
    cfg = reduced(get_config("qwen3-4b")).replace(n_layers=2)
    tcfg = TrainConfig(warmup_steps=0, total_steps=10, mtp_weight=0.3,
                       compress_grads=True)
    m, p, m_mesh, sh, mesh = _steps(cfg, tcfg, (2, 2), _batch(cfg))
    assert abs(float(m["loss"]) - float(m_mesh["loss"])) <= LOSS_ATOL
    assert abs(float(m["grad_norm"]) / float(m_mesh["grad_norm"]) - 1) \
        <= GNORM_RTOL
    want = shard_params(p, cfg, mesh)
    bad = total = 0
    for got_t, want_t in zip(sh.trees, want.trees):
        for g, w in zip(tree_leaves(got_t), tree_leaves(want_t)):
            diff = (g.detach().float() - w.float()).abs()
            bad += int((diff > 0.5 * tcfg.optimizer.lr).sum())
            total += diff.numel()
    assert bad / total <= UPDATE_FRAC


def test_int8_moments_take_the_whole_tensor_scale():
    """Quantized moments: every piece of a leaf holds one scale, the max
    over the pieces (a per-piece amax would differ between pieces), and it
    is the unsharded step's within a rounding."""
    cfg = reduced(get_config("qwen3-4b")).replace(n_layers=2)
    tcfg = TrainConfig(warmup_steps=0, total_steps=10,
                       optimizer=AdamWConfig(quantize_moments=True))
    params = model_init(cfg, seed=0, device="cpu")
    mesh = make_local_mesh(dp=2, tp=2, devices=CPU4)
    sh = train_shards(params, cfg, mesh)
    step = make_train_step(cfg, tcfg)
    sh, st, _ = step(sh, adamw_init(sh, tcfg.optimizer), _batch(cfg))
    p = copy.deepcopy(params)
    p, st1, _ = step(p, adamw_init(p, tcfg.optimizer), _batch(cfg))

    def scales(tree):
        out = []

        def walk(node):
            if isinstance(node, dict) and "q" in node:
                out.append(node["scale"])
            elif isinstance(node, dict):
                for k in sorted(node):
                    walk(node[k])
            else:
                for v in node:
                    walk(v)
        walk(tree)
        return out

    whole = scales(st1["mu"])
    per_entry = [scales(t) for t in st["mu"]]
    split_pieces = 0
    for j, groups in enumerate(piece_groups(sh)):
        vals = {float(per_entry[e][j]) for e in range(4)}
        assert len(vals) == 1, (j, vals)
        split_pieces += len(groups) > 1
        assert abs(vals.pop() / float(whole[j]) - 1) <= 2e-2, j
    assert split_pieces > 0


def test_forward_over_shards_gives_the_unsharded_logits():
    cfg = reduced(get_config("qwen3-4b")).replace(n_layers=2)
    params = model_init(cfg, seed=0, device="cpu")
    toks = _batch(cfg)["tokens"]
    with torch.no_grad():
        want, _ = forward(params, cfg, toks)
        sh = shard_params(params, cfg,
                          make_local_mesh(dp=2, tp=2, devices=CPU4))
        got, aux = forward(sh, cfg, toks)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 2.0 ** -6
    assert float(aux) == 0.0


# ---------------------------------------------------------------------------
# Collective counters
# ---------------------------------------------------------------------------

def test_collectives_count_both_directions_by_kind_and_axis():
    """A move counts its bytes forward and its gradient's backward; a
    data gather's backward is the reduce-scatter of its pieces."""
    collectives.reset_collective_counts()
    with collectives.distinct_entries():
        pieces = [torch.ones(4, 8, requires_grad=True) for _ in range(2)]
        whole = collectives.data_gather(pieces, 0, ["cpu", "cpu"], rows=[0, 1])
        assert len({id(w) for w in whole}) == 2       # one per entry
        (whole[0].sum() + 2 * whole[1].sum()).backward()
    got = collectives.collective_bytes()["data_gather"]
    # each entry gathers one foreign piece of 128 bytes, both ways
    assert got == {"model": 0, "data": 4 * 128}
    assert torch.equal(pieces[0].grad, torch.full((4, 8), 3.0))
    collectives.reset_collective_counts()
    x = torch.ones(3, requires_grad=True)
    outs = collectives.broadcast(x, ["cpu", "cpu"], src=0)
    assert outs[1] is x                  # one card: no copy, no bytes
    with collectives.distinct_entries():
        outs = collectives.broadcast(x, ["cpu", "cpu"], src=0)
        sum(o.sum() for o in outs).backward()
    assert collectives.collective_bytes()["broadcast"]["model"] == 2 * 12
    assert collectives.collective_calls() == 1


def test_mesh_step_counts_its_collectives():
    """At (2, 2) the step moves bytes over both axes: the FSDP gathers
    over data, the row-parallel sums over model, the copies' gradient sums
    over both; at (1, 1) nothing moves."""
    cfg = reduced(get_config("qwen3-4b")).replace(n_layers=2)
    tcfg = TrainConfig(warmup_steps=0, total_steps=10)
    got = {}
    for shape in ((1, 1), (2, 2)):
        sh = train_shards(model_init(cfg, seed=0, device="cpu"), cfg,
                          make_local_mesh(dp=shape[0], tp=shape[1],
                                          devices=CPU4))
        collectives.reset_collective_counts()
        make_train_step(cfg, tcfg)(sh, adamw_init(sh, tcfg.optimizer),
                                   _batch(cfg))
        got[shape] = collectives.collective_bytes()
    assert not any(v for k in got[(1, 1)].values() for v in k.values())
    two = got[(2, 2)]
    assert two["data_gather"]["data"] > 0
    assert two["all_reduce_sum"]["model"] > 0
    assert two["all_reduce_sum"]["data"] > 0
    assert two["all_gather"]["model"] > 0           # the vocab log-sum-exp
