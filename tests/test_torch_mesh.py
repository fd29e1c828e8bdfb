"""The port's mesh and partition rules against the reference's.

``make_local_mesh`` keeps the reference's sizing and messages; the rule
functions (``_param_rule``, ``_fit_spec``, ``param_specs``,
``cache_specs``, ``page_table_spec``, ``opt_state_specs``,
``batch_specs``) give the reference's spec for every leaf of every
config's tree, its stacked block axis dropped (the port's layers are
unrolled), on the reference tests' ``FakeMesh`` (data 4, model 2) and on
a (1, 2) mesh; ``shard_params`` and ``shard_caches`` split what the specs
say and nothing else, keep a row-parallel weight's scales whole and never
change the caller's tree.  Exact throughout: specs are names and shapes.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import models as jmodels
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.distributed import sharding as jsh
from repro_torch.configs import ARCH_NAMES, get_config, reduced
from repro_torch.distributed import sharding as tsh
from repro_torch.launch.mesh import LocalMesh, make_local_mesh
from repro_torch.models import init_caches, model_init
from repro_torch.models.transformer import unstack_jax_tree

torch.set_num_threads(1)


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 4, "model": 2}


class TPMesh:
    axis_names = ("data", "model")
    shape = {"data": 1, "model": 2}


class FakeLeaf:
    def __init__(self, *shape):
        self.shape = shape
        self.ndim = len(shape)


def _norm(spec):
    """A spec as a plain tuple, one-axis tuples as the axis (the forms
    ``PartitionSpec`` treats as equal)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _flat(tree, path=()):
    """{path: spec} over dict / list nodes; a spec (a tuple) is a leaf."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (str(k),)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (str(i),)))
        return out
    return {path: _norm(tree)}


def _unstacked_specs(tree, n_blocks, stacked=False):
    """The reference's spec tree with every stacked spec's block axis
    dropped and repeated once per block (``unstack_jax_tree`` indexes
    it), the others as tuples."""
    if isinstance(tree, dict):
        return {k: _unstacked_specs(v, n_blocks, stacked or k == "blocks")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unstacked_specs(v, n_blocks, stacked) for v in tree]
    spec = tuple(tree)
    return [spec[1:]] * n_blocks if stacked else spec


def test_make_local_mesh_sizing_and_validation():
    """The reference's sizing and messages on an explicit device list (a
    device may repeat); ``devices=None`` takes the visible cards and
    raises without one (no silent CPU)."""
    mesh = make_local_mesh(devices=["cpu"])
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 1, "model": 1}
    mesh = make_local_mesh(tp=2, devices=["cpu"] * 4)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.size == 4
    assert mesh.model_devices == [torch.device("cpu")] * 2
    mesh = make_local_mesh(dp=1, tp=2, devices=["cpu"] * 3)
    assert mesh.shape == {"data": 1, "model": 2}
    with pytest.raises(ValueError, match="tp must be >= 1"):
        make_local_mesh(tp=0, devices=["cpu"])
    with pytest.raises(ValueError, match="dp must be >= 0"):
        make_local_mesh(dp=-1, devices=["cpu"])
    with pytest.raises(ValueError, match="does not divide the 1"):
        make_local_mesh(tp=2, devices=["cpu"])
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_local_mesh(dp=2, tp=2, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_local_mesh(tp=2)


@pytest.mark.parametrize("path,shape", [
    (("wq", "w"), (64, 32)), (("wo", "w"), (32, 64)),
    (("blocks", "0", "mlp", "gate", "w"), (4, 64, 128)),
    (("embed", "emb"), (1000, 64)), (("moe", "w_gate"), (8, 64, 128)),
    (("moe", "w_down"), (8, 128, 64)), (("norm", "scale"), (64,)),
    (("moe", "router"), (64, 8)), (("mamba", "conv_w"), (4, 96)),
    (("mamba", "conv_b"), (96,)), (("wq_a", "w"), (64, 16)),
    (("mystery", "w"), (64, 16))])
def test_param_rule_equals_reference(path, shape):
    fsdp = ("data",)
    assert _norm(tsh._param_rule(path, FakeLeaf(*shape), fsdp)) == \
        _norm(jsh._param_rule(path, FakeLeaf(*shape), fsdp))


@pytest.mark.parametrize("spec,shape", [
    (("model", None), (50280, 64)), (("model", None), (50281, 64)),
    ((("data",), None, "model", None), (1, 128, 2, 16)),
    ((("data", "model"),), (64,)), ((("data", "model"),), (12,))])
def test_fit_spec_equals_reference(spec, shape):
    for mesh in (FakeMesh(), TPMesh()):
        assert _norm(tsh._fit_spec(spec, shape, mesh)) == \
            _norm(jsh._fit_spec(P(*spec), shape, mesh))


def test_prepared_int8_leaves_follow_their_weight():
    """The port's own leaves: ``qt8`` takes its weight's spec reversed,
    ``s8`` its out axis where that is the model axis and never the data
    axis, so a row-parallel weight keeps its scales whole (also over a
    data axis) and a column-parallel one splits them with its
    columns."""
    fsdp = ("data",)
    for parent, w_spec, s_spec in (("wq", (fsdp, "model"), (None, "model")),
                                   ("wo", ("model", fsdp), (None, None))):
        assert tsh._param_rule((parent, "w"), FakeLeaf(8, 8), fsdp) == w_spec
        assert tsh._param_rule((parent, "qt8"), FakeLeaf(8, 8), fsdp) == \
            w_spec[::-1]
        assert tsh._param_rule((parent, "s4"), FakeLeaf(1, 8), fsdp) == \
            s_spec


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_equal_reference_leaf_by_leaf(arch):
    jcfg = jreduced(jget_config(arch))
    tcfg = reduced(get_config(arch))
    shapes = jax.eval_shape(lambda: jmodels.model_init(
        jax.random.PRNGKey(0), jcfg))
    params = model_init(tcfg, device="cpu")
    for mesh in (FakeMesh(), TPMesh()):
        want = _flat(unstack_jax_tree(
            _unstacked_specs(jsh.param_specs(shapes, mesh), jcfg.n_blocks),
            tcfg, lambda k, v: v))
        got = _flat(tsh.param_specs(params, mesh))
        assert got == want


def _ref_cache_layers(tree, cfg):
    """The reference's cache spec tree as the port's per-layer list:
    prefix, then every block of the pattern (block axis dropped), then
    suffix; each layer's one mixer dict."""
    def inner(d, drop):
        (sub,) = d.values()
        return {k: tuple(v)[drop:] for k, v in sub.items()}

    layers = [inner(d, 0) for d in tree["prefix"]]
    if tree["blocks"] is not None:
        for _ in range(cfg.n_blocks):
            layers += [inner(tree["blocks"][str(j)], 1)
                       for j in range(len(cfg.block_pattern))]
    return layers + [inner(d, 0) for d in tree["suffix"]]


CACHE_CASES = [(arch, mode, kv, batch) for arch in ARCH_NAMES
               for mode in ("dense", "paged") for kv in ("bf16", "int8")
               for batch in (1, 2)]


@pytest.mark.parametrize("arch,cache_mode,kv_dtype,batch", CACHE_CASES)
def test_cache_specs_equal_reference_leaf_by_leaf(arch, cache_mode,
                                                  kv_dtype, batch):
    """Dense slabs and paged pools, the int8 scale pools, MLA latents and
    mamba state, batch 2 and the batch-1 sequence rule."""
    over = dict(cache_mode=cache_mode, page_size=4, kv_cache_dtype=kv_dtype)
    jcfg = jreduced(jget_config(arch)).replace(**over)
    tcfg = reduced(get_config(arch)).replace(**over)
    shapes = jax.eval_shape(lambda: jmodels.init_caches(jcfg, batch, 16))
    caches = init_caches(tcfg, batch, 16, device="cpu")
    for mesh in (FakeMesh(), TPMesh()):
        want = _flat(_ref_cache_layers(
            jsh.cache_specs(jcfg, shapes, mesh, batch=batch), jcfg))
        got = _flat(tsh.cache_specs(tcfg, caches, mesh, batch=batch))
        assert got == want
    assert _norm(tsh.page_table_spec(TPMesh())) == \
        _norm(jsh.page_table_spec(TPMesh()))


def test_batch_and_opt_state_specs_equal_reference():
    for arch in ("qwen3-4b", "whisper-base", "phi-3-vision-4.2b"):
        for mesh in (FakeMesh(), TPMesh()):
            got = {k: _norm(v) for k, v in tsh.batch_specs(
                reduced(get_config(arch)), mesh).items()}
            want = {k: _norm(v) for k, v in jsh.batch_specs(
                jreduced(jget_config(arch)), mesh).items()}
            assert got == want
    pspec = {"a": ("model", None), "b": [(None,)]}
    state = {"step": 0, "mu": {"a": {"q": 1, "scale": 2}, "b": [3]},
             "nu": {"a": 4, "b": [{"q": 5, "scale": 6}]}}
    assert tsh.opt_state_specs(state, pspec) == {
        "step": (), "mu": {"a": {"q": ("model", None), "scale": ()},
                           "b": [(None,)]},
        "nu": {"a": ("model", None), "b": [{"q": (None,), "scale": ()}]}}


def _mesh(tp=2):
    return make_local_mesh(tp=tp, devices=["cpu"] * tp)


@pytest.mark.parametrize("mode", ["w8a8_nibble", "w4a8_nibble", "lut"])
def test_shard_params_splits_per_spec_and_keeps_row_scales_whole(mode):
    """Column shards split ``w``'s columns, ``qt``'s rows and the scales;
    row shards split ``w``'s rows and ``qt``'s columns and keep every
    scale whole; the pieces concatenate back to the quantized tree; the
    caller's tree is unchanged and its replicated leaves are shared."""
    bits = 4 if mode == "w4a8_nibble" else 8
    cfg = reduced(get_config("yi-6b")).replace(quant_mode=mode)
    params = model_init(cfg.replace(quant_mode="dense"), device="cpu")
    before = {k: v for k, v in params["layers"][0]["attn"]["wo"].items()}
    shards = tsh.shard_params(params, cfg, _mesh())
    assert params["layers"][0]["attn"]["wo"].keys() == before.keys()
    whole = model_init(cfg, device="cpu")
    for blk, lin, col in (("attn", "wq", True), ("attn", "wk", True),
                          ("attn", "wo", False), ("mlp", "gate", True),
                          ("mlp", "down", False)):
        full = whole["layers"][0][blk][lin]
        parts = [s["layers"][0][blk][lin] for s in shards]
        q, sc = f"qt{bits}", f"s{bits}"
        assert torch.equal(torch.cat([p["w"] for p in parts],
                                     dim=1 if col else 0), full["w"])
        assert torch.equal(torch.cat([p[q] for p in parts],
                                     dim=0 if col else 1), full[q])
        if col:
            assert torch.equal(torch.cat([p[sc] for p in parts], dim=1),
                               full[sc])
        else:
            assert all(torch.equal(p[sc], full[sc]) for p in parts)
            assert parts[0][sc] is parts[1][sc]
    norm = [s["layers"][0]["mixer_norm"]["scale"] for s in shards]
    assert norm[0] is norm[1] is params["layers"][0]["mixer_norm"]["scale"]
    assert torch.equal(torch.cat([s["embed"]["emb"] for s in shards]),
                       params["embed"]["emb"])


def test_shard_params_keeps_indivisible_attention_whole():
    """gemma3-1b (KVH 1) at tp=2: its attention blocks stay whole on every
    shard (the reference splits its pools' in-page sequence instead; the
    two differ in memory only), its MLP and tied embedding split."""
    cfg = reduced(get_config("gemma3-1b"))
    params = model_init(cfg, device="cpu")
    shards = tsh.shard_params(params, cfg, _mesh())
    assert not shards.layout.heads and shards.layout.ffn
    assert shards.layout.vocab
    for name in ("wq", "wk", "wv", "wo"):
        assert shards[0]["layers"][0]["attn"][name]["w"] is \
            params["layers"][0]["attn"][name]["w"]
    assert shards[0]["layers"][0]["mlp"]["gate"]["w"].shape == \
        (cfg.d_model, cfg.d_ff // 2)
    assert shards[1]["embed"]["emb"].shape[0] == cfg.vocab_size // 2


@pytest.mark.parametrize("arch,kv_dtype", [("qwen3-4b", "bf16"),
                                           ("qwen3-4b", "int8"),
                                           ("gemma3-1b", "bf16")])
def test_shard_caches_split_heads_and_copy(arch, kv_dtype):
    """Head-split pools (K, V and the int8 scale pools) concatenate back
    along the head axis; indivisible heads keep whole pools; every shard
    is a copy (the caller's caches are not written through it)."""
    cfg = reduced(get_config(arch)).replace(cache_mode="paged", page_size=4,
                                            kv_cache_dtype=kv_dtype)
    caches = init_caches(cfg, 2, 16, device="cpu")
    for pool in caches[0].values():
        pool.copy_(torch.arange(pool.numel()).reshape(pool.shape)
                   .to(pool.dtype))
    shards = tsh.shard_caches(caches, cfg, _mesh(), batch=2)
    split = cfg.n_kv_heads % 2 == 0
    for key, pool in caches[0].items():
        parts = [s[0][key] for s in shards]
        if split:
            assert torch.equal(torch.cat(parts, dim=2), pool)
        else:
            assert parts[0] is parts[1] and torch.equal(parts[0], pool)
        assert parts[0].data_ptr() != pool.data_ptr()
        parts[0].zero_()
        assert pool.abs().sum() > 0


def test_tp_refuses_the_other_families():
    """Every family (MLA, MoE, the encoder-decoder, the VLM, the mamba
    mixers) and every quant mode (``qat`` too) pass at tp=2, and a data
    axis above 1 passes at any tp; only a size below 1 raises."""
    for arch in ("deepseek-v3-671b", "llama4-maverick-400b-a17b",
                 "whisper-base", "phi-3-vision-4.2b", "mamba2-780m",
                 "jamba-v0.1-52b"):
        tsh.check_tp_supported(reduced(get_config(arch)), 1)
        tsh.check_tp_supported(reduced(get_config(arch)), 2)
    tsh.check_tp_supported(
        reduced(get_config("yi-6b")).replace(quant_mode="qat"), 2)
    for tp in (1, 2):
        tsh.check_tp_supported(reduced(get_config("yi-6b")), tp, dp=2)
        with pytest.raises(ValueError, match="dp >= 1 and tp >= 1"):
            tsh.check_tp_supported(reduced(get_config("yi-6b")), tp, dp=0)
    assert isinstance(_mesh(), LocalMesh)
    np.testing.assert_equal(tsh.split_dim((None, ("data", "model"))), 1)
