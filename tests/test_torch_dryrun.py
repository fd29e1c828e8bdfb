"""The dry run (``launch/dryrun.py``), its grid (``launch/shapes.py``), the
production mesh, the roofline's readers and the flash cost model, on the
CPU.

* ``SHAPES`` and ``skip_reason`` equal the reference's for every config.
* ``analyze_cell`` equals the reference's on the same record with ``HW``
  set to the reference's TPU v5e numbers, and splits the collective term
  over NVLink and the network with the H100's.
* A walk counts the same on fake ``meta:N`` entries as on real CPU
  tensors (flops, bytes, collective bytes, ``io_bytes``); the depth and
  data-row extrapolations equal a direct walk of the training step and
  of an MoE config's prefill and decode cells (the serving steps under
  the reference's mesh semantics, every entry an equal share).
* ``flash_attn_cost`` is half the walk's attention flops for ``d == dv``
  (the walk counts the costed calls' full square, the model the causal
  half), in training and in a prefill; the flash backward is counted
  once, by its own cost hook.
"""

import dataclasses
import json

import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import shapes as jshapes
from repro.roofline import analysis as janalysis
from repro_torch.configs import ARCH_NAMES, get_config, reduced
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, shapes
from repro_torch.launch.mesh import HW, make_local_mesh, \
    make_production_mesh, production_tag
from repro_torch.roofline import analysis, flash_attn_cost
from repro_torch.staticcheck.flops import StageWalk

torch.set_num_threads(1)


def _meta(dp, tp):
    return make_local_mesh(dp=dp, tp=tp, devices=[
        torch.device("meta", i) for i in range(dp * tp)])


# ---------------------------------------------------------------------------
# The grid and the mesh
# ---------------------------------------------------------------------------

def test_shape_grid_is_the_references():
    assert set(shapes.SHAPES) == set(jshapes.SHAPES)
    for name, case in shapes.SHAPES.items():
        want = jshapes.SHAPES[name]
        assert (case.name, case.kind, case.seq, case.batch) == \
            (want.name, want.kind, want.seq, want.batch)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_skip_reason_is_the_references(arch):
    for name in shapes.SHAPES:
        got = shapes.skip_reason(get_config(arch), shapes.SHAPES[name])
        want = jshapes.skip_reason(jget_config(arch), jshapes.SHAPES[name])
        assert got == want
        assert shapes.runnable(get_config(arch), shapes.SHAPES[name]) == \
            (want is None)


def test_input_structs_have_the_references_shapes():
    cfg = get_config("phi-3-vision-4.2b")
    case = shapes.SHAPES["train_4k"]
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        got = shapes.train_input_structs(cfg, case)
        pre = shapes.prefill_input_structs(
            get_config("whisper-base"), shapes.SHAPES["prefill_32k"])
        dec = shapes.decode_input_structs(
            reduced(get_config("yi-6b")), shapes.SHAPES["decode_32k"])
    assert got["tokens"].shape == (256, 4096)
    assert got["tokens"].dtype == torch.int32
    assert got["patch_embeds"].shape == (256, cfg.n_patches, cfg.d_model)
    assert got["patch_embeds"].dtype == torch.bfloat16
    assert pre["frames"].shape[:2] == (32, get_config(
        "whisper-base").enc_seq_len)
    assert dec["token"].shape == (128, 1) and dec["index"].shape == ()
    assert dec["caches"][0]["k"].shape[:2] == (128, 32_768)


def test_production_mesh():
    one = make_production_mesh()
    two = make_production_mesh(multi_pod=True)
    assert one.shape == {"data": 32, "model": 8} and one.size == 256
    assert two.shape == {"data": 64, "model": 8} and two.size == 512
    assert production_tag(one) == "256gpu_32x8"
    assert production_tag(two) == "512gpu_2x32x8"
    with pytest.raises(ValueError):
        dryrun._walk_mesh(32, 8)            # 8-bit device indices
    assert HW.NET_BW == 50e9 and HW.NVLINK_BW == 450e9


# ---------------------------------------------------------------------------
# The roofline's readers
# ---------------------------------------------------------------------------

class _V5e:
    """The reference's ``HW`` under the port's names (its one link, ICI,
    stands for both of the port's)."""
    PEAK_BF16_FLOPS = 197e12
    PEAK_INT8_OPS = 394e12
    HBM_BW = 819e9
    NVLINK_BW = 50e9
    NET_BW = 50e9
    HBM_BYTES = 16 * 2 ** 30


_REF_RECORD = {
    "status": "ok", "arch": "x", "shape": "train_4k",
    "mesh": "1pod_16x16",
    "flops": 1.97e12, "bytes_accessed": 8.19e11,
    "flops_extrapolated": 1.97e13, "bytes_extrapolated": 8.19e11,
    "collective_bytes_extrapolated": {"all-reduce": 5.0e10,
                                      "all-gather": 1.5e10, "n_ops": 7},
    "params": 1e9, "params_active": 7e8,
}


@pytest.mark.parametrize("shape,mesh", [("train_4k", "1pod_16x16"),
                                        ("decode_32k", "2pod_2x16x16"),
                                        ("prefill_32k", "1pod_16x16")])
def test_analyze_cell_is_the_references_on_v5e(monkeypatch, shape, mesh):
    monkeypatch.setattr(analysis, "HW", _V5e)
    rec = dict(_REF_RECORD, shape=shape, mesh=mesh)
    got, want = analysis.analyze_cell(rec), janalysis.analyze_cell(rec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert analysis.format_table([got]) == janalysis.format_table([want])


def test_analyze_cell_splits_links_on_the_h100():
    rec = {"status": "ok", "arch": "x", "shape": "train_4k",
           "mesh": "256gpu_32x8", "chips": 256,
           "flops": 0.0, "bytes_accessed": 0.0,
           "flops_extrapolated": 989e12 + 1.979e15,
           "int_flops_extrapolated": 1.979e15,      # 1 s at the int8 peak
           "bytes_extrapolated": 3.35e12,           # 1 s at HBM
           "collective_bytes_extrapolated": {
               "all_reduce_sum": {"model": 450e9, "data": 50e9},
               "data_gather": {"model": 0.0, "data": 100e9}, "n_ops": 3},
           "params": 1e9, "params_active": 1e9}
    t = analysis.analyze_cell(rec)
    assert t.compute_s == pytest.approx(2.0)         # int8 1 s + bf16 1 s
    assert t.memory_s == pytest.approx(1.0)
    assert t.collective_s == pytest.approx(1.0 + 3.0)  # NVLink + network
    assert t.dominant == "collective"
    assert t.model_flops_per_device == pytest.approx(6e9 * 4096)
    assert analysis.analyze_cell({"status": "fail"}) is None


# ---------------------------------------------------------------------------
# Walks
# ---------------------------------------------------------------------------

_CASE = shapes.ShapeCase("t", "train", 16, 4)
_SAME = ("flops", "int_flops", "bytes_accessed", "io_bytes",
         "collective_bytes", "n_ops", "argument_size_in_bytes",
         "output_size_in_bytes")


@pytest.mark.parametrize("arch,fake_devices", [
    ("qwen3-4b", "meta"), ("yi-6b", "cpu")])
def test_fake_walk_counts_what_a_real_walk_counts(arch, fake_devices):
    """The step over a (2, 2) mesh: fake entries against real CPU tensors
    (yi-6b's untied head runs ``bf16_matmul``, which widens on the CPU,
    so its fake entries are ``cpu:N``)."""
    from repro_torch.models import model_init
    cfg = reduced(get_config(arch)).replace(n_layers=2)
    fake = dryrun.walk_cell(cfg, _CASE, make_local_mesh(dp=2, tp=2, devices=[
        torch.device(fake_devices, i) for i in range(4)]),
        quant_moments=False)
    real = dryrun.walk_cell(cfg, _CASE, make_local_mesh(
        dp=2, tp=2, devices=["cpu"] * 4), quant_moments=False,
        params=model_init(cfg, device="cpu"), fake=False)
    for k in _SAME:
        assert fake[k] == real[k], k
    assert fake["flops"] > 0 and fake["io_bytes"] > 0
    assert fake["collective_bytes"]["data_gather"]["data"] > 0
    assert fake["temp_size_in_bytes"] > 0


@pytest.mark.parametrize("arch,n_layers,kind", [
    ("qwen3-4b", 4, "train"),
    ("llama4-maverick-400b-a17b", 6, "prefill"),
    ("llama4-maverick-400b-a17b", 6, "decode")])
def test_depth_extrapolation_equals_the_full_walk(arch, n_layers, kind):
    """Several blocks on a (2, 2) mesh of distinct labels: the 1- and
    2-block walks extrapolated equal the full-depth walk (the training
    step; llama4's 3 dense + MoE blocks in its prefill and decode
    cells)."""
    cfg = reduced(get_config(arch)).replace(n_layers=n_layers)
    case = dataclasses.replace(_CASE, kind=kind)
    mesh = _meta(2, 2)
    ext = dryrun.scan_extrapolated_cost(cfg, case, mesh, False)
    full = dryrun._per_entry(dryrun.walk_cell(cfg, case, mesh,
                                              quant_moments=False), 4)
    assert ext["scan_trips"] == cfg.n_blocks > 2
    assert ext["data_rows_walked"] == [2]
    for k in ("flops", "bytes_accessed", "io_bytes",
              "argument_size_in_bytes"):
        assert ext[k] == pytest.approx(full[k], rel=1e-9), k
    # the training step's peak of live bytes is affine in depth; a decode
    # step's moves with the order its tensors are freed in (4 bytes of
    # 98022 here)
    assert ext["temp_size_in_bytes"] == pytest.approx(
        full["temp_size_in_bytes"], rel=1e-9 if kind == "train" else 1e-3)
    for name, axes in full["collective_bytes"].items():
        assert ext["collective_bytes"][name] == pytest.approx(axes,
                                                              rel=1e-9)


@pytest.mark.parametrize("arch,kind", [
    ("yi-6b", "train"), ("llama4-maverick-400b-a17b", "prefill"),
    ("llama4-maverick-400b-a17b", "decode")])
def test_data_row_extrapolation_equals_the_full_walk(arch, kind):
    """8 data rows: the walks at 2 and 4 rows (the batch per row kept)
    extrapolated in 1 / dp equal the walk of all 8 (the peak of live
    bytes within 10%): the training step, and an MoE config's prefill
    and decode cells, each row routing its own tokens."""
    cfg = reduced(get_config(arch)).replace(n_layers=2)
    case = shapes.ShapeCase("t", kind, 16, 16)
    mesh = _meta(8, 2)
    ext = dryrun.scan_extrapolated_cost(cfg, case, mesh, False)
    full = dryrun._per_entry(dryrun.walk_cell(cfg, case, mesh,
                                              quant_moments=False), 16)
    assert ext["data_rows_walked"] == [2, 4]
    for k in ("flops", "bytes_accessed", "io_bytes", "n_ops",
              "argument_size_in_bytes", "output_size_in_bytes"):
        assert ext[k] == pytest.approx(full[k], rel=1e-9), k
    # the peak of live bytes moves with the order the entries run in:
    # near, not exact (5.5% in training here, 0.2% in decode)
    assert ext["temp_size_in_bytes"] == pytest.approx(
        full["temp_size_in_bytes"], rel=0.1)
    for kind, axes in full["collective_bytes"].items():
        assert ext["collective_bytes"][kind] == pytest.approx(axes,
                                                              rel=1e-9)


def test_cli_writes_records_the_readers_read(tmp_path, monkeypatch, capsys):
    """``main`` over a reduced grid (the production mesh cut to (4, 2)):
    one record per cell with every key the readers and the tables use."""
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: _meta(8 if multi_pod else 4,
                                                      2))
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: reduced(get_config(arch)).replace(
                            n_layers=2))
    monkeypatch.setattr(dryrun, "SHAPES", {
        "train_4k": shapes.ShapeCase("train_4k", "train", 16, 8),
        "decode_32k": shapes.ShapeCase("decode_32k", "decode", 32, 8),
        "long_500k": shapes.SHAPES["long_500k"]})
    out = tmp_path / "r.json"
    assert dryrun.main(["--arch", "yi-6b", "--shape", "train_4k",
                        "decode_32k", "long_500k", "--singlepod",
                        "--out", str(out)]) == 0
    records = json.loads(out.read_text())
    assert [r["status"] for r in records] == ["ok", "ok", "skip"]
    train = records[0]
    assert train["mesh"] == "8gpu_4x2" and train["chips"] == 8
    for k in ("flops", "bytes_accessed", "collective_bytes",
              "argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "fits", "scan_trips", "io_bytes"):
        assert k in train, k
    assert set(train["collective_bytes"]["data_gather"]) == {"model",
                                                            "data"}
    # every entry takes an equal share of the serving cell too: no
    # ``unbalanced`` key, and the per-card figures are the mesh's
    serve = records[1]
    assert "unbalanced" not in train and "unbalanced" not in serve
    assert serve["shape"] == "decode_32k" and serve["chips"] == 8
    assert serve["flops"] > 0 and serve["collective_bytes"][
        "data_gather"]["data"] > 0
    terms = analysis.analyze_file(str(out))
    assert len(terms) == 2
    table = analysis.format_table(terms)
    assert "yi-6b" in table and "train_4k" in table
    # --append keeps the cells already done
    assert dryrun.main(["--arch", "yi-6b", "--shape", "train_4k",
                        "--singlepod", "--out", str(out), "--append"]) == 0
    assert len(json.loads(out.read_text())) == 3


# ---------------------------------------------------------------------------
# Flash attention: the cost model and the backward's hook
# ---------------------------------------------------------------------------

class _ByFn(StageWalk):
    """A walk that also sums each costed entry point's MACs by name."""

    def __init__(self):
        super().__init__()
        self.by_fn: dict = {}

    def _hook(self, fn, cost, args, kwargs):
        if not self._depth:
            int_m, float_m, _, _ = cost(*args, **kwargs)
            n, m = self.by_fn.get(fn.__name__, (0, 0))
            self.by_fn[fn.__name__] = (n + 1, m + int_m + float_m)
        return super()._hook(fn, cost, args, kwargs)


def _flash_walk(kind):
    from repro_torch.models import model_init
    from repro_torch.distributed.sharding import train_shards
    from repro_torch.models import prefill
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainConfig, make_train_step
    cfg = reduced(get_config("qwen3-4b")).replace(n_layers=2,
                                                  attn_impl="flash")
    case = shapes.ShapeCase("t", kind, 64, 4)
    mesh = make_local_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    sh = train_shards(model_init(cfg, device="cpu"), cfg, mesh)
    toks = torch.zeros((case.batch, case.seq), dtype=torch.long)
    walk = _ByFn()
    with walk:
        if kind == "train":
            tcfg = TrainConfig()
            make_train_step(cfg, tcfg)(sh, adamw_init(sh, tcfg.optimizer),
                                       {"tokens": toks, "labels": toks})
        else:
            from repro_torch.distributed.collectives import distinct_entries
            with distinct_entries(), torch.no_grad():
                prefill(sh, cfg, toks)
    return cfg, case, walk


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_flash_cost_model_is_half_the_walks_full_square(kind):
    cfg, case, walk = _flash_walk(kind)
    assert cfg.head_dim == cfg.head_dim            # d == dv: GQA
    hooked = sum(walk.by_fn.get(n, (0, 0))[1]
                 for n in ("flash_mha", "flash_mha_bwd"))
    model_flops, _ = flash_attn_cost(cfg, case, dp=2, tp=2)
    assert 2 * hooked / 4 == pytest.approx(2 * model_flops, rel=1e-12)


def test_flash_backward_is_counted_once_by_its_hook(monkeypatch):
    """The training step's walk counts row 4 by ``flash_mha_bwd``'s cost,
    one call per layer and entry, and nothing inside it: with the cost
    function zeroed the walk loses exactly those MACs."""
    cfg, case, walk = _flash_walk("train")
    n, macs = walk.by_fn["flash_mha_bwd"]
    assert n == cfg.n_layers * 4
    bh = case.batch // 2 * cfg.n_heads // 2
    assert macs == n * bh * case.seq * case.seq * 5 * cfg.head_dim
    monkeypatch.setattr(ops, "_flash_bwd_cost",
                        lambda *a, **k: (0, 0, 0, 0))
    fn = ops.flash_mha_bwd.__wrapped__
    monkeypatch.setattr(ops, "flash_mha_bwd",
                        ops.costed(ops._flash_bwd_cost)(fn))
    _, _, zero = _flash_walk("train")
    assert walk.cost.float_dot_macs - zero.cost.float_dot_macs == macs
