"""The port stands alone: nothing under ``src/repro_torch/`` and nothing in
``chip_smoke.py`` imports JAX or the reference package, and entry points
ask for CUDA unless the caller passes ``device="cpu"``."""

import ast
from pathlib import Path

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import init_caches, model_init
from repro_torch.serve import Engine, ServeConfig

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "flax")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"engine.py", "nibble_matmul.py", "chip_smoke.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN or m.startswith("repro.")]
    assert not bad, f"{path} imports {bad}"


def test_entry_points_default_to_cuda():
    cfg = reduced(get_config("yi-6b"))
    params = model_init(cfg, device="cpu")
    scfg = ServeConfig(batch=2, max_len=16)
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert Engine(cfg, params, scfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params, scfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        model_init(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_caches(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        SyntheticLM(DataConfig(vocab_size=16, seq_len=4, global_batch=2))
    assert Engine(cfg, params, scfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("field,value", [
    ("tp", 2), ("mesh_shape", (1, 2))])
def test_unported_serve_knobs_raise(field, value):
    """A (1, 2) mesh, by ``tp`` or ``mesh_shape``, builds over two CPU
    entries and serves two equal greedy streams without a leak, and so
    does a data axis above 1 (a (2, 1) mesh, and a (2, 2) mesh beside
    ``tp=2``) over four; what still raises is a mesh larger than the
    devices it is given."""
    cfg = reduced(get_config("yi-6b")).replace(cache_mode="paged",
                                               page_size=4)
    params = model_init(cfg, device="cpu")
    scfg = ServeConfig(batch=2, max_len=16, prefill_len=8, **{field: value})
    engine = Engine(cfg, params, scfg, device="cpu", devices=["cpu", "cpu"])
    assert engine.mesh_shape == (1, 2) and engine.device_count == 2
    ids = [engine.submit([1, 2, 3, 4, 5, 6], 8) for _ in range(2)]
    done = engine.run()
    assert done[ids[0]].tokens == done[ids[1]].tokens
    assert len(done[ids[0]].tokens) == 8 and engine.leaked_pages() == 0
    shape = {"tp": (2, 2), "mesh_shape": (2, 1)}[field]
    dp_engine = Engine(cfg, params,
                       ServeConfig(batch=2, max_len=16, prefill_len=8,
                                   **{field: value, "mesh_shape": shape}),
                       device="cpu", devices=["cpu"] * 4)
    assert dp_engine.mesh_shape == shape
    ids = [dp_engine.submit([1, 2, 3, 4, 5, 6], 8) for _ in range(2)]
    got = dp_engine.run()
    assert [got[i].tokens for i in ids] == [done[i].tokens for i in ids]
    assert dp_engine.leaked_pages() == 0
    with pytest.raises(ValueError, match="devices but only"):
        Engine(cfg, params, ServeConfig(batch=2, max_len=16,
                                        **{field: value,
                                           "mesh_shape": shape}),
               device="cpu", devices=["cpu"] * (shape[0] * shape[1] - 1))


@pytest.mark.parametrize("field,value", [
    ("prefix_cache", True), ("swap_mode", "host"), ("spec_decode", True),
    ("prefill_chunk", 4), ("admit_group", 2), ("temperature", 0.7)])
def test_ported_serve_knobs_build_and_serve(field, value):
    """The knobs this package has ported build an engine that serves on
    the CPU (an overcommitted pool, two prompts sharing a page).  Greedy,
    the two streams are equal; sampled, the two requests draw under
    their own keys, and a second engine draws the same streams."""
    cfg = reduced(get_config("yi-6b")).replace(cache_mode="paged",
                                               page_size=4)
    params = model_init(cfg, device="cpu")
    scfg = ServeConfig(batch=2, max_len=16, prefill_len=8,
                       alloc_mode="incremental", num_pages=5,
                       **{field: value})

    def serve():
        engine = Engine(cfg, params, scfg, device="cpu")
        ids = [engine.submit([1, 2, 3, 4, 5, 6], 8) for _ in range(2)]
        done = engine.run()
        return engine, [done[i].tokens for i in ids]

    engine, streams = serve()
    assert [len(t) for t in streams] == [8, 8]
    if field == "temperature":
        assert serve()[1] == streams
    else:
        assert streams[0] == streams[1]
    engine.release_prefix_cache()
    assert engine.leaked_pages() == 0
