"""Nothing the benchmark runs imports JAX or the JAX package, and its
reference imports nothing of the program.  Module names are compared by
their top-level name (the part before the first dot), whole: the
program, ``repro_torch``, begins with the JAX package's name, ``repro``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

from portbench.harness import ROOT

PKG = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set[str]:
    """Dotted names a file imports (relative imports resolved)."""
    tree = ast.parse(path.read_text())
    rel = path.relative_to(ROOT).with_suffix("").parts
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = ".".join(rel[:len(rel) - node.level])
                mod = f"{base}.{node.module}" if node.module else base
            else:
                mod = node.module
            out.add(mod)
            out.update(f"{mod}.{a.name}" for a in node.names)
    return out


def _file_of(name: str) -> Path | None:
    parts = name.split(".")
    for p in (ROOT.joinpath(*parts).with_suffix(".py"),
              ROOT.joinpath(*parts, "__init__.py")):
        if p.exists():
            return p
    return None


def _closure(files) -> set[str]:
    """Every dotted name imported by ``files`` and, transitively, by the
    benchmark's own modules they import."""
    seen, todo, names = set(), list(files), set()
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        for name in _imports(f):
            names.add(name)
            if name.split(".")[0] == "portbench":
                g = _file_of(name)
                if g is not None:
                    todo.append(g)
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    found = {n for f in files for n in _imports(f)
             if n.split(".")[0] in FORBIDDEN}
    assert not found


def test_top_level_names_are_compared_whole():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.serve".split(".")[0] in FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    names = _closure(sorted((PKG / "reference").glob("*.py")))
    tops = {n.split(".")[0] for n in names}
    assert "repro_torch" not in tops and not tops & FORBIDDEN
    assert tops <= {"portbench", "torch", "__future__", "dataclasses",
                    "math", "numpy"}


def test_loaded_modules_after_import():
    """Import every module the runs use, in a fresh interpreter, and read
    ``sys.modules``."""
    code = (
        "import sys, importlib\n"
        "import portbench.run as run, portbench.harness, portbench.program\n"
        "import portbench.reference.dense, portbench.reference.ssd\n"
        "from portbench.harness import _reader\n"
        "for f in sorted((run.ROOT / 'portbench' / 'metrics').glob('*.py')):\n"
        "    if f.stem != '__init__': _reader(f.stem)\n"
        "print('loaded', *sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print('forbidden', *run.forbidden_modules())\n")
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT), str(ROOT / "src")])}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = {ln.split()[0]: ln.split()[1:] for ln in out.stdout.splitlines()}
    tops = set(lines["loaded"])
    assert "repro_torch" in tops and "torch" in tops
    assert not tops & FORBIDDEN
    assert lines["forbidden"] == []
