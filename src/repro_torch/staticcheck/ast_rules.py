"""Layer 1: AST lint rules over the ``src/repro_torch`` tree (port of
``repro.staticcheck.ast_rules``).

The port has no jit sites.  Its stage bodies are the functions handed to
``_StageCounter`` / ``_CapturedStage`` (``serve/engine.py``): a captured
stage replays its body from a CUDA graph, which records one run of the
body's device work and none of its Python.  Rule catalog:

* **SC101** — ``.item()`` / ``.tolist()`` on a traced value in a stage
  body (a host sync, and an error inside a capture).
* **SC102** — ``float()`` / ``int()`` / ``bool()`` on a traced value in a
  stage body (the same sync).
* **SC103** — ``np.*`` call on a traced value in a stage body (a
  device-to-host copy; numpy on shapes and constants is fine).
* **SC104** — Python ``if`` / ``while`` (or a conditional expression) on
  a traced value in a stage body: a capture records one branch.
* **SC105** — ``torch.cuda.synchronize``, ``Event.synchronize``,
  ``Stream.synchronize`` or ``.item()`` anywhere in ``serve/``: the
  engine's host boundary is one ``.cpu().numpy()`` on a stage's output
  per dispatch; an ad-hoc sync hides dispatch stalls.
* **SC201** — a stage body that rebinds the engine's caches
  (``self._caches``, a layer of it, or a pool leaf assigned a new
  tensor) instead of writing them in place: a graph holds raw pointers,
  so a rebound pool is one the replay never writes.  (The reference's
  rule, "a cache jit site must donate", has no counterpart in eager
  PyTorch.)
* **SC202** — ``serve/paging.py`` imports ``torch``: the page table is
  host-side numpy by contract.

Traced-ness is a per-function taint pass: every parameter of a stage
body but ``self`` is traced (a signature records a non-tensor argument's
type only, so a branch on its value is as unsafe as one on a tensor's),
and so are the parameters of its nested ``def``s; assignments and ``for``
targets propagate taint, and reads of ``.shape`` / ``.ndim`` /
``.dtype`` / ``.device`` and calls of ``.numel()`` / ``.size()`` /
``.dim()`` *stop* it (they are host values whatever the tensor holds).
"""

from __future__ import annotations

import ast
from pathlib import Path

from repro_torch.staticcheck.findings import Finding

# attribute reads and method calls that yield host values of a tensor
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device"}
_STATIC_CALLS = {"numel", "size", "dim"}
# callables whose result on a traced tensor is a host-side cast
_CAST_BUILTINS = {"float", "int", "bool"}
_NUMPY_ALIASES = {"np", "numpy", "onp"}
# the engine's stage constructors: their first argument is the body
_STAGE_CTORS = {"_StageCounter", "_CapturedStage"}
_CACHES = "_caches"


def _dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for the attribute chain; '' if not a plain
    dotted name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _tainted_names(node: ast.AST) -> set:
    """Names read by ``node``, excluding any inside a static read
    (``x.shape[...]``, ``x.numel()``: host values)."""
    out: set = set()

    class V(ast.NodeVisitor):
        def visit_Attribute(self, n):
            if n.attr in _STATIC_ATTRS:
                return
            self.generic_visit(n)

        def visit_Call(self, n):
            if (isinstance(n.func, ast.Attribute)
                    and n.func.attr in _STATIC_CALLS):
                return
            self.generic_visit(n)

        def visit_Compare(self, n):
            # `x is None` is a host bool whatever x holds, and `"key" in d`
            # is dict-key membership
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in n.ops) \
                    and all(isinstance(c, ast.Constant)
                            and c.value is None for c in n.comparators):
                return
            if all(isinstance(op, (ast.In, ast.NotIn)) for op in n.ops) \
                    and isinstance(n.left, ast.Constant):
                return
            self.generic_visit(n)

        def visit_Name(self, n):
            out.add(n.id)

    V().visit(node)
    return out


def _nested_defs(fn: ast.FunctionDef) -> list:
    return [n for n in ast.walk(fn) if n is not fn
            and isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda))]


def _param_names(fn) -> list:
    a = fn.args
    return ([p.arg for p in a.posonlyargs] + [p.arg for p in a.args]
            + [p.arg for p in a.kwonlyargs])


def _is_self_attr(node: ast.AST, attr: str | None = None) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name) and node.value.id == "self"
            and (attr is None or node.attr == attr))


def _self_methods(expr: ast.AST, methods: dict) -> list:
    """Methods of the class named as ``self.<name>`` inside ``expr``."""
    return [n.attr for n in ast.walk(expr)
            if _is_self_attr(n) and n.attr in methods]


def _resolve_body(arg: ast.AST, scope: ast.AST, methods: dict) -> list:
    """The methods a stage constructor's first argument can name: a
    ``self.<method>`` (under a conditional expression too), or a local
    name bound by a ``for`` loop or an assignment in ``scope`` (the
    methods named in what binds it)."""
    if not isinstance(arg, ast.Name):
        return _self_methods(arg, methods)
    found = []
    for node in ast.walk(scope):
        if isinstance(node, ast.For):
            bound = {n.id for n in ast.walk(node.target)
                     if isinstance(n, ast.Name)}
            if arg.id in bound:
                found += _self_methods(node.iter, methods)
        elif isinstance(node, ast.Assign):
            bound = {n.id for t in node.targets for n in ast.walk(t)
                     if isinstance(n, ast.Name)}
            if arg.id in bound:
                found += _self_methods(node.value, methods)
    return found


def find_stage_bodies(tree: ast.Module) -> list:
    """``(qualname, FunctionDef)`` of every stage body: each method of a
    class that the class hands to ``_StageCounter`` / ``_CapturedStage``
    (found from the constructor calls, not from a list of names)."""
    bodies = {}
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        methods = {n.name: n for n in cls.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        for scope in methods.values():
            for node in ast.walk(scope):
                if (isinstance(node, ast.Call) and node.args
                        and _dotted(node.func).split(".")[-1]
                        in _STAGE_CTORS):
                    for name in _resolve_body(node.args[0], scope, methods):
                        bodies.setdefault(f"{cls.name}.{name}",
                                          methods[name])
    return sorted(bodies.items())


def _traced(fn) -> set:
    """The taint of one stage body: its parameters and its nested defs',
    then forward through assignments and ``for`` targets to a fixpoint."""
    traced = {p for p in _param_names(fn) if p != "self"}
    for nested in _nested_defs(fn):
        traced |= set(_param_names(nested))
    while True:
        before = len(traced)
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                value, targets = node.value, (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target])
            elif isinstance(node, (ast.For, ast.comprehension)):
                value, targets = node.iter, [node.target]
            else:
                continue
            if value is not None and _tainted_names(value) & traced:
                for t in targets:
                    traced |= {n.id for n in ast.walk(t)
                               if isinstance(n, ast.Name)}
        if len(traced) == before:
            return traced


def _lint_stage_body(fn, relpath: str, qual: str) -> list:
    """SC101-SC104 over one stage body (its nested defs included)."""
    findings = []
    traced = _traced(fn)

    def flag(rule, node, msg):
        findings.append(Finding(rule, relpath, qual, msg,
                                getattr(node, "lineno", 0)))

    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("item", "tolist")
                    and _tainted_names(node.func.value) & traced):
                flag("SC101", node, f".{node.func.attr}() on a traced value "
                     "is a host sync inside a stage body (and an error "
                     "inside a capture)")
            fname = _dotted(node.func)
            if (fname in _CAST_BUILTINS and node.args
                    and _tainted_names(node.args[0]) & traced):
                flag("SC102", node, f"{fname}() on a traced value is a "
                     "host sync inside a stage body")
            root = fname.split(".", 1)[0] if fname else ""
            if (root in _NUMPY_ALIASES and "." in fname
                    and any(_tainted_names(a) & traced for a in node.args)):
                flag("SC103", node, f"{fname}() on a traced value is a "
                     "device-to-host copy inside a stage body")
        if isinstance(node, (ast.If, ast.While, ast.IfExp)):
            if _tainted_names(node.test) & traced:
                kind = type(node).__name__.lower()
                flag("SC104", node, f"python {kind} on a traced value "
                     "inside a stage body: a capture records one branch")
    return findings


def _cache_chain(node: ast.AST, aliases: set):
    """``(rooted, slices)`` of an assignment target: whether its subscript
    chain ends at ``self._caches`` or a local alias of it, and the
    subscripts from the outermost in."""
    slices = []
    while isinstance(node, ast.Subscript):
        slices.append(node.slice)
        node = node.value
    rooted = _is_self_attr(node, _CACHES) or (
        isinstance(node, ast.Name) and node.id in aliases)
    return rooted, slices


def _targets(node: ast.AST):
    """The assigned expressions of a target, tuples unpacked."""
    if isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            yield from _targets(e)
    elif isinstance(node, ast.Starred):
        yield from _targets(node.value)
    else:
        yield node


def _lint_cache_rebinding(fn, relpath: str, qual: str) -> list:
    """SC201 over one stage body: an assignment to ``self._caches``, to a
    layer of it (``self._caches[i] = ...``) or to a leaf by name
    (``...["k"] = ...``), directly or through a local alias of the caches.
    Index writes into a leaf (``pool[rows] = new``) are in place and
    pass."""
    aliases = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and _cache_chain(node.value,
                                                         aliases)[0]:
            aliases |= {t.id for t in node.targets
                        if isinstance(t, ast.Name)}
    findings = []
    for node in ast.walk(fn):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for target in (x for t in targets for x in _targets(t)):
            rooted, slices = _cache_chain(target, aliases)
            if not rooted:
                continue
            whole = _is_self_attr(target, _CACHES)
            named = bool(slices) and isinstance(slices[0], ast.Constant) \
                and isinstance(slices[0].value, str)
            if whole or len(slices) == 1 or named:
                findings.append(Finding(
                    "SC201", relpath, qual,
                    "a stage body rebinds the engine's caches: a captured "
                    "graph holds the old pools' pointers; write the pools "
                    "in place", node.lineno))
    return findings


def _lint_serve_host_sync(tree: ast.Module, relpath: str) -> list:
    """SC105 over a serve/ module (whole file, not just stage bodies)."""
    findings = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        if node.func.attr == "synchronize":
            what = _dotted(node.func) or ".synchronize()"
            findings.append(Finding(
                "SC105", relpath, "module",
                f"{what} in an engine step path serializes dispatch; the "
                "host boundary is one .cpu().numpy() on a stage's output",
                node.lineno))
        elif node.func.attr == "item":
            findings.append(Finding(
                "SC105", relpath, "module",
                ".item() in an engine step path is a host sync per call; "
                "the host boundary is one .cpu().numpy() on a stage's "
                "output", node.lineno))
    return findings


def _lint_paging_numpy_only(tree: ast.Module, relpath: str) -> list:
    """SC202: serve/paging.py must not import torch."""
    findings = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            if name.split(".")[0] == "torch":
                findings.append(Finding(
                    "SC202", relpath, "module",
                    f"import of {name!r}: page-table logic is host-side "
                    "numpy by contract", node.lineno))
    return findings


def run_ast_rules(root: str | Path, repo_root: str | Path | None = None
                  ) -> list:
    """Run every AST rule over the ``.py`` files under ``root``.

    ``repo_root`` anchors the repo-relative paths used in finding keys
    (default: the nearest parent of ``root`` that holds ``src``)."""
    root = Path(root).resolve()
    if repo_root is None:
        repo_root = next((p for p in root.parents if (p / "src").is_dir()),
                         root)
    repo_root = Path(repo_root).resolve()

    findings: list = []
    for path in sorted(root.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        try:
            rel = path.relative_to(repo_root).as_posix()
        except ValueError:
            rel = path.as_posix()
        try:
            tree = ast.parse(path.read_text())
        except SyntaxError as e:
            findings.append(Finding("SC000", rel, "module",
                                    f"syntax error: {e}", e.lineno or 0))
            continue
        for qual, body in find_stage_bodies(tree):
            findings += _lint_stage_body(body, rel, qual)
            findings += _lint_cache_rebinding(body, rel, qual)
        if "serve" in Path(rel).parts:
            findings += _lint_serve_host_sync(tree, rel)
            if path.name == "paging.py":
                findings += _lint_paging_numpy_only(tree, rel)
    return findings
