"""Multi-node dry run: walk every (arch x shape x mesh) cell's sharded step
once on fake tensors (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for 512 placeholder host
devices and reads XLA's cost and memory analyses.  The port has no
compiler to ask, so a cell runs its step once, the way the port runs it:
one process drives every entry of a production mesh
(``launch.mesh.make_production_mesh``: 256 entries as (data 32, model
8), or 512 over two pods; walked as its smaller twins, see **Depth and
data rows**), each entry a placeholder device ``meta:N`` under
``FakeTensorMode``, so nothing is allocated on any device, and every
entry counts as a card of its own (``collectives.distinct_entries``).
Fake ``cuda:N`` entries do not serve: a CPU-only torch refuses them at
the embedding's index op, and on a machine with one card FakeTensorMode
asks the card for ``cuda:1`` and gets "invalid device ordinal".
Around the step run

* ``staticcheck.flops.StageWalk``: every op's flops and bytes, and the
  kernels' cost hooks (the cells use the reference's defaults, ``dense``
  and ``chunked``, so they reach no kernel);
* the collective counters (``distributed.collectives``): the bytes every
  entry sends another, by kind and by axis (``model`` inside a node over
  NVLink, ``data`` over the network), forward and backward; they take
  the place of the reference's ``collective_bytes_from_hlo``, under the
  same record keys, ``n_ops`` counting the collective calls;
* :class:`LiveBytes`: the bytes each entry holds in tensors the step
  makes, at their peak.

**Per-card figures.**  One process runs the whole mesh, so a record's
per-device flops, bytes and collective bytes are the mesh's totals over
the entry count.  The training step gives every entry an equal share, as
the reference's SPMD program does.  Where a cell cannot be balanced, the
record names it under ``unbalanced``: the serving paths a prefill and a
decode run (``models.prefill`` / ``decode_step``) put the head, and an
MoE block, over the whole batch on data row 0.

**Memory.**  ``argument_size_in_bytes`` is the stored bytes of the busiest
entry (its parameter pieces, optimizer state and batch or caches),
``output_size_in_bytes`` what the step returns on it, and
``temp_size_in_bytes`` its peak of live bytes in tensors the step makes.
``chips`` and ``fits`` (argument + temp within ``HW.HBM_BYTES``) are the
port's additions.

**Depth and data rows.**  The port has no scan, so a walk at full depth
is exact; but one process over 256 entries is slow (every op on a fake
tensor costs ~0.3 ms on the host, so yi-6b's 1-layer training step over
all 256 entries took 23 minutes on one CPU core), so
``scan_extrapolated_cost`` walks the 1-block and 2-block variants
(``_with_blocks``) at 2 and 4 data rows (the batch per row and the model
axis kept) and extrapolates every figure, the memory ones included,
linearly in depth (``cost(n) = cost(1) + (n - 1) * (cost(2) -
cost(1))``, the reference's recipe) and in ``1 / dp`` (``scan_trips``
and ``data_rows_walked`` say so).  For the training step the flops,
bytes, collective bytes and stored bytes extrapolate exactly (tests
hold them to direct walks); the peak of live bytes moves with the order
the entries run in, so it is near (within 10% on reduced configs).  The
serving cells' row-0 work (``unbalanced``) is not affine in ``1 / dp``,
so their figures are near too (within 5% on reduced configs).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--arch yi-6b ...] [--shape train_4k ...] \\
        [--multipod | --singlepod] [--out results.json] [--append]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import train_shards
from repro_torch.launch.mesh import HW, make_local_mesh, \
    make_production_mesh, production_tag
from repro_torch.launch.shapes import (
    SHAPES,
    decode_input_structs,
    prefill_input_structs,
    skip_reason,
    train_input_structs,
)
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.staticcheck.flops import StageWalk, _storage
from repro_torch.train import TrainConfig, make_train_step

__all__ = ["build_cell", "walk_cell", "scan_extrapolated_cost", "run_cell",
           "LiveBytes", "main"]

_MEMORY_KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes")


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class LiveBytes(TorchDispatchMode):
    """The bytes each device holds in storages made while the mode runs,
    and their peak per device (``peak``); a storage counts from the op
    that makes it until its tensor is freed."""

    def __init__(self):
        super().__init__()
        self.live: dict = {}
        self.peak: dict = {}
        self._keys: set = set()

    def _free(self, key, dev, n):
        self._keys.discard(key)
        self.live[dev] -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            got = _storage(t)
            if got is None or got[0] in self._keys or t._base is not None:
                continue
            key, n = got
            dev = key[0]
            self._keys.add(key)
            self.live[dev] = self.live.get(dev, 0) + n
            self.peak[dev] = max(self.peak.get(dev, 0), self.live[dev])
            weakref.finalize(t, self._free, key, dev, n)
        return out


def _with_blocks(cfg, k: int):
    """Config with exactly k repeated blocks (layer-scan trip count k)."""
    n_fixed = len(cfg.prefix_pattern) + len(cfg.suffix_pattern)
    kw = {"n_layers": n_fixed + k * len(cfg.block_pattern)}
    if cfg.is_encdec:
        kw["n_enc_layers"] = k     # the encoder's stack scales in lockstep
    return cfg.replace(**kw)


def _fake_params(cfg, device):
    """The model's weights as fake tensors on ``device`` (the reference's
    init shapes and dtypes; drawn from a CPU generator, which under
    ``FakeTensorMode`` draws nothing)."""
    from repro_torch.models import model_init
    params = model_init(cfg, device="cpu")

    def move(node):
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        if isinstance(node, list):
            return [move(v) for v in node]
        return node.to(device)

    return move(params)


def build_cell(cfg, case, mesh, *, quant_moments: bool, params=None):
    """``(fn, stored, batch_bytes, returned)`` for one cell over ``mesh``:
    ``fn()`` runs its step once; ``stored[e]`` entry ``e``'s stored
    tensors (parameter pieces, optimizer state or caches);
    ``batch_bytes`` the bytes of an entry's batch slots; ``returned(out)``
    the tensors each entry holds of the step's outputs.  ``params``: the
    unsharded weights (default: fake ones, under the caller's
    ``FakeTensorMode``)."""
    dev0 = mesh.entries[0]
    params = _fake_params(cfg, dev0) if params is None else params
    shards = train_shards(params, cfg, mesh)
    stored = [_tensors(t) for t in shards.trees]
    n = len(stored)

    def batch_bytes(batch) -> int:
        # each entry holds its data row's slots of every batch leaf
        return sum(_nbytes(t) for t in _tensors(batch)) // mesh.shape["data"]

    if case.kind == "train":
        tcfg = TrainConfig(optimizer=AdamWConfig(
            quantize_moments=quant_moments))
        opt = adamw_init(shards, tcfg.optimizer)
        batch = train_input_structs(cfg, case, dev0)
        step = make_train_step(cfg, tcfg)
        for e in range(n):
            stored[e] += _tensors([opt["mu"][e], opt["nu"][e],
                                        opt["step"][e]])

        def returned(out):
            p, o, metrics = out
            return [_tensors([p.trees[e], o["mu"][e], o["nu"][e],
                                   o["step"][e]])
                    + (_tensors(metrics) if e == 0 else []) for e in range(n)]

        return (lambda: step(shards, opt, batch)), stored, \
            batch_bytes(batch), returned

    from repro_torch.models import decode_step, prefill

    def caches_returned(out):
        head, caches = out
        return [_tensors(caches.trees[e]) + ([head] if e == 0 else [])
                for e in range(n)]

    if case.kind == "prefill":
        batch = prefill_input_structs(cfg, case, dev0)

        def fn():
            kw = {}
            if "patch_embeds" in batch:
                kw["extra_embeds"] = batch["patch_embeds"]
            if "frames" in batch:
                kw["frames"] = batch["frames"]
            logits, caches, _ = prefill(shards, cfg, batch["tokens"], **kw)
            return logits, caches

        return fn, stored, batch_bytes(batch), caches_returned

    ins = decode_input_structs(cfg, case, dev0, params=shards)
    for e, tree in enumerate(ins["caches"].trees):
        stored[e] += _tensors(tree)

    def fn():
        # one position per slot: a 0-d index would be read on the host
        index = ins["index"].expand(case.batch)
        logits, caches = decode_step(shards, cfg, ins["token"],
                                     ins["caches"], index,
                                     enc_out=ins.get("enc_out"))
        nxt = torch.argmax(logits[:, -1].to(torch.float32), dim=-1)
        return nxt[:, None].to(torch.int32), caches

    extra = [ins["token"]] + ([ins["enc_out"]] if "enc_out" in ins else [])
    return fn, stored, batch_bytes(extra), caches_returned


def _distinct_bytes(tensors) -> int:
    got = {}
    for t in tensors:
        key = _storage(t)
        if key is not None:
            got[key[0]] = key[1]
    return sum(got.values())


def walk_cell(cfg, case, mesh, *, quant_moments: bool, params=None,
              fake: bool = True) -> dict:
    """Build one cell and walk its step once.  Returns the mesh totals
    (``flops``, ``int_flops``, ``bytes_accessed``, ``io_bytes``,
    ``collective_bytes`` ``{kind: {axis: bytes}}``, ``n_ops``) and the
    busiest entry's ``argument_size_in_bytes`` / ``output_size_in_bytes``
    / ``temp_size_in_bytes``.  ``fake``: under ``FakeTensorMode`` (the dry
    run); else on the real tensors of ``params`` and ``mesh``'s devices
    (the check that a fake walk counts what a real one does: the peak
    of live bytes needs distinct devices, so it is per entry only there)."""
    import contextlib
    mode = FakeTensorMode(allow_non_fake_inputs=False) if fake \
        else contextlib.nullcontext()
    with mode:
        fn, stored, batch, returned = build_cell(
            cfg, case, mesh, quant_moments=quant_moments, params=params)
        collectives.reset_collective_counts()
        live = LiveBytes()
        walk = StageWalk()
        with collectives.distinct_entries(), live, walk:
            out = fn()
        walk.finish(out)
        coll = collectives.collective_bytes()
        n_ops = collectives.collective_calls()
        arg = max(_distinct_bytes(s) + batch for s in stored)
        out_bytes = max(_distinct_bytes(t) for t in returned(out))
        temp = max(live.peak.get(str(d), 0) for d in mesh.entries)
    c = walk.cost
    return {"flops": c.total_flops, "int_flops": 2 * c.int_dot_macs,
            "bytes_accessed": c.bytes_accessed, "io_bytes": c.io_bytes,
            "collective_bytes": coll, "n_ops": n_ops,
            "argument_size_in_bytes": arg,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": temp}


def _affine(a, b, xa: float, xb: float, x: float):
    """The affine function through ``(xa, a)`` and ``(xb, b)`` at ``x``,
    leaf by leaf over nested dicts (never below 0)."""
    if isinstance(a, dict):
        return {k: _affine(a[k], b[k], xa, xb, x) for k in a}
    return max(0.0, a + (b - a) * (x - xa) / (xb - xa))


def _walk_mesh(dp: int, tp: int):
    """A (dp, tp) mesh of distinct placeholder entries ``meta:N``."""
    if dp * tp > 128:
        raise ValueError(f"a walk takes at most 128 entries (a torch device "
                         f"index has 8 bits), not {dp * tp}")
    return make_local_mesh(dp=dp, tp=tp, devices=[
        torch.device("meta", i) for i in range(dp * tp)])


def _per_entry(totals: dict, n: int) -> dict:
    """A walk's mesh totals over its ``n`` entries; the memory figures are
    per entry already."""
    out = {k: totals[k] / n for k in ("flops", "int_flops",
                                       "bytes_accessed", "io_bytes",
                                       "n_ops")}
    out["collective_bytes"] = {k: {a: v / n for a, v in axes.items()}
                               for k, axes in
                               totals["collective_bytes"].items()}
    out.update({k: float(totals[k]) for k in _MEMORY_KEYS})
    return out


def scan_extrapolated_cost(cfg, case, mesh, quant_moments: bool) -> dict:
    """Per-entry figures of ``case`` on ``mesh`` from small walks.

    **Depth**: the 1-block and 2-block variants, extrapolated to
    ``cfg.n_blocks`` (the reference's recipe, there because XLA counts a
    scan's body once; here because a full-depth walk over a production
    mesh is slow); a model of at most one block is walked whole.

    **Data rows**: the entries of every data row do the same work, on
    their own slots, so at a fixed batch per row each per-entry figure is
    affine in ``1 / dp`` (the FSDP pieces, a gather's foreign pieces and
    each reduction's share over the rows scale so, the rest is
    constant).  A mesh of more than 4 data rows is walked at 2 and 4 rows
    (the batch per row and the model axis kept) and extrapolated in
    ``1 / dp``; the two extrapolations compose exactly for a figure
    bilinear in depth and ``1 / dp``."""
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    split = case.batch % dp == 0
    per_row = case.batch // dp if split else case.batch
    rows = (2, 4) if dp > 4 else (dp,)
    n = cfg.n_blocks
    depths = (1, 2) if n > 1 else (None,)

    def at(depth, r):
        c = cfg if depth is None else _with_blocks(cfg, depth)
        k = dataclasses.replace(case, batch=per_row * r if split
                                else case.batch)
        m = _walk_mesh(r, tp)
        return _per_entry(walk_cell(c, k, m, quant_moments=quant_moments),
                          m.size)

    by_depth = []
    for depth in depths:
        walks = [at(depth, r) for r in rows]
        by_depth.append(walks[0] if len(walks) == 1 else _affine(
            walks[0], walks[1], 1 / rows[0], 1 / rows[1], 1 / dp))
    out = by_depth[0] if len(by_depth) == 1 else _affine(
        by_depth[0], by_depth[1], 1, 2, n)
    return dict(out, scan_trips=n, data_rows_walked=list(rows))


def _unbalanced(cfg, case) -> list:
    if case.kind == "train":
        return []
    out = ["head: the final norm and head run over the whole batch on "
           "data row 0 (the serving path)"]
    if any(s.ffn == "moe" for s in cfg.layer_specs):
        out.append("moe: every MoE block runs over the whole batch on data "
                   "row 0 (the serving path)")
    return out


def run_cell(arch: str, shape: str, mesh, mesh_tag: str, *,
             verbose: bool = True) -> dict:
    cfg = get_config(arch)
    case = SHAPES[shape]
    reason = skip_reason(cfg, case)
    if reason:
        return {"arch": arch, "shape": shape, "mesh": mesh_tag,
                "status": "skip", "reason": reason}
    quant_moments = cfg.param_count() > 1e11   # 671B/400B: int8 moments
    chips = mesh.size
    t0 = time.time()
    try:
        ext = scan_extrapolated_cost(cfg, case, mesh, quant_moments)
        coll = dict(ext["collective_bytes"], n_ops=ext["n_ops"])
        mem = {k: int(ext[k]) for k in _MEMORY_KEYS}
        result = {
            "arch": arch, "shape": shape, "mesh": mesh_tag, "status": "ok",
            "walk_s": round(time.time() - t0, 1),
            "chips": chips,
            "collective_bytes": coll,
            "flops": ext["flops"], "int_flops": ext["int_flops"],
            "bytes_accessed": ext["bytes_accessed"],
            "io_bytes": ext["io_bytes"],
            "flops_extrapolated": ext["flops"],
            "int_flops_extrapolated": ext["int_flops"],
            "bytes_extrapolated": ext["bytes_accessed"],
            "collective_bytes_extrapolated": coll,
            "scan_trips": ext["scan_trips"],
            "data_rows_walked": ext["data_rows_walked"],
            "params": cfg.param_count(),
            "params_active": cfg.param_count(active_only=True),
            **mem,
            "fits": mem["argument_size_in_bytes"]
            + mem["temp_size_in_bytes"] <= HW.HBM_BYTES,
            "unbalanced": _unbalanced(cfg, case),
        }
        if verbose:
            print(f"[ok] {arch:28s} {shape:12s} {mesh_tag:14s} "
                  f"walk={result['walk_s']:6.1f}s "
                  f"flops/card={result['flops']:.3e} "
                  f"stored={mem['argument_size_in_bytes'] / 1e9:.1f}GB "
                  f"temp={mem['temp_size_in_bytes'] / 1e9:.1f}GB "
                  f"fits={result['fits']}", flush=True)
        return result
    except Exception as e:  # a failed cell is a bug: surface it loudly
        if verbose:
            print(f"[FAIL] {arch} {shape} {mesh_tag}: "
                  f"{type(e).__name__}: {e}")
            traceback.print_exc()
        return {"arch": arch, "shape": shape, "mesh": mesh_tag,
                "status": "fail", "error": f"{type(e).__name__}: {e}"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=None)
    ap.add_argument("--shape", nargs="*", default=None)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--singlepod", action="store_true")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--append", action="store_true")
    args = ap.parse_args(argv)

    archs = args.arch or list(ARCH_NAMES)
    shapes = args.shape or list(SHAPES)
    meshes = []
    if args.singlepod or not args.multipod:
        meshes.append(make_production_mesh(multi_pod=False))
    if args.multipod or not args.singlepod:
        meshes.append(make_production_mesh(multi_pod=True))

    results = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}

    for mesh in meshes:
        tag = production_tag(mesh)
        for arch in archs:
            for shape in shapes:
                if (arch, shape, tag) in done:
                    continue
                results.append(run_cell(arch, shape, mesh, tag))
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_fail = sum(r["status"] == "fail" for r in results)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skip, {n_fail} FAIL "
          f"-> {args.out}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
