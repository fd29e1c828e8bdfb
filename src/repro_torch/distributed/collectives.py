"""Collectives over a list of per-shard tensors, driven by one process
(the port's stand-in for the reductions GSPMD inserts in the reference).

Each takes one tensor per model-axis shard, in shard order, and returns
one per shard on that shard's device.  The reduction runs on shard 0's
device in shard order 0..tp-1, and every shard gets a copy of that one
result, so all shards hold the same bits whatever their devices.  Shards
that share a device get the same tensor object.  Everything is a stream
operation (a copy between cards included), so a CUDA graph captures it
when the shards share a card.

Quantized accumulators are int32 and reduce exactly; ``all_reduce_sum``
over f32 partials sums in shard order.

Over the data axis (FSDP storage): :func:`data_gather` concatenates one
piece per data row, in data order, onto each device that uses the whole
tensor, and counts the bytes it writes (``gathered_bytes``); the amax the integer modes share across
data rows is :func:`all_reduce_max` over one value per row.

**Distinct entries.**  By default two entries on one device are one card:
they share replicated work (:func:`per_device`) and a tensor moves only
between devices.  Under :func:`distinct_entries` (the training step over
a mesh, and the dry run) every entry of a list is a card of its own,
whatever its device: :func:`per_device` runs ``fn`` for every entry, and
a value moves (and is counted) between any two entries.  So a mesh of
one card repeated, or of fake ``meta:N`` devices, does per entry what a
mesh of distinct cards does.

**Byte counters** (host-side, like ``gathered_bytes``: a replayed CUDA
graph does not advance them; read differences): every move of a tensor
from one entry to another adds its bytes under ``(kind, axis)``, the
kinds ``all_reduce_sum``, ``all_reduce_max``, ``all_gather``,
``broadcast`` and ``data_gather``, the axes ``model`` (inside a node:
NVLink) and ``data`` (across nodes: the network).  Each move is an
autograd function whose backward moves the gradient back and counts it
under the same key: a broadcast's backward is the sum of the copies'
gradients onto the source, a gather's the reduce-scatter of its pieces'
gradients, so a training step's bytes come out whole.
``collective_calls`` counts the collective calls that moved any bytes.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels.ops import costed

__all__ = ["all_reduce_sum", "all_reduce_max", "all_gather", "broadcast",
           "reduce_sum", "per_device", "data_gather", "gathered_bytes",
           "move", "distinct_entries", "entries_distinct",
           "collective_bytes", "collective_calls", "reset_collective_counts",
           "KINDS", "AXES", "mesh_all_reduce"]

KINDS = ("all_reduce_sum", "all_reduce_max", "all_gather", "broadcast",
         "data_gather")
AXES = ("model", "data")

# bytes written by data_gather in this process (host-side count: a
# replayed CUDA graph does not advance it; read differences)
_GATHERED = [0]
_DISTINCT = [False]
_BYTES: dict = {}                 # (kind, axis) -> bytes moved
_CALLS = [0]


def gathered_bytes() -> int:
    return _GATHERED[0]


@contextlib.contextmanager
def distinct_entries():
    """Every entry is a card of its own inside this block (see the module
    docstring)."""
    prev, _DISTINCT[0] = _DISTINCT[0], True
    try:
        yield
    finally:
        _DISTINCT[0] = prev


def entries_distinct() -> bool:
    return _DISTINCT[0]


def collective_bytes() -> dict:
    """``{kind: {axis: bytes}}`` moved so far, every kind and axis."""
    return {k: {a: _BYTES.get((k, a), 0) for a in AXES} for k in KINDS}


def collective_calls() -> int:
    return _CALLS[0]


def reset_collective_counts() -> None:
    _BYTES.clear()
    _CALLS[0] = 0


def _count(kind: str, axis: str, nbytes: int) -> None:
    _BYTES[(kind, axis)] = _BYTES.get((kind, axis), 0) + nbytes


def _moved() -> int:
    return sum(_BYTES.values())


def _call_if_moved(before: int) -> None:
    if _moved() != before:
        _CALLS[0] += 1


def _link_cost(t, dev):
    """A copy between entries crosses a link, not memory: a static walk
    counts no bytes for it (the counters here do)."""
    return 0, 0, 0, 0


@costed(_link_cost)
def _to_entry(t: torch.Tensor, dev) -> torch.Tensor:
    """``t`` on ``dev`` (``t`` itself where it lies there), one call a
    static walk counts by its cost alone, so a mesh of fake devices and
    one of a card repeated count the same."""
    return t.to(dev)


class _Move(torch.autograd.Function):
    """``t`` on ``dev``, counted under ``(kind, axis)`` both ways."""

    @staticmethod
    def forward(ctx, t, dev, kind, axis):
        ctx.src, ctx.key = t.device, (kind, axis)
        _count(kind, axis, t.numel() * t.element_size())
        out = _to_entry(t, dev)
        return out.view_as(out) if out is t else out

    @staticmethod
    def backward(ctx, g):
        _count(*ctx.key, g.numel() * g.element_size())
        return _to_entry(g, ctx.src), None, None, None


def move(t: torch.Tensor, dev, kind: str, axis: str = "model"
         ) -> torch.Tensor:
    """``t`` moved to another entry on ``dev``, its bytes counted (and its
    gradient's, in backward)."""
    return _Move.apply(t, dev, kind, axis)


def _same(i: int, j: int, devices) -> bool:
    """Entries ``i`` and ``j`` of ``devices`` are one card."""
    return i == j or (not _DISTINCT[0]
                      and str(devices[i]) == str(devices[j]))


def per_device(devices, fn) -> list:
    """``fn(i)`` for the first shard on each distinct device, shared by
    the other shards on it: replicated work runs once per device (under
    :func:`distinct_entries`, once per entry)."""
    if _DISTINCT[0]:
        return [fn(i) for i in range(len(devices))]
    seen, out = {}, []
    for i, dev in enumerate(devices):
        key = str(dev)
        if key not in seen:
            seen[key] = fn(i)
        out.append(seen[key])
    return out


def broadcast(t: torch.Tensor, devices, *, src: int | None = None,
              kind: str = "broadcast", axis: str = "model") -> list:
    """``t`` on each of ``devices``: ``t`` itself where it already lies,
    one copy per other device (shared by the shards on it).  ``src``: the
    entry of ``devices`` that holds ``t``; where given, every other entry
    receives a counted copy (one per device, or under
    :func:`distinct_entries` one per entry); None: ``t`` comes from
    outside the list (a host-made input), and copies to other devices are
    not collectives."""
    if src is not None:
        before = _moved()
        if _DISTINCT[0]:
            out = [t if i == src else move(t, dev, kind, axis)
                   for i, dev in enumerate(devices)]
        else:
            copies = {str(devices[src]): t}
            out = []
            for dev in devices:
                if str(dev) not in copies:
                    copies[str(dev)] = move(t, dev, kind, axis)
                out.append(copies[str(dev)])
        _call_if_moved(before)
        return out
    copies = {}
    out = []
    for dev in devices:
        key = str(dev)
        if key not in copies:
            copies[key] = t if t.device == dev else _to_entry(t, dev)
        out.append(copies[key])
    return out


def _reduce(parts, op, kind: str, axis: str, devices=None) -> torch.Tensor:
    devices = devices or [p.device for p in parts]
    before = _moved()
    acc = parts[0]
    for i, p in enumerate(parts[1:], 1):
        acc = op(acc, p.to(acc.device) if _same(i, 0, devices)
                 else move(p, acc.device, kind, axis))
    _call_if_moved(before)
    return acc


def reduce_sum(parts, *, axis: str = "model", devices=None
               ) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` in shard order, on shard 0's device
    only (for a result that is finished there, then broadcast).
    ``devices``: the entries' devices (default: the parts')."""
    return _reduce(parts, torch.add, "all_reduce_sum", axis, devices)


def all_reduce_sum(parts, *, devices=None) -> list:
    """``parts[0] + parts[1] + ...`` in shard order, on every shard."""
    devices = devices or [p.device for p in parts]
    return broadcast(reduce_sum(parts, devices=devices), devices, src=0,
                     kind="all_reduce_sum")


def all_reduce_max(parts, *, devices=None) -> list:
    """The elementwise maximum of ``parts``, on every shard."""
    devices = devices or [p.device for p in parts]
    return broadcast(_reduce(parts, torch.maximum, "all_reduce_max",
                             "model", devices), devices, src=0,
                     kind="all_reduce_max")


def all_gather(parts, dim: int = -1, *, devices=None) -> list:
    """``parts`` concatenated along ``dim`` in shard order, on every
    shard."""
    devices = devices or [p.device for p in parts]
    dev = parts[0].device
    before = _moved()
    whole = torch.cat([p.to(dev) if _same(i, 0, devices)
                       else move(p, dev, "all_gather")
                       for i, p in enumerate(parts)], dim=dim)
    _call_if_moved(before)
    return broadcast(whole, devices, src=0, kind="all_gather")


def data_gather(pieces, dim: int, devices, rows=None) -> list:
    """The FSDP gather: ``pieces`` (one per data row, in data order)
    concatenated along ``dim`` on each of ``devices``, one tensor per
    distinct device (shared by the entries on it; under
    :func:`distinct_entries` one per entry) and always a fresh copy, even
    where every piece already lies on that device.  ``rows``: the data
    row of each destination (default ``0, 1, ...``): piece ``r`` reaching
    a destination of another row crosses the data axis, and counts."""
    rows = list(range(len(devices))) if rows is None else list(rows)
    out: dict = {}
    res = []
    for dev, d in zip(devices, rows):
        key = (d, str(dev)) if _DISTINCT[0] else str(dev)
        if key not in out:
            before = _moved()
            whole = torch.cat([
                p.to(dev) if r == d or (not _DISTINCT[0]
                                        and str(p.device) == str(dev))
                else move(p, dev, "data_gather", "data")
                for r, p in enumerate(pieces)], dim=dim)
            _call_if_moved(before)
            _GATHERED[0] += whole.numel() * whole.element_size()
            out[key] = whole
        res.append(out[key])
    return res


def mesh_all_reduce(parts, entries, devices, tp: int, op: str = "sum"
                    ) -> list:
    """An all-reduce over mesh entries ``entries`` (``e = d * tp + m``,
    ascending; ``parts[i]`` on ``devices[i]``): within each data row over
    the model axis onto the row's first entry, then over the rows onto
    the first row's (sum or max, in that order), then copied back the same
    way.  Returns the result per entry."""
    fn, kind = ((torch.add, "all_reduce_sum") if op == "sum"
                else (torch.maximum, "all_reduce_max"))
    before = _moved()

    def hop(t, i, j, axis):
        return t if _same(i, j, devices) \
            else move(t, devices[j], kind, axis)

    by_row: dict = {}
    for i, e in enumerate(entries):
        by_row.setdefault(e // tp, []).append(i)
    leads = []
    for idx in by_row.values():
        acc = parts[idx[0]]
        for j in idx[1:]:
            acc = fn(acc, hop(parts[j], j, idx[0], "model"))
        leads.append((idx, acc))
    root = leads[0][0][0]
    total = leads[0][1]
    for idx, acc in leads[1:]:
        total = fn(total, hop(acc, idx[0], root, "data"))
    out = [None] * len(entries)
    for idx, _ in leads:
        val = total if idx[0] == root else hop(total, root, idx[0], "data")
        for j in idx:
            out[j] = val if j == idx[0] else hop(val, idx[0], j, "model")
    _call_if_moved(before)
    return out
