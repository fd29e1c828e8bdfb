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
"""

from __future__ import annotations

import torch

__all__ = ["all_reduce_sum", "all_reduce_max", "all_gather", "broadcast",
           "reduce_sum", "per_device", "data_gather", "gathered_bytes"]

# bytes written by data_gather in this process (host-side count: a
# replayed CUDA graph does not advance it; read differences)
_GATHERED = [0]


def gathered_bytes() -> int:
    return _GATHERED[0]


def per_device(devices, fn) -> list:
    """``fn(i)`` for the first shard on each distinct device, shared by
    the other shards on it: replicated work runs once per device."""
    seen, out = {}, []
    for i, dev in enumerate(devices):
        key = str(dev)
        if key not in seen:
            seen[key] = fn(i)
        out.append(seen[key])
    return out


def broadcast(t: torch.Tensor, devices) -> list:
    """``t`` on each of ``devices``: ``t`` itself where it already lies,
    one copy per other device (shared by the shards on it)."""
    copies = {}
    out = []
    for dev in devices:
        key = str(dev)
        if key not in copies:
            copies[key] = t if t.device == dev else t.to(dev)
        out.append(copies[key])
    return out


def _reduce(parts, op) -> torch.Tensor:
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, p.to(acc.device))
    return acc


def reduce_sum(parts) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` in shard order, on shard 0's device
    only (for a result that is finished there, then broadcast)."""
    return _reduce(parts, torch.add)


def all_reduce_sum(parts) -> list:
    """``parts[0] + parts[1] + ...`` in shard order, on every shard."""
    return broadcast(reduce_sum(parts), [p.device for p in parts])


def all_reduce_max(parts) -> list:
    """The elementwise maximum of ``parts``, on every shard."""
    return broadcast(_reduce(parts, torch.maximum),
                     [p.device for p in parts])


def all_gather(parts, dim: int = -1) -> list:
    """``parts`` concatenated along ``dim`` in shard order, on every
    shard."""
    dev = parts[0].device
    whole = torch.cat([p.to(dev) for p in parts], dim=dim)
    return broadcast(whole, [p.device for p in parts])


def data_gather(pieces, dim: int, devices) -> list:
    """The FSDP gather: ``pieces`` (one per data row, in data order)
    concatenated along ``dim`` on each of ``devices``, one tensor per
    distinct device (shared by the entries on it) and always a fresh
    copy, even where every piece already lies on that device."""
    out = {}
    for dev in devices:
        key = str(dev)
        if key not in out:
            whole = torch.cat([p.to(dev) for p in pieces], dim=dim)
            _GATHERED[0] += whole.numel() * whole.element_size()
            out[key] = whole
    return [out[str(dev)] for dev in devices]
