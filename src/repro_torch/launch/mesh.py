"""Local device meshes (port of ``repro.launch.mesh``).

A mesh is a ``(data, model)`` grid of ``torch.device``s that one process
drives: the serve engine shards its weights and KV pools over the
"model" axis and runs every shard from this process, with explicit
collectives (``distributed.collectives``) where the reference's GSPMD
partitioner inserts them.  A device may appear more than once: its shards
then share it, which is how one card (or the CPU) runs ``tp=2``, or a
``(2, 2)`` mesh.  Entry ``(d, m)`` is data row ``d``, model shard ``m``:
the engine stores FSDP pieces of the weights per entry and splits its
slots over the data rows (``distributed.sharding``).

``HW`` carries the H100's data-sheet rates, which the roofline
(``roofline.analysis``) and the capacity model (``capacity.model``) divide
work by.  Not here yet: ``make_production_mesh`` (the reference's TPU
pod mesh); it comes with the dry run (``launch/dryrun.py``), the one tool
that reads it.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["LocalMesh", "make_local_mesh", "canonical_device", "HW"]


def canonical_device(device) -> torch.device:
    """``cuda`` and ``cuda:<current>`` name one card; one spelling each."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """``devices[d][m]`` runs data row ``d``, model shard ``m``."""
    devices: tuple                    # (dp, tp) grid of torch.device
    axis_names: tuple = ("data", "model")

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def model_devices(self) -> list:
        """The model axis of data row 0: shard ``m`` runs on entry ``m``."""
        return list(self.devices[0])

    def row_devices(self, d: int) -> list:
        """The model axis of data row ``d``."""
        return list(self.devices[d])

    @property
    def entries(self) -> list:
        """Every entry's device, row-major: entry ``(d, m)`` at ``d * tp +
        m``."""
        return [dev for row in self.devices for dev in row]

    @property
    def distinct_devices(self) -> list:
        """Each device the mesh names, once, in entry order."""
        seen = {}
        for dev in self.entries:
            seen.setdefault(str(dev), dev)
        return list(seen.values())


def make_local_mesh(*, dp: int = 0, tp: int = 1, devices=None) -> LocalMesh:
    """Local ``(data, model)`` mesh.  ``tp`` sizes the "model" axis; ``dp``
    the "data" axis, ``dp=0`` meaning every remaining device (``len(devices)
    // tp``).  ``devices`` is an explicit list (the router hands each
    engine replica a disjoint slice; entries may repeat); ``None`` means
    every visible CUDA card, and raises when there is none: a mesh never
    drops to the CPU unless the CPU is named.  The sizes are checked up
    front with the reference's messages."""
    if devices is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if not n_cards:
            raise RuntimeError("make_local_mesh(devices=None) takes every "
                               "visible CUDA card, and there is none; "
                               "pass devices=[...] (the CPU may be named, "
                               "and repeated)")
        devices = [torch.device("cuda", i) for i in range(n_cards)]
    devices = [canonical_device(d) for d in devices]
    n = len(devices)
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if dp < 0:
        raise ValueError(f"dp must be >= 0 (0 = all remaining devices), "
                         f"got {dp}")
    if dp == 0:
        if n % tp:
            raise ValueError(f"tp={tp} does not divide the {n} available "
                             f"device(s)")
        dp = n // tp
    if dp * tp > n:
        raise ValueError(f"mesh ({dp}, {tp}) needs {dp * tp} devices but "
                         f"only {n} are available")
    grid = tuple(tuple(devices[r * tp:(r + 1) * tp]) for r in range(dp))
    return LocalMesh(grid)


class HW:
    """NVIDIA H100 SXM at its 700 W limit, from NVIDIA's data sheet (dense
    rates without sparsity; HBM3): what the roofline and the capacity
    model divide work by.  ``NVLINK_BW`` is one direction of a card's
    NVLink 4 bandwidth, the link the roofline's collective term crosses
    (the reference's ``ICI_BW``)."""
    PEAK_BF16_FLOPS = 989e12        # per card
    PEAK_INT8_OPS = 1.979e15        # per card
    HBM_BW = 3.35e12                # bytes/s per card
    HBM_BYTES = 80e9                # bytes per card
    NVLINK_BW = 450e9               # bytes/s per card, per direction
