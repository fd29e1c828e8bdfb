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
work by.

:func:`make_production_mesh` is the dry run's mesh (``launch/dryrun.py``,
its one reader): the reference's chip counts, 256 entries in one pod and
512 in two, laid out for HGX H100 nodes: the model axis is 8, the cards
of one NVLink node, and the data axis takes the rest (32 rows; two pods
fold their pod axis into 64 data rows, so FSDP spans pod x data, as
``sharding.fsdp_axes`` spans the reference's).  Its default entries are
the placeholder device ``meta``: the dry run reads the mesh's shape and
walks meshes of its own, each entry a distinct ``meta:N`` (a torch device
index has 8 bits, so no more than 128 of them).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["LocalMesh", "make_local_mesh", "make_production_mesh",
           "production_tag", "canonical_device", "HW"]


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
    pods: int = 1                     # pods folded into the data rows

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


# cards per HGX H100 node: the NVLink domain the model axis stays inside
NODE_CARDS = 8


def make_production_mesh(*, multi_pod: bool = False) -> LocalMesh:
    """The dry run's mesh: 256 entries as (data 32, model 8), or with
    ``multi_pod`` 512 as two pods of that, their pod axis folded into 64
    data rows; every entry the placeholder ``meta``."""
    pods = 2 if multi_pod else 1
    mesh = make_local_mesh(dp=pods * 32, tp=NODE_CARDS,
                           devices=[torch.device("meta")]
                           * (pods * 32 * NODE_CARDS))
    return dataclasses.replace(mesh, pods=pods)


def production_tag(mesh: LocalMesh) -> str:
    """``256gpu_32x8`` or ``512gpu_2x32x8``: cards, then the axes."""
    rows, tp = mesh.shape["data"], mesh.shape["model"]
    axes = (f"{mesh.pods}x{rows // mesh.pods}x{tp}" if mesh.pods > 1
            else f"{rows}x{tp}")
    return f"{mesh.size}gpu_{axes}"


class HW:
    """NVIDIA H100 SXM at its 700 W limit, from NVIDIA's data sheet (dense
    rates without sparsity; HBM3): what the roofline and the capacity
    model divide work by.  ``NVLINK_BW`` is one direction of a card's
    NVLink 4 bandwidth, the link the roofline's collective term crosses
    (the reference's ``ICI_BW``); ``NET_BW`` the network a data axis
    crosses."""
    PEAK_BF16_FLOPS = 989e12        # per card
    PEAK_INT8_OPS = 1.979e15        # per card
    HBM_BW = 3.35e12                # bytes/s per card
    HBM_BYTES = 80e9                # bytes per card
    NVLINK_BW = 450e9               # bytes/s per card, per direction
    # the network a data axis crosses between nodes: one 400 Gb/s NDR
    # InfiniBand adapter per card (HGX H100 with 8 ConnectX-7, NVIDIA's
    # DGX H100 data sheet): 400e9 / 8 bytes/s per card, one direction
    NET_BW = 50e9
