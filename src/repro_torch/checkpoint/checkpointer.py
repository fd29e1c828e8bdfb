"""Checkpointing with manifest validation, atomic commits and a
background writer (the port's own format, modelled on
``repro.checkpoint.checkpointer``).

Layout: ``<dir>/step_<N>/`` holding ``shard_<host>.npz`` (one array per
tree path) and ``manifest.json`` (step, mesh shape, paths, shapes and
dtypes).  bf16 tensors are stored through a ``uint16`` view (numpy has no
bf16), so every value round-trips bit for bit.  Writes go to a temp dir
and are committed by an atomic rename, so ``latest_step`` only ever sees
complete checkpoints; ``keep`` bounds how many stay on disk.

``save`` snapshots the tensors to host memory in the caller's thread
(the training step may overwrite them in place right after) and hands
the file writing to a background thread; ``wait`` joins it.  Restoring
under a different ``mesh_shape`` (re-sharding) is not ported yet.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading

import numpy as np
import torch

from repro_torch.tree import tree_map, tree_paths

__all__ = ["Checkpointer"]

_MANIFEST = "manifest.json"


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu()
    name = str(t.dtype).replace("torch.", "")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _from_numpy(a: np.ndarray, dtype_name: str, like: torch.Tensor):
    if dtype_name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device=like.device, dtype=like.dtype)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        os.makedirs(directory, exist_ok=True)

    def _steps(self) -> list[int]:
        return sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_")
            and os.path.exists(os.path.join(self.dir, n, _MANIFEST)))

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def wait(self):
        """Join the background writer; re-raise its failure, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def save(self, step: int, state, *, mesh_shape=None, host_id: int = 0,
             n_hosts: int = 1):
        """Snapshot to host memory now, then write in the background and
        commit by atomic rename."""
        self.wait()
        arrays, dtypes = {}, {}
        for path, t in tree_paths(state):
            arrays[path], dtypes[path] = _to_numpy(t)
        manifest = {"step": step, "n_hosts": n_hosts,
                    "mesh_shape": list(mesh_shape or []),
                    "keys": sorted(arrays),
                    "shapes": {k: list(v.shape) for k, v in arrays.items()},
                    "dtypes": dtypes}

        def write():
            tmp = tempfile.mkdtemp(dir=self.dir)
            try:
                np.savez(os.path.join(tmp, f"shard_{host_id}.npz"),
                         **{k.replace("/", "__"): v
                            for k, v in arrays.items()})
                with open(os.path.join(tmp, _MANIFEST), "w") as f:
                    json.dump(manifest, f)
                final = os.path.join(self.dir, f"step_{step}")
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
            finally:
                if os.path.exists(tmp):
                    shutil.rmtree(tmp, ignore_errors=True)
            for s in self._steps()[:-self.keep]:
                shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                              ignore_errors=True)

        def run():
            try:
                write()
            except Exception as exc:        # re-raised by wait()
                self._error = exc

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def restore(self, template, step: int | None = None, *,
                host_id: int = 0, mesh_shape=None):
        """Restore into the structure, devices and dtypes of ``template``;
        returns (state, step).  Raises with the differing paths when the
        checkpoint and the template disagree."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        if manifest["mesh_shape"] != list(mesh_shape or []):
            raise NotImplementedError(
                f"checkpoint saved under mesh {manifest['mesh_shape']}, "
                f"restoring under {list(mesh_shape or [])}: re-sharding is "
                f"not ported yet")
        flat_t = dict(tree_paths(template))
        missing = sorted(set(flat_t) - set(manifest["keys"]))
        extra = sorted(set(manifest["keys"]) - set(flat_t))
        if missing or extra:
            raise ValueError(
                f"checkpoint/template structure mismatch at step {step}: "
                f"missing={missing[:5]} extra={extra[:5]}")
        with np.load(os.path.join(path, f"shard_{host_id}.npz")) as data:
            flat = {}
            for k, like in flat_t.items():
                arr = data[k.replace("/", "__")]
                if tuple(arr.shape) != tuple(like.shape):
                    raise ValueError(f"shape drift for {k}: ckpt "
                                     f"{arr.shape} vs template "
                                     f"{tuple(like.shape)}")
                flat[k] = _from_numpy(arr, manifest["dtypes"][k], like)
        it = iter(flat[k] for k, _ in tree_paths(template))
        return tree_map(lambda _: next(it), template), manifest["step"]
