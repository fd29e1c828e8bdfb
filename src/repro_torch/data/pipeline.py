"""Data pipeline: deterministic synthetic token streams, host-sharded
(port of ``repro.data.pipeline``).

Each host produces only its slice of the global batch
(:func:`host_batch_slice`), and ``batch(step)`` is a pure function of
(seed, step, slice), so a restarted host reproduces exactly the batches
it owes.  The tokens come from the same numpy generator, seeded the same
way, as the reference's, so both packages train on identical integers;
here they are returned as int64 tensors on the given device (CUDA unless
the caller asks for the CPU).

The stream is a Markov ramp, ``tokens[t+1] = (31 * tokens[t] + noise +
7) % vocab`` with step-seeded noise: learnable short-range structure,
zero I/O.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["DataConfig", "SyntheticLM", "host_batch_slice"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234


def host_batch_slice(global_batch: int, host_id: int, n_hosts: int) \
        -> tuple[int, int]:
    """[start, size) of this host's slice of the global batch."""
    if global_batch % n_hosts:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{n_hosts} hosts")
    per = global_batch // n_hosts
    return host_id * per, per


class SyntheticLM:
    """Deterministic synthetic LM batches: ``batch(step)`` is a pure
    function of the step."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1,
                 *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.start, self.local_batch = host_batch_slice(
            cfg.global_batch, host_id, n_hosts)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.uint64(cfg.seed) + np.uint64(step) * np.uint64(1_000_003)
            + np.uint64(self.start))
        b, s, v = self.local_batch, cfg.seq_len, cfg.vocab_size
        first = rng.integers(0, v, (b, 1))
        noise = rng.integers(0, 17, (b, s - 1))
        toks = [first]
        for t in range(s - 1):
            toks.append((toks[-1] * 31 + noise[:, t:t + 1] + 7) % v)
        tokens = np.concatenate(toks, axis=1).astype(np.int64)
        labels = np.concatenate([tokens[:, 1:], np.full((b, 1), -1)], axis=1)
        return {"tokens": torch.from_numpy(tokens).to(self.device),
                "labels": torch.from_numpy(labels).to(self.device)}
