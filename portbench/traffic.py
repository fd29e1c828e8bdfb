"""The one traffic generator: it reads a mix's data file and gives every
seed the same work.

A mix (``traffic/<name>.json``) fixes one *block* of requests: its
prompt lengths, output lengths and, for an open loop, its inter-arrival
gaps.  The block is drawn once, from constants in the file, so it is the
same for every seed.  A run's request stream is that block repeated,
each repetition in an order drawn from ``--seed``; the seed also draws
every prompt's token ids.  Stopping is by length only, so any prefix of
whole blocks holds the same prompt tokens, output tokens and (open loop)
the same sum of gaps whatever the seed.

Length and gap lists:

* ``{"kind": "ladder", "lo": a, "hi": b}``: ``block`` evenly spaced
  values from ``a`` to ``b``, both ends included;
* ``{"kind": "pareto", "lo": a, "hi": b, "alpha": x, "scale": s,
  "draw_seed": n}``: ``clip(a + pareto(x) * s, a, b)`` drawn once from
  ``draw_seed`` (the clipped heavy tail of the port's bursty workload
  generator, ``serve/workload.py``);
* ``{"kind": "exponential", "mean_s": m, "draw_seed": n}``: gaps drawn
  once from ``draw_seed`` and scaled so that the block's gaps sum to
  exactly ``block * m`` seconds.

``pairing_seed`` fixes, once, which output length goes with which
prompt length inside the block.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

__all__ = ["Request", "Mix", "load_mix", "mix_from", "block_lists",
           "RequestStream"]


@dataclasses.dataclass(frozen=True)
class Request:
    """One request of the stream: its position, prompt ids, output length
    and, in an open loop, its due time in seconds from the window's
    start (0 in a closed loop, where a request is due when it is sent)."""
    index: int
    prompt: np.ndarray
    max_new_tokens: int
    due_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class Mix:
    name: str
    loop: str                 # "closed" | "open"
    slots: int                # engine batch slots
    in_flight: int            # closed loop: requests kept in flight
    max_len: int              # per-slot cache budget (tokens)
    block: int
    prompt: dict
    output: dict
    gaps: dict | None
    pairing_seed: int
    trace_seconds: float
    raw: dict


def load_mix(path: Path) -> Mix:
    return mix_from(json.loads(Path(path).read_text()))


def mix_from(raw: dict) -> Mix:
    mix = Mix(name=raw["name"], loop=raw["loop"], slots=int(raw["slots"]),
              in_flight=int(raw.get("in_flight", 0)),
              max_len=int(raw["max_len"]), block=int(raw["block"]),
              prompt=raw["prompt"], output=raw["output"],
              gaps=raw.get("gaps"), pairing_seed=int(raw["pairing_seed"]),
              trace_seconds=float(raw.get("trace_seconds", 4.0)), raw=raw)
    if mix.loop not in ("closed", "open"):
        raise ValueError(f"{mix.name}: loop must be 'closed' or 'open'")
    if mix.loop == "open" and mix.gaps is None:
        raise ValueError(f"{mix.name}: an open loop needs 'gaps'")
    if mix.loop == "closed" and not 0 < mix.in_flight <= mix.slots:
        raise ValueError(f"{mix.name}: in_flight must be in [1, slots]")
    return mix


def _lengths(spec: dict, n: int) -> np.ndarray:
    kind = spec["kind"]
    lo, hi = int(spec["lo"]), int(spec["hi"])
    if kind == "ladder":
        if n == 1:
            return np.asarray([lo], np.int64)
        return np.rint(lo + np.arange(n) * (hi - lo) / (n - 1)).astype(
            np.int64)
    if kind == "pareto":
        rng = np.random.default_rng(int(spec["draw_seed"]))
        draw = lo + rng.pareto(float(spec["alpha"]), n) * float(spec["scale"])
        return np.clip(draw.astype(np.int64), lo, hi)
    raise ValueError(f"unknown length kind {kind!r}")


def _gaps(spec: dict, n: int) -> np.ndarray:
    if spec["kind"] != "exponential":
        raise ValueError(f"unknown gap kind {spec['kind']!r}")
    rng = np.random.default_rng(int(spec["draw_seed"]))
    g = rng.exponential(1.0, n)
    return g * (n * float(spec["mean_s"]) / g.sum())


def block_lists(mix: Mix):
    """The block's fixed ``(prompt_lengths, output_lengths, gaps)``, the
    same for every seed (``gaps`` is None in a closed loop)."""
    prompts = _lengths(mix.prompt, mix.block)
    outputs = _lengths(mix.output, mix.block)
    pair = np.random.default_rng(mix.pairing_seed).permutation(mix.block)
    gaps = _gaps(mix.gaps, mix.block) if mix.gaps is not None else None
    return prompts, outputs[pair], gaps


class RequestStream:
    """The seed's request stream: block after block of the mix's fixed
    requests, each block in its own order drawn from the seed, with
    prompt ids drawn from the seed in stream order.  ``take(n)`` returns
    the next ``n`` requests; ``until(t)`` (open loop) the requests due
    before ``t`` seconds."""

    def __init__(self, mix: Mix, seed: int, vocab_size: int):
        self.mix = mix
        self.vocab_size = int(vocab_size)
        self._prompts, self._outputs, self._gaps = block_lists(mix)
        ss = np.random.SeedSequence(int(seed) % (1 << 64))
        order_ss, ids_ss = ss.spawn(2)
        self._order_rng = np.random.default_rng(order_ss)
        self._ids_rng = np.random.default_rng(ids_ss)
        self._order: list[int] = []
        self._next = 0
        self._clock = 0.0

    def _pop_slot(self) -> int:
        if not self._order:
            self._order = list(self._order_rng.permutation(self.mix.block))
        return self._order.pop(0)

    def next(self) -> Request:
        j = self._pop_slot()
        n = int(self._prompts[j])
        prompt = self._ids_rng.integers(0, self.vocab_size, n,
                                        dtype=np.int64).astype(np.int32)
        due = 0.0
        if self._gaps is not None:
            due = self._clock
            self._clock += float(self._gaps[j])
        req = Request(self._next, prompt, int(self._outputs[j]), due)
        self._next += 1
        return req

    def take(self, n: int) -> list[Request]:
        return [self.next() for _ in range(n)]

    def until(self, t_s: float) -> list[Request]:
        if self._gaps is None:
            raise ValueError("until() is for an open loop")
        out = []
        while self._clock < t_s:
            out.append(self.next())
        return out
