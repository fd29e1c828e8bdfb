"""One run of one cell: set-up, the measured window, the metrics, and the
comparison with the plain reference that decides ``correct``.

Everything a cell needs is found by name: its configuration
(``BENCHMARK.json``'s ``configs[].file``), its traffic mix
(``traffic/<traffic>.json``), its limits (``limits/<workload>.json``),
the reference module its configuration names (``reference/<name>.py``)
and a reader for each per-layer metric (``metrics/<metric>.py``, or
``metrics/<base>.py`` for ``<base>.<suffix>``).  A later cell or metric
is files and entries, not edits.

The window drives ``repro_torch``'s ``Engine`` through ``submit`` /
``step`` / ``drain``.  A closed loop keeps ``in_flight`` requests in
flight, sending the stream's next request whenever one finishes; an
open loop sends every request due in the window at its due time.  The
window closes with the engine step that runs at ``--seconds``: its
length is the time from its start to that step's end, so a rate counts
all the work and all the time of the window, whole decode chunks at
both ends.  After the window closes, no request is sent; the engine
steps on until every request due in the window has its first token (at
most ``GRACE_S``), so a late answer counts as late, not as missing.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from portbench import cost
from portbench.reference import strict_f32
from portbench.trace import Tracer
from portbench.traffic import RequestStream, mix_from
from portbench.weights import generator_seed, make_weights

__all__ = ["ROOT", "Cell", "load_cell", "run_cell", "percentile"]

ROOT = Path(__file__).resolve().parents[1]
GRACE_S = 60.0


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    mix: object
    limits: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str, root: Path = ROOT,
              mix_overrides: dict | None = None) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = json.loads((root / entry["file"]).read_text())
    raw = json.loads((root / "portbench" / "traffic"
                      / f"{wl['traffic']}.json").read_text())
    mix = mix_from({**raw, **(mix_overrides or {})})
    limits = json.loads(
        (root / "portbench" / "limits" / f"{name}.json").read_text())

    def here(metric):
        return name in metric.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if here(m)]
    layer = [m for m in bench["per_layer"]
             if name in metric_cells(bench, m)]
    return Cell(wl, config, mix, limits, e2e, layer)


def metric_cells(bench: dict, metric: dict) -> list:
    """A per-layer metric's cells: its ``workloads``, or else every cell
    that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return metric["workloads"]
    e2e = next(m for m in bench["end_to_end"] if m["name"] == metric["moves"])
    return e2e.get("workloads", [w["name"] for w in bench["workloads"]])


def percentile(values, q: float) -> float:
    """The ``q``-th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Served:
    """One request as the window saw it, in window seconds."""
    index: int
    prompt: np.ndarray
    max_new_tokens: int
    due: float
    tokens: list
    t_first: float | None
    t_tokens: list
    finished: bool


class Book:
    """The harness's record of what it sent: engine id -> the stream's
    request and its due time (window seconds)."""

    def __init__(self, off: float):
        self.off = off          # engine seconds at the window's start
        self.sent: dict[int, tuple] = {}
        self.done: dict[int, object] = {}

    def send(self, engine, req, due: float, arrival: float) -> None:
        rid = engine.submit(req.prompt, req.max_new_tokens, arrival=arrival)
        self.sent[rid] = (req, due)

    def finish(self, done: dict) -> int:
        self.done.update(done)
        return len(done)

    def served(self, running: list) -> list[Served]:
        live = {r.id: r for r in running}
        out = []
        for rid, (req, due) in self.sent.items():
            r = self.done.get(rid) or live.get(rid)
            if r is None:
                out.append(Served(req.index, req.prompt, req.max_new_tokens,
                                  due, [], None, [], False))
                continue
            tf = r.t_first - self.off if r.t_first >= 0 else None
            out.append(Served(req.index, req.prompt, req.max_new_tokens, due,
                              list(r.tokens), tf,
                              [t - self.off for t in r.t_tokens],
                              rid in self.done))
        return out

    def waiting(self, engine, running_requests, until: float) -> bool:
        """Whether a request due by ``until`` still lacks a first token."""
        live = {r.id: r for r in running_requests(engine)}
        for rid, (_, due) in self.sent.items():
            if due > until or rid in self.done:
                continue
            r = live.get(rid)
            if r is None or r.t_first < 0:
                return True
        return False


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             t_start: float, device="cuda", model_overrides=None,
             quant_mode=None, log=print) -> dict:
    from portbench import program

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    config, mix = cell.config, cell.mix
    family = config["reference"]
    model = {**config["model"], **(model_overrides or {})}
    ref = importlib.import_module(f"portbench.reference.{family}")

    weights = make_weights(ref.weight_layout(model), seed, dev)
    engine = program.build_engine(config, model, mix, weights, dev,
                                  quant_mode)
    del weights
    stream = RequestStream(mix, seed, model["vocab_size"])
    tracer = Tracer(dev) if trace else None
    if trace:
        tracer.warm()

    # set-up: the closed loop admits its first requests and runs one chunk
    # (the decode chunk's graph is captured there); the open loop serves
    # two warm-up requests of the block's extreme prompt lengths apart
    anchor = time.perf_counter()
    engine.start(anchor)
    book = Book(0.0)
    if mix.loop == "closed":
        for req in stream.take(mix.in_flight):
            book.send(engine, req, 0.0, 0.0)
        engine.step()
        book.finish(engine.drain())
    else:
        _warm_open(engine, mix, model["vocab_size"], seed)
        engine.start(anchor)
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    off = t0 - anchor
    for rid, (req, _) in book.sent.items():
        book.sent[rid] = (req, -off)          # sent during set-up
    book.off = off
    if mix.loop == "open":
        for req in stream.until(seconds):
            book.send(engine, req, req.due_s, off + req.due_s)

    # the traced slice is the window's last ``trace_seconds``: stopping
    # the profiler collects the trace, which takes seconds and so runs
    # after the window has closed
    trace_at = max(0.0, seconds - mix.trace_seconds)
    dtrace = None
    tr_bounds = None
    steps = []                # (prefilled, seconds, traced) a window step
    while True:
        now = time.perf_counter() - t0
        if now >= seconds:
            break
        if tracer is not None and not tracer.active and now >= trace_at:
            tracer.start()
            c0 = engine.decode_chunks
        pt = engine.prefill_tokens
        ts = time.perf_counter()
        traced = tracer is not None and tracer.active
        if traced:
            alive = tracer.step(engine.step, lambda _: (
                "step_with_prefill" if engine.prefill_tokens > pt
                else "decode_chunk_step"))
        else:
            alive = engine.step()
        steps.append((engine.prefill_tokens > pt, time.perf_counter() - ts,
                      traced))
        n_done = book.finish(engine.drain())
        if mix.loop == "closed":
            for req in stream.take(n_done):
                t = time.perf_counter() - anchor
                book.send(engine, req, t - off, t)
        elif not alive:
            time.sleep(0.001)
    window = time.perf_counter() - t0
    if tracer is not None and tracer.active:
        dtrace = tracer.stop()
        tr_bounds = (tracer.t0 - t0, tracer.t1 - t0, c0,
                     engine.decode_chunks)
    t_close = time.perf_counter()
    while (book.waiting(engine, program.running_requests, window)
           and time.perf_counter() - t_close < GRACE_S):
        engine.step()
        book.finish(engine.drain())
    served = book.served(program.running_requests(engine))
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"

    run = Run(model=model, family=family, mix=mix, config=config,
              seconds=window, served=served, steps=steps,
              trace=dtrace, trace_bounds=tr_bounds)
    log(run.summary())
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = _reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            else:
                metrics[m["name"]] = {"value": run.end_to_end(m["name"]),
                                      "unit": m["unit"]}

    # the comparison: the program's state is freed first, then the
    # reference runs on weights made again from the seed
    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checked = check(cell, run, ref, seed, dev, log)
    ok = all(c["value"] <= c["limit"] for c in checked.values())
    due = [s for s in served if 0.0 <= s.due <= window]
    attempted = len(due) + sum(1 for s in served if s.due < 0)
    result = {"correct": ok, "attempted": attempted,
              "failed": sum(1 for s in due if s.t_first is None),
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if dtrace is not None:
        result["device"]["busy_s"] = dtrace.busy_s
        result["device"]["window_s"] = dtrace.window_s
        result["breakdown"] = {
            "device_ops": dtrace.device_ops(),
            "idle_gaps": _idle_breakdown(dtrace)}
    result["checked"] = checked
    return result


def _warm_open(engine, mix, vocab: int, seed: int) -> None:
    """Serve the block's shortest and longest prompts once, long enough to
    run a decode chunk, then clear the engine (graphs stay)."""
    from portbench.traffic import block_lists
    prompts, _, _ = block_lists(mix)
    rng = np.random.default_rng(generator_seed(seed, 2))
    for n in (int(prompts.min()), int(prompts.max())):
        engine.submit(rng.integers(0, vocab, n).astype(np.int32),
                      engine.scfg.decode_chunk + 1)
    engine.run()
    engine.drain()
    engine.reset()


def _idle_breakdown(dtrace) -> list:
    pooled = sorted(([f"{k}: all {n} gaps", s]
                     for k, (n, s) in dtrace.gaps.items()),
                    key=lambda e: -e[1])
    longest = [[f"{k}: longest", s] for k, s in dtrace.longest_gaps]
    return (pooled + longest)[:10]


def _reader(name: str):
    """The reader of a per-layer metric: ``metrics/<name>.py``, else
    ``metrics/<base>.py`` for ``<base>.<suffix>``."""
    base = ROOT / "portbench" / "metrics"
    path = base / f"{name}.py"
    if not path.exists():
        path = base / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# what the window served
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Run:
    model: dict
    family: str
    mix: object
    config: dict
    seconds: float
    served: list
    steps: list               # (prefilled, seconds, traced) a window step
    trace: object
    trace_bounds: tuple | None

    def in_window(self, t: float) -> bool:
        return 0.0 <= t <= self.seconds

    def step_seconds(self, prefilled: bool, untraced: bool = False
                     ) -> tuple[int, float]:
        """``(count, seconds)`` of the window's engine steps that admitted
        and prefilled requests (or that ran only the decode chunk); with
        ``untraced``, only the steps outside the traced slice."""
        d = [t for p, t, tr in self.steps
             if p == prefilled and not (untraced and tr)]
        return len(d), sum(d)

    def summary(self) -> str:
        """Where the window's time went, for the run's log."""
        n_p, s_p = self.step_seconds(True)
        n_c, s_c = self.step_seconds(False)
        pre = self.prefills(0.0, self.seconds)
        return (f"window {self.seconds:.4f} s: {n_p} steps that prefilled "
                f"{s_p:.4f} s, {n_c} chunk-only steps {s_c:.4f} s, "
                f"{len(pre)} prefills of {sum(pre)} prompt tokens")

    def end_to_end(self, name: str) -> float:
        w = self.seconds
        if name == "output_tok_s":
            n = sum(1 for s in self.served for t in s.t_tokens
                    if self.in_window(t))
            return n / w
        if name == "prompt_tok_s":
            n = sum(len(s.prompt) for s in self.served
                    if s.t_first is not None and self.in_window(s.t_first))
            return n / w
        if name == "ttft_p95_ms":
            vals = [(s.t_first - s.due) * 1e3 for s in self.served
                    if 0.0 <= s.due <= w and s.t_first is not None]
            return percentile(vals, 95) if vals else math.inf
        if name == "tpot_p95_ms":
            vals = [v for v in (tpot_ms(s.t_tokens, w) for s in self.served)
                    if v is not None]
            return percentile(vals, 95) if vals else math.inf
        raise KeyError(f"no end-to-end metric {name!r}")

    # ---- counts the per-layer readers use ----

    def decode_tokens(self, lo: float, hi: float):
        """``(ctx, stamp)`` of every decode token stamped in [lo, hi]:
        the keys its step attended (prompt plus earlier tokens)."""
        out = []
        for s in self.served:
            p = len(s.prompt)
            for i, t in enumerate(s.t_tokens):
                if i and lo <= t <= hi:
                    out.append((p + i, t))
        return out

    def prefills(self, lo: float, hi: float) -> list[int]:
        """Prompt lengths of the requests whose prefill ended in [lo, hi]."""
        return [len(s.prompt) for s in self.served
                if s.t_first is not None and lo <= s.t_first <= hi]

    def window_work(self) -> tuple[float, float]:
        """``(int8 ops, bf16 FLOP)`` of the tokens served in the window."""
        i_ops = f_ops = 0.0
        for ctx, _ in self.decode_tokens(0.0, self.seconds):
            a, b = cost.token_work(self.model, self.family, ctx)
            i_ops, f_ops = i_ops + a, f_ops + b
        for s in self.prefills(0.0, self.seconds):
            a, b = cost.prefill_work(self.model, self.family, s)
            i_ops, f_ops = i_ops + a, f_ops + b
        return i_ops, f_ops


def tpot_ms(stamps: list, window: float) -> float | None:
    """Mean time per output token over a request's tokens stamped inside
    the window: the span from its first in-window stamp to its last,
    over the tokens that came after the first stamp (a decode chunk's
    tokens share one stamp).  None with fewer than two stamps."""
    ts = [t for t in stamps if 0.0 <= t <= window]
    if not ts or ts[-1] == ts[0]:
        return None
    after = sum(1 for t in ts if t > ts[0])
    return (ts[-1] - ts[0]) / after * 1e3


# ---------------------------------------------------------------------------
# correct
# ---------------------------------------------------------------------------

def pick_sample(served: list, seed: int, tokens: int, requests: int) -> list:
    """Finished requests, drawn from the seed, the one with the most
    served tokens first, until the sample holds ``tokens`` served tokens
    and ``requests`` requests (or every finished request)."""
    done = [s for s in served if s.finished and s.tokens]
    if not done:
        return []
    done.sort(key=lambda s: s.index)
    longest = max(done, key=lambda s: (len(s.tokens), -s.index))
    rest = [s for s in done if s is not longest]
    rng = np.random.default_rng(generator_seed(seed, 3))
    rng.shuffle(rest)
    out = [longest]
    for s in rest:
        if sum(len(x.tokens) for x in out) >= tokens and len(out) >= requests:
            break
        out.append(s)
    return out


def logit_gaps(ref_logits: torch.Tensor, served_tokens) -> torch.Tensor:
    """At each position, the gap by which the served token's reference
    logit lies below the reference's best (0 where they agree)."""
    tok = torch.as_tensor(served_tokens, dtype=torch.long,
                          device=ref_logits.device)
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(1, tok[:, None])[:, 0]


# the numbers a cell's limits file may hold a limit for
GAP_NUMBERS = {"widest_logit_gap": lambda g: float(g.max()),
               "mean_logit_gap": lambda g: float(g.mean())}


def check(cell: Cell, run: Run, ref, seed: int, dev, log) -> dict:
    """The numbers compared, each with its limit: every request due in the
    window answered; every sampled stream whole (its full length, ids in
    the vocabulary); and the gaps of the sampled served tokens' reference
    logits below the reference's best that the cell's limits file names
    (the widest, or the mean over the sample).  Each number is printed
    beside its limit."""
    lim = cell.limits
    vocab = run.model["vocab_size"]
    unanswered = sum(1 for s in run.served
                     if 0.0 <= s.due <= run.seconds and s.t_first is None)
    sample = pick_sample(run.served, seed, int(lim["sample_tokens"]),
                         int(lim["sample_requests"]))
    bad = sum(1 for s in sample
              if len(s.tokens) != s.max_new_tokens
              or min(s.tokens) < 0 or max(s.tokens) >= vocab)
    values = {name: math.inf for name in GAP_NUMBERS}
    if sample and not bad:
        strict_f32()
        weights = make_weights(ref.weight_layout(run.model), seed, dev)
        seqs = [(torch.as_tensor(np.concatenate(
            [s.prompt, np.asarray(s.tokens[:-1], np.int32)]),
            dtype=torch.long, device=dev), len(s.prompt) - 1)
            for s in sample]
        logits = ref.logits(weights, run.model, seqs)
        gaps = torch.cat([logit_gaps(lg, s.tokens)
                          for lg, s in zip(logits, sample)])
        values = {name: f(gaps) for name, f in GAP_NUMBERS.items()}
        del weights, logits
    checked = {
        "unanswered_requests": {"value": unanswered, "limit": 0},
        "broken_streams": {"value": bad if sample else 1, "limit": 0},
    }
    for name, value in values.items():
        if name in lim:
            checked[name] = {"value": value, "limit": float(lim[name])}
        else:
            log(f"read {name}: {value} (not compared in this cell)")
    log(f"sampled {len(sample)} requests, "
        f"{sum(len(s.tokens) for s in sample)} served tokens")
    for k, c in checked.items():
        log(f"check {k}: {c['value']} (limit {c['limit']})")
    return checked
