"""Slot-based continuous-batching serve engine (port of
``repro.serve.engine``).

Each batch slot is an independent sequence sharing one model:

* **Prefill into a free slot.**  A new request is prefilled alone (batch
  1), its prompt zero-padded to the slot budget ``prefill_len``, and its
  caches are copied into the slot's row of the dense slab or, paged, into
  the pool pages its table row maps.  Pad-token rows are harmless: decode
  overwrites row ``p`` before any query attends to it.  A model with
  mamba mixers prefills at the exact prompt length instead (pad tokens
  would run through the recurrent state), so its prompts may exceed
  ``prefill_len`` and the prefill keeps one signature per distinct
  length; its per-slot state is copied to the slot's batch row.
* **Decode chunks.**  ``decode_chunk`` steps run back to back on the
  device at per-slot positions, each token the argmax (``temperature``
  0) or a draw from ``logits / temperature``.  Slots that are idle or
  finished keep running *frozen* on their last token and position (their
  rewrites land on already-written rows, or paged, on the trash page) -
  the batch composition stays what the reference engine runs, which
  matters because the w8a8 activation scale is taken over the whole
  batch.
* **Sampling** (``serve/sampling.py``).  Token ``i`` of request ``r`` is
  drawn under ``fold_in(fold_in(base_key, r.id), i)``, the reference's
  threefry keys computed bit for bit, never a generator state threaded
  through the loop: a draw depends on (request, stream index) alone, so
  sampled streams, like greedy ones, resume exactly after a preemption.
* **CUDA graphs.**  On the card the decode chunk, and with speculative
  decoding the draft and the verify, are captured once per signature
  (``_CapturedStage``) and replayed: the host copies the chunk's state
  into static buffers, replays one graph and reads the outputs back once
  (``capture_counts``).  Prefill, context prefill and the wave run
  eagerly.
* **Paged KV cache.**  ``alloc_mode="reserve"`` books a request's
  worst-case pages at admission and defers (backpressure) when the pool
  cannot cover them; ``alloc_mode="incremental"`` books the prompt pages
  plus the first decode page and tops a slot up before any chunk whose
  writes would cross its last page, so ``num_pages`` may sit below the
  sum of worst cases (overcommit).
* **Preemption.**  When a top-up finds the pool dry, or a strictly
  stronger arrival (aging-adjusted priority) finds no slot or no pages,
  the weakest runner is evicted: its pages go back to the pool, its table
  row to the trash page, and the request re-enters the queue carrying its
  tokens.  On re-admission the prompt is prefilled again and the stored
  tokens are teacher-forced back through the decode chunk, so a stream,
  greedy or sampled, resumes exactly as an uninterrupted one wherever
  rows do not depend on each other (``quant_mode="dense"``).
* **Host swap** (``swap_mode="host"``).  Eviction copies the victim's
  live pages to a ``HostPagePool`` (CPU tensors), and re-admission copies
  them back into fresh pages: a page copy instead of a re-prefill and a
  replay (a bit copy, so the stream resumes exactly).  A full host pool
  falls back to replay.
* **Prefix cache** (``prefix_cache=True``).  Page-aligned prompt chunks
  are indexed by hash chain (``PrefixCache``); an admission maps the
  cached pages read-only and prefills only the suffix against them
  (context prefill, one stage signature for miss, hit and copy-on-write).
  A fully covered prompt copies its shared tail page into a private one
  before writing its last row (COW).  Unpinned entries are reclaimed LRU
  leaf-first under pool pressure or above ``prefix_cache_pages``; with
  the host swap they are demoted to host pages and promoted back on a
  later hit.
* **Self-speculative decoding** (``spec_decode=True``).  The engine's
  quant knobs configure a *draft* (``spec_split``: the nibble datapath
  by default, its int8 weights prepared once at construction) that
  proposes ``spec_k`` tokens per slot by S = 1 decode steps; ONE dense
  ``decode_step`` over ``[token, drafts]`` (S = k + 1) verifies them
  (``spec_accept``).  Greedy, a draft is accepted where it equals the
  dense argmax, so the stream is the non-spec dense engine's; sampled,
  rejection sampling keeps the dense model's distribution.  Drafts and
  their distributions stay on the device and the round reads the host
  copy once.  Rejected tails roll back by ``PageTable.truncate``
  (incremental mode).  Prefill and verify run dense.
* **Wave prefill** (``prefill_chunk > 0`` or ``admit_group > 1``, paged).
  Admission books pages and parks the slot as a *prefilling* lane; each
  scheduler step advances up to ``admit_group`` lanes by one
  ``prefill_chunk``-token chunk through one ``decode_step`` over a (G, C)
  block at per-lane positions and table rows, before the decode chunk.
  The monolithic prefill is then never run.
* **Priority queue** with optional aging, as in the reference.
* **Families and the KV dtype.**  An encoder-decoder (whisper) and a VLM
  (phi-3-vision) are served text-only, as the reference's engine serves
  them: no frames and no patches, so the decoder's cross-attention does
  not run.  Under ``kv_cache_dtype="int8"`` the prefix cache and the wave
  prefill are refused (the reference's rules: a cached or earlier-chunk
  row would be attended dequantized where a solo prefill attends full
  precision); the host swap and speculative decoding run.

* **Tensor parallelism** (``tp`` / ``mesh_shape``).  One engine spans a
  ``(1, tp)`` mesh of devices (``launch.mesh``), which may repeat a
  device: its weights split over the "model" axis (``shard_params``:
  column- and row-parallel projections, GQA heads by kv heads and MLA
  heads by query heads, mamba mixers by SSD head, MoE experts by expert,
  vocab-parallel embedding and head), its paged pools or dense slab by
  kv heads and a mamba layer's state by SSD head (MLA's latent pools,
  and heads that do not divide ``tp``, whole, one per distinct device),
  and every stage runs all shards from this process with
  explicit collectives.  Greedy streams equal the single-device
  engine's (every integer projection is bit for bit the unsharded one,
  the expert rows are summed exactly), and every mechanism above keeps
  its rule; what runs replicated is reported (``tp_layout``).  When all
  shards share one card the captured stages are captured as before; over
  several cards they run eagerly.  Every quant mode shards (``dense``
  and ``qat`` within a rounding of tp=1: a row-parallel projection sums
  f32 partials).
* **A data axis** (``mesh_shape=(dp, tp)``, ``dp > 1``).  Entry ``(d,
  m)`` stores piece ``d`` of model shard ``m``'s weights along each
  leaf's FSDP dimension (``param_specs``; ``param_bytes`` per entry), and
  every stage gathers each layer's weights in data order onto the
  devices that use them, at use (``gathered_bytes_per_step``), on a
  shared card too.  Slot ``b`` lives on data row ``b // (B / dp)``
  (``slot_row``): its dense slab rows and mamba state sit there and the
  row computes its slots.  When ``dp`` does not divide the batch, the
  batch is not split: data row 0 holds and runs every slot, the other
  rows only store their weight pieces.  A batch-1 prefill runs on data
  row 0 and its caches are merged into the slot's row.  Paged pools are
  whole on every row, one copy per distinct device (a decode step's rows
  are mirrored into the other copies), so a prefix page, a swapped-in
  page or a copy-on-write page is the same on every row.  The rows meet
  where the unsplit batch does: the integer modes' per-tensor
  activation scale is the max over all rows, the MoE block (routing,
  capacity, drops) runs once over the whole batch on data row 0, and the
  final norm and head run over the gathered batch, so every integer
  mode keeps the single-device engine's streams and logits bit for bit
  (``dense`` within a rounding: a data row's dense products run at its
  own row count).  Capture across cards is refused as at tp > 1.  Data
  parallelism across engines is ``serve.router``: N engines (each on its
  own device slice when meshed) behind one admission queue.
"""

from __future__ import annotations

import dataclasses
import gc
import heapq
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, spec_split
from repro_torch.distributed.sharding import TP_ROADMAP, \
    check_tp_supported, shard_params, slot_rows, stored_bytes
from repro_torch.kernels.ops import add_launch_counts, launch_counts
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.transformer import (
    cache_bytes,
    decode_gather_bytes,
    copy_paged_cache_page,
    decode_step,
    extract_cache_pages,
    init_caches,
    init_shard_caches,
    insert_cache_pages,
    merge_slot_caches,
    merge_slot_paged_caches,
    prefill,
    prepare_params,
    scatter_prefill_paged_caches,
)
from repro_torch.serve.paging import (
    HostPagePool,
    PageAllocator,
    PageTable,
    PrefixCache,
    pages_needed,
)
from repro_torch.serve.sampling import (
    as_key,
    draft_sample,
    fold_in,
    sample,
    spec_accept,
)

__all__ = ["ServeConfig", "Request", "Engine", "make_serve_step"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch: int                        # concurrent decode slots
    max_len: int                      # per-slot cache budget (tokens)
    temperature: float = 0.0          # 0 = greedy; > 0 samples from
    #   logits / temperature under index-derived keys
    eos_id: int = -1                  # -1 = length-only stopping
    prefill_len: int = 0              # slot prompt budget (prompts are
    #   zero-padded to it); 0 = prefill at exact prompt length
    decode_chunk: int = 8             # decode steps per decode chunk
    priority_aging_s: float = 0.0     # seconds per +1 effective priority
    #   (queued and running requests alike: it also gates preemption)
    alloc_mode: str = "reserve"       # paged page accounting: "reserve"
    #   (worst case at admission) or "incremental" (live pages, top-up
    #   per chunk, evict-and-resume when the pool runs dry)
    # serving-time overrides of the model config; None keeps its value
    quant_mode: str | None = None
    quant_backend: str | None = None
    cache_mode: str | None = None
    page_size: int | None = None
    num_pages: int | None = None
    prefix_cache: bool = False        # paged only: share read-only prompt
    #   prefix pages across requests (hash-indexed page-aligned chunks,
    #   refcounted pages, COW on a fully covered prompt's tail page); an
    #   admission prefills only the uncached suffix
    prefix_cache_pages: int = 0       # cap on pages the prefix index pins
    #   (LRU reclaim after each insert, best effort); 0 = uncapped
    swap_mode: str = "off"            # "host": evicted slots' pages go to
    #   a host pool and come back by copy on resume (and the prefix cache
    #   gets a cold tier); "off" = replay-only resume.  Paged only
    host_pages: int = 0               # host pool pages; 0 = twice the
    #   device pool's allocatable pages
    spec_decode: bool = False         # self-speculative decoding:
    #   the quant knobs configure the draft, prefill and verify run dense
    spec_k: int = 4                   # draft tokens per speculation round
    spec_quant_mode: str | None = None  # draft mode; None = the engine's
    #   effective quant_mode (the deployment drafts for itself)
    prefill_chunk: int = 0            # > 0: prompts advance one chunk of
    #   this many tokens per scheduler step (the wave program); paged only
    admit_group: int = 1              # prefilling lanes a wave advances
    #   together; > 1 with prefill_chunk 0 makes prefill_len the chunk
    tp: int = 1                       # tensor-parallel width: the
    #   weights and the KV pools split over a (1, tp) mesh's "model" axis
    #   (``distributed.sharding``); 1 = no mesh, the single-device engine
    mesh_shape: tuple | None = None   # explicit (data, model) in-engine
    #   mesh shape; overrides ``tp`` (the two must agree when both are
    #   given).  None = derived from ``tp``


def _apply_overrides(cfg: ModelConfig, scfg: ServeConfig) -> ModelConfig:
    updates = {f: getattr(scfg, f) for f in ("quant_mode", "quant_backend",
                                             "cache_mode", "page_size",
                                             "num_pages")
               if getattr(scfg, f) is not None}
    return cfg.replace(**updates) if updates else cfg


def make_serve_step(cfg: ModelConfig, scfg: ServeConfig) -> Callable:
    """``serve_step(params, caches, token, index, rng) -> (next_token,
    caches)``: one decode step over a dense cache, greedy or sampled
    (port of the reference's ``make_serve_step``).  ``index`` is a scalar
    or (B,) per-slot positions; ``rng`` is one key (an int seed or a JAX
    key's two words) whose noise covers the whole (B, V) batch, as the
    reference's unbatched ``categorical`` draws it.  Paged caches need a
    page table per step, which this entry point does not carry: use
    ``Engine``."""
    cfg = _apply_overrides(cfg, scfg)
    if cfg.cache_mode == "paged":
        raise ValueError("make_serve_step does not support "
                         "cache_mode='paged' (no page-table plumbing); "
                         "use Engine for the paged cache")

    def serve_step(params, caches, token, index, rng):
        logits, caches = decode_step(params, cfg, token, caches, index)
        key = as_key(rng).to(logits.device)
        return sample(logits[:, -1], key, scfg.temperature)[:, None], caches

    return serve_step


@dataclasses.dataclass
class Request:
    """One generation request (host-side bookkeeping)."""
    id: int
    prompt: np.ndarray                # (S,) int32
    max_new_tokens: int
    arrival: float = 0.0              # seconds after Engine.run() starts
    priority: int = 0                 # higher = served first
    tokens: list = dataclasses.field(default_factory=list)
    t_first: float = -1.0             # time to first token (from run t0)
    t_done: float = -1.0
    t_tokens: list = dataclasses.field(default_factory=list)  # emission
    #   times; replayed tokens keep their original stamps
    cache_rows: int = 0               # peak cache rows held for the request
    truncated: bool = False           # max_new_tokens cut to fit max_len
    preemptions: int = 0              # times evicted mid-stream and resumed
    chunk_keys: list | None = None    # memoized hash chain of the prompt's
    #   page-aligned chunks (prefix cache)
    swap_pages: list | None = None    # host pages holding the swapped-out
    #   rows while the request waits; None = resume replays
    swap_rows: int = 0                # rows captured at swap-out (the
    #   slot's decode position); later tokens re-enter the forcing lane


class _PriorityQueue:
    """Arrival-gated max-priority queue with lazy aging, keyed
    ``(-priority, arrival, seq)`` (the reference's ordering)."""

    def __init__(self, aging_s: float = 0.0):
        self.aging_s = aging_s
        self._heap: list[tuple] = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, req: Request) -> None:
        heapq.heappush(self._heap, (-req.priority, req.arrival, self._seq,
                                    req))
        self._seq += 1

    def effective(self, req: Request, now: float) -> int:
        """Aging-adjusted priority (the same measure ranks runners for
        eviction, so equal-priority requests never evict each other)."""
        if self.aging_s <= 0:
            return req.priority
        return req.priority + int(max(0.0, now - req.arrival)
                                  / self.aging_s)

    def next_arrival(self) -> float | None:
        return min((e[1] for e in self._heap), default=None)

    def _best_index(self, now: float) -> int | None:
        if not self._heap:
            return None
        if self.aging_s <= 0 and self._heap[0][1] <= now:
            return 0
        best_i, best_key = None, None
        for i, (_, arr, seq, req) in enumerate(self._heap):
            if arr > now:
                continue
            key = (-self.effective(req, now), arr, seq)
            if best_key is None or key < best_key:
                best_i, best_key = i, key
        return best_i

    def peek(self, now: float) -> Request | None:
        i = self._best_index(now)
        return None if i is None else self._heap[i][3]

    def pop(self, now: float, admit: Callable[[Request], bool] = None):
        """Remove and return the best arrived request, or ``None``;
        ``admit`` vetoes the winner without removing it."""
        best_i = self._best_index(now)
        if best_i is None:
            return None
        req = self._heap[best_i][3]
        if admit is not None and not admit(req):
            return None
        self._heap[best_i] = self._heap[-1]
        self._heap.pop()
        heapq.heapify(self._heap)
        return req


class _StageCounter:
    """Distinct call signatures of one engine stage: the shape and dtype
    of each tensor or array argument, the type name of any other.  Stands
    in for the reference's ``_CountingJit``: a stage that keeps one
    signature is one a CUDA graph captured once can replay, so the count
    pins the same contract: a warm engine reads ``{"prefill": 1,
    "decode_chunk": 1}`` across request mixes, page recyclings and
    preemptions (given a fixed ``prefill_len``).

    ``fn`` is the stage's body, which takes the recorded arguments and
    runs the stage's device work; the recorded signatures are its replay
    surface (``signatures``, ``rerun``), the calibration's counterpart of
    the reference's ``abstract_args``.  The body writes the engine's
    caches in place, so a rerun leaves stale rows behind: calibrate a
    drained engine and ``reset`` it afterwards."""

    # a non-tensor argument keeps only its type in the signature; a stage
    # body takes such arguments as data (an index, a slot), never as a
    # shape, so a stand-in value runs the same work
    _STANDIN = {"int": 0, "float": 0.0, "bool": False, "NoneType": None}

    def __init__(self, fn=None, device: torch.device | None = None):
        self._keys: set = set()
        self._fn = fn
        self.device = device

    def record(self, *args) -> tuple:
        key = tuple(
            (tuple(a.shape), str(a.dtype))
            if isinstance(a, (torch.Tensor, np.ndarray))
            else (type(a).__name__,) for a in args)
        self._keys.add(key)
        return key

    @property
    def count(self) -> int:
        return len(self._keys)

    @property
    def signatures(self) -> tuple:
        """The distinct signatures recorded so far, in a fixed order."""
        return tuple(sorted(self._keys, key=repr))

    @property
    def body(self):
        """The stage's body: what ``rerun`` runs (a captured stage's replay
        runs no Python, so the static walk calls this)."""
        return self._fn

    def abstract_args(self, signature) -> list:
        """Zero tensors of ``signature`` on the stage's device, stand-ins
        for its non-tensor arguments (the reference's
        ``_CountingJit.abstract_args``)."""
        args = []
        for leaf in signature:
            if len(leaf) == 1:
                args.append(self._STANDIN[leaf[0]])
                continue
            shape, dtype = leaf
            dtype = (getattr(torch, dtype[len("torch."):])
                     if dtype.startswith("torch.")
                     else torch.from_numpy(np.zeros(0, dtype)).dtype)
            args.append(torch.zeros(shape, dtype=dtype, device=self.device))
        return args

    def rerun(self, signature):
        """Run the stage's body once on :meth:`abstract_args` of
        ``signature``: the calibration's timed dispatch.  Returns the
        body's outputs."""
        return self._fn(*self.abstract_args(signature))


@dataclasses.dataclass
class _StageBuffers:
    """One signature of a ``_CapturedStage``: its static inputs, and once
    captured, its graph, outputs and kernel launches per replay."""
    args: list                  # device buffers (array inputs) or tensors
    staging: list               # host buffer per array input, else None
    graph: object = None        # torch.cuda.CUDAGraph
    outputs: object = None
    launches: list | None = None


class _CapturedStage(_StageCounter):
    """An engine stage run from static device buffers and, with
    ``capture``, replayed from CUDA graphs: the port's ``_CountingJit``.
    ``fn`` takes the stage's inputs as tensors and returns its outputs on
    the device, reading nothing back to the host.

    A call records its signature, copies each numpy input into that
    signature's device buffer (through pinned staging on the card, without
    blocking) and passes tensor inputs (an earlier captured stage's
    outputs) as they are.  With ``capture``, the first call of a
    signature runs ``fn`` once eagerly on a side stream (the warm-up
    ``torch.cuda.graphs`` asks for) and captures it, and the call returns
    the warm-up's result in the graph's output tensors; later calls
    replay the graph.  So a call runs the stage once, captured or not.
    Otherwise ``fn`` runs eagerly on the buffers.
    The caller reads the outputs back: a stage's one host read, which also
    orders the next call's staging writes after this call's copies.

    A graph holds raw pointers, so the weights, the caches and these
    buffers keep their storage for the engine's life (the caches are
    written in place, never rebound).  The kernel wrappers count their
    launches in Python, which a replay does not run: the counts a capture
    recorded are added on every replay and withdrawn for the capture
    itself, which launches nothing."""

    def __init__(self, fn, device: torch.device, capture: bool):
        super().__init__(fn, device)
        self._capture = capture
        self._buffers: dict[tuple, _StageBuffers] = {}

    @property
    def captures(self) -> int:
        """CUDA graphs captured (one per signature on the card, else 0)."""
        return sum(b.graph is not None for b in self._buffers.values())

    def rerun(self, signature):
        """Replay ``signature``'s graph on its static buffers (eagerly: run
        the body on them), as a warm call does after its staging copies;
        returns the outputs."""
        st = self._buffers[signature]
        if st.graph is None:
            return self._fn(*st.args)
        st.graph.replay()
        add_launch_counts(st.launches)
        return st.outputs

    def _new_buffers(self, args) -> _StageBuffers:
        pin = self.device.type == "cuda"
        bufs, staging = [], []
        for a in args:
            if isinstance(a, np.ndarray):
                host = torch.from_numpy(np.zeros(a.shape, a.dtype))
                buf = host.to(self.device)
                staging.append(host.pin_memory() if pin else buf)
            else:
                buf = a
                staging.append(None)
            bufs.append(buf)
        return _StageBuffers(bufs, staging)

    def __call__(self, *args):
        key = self.record(*args)
        st = self._buffers.get(key)
        if st is None:
            st = self._buffers[key] = self._new_buffers(args)
        for i, a in enumerate(args):
            host = st.staging[i]
            if host is not None:
                host.numpy()[...] = a
                if host is not st.args[i]:
                    st.args[i].copy_(host, non_blocking=True)
            elif not self._capture:
                st.args[i] = a
            elif a is not st.args[i]:
                raise RuntimeError("a captured stage's tensor input is not "
                                   "the tensor it was captured with")
        if not self._capture:
            return self._fn(*st.args)
        if st.graph is None:
            self._capture_graph(st)
        else:
            st.graph.replay()
            add_launch_counts(st.launches)
        return st.outputs

    def _capture_graph(self, st: _StageBuffers) -> None:
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            warm = self._fn(*st.args)       # launches for real, counted
        stream.wait_stream(side)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        # a dropped engine's graphs wait in a reference cycle (its stages
        # hold its bound methods) for the cyclic collector; freed while a
        # stream captures, they invalidate the capture.  So collect first
        # and keep the collector off until the capture ends.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                st.outputs = self._fn(*st.args)
        finally:
            if collecting:
                gc.enable()
        st.launches = [a - b for a, b in zip(launch_counts(), before)]
        add_launch_counts([-n for n in st.launches])
        st.graph = graph
        outs = st.outputs if isinstance(st.outputs, tuple) else (st.outputs,)
        for out, w in zip(outs, warm if isinstance(warm, tuple) else (warm,)):
            out.copy_(w)


class Engine:
    """Continuous-batching engine (greedy or sampled) over a dense or
    paged KV cache, with incremental page allocation, evict-and-resume
    preemption, the prefix cache, the host swap tier, self-speculative
    decoding and the wave prefill.
    ``params`` come from ``model_init`` or ``load_jax_params`` on the
    same device; ``device`` defaults to CUDA and raises without a card.
    Under ``tp`` / ``mesh_shape`` the mesh takes ``devices`` (entries may
    repeat: shards then share a device), by default every visible card,
    or on ``device="cpu"`` the CPU once; ``self.device`` is shard 0's and
    ``params`` are sharded onto the mesh (the caller's tree is not
    changed).  ``capture`` replays the decode chunk (draft and verify
    under ``spec_decode``) from CUDA graphs: ``None`` captures on CUDA
    (when every shard shares one card) and runs eagerly otherwise;
    ``False`` runs eagerly on the card (the eager side of a comparison).
    ``True`` is kept apart from ``None`` so that asking for graphs where
    they are not taken raises instead of running eagerly: the hot path
    has no silent fallback."""

    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig, *,
                 device="cuda", devices=None, capture: bool | None = None):
        self.scfg = scfg
        self._mesh = self._build_mesh(cfg, device, devices)
        if self._mesh is not None:
            self.device = self._mesh.model_devices[0]
        elif devices is not None:
            self.device = resolve_device(list(devices)[0])
        else:
            self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        if capture and not on_card:
            raise ValueError("capture=True needs a CUDA device: CUDA "
                             "graphs replay on the card only")
        several = self._mesh is not None and len(
            self._mesh.distinct_devices) > 1
        if capture and several:
            raise NotImplementedError(
                f"capture=True over a mesh of several cards: a CUDA graph "
                f"is captured on one card ({TP_ROADMAP}: capture across "
                f"cards)")
        self._capture = (on_card and not several if capture is None
                         else bool(capture))
        if scfg.alloc_mode not in ("reserve", "incremental"):
            raise ValueError(f"alloc_mode must be 'reserve' or "
                             f"'incremental', got {scfg.alloc_mode!r}")
        if scfg.prefill_len > scfg.max_len:
            raise ValueError(f"prefill_len {scfg.prefill_len} exceeds "
                             f"max_len {scfg.max_len}")
        if scfg.decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got "
                             f"{scfg.decode_chunk}")
        self.cfg = _apply_overrides(cfg, scfg)
        self._paged = self.cfg.cache_mode == "paged"
        self._incremental = scfg.alloc_mode == "incremental"
        if self._incremental and not self._paged:
            raise ValueError("alloc_mode='incremental' requires "
                             "cache_mode='paged' (the dense slab has no "
                             "pages to grow)")
        if self._paged:
            ps = self.cfg.page_size
            if ps < 1:
                raise ValueError(f"page_size must be >= 1, got {ps}")
            if scfg.max_len % ps:
                raise ValueError(f"max_len {scfg.max_len} must be a "
                                 f"multiple of page_size {ps}")
            self._page_size = ps
            self._max_pages = scfg.max_len // ps
            self._num_pages = (self.cfg.num_pages
                               or scfg.batch * self._max_pages + 1)
            self.cfg = self.cfg.replace(num_pages=self._num_pages)
        elif self.cfg.cache_mode != "dense":
            raise ValueError(f"cache_mode must be 'dense' or 'paged', got "
                             f"{self.cfg.cache_mode!r}")
        self._swap = scfg.swap_mode == "host"
        self._has_mamba = any(s.mixer == "mamba"
                              for s in self.cfg.layer_specs)
        self._validate_mechanisms()
        self._spec = scfg.spec_decode
        self._draft_cfg = None
        if self._spec:
            # the quant knobs configure the draft; prefill and verify run
            # dense.  The draft's int8 weights are prepared once, beside
            # the bf16 ``w`` the verifier reads
            self._draft_cfg, self.cfg = spec_split(self.cfg,
                                                   scfg.spec_quant_mode)
        self._wave = scfg.prefill_chunk > 0 or scfg.admit_group > 1
        if self._wave:
            self._wave_chunk = scfg.prefill_chunk or scfg.prefill_len
            self._wave_group = scfg.admit_group
        if self._mesh is None:
            if self._spec:
                prepare_params(params, self._draft_cfg)
            self.params = params
            self._caches = init_caches(self.cfg, scfg.batch, scfg.max_len,
                                       device=self.device)
        else:
            # quantized for the draft's mode where there is one (the
            # verifier reads the bf16 ``w`` beside it)
            self.params = shard_params(params, self._draft_cfg or self.cfg,
                                       self._mesh)
            self._caches = init_shard_caches(self.cfg, scfg.batch,
                                             scfg.max_len, self.params)
        self._stages = {
            "prefill": _StageCounter(self._prefix_body if scfg.prefix_cache
                                     else self._prefill_body, self.device),
            "prefill_chunk": _StageCounter(self._wave_body, self.device)}
        for name, fn in (("decode_chunk", self._chunk_body),
                         ("draft", self._draft_body),
                         ("verify", self._verify_body)):
            self._stages[name] = _CapturedStage(fn, self.device,
                                                self._capture)
        self._next_id = 0
        self.reset()

    # ------------------------------------------------------------------
    # the mesh
    # ------------------------------------------------------------------

    def _build_mesh(self, cfg, device, devices):
        """The in-engine ``(data, model)`` mesh, or None for the
        single-device engine (the reference's checks and messages)."""
        scfg = self.scfg
        if scfg.tp < 1:
            raise ValueError(f"tp must be >= 1, got {scfg.tp}")
        shape = scfg.mesh_shape
        if shape is not None:
            shape = tuple(int(x) for x in shape)
            if len(shape) != 2:
                raise ValueError(f"mesh_shape must be (data, model), got "
                                 f"{scfg.mesh_shape!r}")
            if scfg.tp != 1 and shape[1] != scfg.tp:
                raise ValueError(f"mesh_shape {shape} disagrees with "
                                 f"tp={scfg.tp} on the model axis")
        elif scfg.tp > 1:
            shape = (1, scfg.tp)
        if shape is None or shape == (1, 1):
            return None
        check_tp_supported(_apply_overrides(cfg, scfg), shape[1], shape[0])
        if devices is None and resolve_device(device).type == "cpu":
            devices = ["cpu"]
        return make_local_mesh(dp=shape[0], tp=shape[1], devices=devices)

    @property
    def mesh_shape(self) -> tuple:
        """(data, model) shape of the in-engine mesh; (1, 1) unmeshed."""
        if self._mesh is None:
            return (1, 1)
        return (self._mesh.shape["data"], self._mesh.shape["model"])

    @property
    def tp_layout(self):
        """How the weights split over the model shards
        (``distributed.sharding.TPLayout``: which blocks split and which
        run replicated), None unmeshed."""
        return None if self._mesh is None else self.params.layout

    @property
    def device_count(self) -> int:
        """Devices this engine's stages span, counted as mesh entries (1
        without a mesh): a mesh that repeats a card counts it per entry,
        as the reference's forced host devices count."""
        return 1 if self._mesh is None else self._mesh.size

    def slot_row(self, slot: int) -> int:
        """The data row that holds and runs ``slot``: ``slot // (B /
        dp)`` where ``dp`` divides the batch ``B``, else 0."""
        if self._mesh is None:
            return 0
        rows = slot_rows(self.scfg.batch, self._mesh.shape["data"])
        return slot // (self.scfg.batch // rows)

    @property
    def param_bytes(self) -> list:
        """Parameter bytes each mesh entry stores (every leaf it holds,
        the int8 copies and the bf16 weights beside them), row-major;
        one entry without a mesh."""
        return stored_bytes([self.params] if self._mesh is None
                            else self.params.trees)

    @property
    def gathered_bytes_per_step(self) -> int:
        """Weight bytes the FSDP gather writes in one decode step at this
        engine's batch (0 without a data axis)."""
        return decode_gather_bytes(self.params, self.cfg, self.scfg.batch)

    def _validate_mechanisms(self) -> None:
        """The config rules of the prefix cache, the host swap,
        speculative decoding and the wave prefill (the reference's checks
        and messages)."""
        scfg = self.scfg
        if scfg.swap_mode not in ("off", "host"):
            raise ValueError(f"swap_mode must be 'off' or 'host', got "
                             f"{scfg.swap_mode!r}")
        if scfg.host_pages < 0:
            raise ValueError(f"host_pages must be >= 0, got "
                             f"{scfg.host_pages}")
        if scfg.prefix_cache_pages < 0:
            raise ValueError(f"prefix_cache_pages must be >= 0, got "
                             f"{scfg.prefix_cache_pages}")
        if scfg.prefix_cache:
            if not self._paged:
                raise ValueError("prefix_cache=True requires "
                                 "cache_mode='paged' (the dense slab has "
                                 "no pages to share)")
            if self._has_mamba:
                raise ValueError("prefix_cache=True is incompatible with "
                                 "mamba-mixer models: SSM state is "
                                 "sequential and cannot be composed from "
                                 "a cached prefix")
            if self.cfg.kv_cache_dtype == "int8":
                raise ValueError("prefix_cache=True is incompatible with "
                                 "kv_cache_dtype='int8': cached rows are "
                                 "attended dequantized while a solo "
                                 "prefill attends full precision, "
                                 "breaking the bit-match contract")
        if self._swap:
            if not self._paged:
                raise ValueError("swap_mode='host' requires "
                                 "cache_mode='paged': the dense slab has "
                                 "no pages to swap")
            if self._has_mamba:
                raise ValueError("swap_mode='host' is incompatible with "
                                 "mamba-mixer models: recurrent state is "
                                 "per-slot, not paged")
        if scfg.spec_decode:
            if scfg.spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {scfg.spec_k}")
            if self._has_mamba:
                raise ValueError("spec_decode=True is incompatible with "
                                 "mamba-mixer models: the multi-token "
                                 "verify forward needs position-indexed "
                                 "caches")
        if scfg.prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, got "
                             f"{scfg.prefill_chunk}")
        if scfg.admit_group < 1:
            raise ValueError(f"admit_group must be >= 1, got "
                             f"{scfg.admit_group}")
        if scfg.prefill_chunk > 0 or scfg.admit_group > 1:
            if not self._paged:
                raise ValueError("prefill_chunk/admit_group require "
                                 "cache_mode='paged': the wave program "
                                 "writes prompt rows through page-table "
                                 "rows, not a dense slab")
            if self._has_mamba:
                raise ValueError("prefill_chunk/admit_group are "
                                 "incompatible with mamba-mixer models: "
                                 "chunk boundaries are cache positions, "
                                 "and recurrent state has none")
            if self.cfg.kv_cache_dtype == "int8":
                raise ValueError("prefill_chunk/admit_group are "
                                 "incompatible with kv_cache_dtype="
                                 "'int8': earlier chunks are attended "
                                 "dequantized while a monolithic "
                                 "prefill attends full precision, "
                                 "breaking the bit-match contract")
            if (scfg.prefill_chunk or scfg.prefill_len) < 1:
                raise ValueError("admit_group > 1 with prefill_chunk=0 "
                                 "needs prefill_len > 0 to serve as the "
                                 "wave width")

    # ------------------------------------------------------------------
    # host-side state
    # ------------------------------------------------------------------

    def reset(self, rng=None) -> None:
        """Clear queue, slots and counters (cache buffers, stage counters
        and captured graphs are kept: stale rows are never attended before
        their next owner rewrites them).  ``rng`` sets the base key of
        this run's sampled streams (an int seed or a JAX key's two uint32
        words; default seed 0, as the reference's ``PRNGKey(0)``): request
        ``r``'s key is ``fold_in(base, r.id)``, and its token ``i`` is
        drawn under ``fold_in(request_key, i)``."""
        b = self.scfg.batch
        self._base_key = as_key(0 if rng is None else rng)
        self._req_keys: dict[int, np.ndarray] = {}
        self._slot_keys = np.zeros((b, 2), np.int64)
        self._queue = _PriorityQueue(self.scfg.priority_aging_s)
        self._slots: list[Request | None] = [None] * b
        self._token = np.zeros((b, 1), np.int32)
        self._positions = np.zeros((b,), np.int32)
        self._active = np.zeros((b,), bool)
        self._remaining = np.zeros((b,), np.int32)
        self._finished: dict[int, Request] = {}
        # teacher-forcing lanes: a resumed request's stored tokens, waiting
        # to be replayed through the decode chunk
        self._slot_forced: list[list[int]] = [[] for _ in range(b)]
        self.prefill_tokens = 0           # tokens run through prefill
        self.decode_chunks = 0
        self.preemptions = 0
        self._stat_samples = 0
        self._stat_running = 0
        self._stat_in_use = 0
        # prefix cache: admissions that hit, prompt tokens served from
        # cached pages against all prompt tokens admitted, COW copies
        self._prefix_hits = 0
        self._cached_prompt_tokens = 0
        self._total_prompt_tokens = 0
        self.cow_copies = 0
        self.prefix_capacity_reclaims = 0
        self.prefix_demotions = 0
        self.prefix_cold_hits = 0
        # host swap: events, and decode rows restored instead of replayed
        self.swap_outs = 0
        self.swap_ins = 0
        self.replay_steps_saved = 0
        # speculative decoding: proposed / accepted count fresh drafts
        # only, up to each round's emission clamp (replayed tokens are
        # committed history, force-accepted)
        self.spec_rounds = 0
        self.spec_slot_rounds = 0
        self.spec_tokens = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_rollback_pages = 0
        # wave prefill: dispatches, each lane's next prompt position (-1 =
        # not prefilling) and its pending COW pair (applied with the
        # lane's final chunk)
        self.prefill_waves = 0
        self._prefill_next = np.full((b,), -1, np.int64)
        self._slot_cow: list[tuple[int, int]] = [(0, 0)] * b
        self._t0 = time.perf_counter()
        self.prefix_cache: PrefixCache | None = None
        self.host_pool: HostPagePool | None = None
        if self._paged:
            self.allocator = PageAllocator(self._num_pages, reserved=1)
            self.page_table = PageTable(b, self._max_pages, trash_page=0,
                                        num_pages=self._num_pages,
                                        reserved=1)
            self._slot_pages: list[list[int] | None] = [None] * b
            if self._swap:
                self.host_pool = HostPagePool(
                    self.scfg.host_pages or 2 * self.allocator.capacity)
            if self.scfg.prefix_cache:
                self.prefix_cache = PrefixCache(self._page_size,
                                                self.allocator)
                if self.host_pool is not None:
                    self.prefix_cache.attach_cold_tier(
                        self._demote_page,
                        lambda hid: self.host_pool.free([hid]))

    @property
    def compile_counts(self) -> dict:
        """Distinct call signatures per stage (see ``_StageCounter``); a
        stage a mode never runs reads 0.  A warm engine reads
        ``{"prefill": 1, "decode_chunk": 1}``; with ``spec_decode``
        ``{"prefill": 1, "decode_chunk": 0, "draft": 1, "verify": 1}``;
        in wave mode ``{"prefill": 0, "decode_chunk": 1, "prefill_chunk":
        1}``, and both together ``{"prefill": 0, "decode_chunk": 0,
        "prefill_chunk": 1, "draft": 1, "verify": 1}`` (the reference's
        keys per mode).  On a model with mamba mixers the prefill counts
        one signature per distinct prompt length (exact-length
        prefills), as the reference's ``_CountingJit`` does."""
        names = ["prefill", "decode_chunk"]
        if self._wave:
            names.append("prefill_chunk")
        if self._spec:
            names += ["draft", "verify"]
        return {name: self._stages[name].count for name in names}

    def stage_programs(self) -> dict:
        """The stages this engine's mode runs, ``{name: stage}``, under the
        reference's keys: ``prefill`` (``prefill_chunk`` in wave mode), then
        ``decode_chunk`` (``draft`` and ``verify`` under ``spec_decode``).
        Each stage's ``signatures`` and ``rerun`` are the calibration's
        replay surface (``repro_torch.capacity.calibrate``)."""
        names = ["prefill_chunk" if self._wave else "prefill"]
        names += ["draft", "verify"] if self._spec else ["decode_chunk"]
        return {name: self._stages[name] for name in names}

    @property
    def capture_counts(self) -> dict:
        """CUDA graphs captured per captured stage (one per signature): a
        warm engine on the card reads ``{"decode_chunk": 1}``, with
        ``spec_decode`` ``{"decode_chunk": 0, "draft": 1, "verify": 1}``;
        every stage reads 0 on the CPU and with ``capture=False``."""
        names = ["decode_chunk"] + (["draft", "verify"] if self._spec
                                    else [])
        return {name: self._stages[name].captures for name in names}

    @property
    def stats(self) -> dict:
        """Scheduling counters since the last ``reset``, under the
        reference's keys: ``preemptions``, ``occupancy`` (mean fraction of
        allocatable pool pages in use, sampled at each decode chunk; 0 in
        dense mode), ``concurrency`` (mean admitted requests per chunk),
        ``pool_pages``; the prefix cache's ``prefix_hits``,
        ``prefix_hit_rate`` (prompt tokens served from cached pages over
        prompt tokens admitted), ``prefill_tokens`` (tokens run through
        prefill), ``cow_copies``, ``prefix_pages`` (pages the index pins);
        the host swap's ``swap_out`` / ``swap_in`` (events),
        ``replay_steps_saved`` (decode rows restored by copy),
        ``host_pages`` (host pool size) and the cold tier's
        ``prefix_cold_pages``, ``prefix_cold_hits`` (pages promoted) and
        ``prefix_demotions``; speculative decoding's ``spec_rounds``,
        ``acceptance_rate`` (fresh drafts accepted over proposed),
        ``tokens_per_step`` (tokens emitted per slot-round) and
        ``spec_rollback_pages``; the wave's ``prefill_waves``."""
        n = max(1, self._stat_samples)
        occ = (self._stat_in_use / (n * self.allocator.capacity)
               if self._paged else 0.0)
        pc, hp = self.prefix_cache, self.host_pool
        return {"preemptions": self.preemptions,
                "occupancy": occ,
                "concurrency": self._stat_running / n,
                "pool_pages": self.allocator.num_pages if self._paged else 0,
                "prefix_hits": self._prefix_hits,
                "prefix_hit_rate": (self._cached_prompt_tokens
                                    / max(1, self._total_prompt_tokens)),
                "prefill_tokens": self.prefill_tokens,
                "cow_copies": self.cow_copies,
                "prefix_pages": len(pc) if pc is not None else 0,
                "spec_rounds": self.spec_rounds,
                "acceptance_rate": (self.spec_accepted
                                    / max(1, self.spec_proposed)),
                "tokens_per_step": (self.spec_tokens
                                    / max(1, self.spec_slot_rounds)),
                "spec_rollback_pages": self.spec_rollback_pages,
                "prefill_waves": self.prefill_waves,
                "decode_chunks": self.decode_chunks,
                "swap_out": self.swap_outs,
                "swap_in": self.swap_ins,
                "replay_steps_saved": self.replay_steps_saved,
                "host_pages": hp.capacity if hp is not None else 0,
                "prefix_cold_pages": pc.cold_size if pc is not None else 0,
                "prefix_cold_hits": self.prefix_cold_hits,
                "prefix_demotions": self.prefix_demotions}

    @property
    def cache_token_bytes(self) -> int:
        """KV-cache bytes per cached token, summed over every layer's
        sequence leaves (K and V, with their f32 scales under the int8 KV
        cache, or MLA's latents and rope keys; a mamba layer's per-slot
        state holds no token's row), in the unsharded layout under a mesh
        (``transformer.cache_bytes``); times a request's ``cache_rows`` is
        its cache footprint."""
        rows = (self._num_pages * self._page_size if self._paged
                else self.scfg.batch * self.scfg.max_len)
        return cache_bytes(self._caches) // rows

    def _pages_for(self, req: Request) -> int:
        """Worst-case pages: prompt rows plus one row per decode step but
        the last (whose token is sampled, never written back)."""
        return pages_needed(len(req.prompt) + req.max_new_tokens - 1,
                            self._page_size)

    def _alloc_pages_for(self, req: Request) -> int:
        """Pages booked at admission: the worst case in reserve mode; the
        prompt pages plus the first decode page in incremental mode (the
        rest arrive by top-up, for resumed requests while they replay).  A
        swapped-out request in incremental mode books its ``swap_rows``
        plus the next decode row."""
        if not self._incremental:
            return self._pages_for(req)
        if req.swap_pages is not None:
            return pages_needed(req.swap_rows + 1, self._page_size)
        rows = len(req.prompt) + (1 if req.max_new_tokens > 1 else 0)
        return pages_needed(rows, self._page_size)

    # ------------------------------------------------------------------
    # host tier and prefix index
    # ------------------------------------------------------------------

    def _demote_page(self, page: int) -> int | None:
        """Cold-tier hook: copy a reclaimed device page into a fresh host
        page and return its id (``None`` when the host pool is full)."""
        hids = self.host_pool.alloc(1)
        if hids is None:
            return None
        self.host_pool.store(hids[0], extract_cache_pages(
            self._caches, [page], pad_to=self._max_pages)[0])
        self.prefix_demotions += 1
        return hids[0]

    def _promote_cold(self, keys: list, pages: list) -> None:
        """Load a run of cold prefix chunks into fresh device pages (mapped
        right behind the hot prefix, so rows keep their positions)."""
        hids = self.prefix_cache.pop_cold(keys)
        insert_cache_pages(self._caches, pages,
                           [self.host_pool.load(h) for h in hids],
                           pad_to=self._max_pages)
        self.host_pool.free(hids)
        self.prefix_cold_hits += len(pages)

    def _prefix_insert(self, keys: list, pages: list) -> None:
        """Index a prompt's chunk chain, then reclaim down to the
        ``prefix_cache_pages`` cap (best effort: pages live slots map
        are pinned)."""
        self.prefix_cache.insert(keys, pages)
        cap = self.scfg.prefix_cache_pages
        if cap and len(self.prefix_cache) > cap:
            self.prefix_capacity_reclaims += self.prefix_cache.reclaim(
                len(self.prefix_cache) - cap)

    def _prefix_plan(self, req: Request):
        """``(keys, shared_pages, cow_src, start, n_cold)`` for the longest
        usable cached prefix of ``req.prompt``; read-only (``_can_admit``
        probes it, ``_prefix_place`` re-derives it and acquires).  A fully
        covered prompt shares every page but the tail, which becomes the
        COW source: its last token must still run for its logits.  Cold
        chunks extend the hot run, except a cold tail that would cover
        the prompt (cheaper to re-prefill than to promote and copy)."""
        if req.chunk_keys is None:
            req.chunk_keys = self.prefix_cache.chunk_keys(req.prompt)
        keys = req.chunk_keys
        hits = self.prefix_cache.match(keys)
        p_len = int(req.prompt.size)
        if hits and len(hits) * self._page_size == p_len:
            return keys, hits[:-1], hits[-1], p_len - 1, 0
        n_cold = self.prefix_cache.match_cold(keys, len(hits))
        if n_cold and (len(hits) + n_cold) * self._page_size == p_len:
            n_cold -= 1
        start = (len(hits) + n_cold) * self._page_size
        return keys, hits, 0, start, n_cold

    def _admission_pages(self, req: Request) -> int:
        """Fresh pages an admission allocates: the booked count minus the
        pages served from the prefix cache (a swapped-out request restores
        its own pages, so no plan applies)."""
        booked = self._alloc_pages_for(req)
        if self.prefix_cache is None or req.swap_pages is not None:
            return booked
        return booked - len(self._prefix_plan(req)[1])

    def validate(self, prompt, max_new_tokens: int):
        """Returns ``(prompt, clamped_new_tokens, truncated)`` or raises."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        scfg = self.scfg
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        if prompt.size == 0 or prompt.size >= scfg.max_len:
            raise ValueError(f"prompt length {prompt.size} must be in "
                             f"[1, max_len={scfg.max_len})")
        if scfg.prefill_len and prompt.size > scfg.prefill_len \
                and not self._has_mamba:
            raise ValueError(f"prompt length {prompt.size} exceeds the "
                             f"slot budget prefill_len={scfg.prefill_len}")
        budget = scfg.max_len - prompt.size
        clamped = min(max_new_tokens, budget)
        if self._paged:
            need = pages_needed(prompt.size + clamped - 1, self._page_size)
            if need > self.allocator.capacity:
                raise ValueError(
                    f"request needs {need} pages but the pool capacity "
                    f"is {self.allocator.capacity}; raise num_pages or "
                    f"shorten the request")
        return prompt, clamped, max_new_tokens > budget

    def submit(self, prompt, max_new_tokens: int, arrival: float = 0.0,
               priority: int = 0) -> int:
        """Queue one request; returns its id.  ``arrival`` is seconds from
        ``run()`` start; ``priority`` orders admission and preemption
        (higher first)."""
        prompt, clamped, truncated = self.validate(prompt, max_new_tokens)
        req = Request(id=self._next_id, prompt=prompt,
                      max_new_tokens=clamped, arrival=arrival,
                      priority=priority, truncated=truncated)
        self._next_id += 1
        self._queue.push(req)
        return req.id

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------

    def _can_admit(self, req: Request) -> bool:
        """The pool must cover the request's fresh pages; with the prefix
        cache, unpinned index entries are reclaimed (never this plan's own
        hits) before deferring."""
        if not self._paged:
            return True
        need = self._admission_pages(req)
        if self.allocator.can_alloc(need):
            return True
        if self.prefix_cache is not None:
            keep = set()
            if req.swap_pages is None:
                _, shared, cow_src, _, _ = self._prefix_plan(req)
                keep = set(shared) | ({cow_src} if cow_src else set())
            self.prefix_cache.reclaim(need - self.allocator.available,
                                      keep=keep)
        return self.allocator.can_alloc(need)

    def _pick_victim(self, now: float, below: int | None = None
                     ) -> int | None:
        """Slot of the weakest runner (lowest effective priority, then the
        youngest); with ``below``, only runners strictly weaker."""
        best, best_key = None, None
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            eff = self._queue.effective(req, now)
            if below is not None and eff >= below:
                continue
            key = (eff, -req.arrival, -req.id)
            if best_key is None or key < best_key:
                best, best_key = slot, key
        return best

    def _evict(self, slot: int) -> None:
        """Preempt a runner: its pages go back to the pool and its table
        row to the trash page (before any new owner gets the pages, so
        the slot's frozen decode writes cannot reach them), and the
        request is requeued carrying every token generated so far.  With
        the host swap its live rows are first copied to host pages."""
        req = self._slots[slot]
        if self._slot_forced[slot]:
            # evicted mid-replay: splice the unreplayed tail back
            req.tokens.extend(self._slot_forced[slot])
            self._slot_forced[slot] = []
        if self._wave and self._prefill_next[slot] >= 0:
            # evicted mid-prefill: the partial chunk rows go with the
            # pages, and the prompt restarts on re-admission
            self._prefill_next[slot] = -1
            self._slot_cow[slot] = (0, 0)
        elif self._swap and req.tokens and self._slot_pages[slot]:
            # the row count is the slot's decode position, not
            # len(tokens): a mid-replay victim's spliced tokens have no
            # rows yet.  A full host pool falls back to replay.
            rows = int(self._positions[slot])
            hids = self.host_pool.alloc(pages_needed(rows, self._page_size))
            if hids is not None:
                payloads = extract_cache_pages(
                    self._caches, self._slot_pages[slot][:len(hids)],
                    pad_to=self._max_pages)
                for h, pl in zip(hids, payloads):
                    self.host_pool.store(h, pl)
                req.swap_pages = hids
                req.swap_rows = rows
                self.swap_outs += 1
        if self._paged and self._slot_pages[slot] is not None:
            self.allocator.free(self._slot_pages[slot])
            self._slot_pages[slot] = None
            self.page_table.clear(slot)
        self._slots[slot] = None
        self._active[slot] = False
        req.preemptions += 1
        self.preemptions += 1
        self._queue.push(req)

    def _evictable_pages(self, now: float, cutoff: int) -> int:
        """Pages the pool would hold after evicting every runner strictly
        below ``cutoff``: the bound both preemption paths check first, so
        no runner is evicted for an arrival that still would not fit.
        Refcount-aware: a shared page counts once, and only when every
        holder is a would-be victim (plus, at most, the prefix index,
        whose pin reclaim can drop); index entries reclaimable now are
        added (they have no slot holder, so nothing counts twice)."""
        held: dict[int, int] = {}
        for s, r in enumerate(self._slots):
            if r is not None and self._queue.effective(r, now) < cutoff:
                for p in self._slot_pages[s] or ():
                    held[p] = held.get(p, 0) + 1
        pc = self.prefix_cache
        pinned = set(pc.pages) if pc is not None else set()
        freed = sum(1 for p, c in held.items()
                    if self.allocator.refcount(p) == c + (p in pinned))
        cold = pc.reclaimable() if pc is not None else 0
        return self.allocator.available + freed + cold

    def _admit(self, now: float) -> None:
        """Admit arrived requests into free slots, best effective priority
        first; a strictly stronger arrival blocked on a slot or on pages
        preempts the weakest runner(s)."""
        while True:
            free = next((s for s in range(self.scfg.batch)
                         if self._slots[s] is None), None)
            cand = self._queue.peek(now)
            if cand is None:
                return
            cutoff = self._queue.effective(cand, now)
            if free is None:
                # evict for the slot only if the arrival's pages are
                # coverable too
                if self._paged and (self._evictable_pages(now, cutoff)
                                    < self._admission_pages(cand)):
                    return
                victim = self._pick_victim(now, below=cutoff)
                if victim is None:
                    return
                self._evict(victim)
                continue
            req = self._queue.pop(now, admit=self._can_admit)
            if req is None:
                # backpressured on pages: evict strictly weaker runners
                # until the pool covers it, if it can
                if (self._evictable_pages(now, cutoff)
                        < self._admission_pages(cand)):
                    return
                while not self._can_admit(cand):
                    victim = self._pick_victim(now, below=cutoff)
                    if victim is None:
                        return
                    self._evict(victim)
                req = self._queue.pop(now, admit=self._can_admit)
                if req is None:
                    return
            self._place(free, req)

    def _book(self, n: int) -> list[int]:
        """Allocate ``n`` pages that ``_can_admit`` vouched for."""
        pages = self.allocator.alloc(n)
        if pages is None:
            raise RuntimeError("page pool changed between admission "
                               "check and placement")
        return pages

    def _assign(self, slot: int, req: Request, pages, shared=()) -> None:
        """Map ``pages`` as the slot's table row (``shared`` read-only)."""
        self.page_table.assign(slot, pages, shared=set(shared))
        self._slot_pages[slot] = pages
        req.cache_rows = max(req.cache_rows, len(pages) * self._page_size)

    def _map_prefix(self, slot: int, req: Request):
        """Map the longest usable cached prefix of ``req.prompt`` read-only
        and book the remaining pages, the first of them holding promoted
        cold chunks right behind the hot run; returns ``(start, cow_src,
        cow_dst)``: the first uncached position and the COW page pair (0,
        0 without COW)."""
        keys, shared, cow_src, start, n_cold = self._prefix_plan(req)
        shared = self.prefix_cache.acquire(keys[:len(shared)])
        fresh = self._book(self._alloc_pages_for(req) - len(shared))
        if n_cold:
            self._promote_cold(keys[len(shared):len(shared) + n_cold],
                               fresh[:n_cold])
        self._assign(slot, req, shared + fresh, shared)
        self._cached_prompt_tokens += start
        self._prefix_hits += bool(shared or n_cold or cow_src)
        return start, cow_src, fresh[0] if cow_src else 0

    def _prefix_place(self, slot: int, req: Request):
        """Prefix-cache admission: map the cached prefix and run the
        uncached suffix through the one prefill stage (a miss is ``start
        == 0``); then index the prompt's full chunks.  ``start`` and the
        COW pair are 0-d tensors, so miss, hit and COW share one
        signature.  Returns the prefill logits."""
        p_len = int(req.prompt.size)
        start, cow_src, cow_dst = self._map_prefix(slot, req)
        sfx_len = p_len - start
        # the splice buffer spans every key position [0, p_len), so it
        # pads to the full prompt length, not the suffix's
        pad_len = self.scfg.prefill_len or p_len
        dev = self.device
        padded = torch.zeros((1, pad_len), dtype=torch.int64, device=dev)
        padded[0, :sfx_len] = torch.as_tensor(req.prompt[start:], device=dev)
        row = torch.as_tensor(self.page_table.row(slot), device=dev)
        args = [padded, row] + [torch.tensor(v, dtype=torch.int64,
                                             device=dev)
                                for v in (start, cow_src, cow_dst)]
        self._stages["prefill"].record(*args, sfx_len)
        logits = self._prefix_body(*args, sfx_len)
        self._prefix_insert(req.chunk_keys, self._slot_pages[slot])
        self.prefill_tokens += sfx_len
        self.cow_copies += bool(cow_src)
        return logits

    @torch.no_grad()
    def _prefix_body(self, padded, row, start, cow_src, cow_dst, sfx_len):
        """The prefix-cache prefill stage: the COW page copy, then the
        suffix ``padded`` prefilled against the rows the table ``row``
        maps below ``start``, its rows scattered through ``row``; returns
        the logits at the suffix's last real token (``sfx_len - 1``)."""
        copy_paged_cache_page(self._caches, cow_src, cow_dst)
        logits, one, _ = prefill(self.params, self.cfg, padded,
                                 logits_index=sfx_len - 1,
                                 ctx_caches=self._caches,
                                 ctx_table=row[None], ctx_start=start)
        scatter_prefill_paged_caches(self._caches, one, 0, row, start)
        return logits

    def _place(self, slot: int, req: Request) -> None:
        """Prefill a request alone into a free slot.  A fresh request
        commits its first token (stream index 0); a resumed one keeps its
        stored first token and queues the rest on the slot's forcing lane.
        A swapped-out request is restored by page copy instead."""
        # the same request always gets the same key, fresh or resumed
        key = self._req_keys.get(req.id)
        if key is None:
            key = fold_in(self._base_key, req.id).numpy()
            self._req_keys[req.id] = key
        self._slot_keys[slot] = key
        if req.swap_pages is not None:
            self._swap_in(slot, req)
            return
        self._total_prompt_tokens += int(req.prompt.size)
        if self._wave:
            self._wave_admit(slot, req)
            return
        if self.prefix_cache is not None:
            logits = self._prefix_place(slot, req)
        else:
            logits = self._plain_place(slot, req)
        # a resumed request keeps its stored first token: no read
        first = -1 if req.tokens else int(self._draw(
            logits[:, -1], self._slot_keys[slot:slot + 1], 0)[0])
        self._commit_first(slot, req, first)

    def _draw(self, logits, keys, index):
        """(B, V) logits -> (B,) tokens: the argmax, or with a temperature
        one draw per slot under ``fold_in(keys, index)`` (the slots'
        request keys and the tokens' stream indices)."""
        t = self.scfg.temperature
        if t <= 0.0:
            return torch.argmax(logits, dim=-1)
        keys = torch.as_tensor(keys, device=logits.device)
        return sample(logits, fold_in(keys, index), t)

    def _plain_place(self, slot: int, req: Request):
        """Book the pages (paged) and prefill the whole prompt, padded to
        ``prefill_len`` (at its exact length on a mamba model: pad tokens
        would run through the state; paged, the caches then grow to whole
        pages instead); returns the prefill logits."""
        p_len = int(req.prompt.size)
        pad_len = (p_len if self._has_mamba
                   else self.scfg.prefill_len or p_len)
        row = None
        if self._paged:
            self._assign(slot, req, self._book(self._alloc_pages_for(req)))
            row = torch.as_tensor(self.page_table.row(slot),
                                  device=self.device)
        else:
            req.cache_rows = self.scfg.max_len
        padded = torch.zeros((1, pad_len), dtype=torch.int64,
                             device=self.device)
        padded[0, :p_len] = torch.as_tensor(req.prompt, device=self.device)
        self.prefill_tokens += p_len
        self._stages["prefill"].record(padded, row, slot, p_len)
        return self._prefill_body(padded, row, slot, p_len)

    @torch.no_grad()
    def _prefill_body(self, padded, row, slot, p_len):
        """The monolithic prefill stage: ``padded`` prefilled alone and its
        caches merged into ``slot`` (paged: the pages the table ``row``
        maps; the caches grow to whole pages, dense to ``max_len``);
        returns the logits at the prompt's last token (``p_len - 1``)."""
        pad_len = padded.shape[1]
        grow_to = (-(-pad_len // self._page_size) * self._page_size
                   if self._paged else self.scfg.max_len)
        logits, one, _ = prefill(self.params, self.cfg, padded,
                                 max_len=grow_to, logits_index=p_len - 1)
        if self._paged:
            merge_slot_paged_caches(self._caches, one, slot, row)
        else:
            merge_slot_caches(self._caches, one, slot)
        return logits

    def _commit_first(self, slot: int, req: Request, first: int) -> None:
        """After a prompt's last row is written (prefill or final wave
        chunk): a fresh request commits its ``first`` token, a
        resumed one keeps its stored first token and queues the rest on
        the forcing lane; then the slot starts decoding."""
        p_len = int(req.prompt.size)
        if req.tokens:
            tok = req.tokens[0]
            self._slot_forced[slot] = req.tokens[1:]
            req.tokens = [tok]
        else:
            self._slot_forced[slot] = []
            tok = first
            req.tokens.append(tok)
            req.t_first = time.perf_counter() - self._t0
            req.t_tokens.append(req.t_first)
        if (req.max_new_tokens <= 1
                or (self.scfg.eos_id >= 0 and tok == self.scfg.eos_id)):
            self._finish(req, slot)
            self._slots[slot] = None
        else:
            self._slots[slot] = req
            self._token[slot, 0] = tok
            self._positions[slot] = p_len
            self._active[slot] = True
            self._remaining[slot] = req.max_new_tokens - 1

    def _swap_in(self, slot: int, req: Request) -> None:
        """Resume a swapped-out request by page copy: its rows come back
        from the host pool into fresh pages, bit for bit, and the stream
        continues at the position the eviction interrupted; tokens past
        the last row written re-enter the forcing lane."""
        p_len = int(req.prompt.size)
        pages = self._book(self._alloc_pages_for(req))
        n = len(req.swap_pages)
        insert_cache_pages(self._caches, pages[:n],
                           [self.host_pool.load(h) for h in req.swap_pages],
                           pad_to=self._max_pages)
        self.host_pool.free(req.swap_pages)
        req.swap_pages = None
        self._assign(slot, req, pages)
        committed = req.swap_rows - p_len + 1
        self._slot_forced[slot] = list(req.tokens[committed:])
        req.tokens = req.tokens[:committed]
        self._slots[slot] = req
        self._token[slot, 0] = int(req.tokens[-1])
        self._positions[slot] = req.swap_rows
        self._active[slot] = True
        self._remaining[slot] = req.max_new_tokens - committed
        self.swap_ins += 1
        self.replay_steps_saved += req.swap_rows - p_len
        req.swap_rows = 0

    def _wave_admit(self, slot: int, req: Request) -> None:
        """Wave-mode admission: book and map the request's pages (with the
        prefix cache: shared, promoted cold and COW pages, as
        ``_prefix_place`` maps them) but run no model code; the slot parks
        as an inactive prefilling lane.  Its decode position parks at
        ``max_len - 1``, past every row a prompt chunk attends, so the
        frozen decode writes there are rewritten before anything reads
        them."""
        start, cow_src, cow_dst = 0, 0, 0
        if self.prefix_cache is not None:
            start, cow_src, cow_dst = self._map_prefix(slot, req)
        else:
            self._assign(slot, req, self._book(self._alloc_pages_for(req)))
        self._slots[slot] = req
        self._prefill_next[slot] = start
        self._slot_cow[slot] = (cow_src, cow_dst)
        self._slot_forced[slot] = []
        self._token[slot, 0] = 0
        self._positions[slot] = self.scfg.max_len - 1
        self._active[slot] = False
        self._remaining[slot] = 0

    @torch.no_grad()
    def _wave_step(self, tokens, lens, starts, rows, cow_src, cow_dst,
                   keys):
        """The wave program: the lanes' COW page copies before any write,
        then one ``decode_step`` over the (G, C) chunks at per-lane
        ``starts`` through per-lane table ``rows`` (all-trash for pad
        lanes); returns each lane's token at its row ``lens - 1`` (the
        first token, stream index 0 under the lane's request key
        ``keys``, where the chunk completes the prompt)."""
        args = [torch.as_tensor(a, device=self.device).long()
                for a in (tokens, lens, starts, rows, cow_src, cow_dst,
                          keys)]
        self._stages["prefill_chunk"].record(*args)
        return self._wave_body(*args).cpu().numpy()

    @torch.no_grad()
    def _wave_body(self, tokens, lens, starts, rows, cow_src, cow_dst, keys):
        """The wave stage on the device (see ``_wave_step``); returns the
        (G,) tokens."""
        copy_paged_cache_page(self._caches, cow_src, cow_dst)
        logits, _ = decode_step(self.params, self.cfg, tokens, self._caches,
                                starts, page_table=rows)
        last = logits[torch.arange(tokens.shape[0], device=self.device),
                      lens - 1]
        return self._draw(last, keys, 0)

    def _run_wave(self) -> None:
        """Advance up to ``admit_group`` prefilling lanes by one prompt
        chunk each; a lane whose chunk completes its prompt commits its
        first token and starts decoding."""
        g, c = self._wave_group, self._wave_chunk
        lanes = [s for s in range(self.scfg.batch)
                 if self._prefill_next[s] >= 0][:g]
        tokens = np.zeros((g, c), np.int64)
        lens = np.ones((g,), np.int64)
        starts = np.zeros((g,), np.int64)
        rows = np.zeros((g, self._max_pages), np.int64)
        cow = np.zeros((2, g), np.int64)
        keys = np.zeros((g, 2), np.int64)
        real = []
        for i, s in enumerate(lanes):
            req = self._slots[s]
            st = int(self._prefill_next[s])
            p_len = int(req.prompt.size)
            n = min(c, p_len - st)
            tokens[i, :n] = req.prompt[st:st + n]
            lens[i], starts[i] = n, st
            rows[i] = self.page_table.row(s)
            keys[i] = self._slot_keys[s]
            if self._slot_cow[s][0] and st + n == p_len:
                # the COW pair applies with the final chunk, the only one
                # that writes into the duplicated tail page
                cow[:, i] = self._slot_cow[s]
                self.cow_copies += 1
            real.append(n)
            self.prefill_tokens += n
        self.prefill_waves += 1
        first = self._wave_step(tokens, lens, starts, rows, cow[0], cow[1],
                                keys)
        for i, s in enumerate(lanes):
            req = self._slots[s]
            nxt = int(self._prefill_next[s]) + real[i]
            if nxt >= int(req.prompt.size):
                self._wave_finish(s, req, int(first[i]))
            else:
                self._prefill_next[s] = nxt

    def _wave_finish(self, slot: int, req: Request, first: int) -> None:
        """A lane's final chunk ran: index the prompt's pages (prefix
        cache), then the monolithic placement's epilogue."""
        self._prefill_next[slot] = -1
        self._slot_cow[slot] = (0, 0)
        if self.prefix_cache is not None:
            self._prefix_insert(req.chunk_keys, self._slot_pages[slot])
        self._commit_first(slot, req, first)

    def _finish(self, req: Request, slot: int) -> None:
        req.t_done = time.perf_counter() - self._t0
        self._finished[req.id] = req
        self._req_keys.pop(req.id, None)
        self._slot_forced[slot] = []
        if self._paged and self._slot_pages[slot] is not None:
            # the departing slot's row re-points at the trash page, so its
            # frozen decode writes cannot touch the pages' next owner
            self.allocator.free(self._slot_pages[slot])
            self._slot_pages[slot] = None
            self.page_table.clear(slot)

    def _top_up(self, now: float) -> None:
        """Incremental mode: before a chunk, grow every active slot whose
        writes would cross its last page; when the pool is dry, evict the
        weakest runner (possibly the needy slot itself, which then resumes
        once pages free up).  A speculation round books the rows it may
        make live, ``spec_k + 1``; its writes past them land on the trash
        page and roll back."""
        chunk_steps = (self.scfg.spec_k + 1 if self._spec
                       else self.scfg.decode_chunk)
        for slot in range(self.scfg.batch):
            req = self._slots[slot]
            if req is None or not self._active[slot]:
                continue
            steps = min(chunk_steps, int(self._remaining[slot]))
            need = pages_needed(int(self._positions[slot]) + steps,
                                self._page_size)
            while need > self.page_table.live_len(slot):
                deficit = need - self.page_table.live_len(slot)
                got = self.allocator.alloc(deficit)
                if got is not None:
                    self.page_table.extend(slot, got)
                    self._slot_pages[slot].extend(got)
                    req.cache_rows = max(
                        req.cache_rows,
                        len(self._slot_pages[slot]) * self._page_size)
                    break
                # unpinned prefix pages go before any runner is evicted
                pc = self.prefix_cache
                if pc is not None and pc.reclaim(
                        deficit - self.allocator.available):
                    continue
                # never None: this slot is running, hence a candidate
                victim = self._pick_victim(now)
                self._evict(victim)
                if victim == slot:
                    break

    def _counts(self) -> np.ndarray:
        """Each slot's stream index of its next token (its request's
        tokens so far; 0 for an empty slot)."""
        return np.asarray([len(r.tokens) if r is not None else 0
                           for r in self._slots], np.int64)

    def _decode_chunk(self, forced: np.ndarray):
        """Run the decode chunk stage (``_chunk_body``) and read it back
        once: returns the host copies of the chunk state and the (steps,
        B) emitted tokens and validity."""
        table = self.page_table.asarray() if self._paged else None
        out = self._stages["decode_chunk"](
            self._token, self._positions, self._active, self._remaining,
            table, forced, self._slot_keys, self._counts()).cpu().numpy()
        n = self.scfg.decode_chunk
        return (out[0, :, None].astype(np.int32), out[1].astype(np.int32),
                out[2].astype(bool), out[3].astype(np.int32), out[4:4 + n],
                out[4 + n:].astype(bool))

    @torch.no_grad()
    def _chunk_body(self, token, positions, active, remaining, table,
                    forced, keys, counts):
        """The decode chunk on the device: ``decode_chunk`` steps, step
        ``t`` of slot ``b`` drawing under ``fold_in(keys[b], counts[b] +
        t)`` (or the argmax); inactive slots are frozen and emit -1.
        ``forced`` (steps, B) holds replayed tokens (-1 = none): where
        set, the stored token replaces the draw, so a resumed request
        rebuilds the KV of its uninterrupted run.  Returns one (4 + 2 *
        steps, B) int64 tensor: the next token, positions, active flags
        and remaining budgets, then the emitted tokens and their
        validity per step."""
        token, positions, forced = token.long(), positions.long(), \
            forced.long()
        max_pos = self.scfg.max_len - 1
        toks, valid = [], []
        for t in range(self.scfg.decode_chunk):
            logits, _ = decode_step(self.params, self.cfg, token,
                                    self._caches, positions,
                                    page_table=table)
            nxt = self._draw(logits[:, -1], keys, counts + t)
            nxt = torch.where(forced[t] >= 0, forced[t], nxt)
            toks.append(torch.where(active, nxt, torch.full_like(nxt, -1)))
            valid.append(active)
            remaining = remaining - active.to(remaining.dtype)
            alive = remaining > 0
            if self.scfg.eos_id >= 0:
                alive = alive & (nxt != self.scfg.eos_id)
            positions = torch.where(
                active, torch.clamp(positions + 1, max=max_pos), positions)
            token = torch.where(active[:, None], nxt[:, None], token)
            active = active & alive
        return torch.cat([token.t(), positions[None], active[None].long(),
                          remaining[None].long(), torch.stack(toks),
                          torch.stack(valid).long()])

    def _run_chunk(self, now: float) -> None:
        if self._incremental:
            self._top_up(now)
            if not self._active.any():
                return                # top-up evicted the last runner
        b, nsteps = self.scfg.batch, self.scfg.decode_chunk
        forced = np.full((nsteps, b), -1, np.int32)
        for slot in range(b):
            buf = self._slot_forced[slot]
            if buf and self._slots[slot] is not None:
                n = min(nsteps, len(buf))
                forced[:n, slot] = buf[:n]
                del buf[:n]
        self._stat_samples += 1
        self._stat_running += sum(r is not None for r in self._slots)
        if self._paged:
            self._stat_in_use += self.allocator.in_use
        self.decode_chunks += 1
        (self._token, self._positions, self._active, self._remaining,
         toks, valid) = self._decode_chunk(forced)
        tnow = time.perf_counter() - self._t0
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            for t in range(toks.shape[0]):
                if not valid[t, slot]:
                    break
                tok = int(toks[t, slot])
                req.tokens.append(tok)
                if len(req.t_tokens) < len(req.tokens):
                    # replayed tokens keep their original stamps
                    req.t_tokens.append(tnow)
                if (len(req.tokens) >= req.max_new_tokens
                        or (self.scfg.eos_id >= 0
                            and tok == self.scfg.eos_id)):
                    self._finish(req, slot)
                    self._slots[slot] = None
                    break

    def _spec_device(self, forced: np.ndarray, start: np.ndarray):
        """The draft and verify stages, back to back on the device (the
        drafts and their distributions never leave it).  Returns the host
        copies, read once, of ``out`` (B, k + 1) (the accepted draft or
        its replacement, then the bonus token) and ``accept`` (B, k)."""
        k = self.scfg.spec_k
        table = self.page_table.asarray() if self._paged else None
        counts = self._counts()
        drafts, dprobs = self._stages["draft"](
            self._token, start, self._active, table, forced,
            self._slot_keys, counts)
        both = self._stages["verify"](
            self._token, drafts, start, table, forced, dprobs,
            self._slot_keys, counts).cpu().numpy()
        return both[:, :k + 1], both[:, k + 1:].astype(bool)

    @torch.no_grad()
    def _draft_body(self, token, start, active, table, forced, keys,
                    counts):
        """The draft stage: ``spec_k`` S = 1 steps under the draft config
        from ``start``, step ``t`` drawing under ``fold_in(fold_in(keys,
        counts + t), TAG_DRAFT)`` (or the argmax); ``forced`` (k, B)
        replayed tokens (-1 = none) replace the draw; positions advance
        only for active slots.  Returns the drafts (B, k) and their
        distributions (k, B, V) ((k, B, 1) zeros when greedy)."""
        temp = self.scfg.temperature
        tok, positions, forced = token.long(), start.long(), forced.long()
        max_pos = self.scfg.max_len - 1
        drafts, dprobs = [], []
        for t in range(self.scfg.spec_k):
            logits, _ = decode_step(self.params, self._draft_cfg, tok,
                                    self._caches, positions,
                                    page_table=table)
            step_keys = fold_in(keys, counts + t) if temp > 0.0 else None
            nxt, probs = draft_sample(logits[:, -1], step_keys, temp)
            nxt = torch.where(forced[t] >= 0, forced[t], nxt)
            drafts.append(nxt)
            dprobs.append(probs)
            positions = torch.where(
                active, torch.clamp(positions + 1, max=max_pos), positions)
            tok = torch.where(active[:, None], nxt[:, None], tok)
        return torch.stack(drafts, dim=1), torch.stack(dprobs)

    @torch.no_grad()
    def _verify_body(self, token, drafts, start, table, forced, dprobs,
                     keys, counts):
        """The verify stage: one dense step over ``[token, drafts]`` at S
        = k + 1 from ``start``, rewriting those rows, then
        ``spec_accept`` (forced drafts are accepted).  Returns ``[out,
        accept]`` as one (B, 2k + 1) int64 tensor."""
        token = token.long()
        logits, _ = decode_step(self.params, self.cfg,
                                torch.cat([token, drafts], dim=1),
                                self._caches, start.long(), page_table=table)
        out, accept = spec_accept(logits, drafts, forced.long().t() >= 0,
                                  dprobs, keys, counts,
                                  self.scfg.temperature)
        return torch.cat([out, accept.long()], dim=1)

    def _spec_rollback(self, slot: int) -> None:
        """Roll a slot's rejected draft tail back as a page-table
        operation: truncate the live prefix to the pages its accepted
        rows need and free the tail (no cache row is copied).  Only
        incremental mode books pages past the live prefix mid-stream;
        shared prefix pages lie below the prompt's last row, so they are
        never reached."""
        if not self._incremental:
            return
        keep = pages_needed(int(self._positions[slot]), self._page_size)
        removed = self.page_table.truncate(slot, keep)
        if removed:
            self.allocator.free(removed)
            del self._slot_pages[slot][keep:]
            self.spec_rollback_pages += len(removed)

    def _run_spec_round(self, now: float) -> None:
        """One speculation round: draft, verify, then the host walk that
        emits each slot's accepted prefix plus the correction or bonus
        token and rolls back what the round over-booked."""
        if self._incremental:
            self._top_up(now)
            if not self._active.any():
                return                # top-up evicted the last runner
        b, k = self.scfg.batch, self.scfg.spec_k
        forced = np.full((k, b), -1, np.int32)
        for slot in range(b):
            buf = self._slot_forced[slot]
            if buf and self._slots[slot] is not None:
                n = min(k, len(buf))
                forced[:n, slot] = buf[:n]
                del buf[:n]
        self._stat_samples += 1
        self._stat_running += sum(r is not None for r in self._slots)
        if self._paged:
            self._stat_in_use += self.allocator.in_use
        start = self._positions.copy()
        out, accept = self._spec_device(forced, start)
        self.spec_rounds += 1
        tnow = time.perf_counter() - self._t0
        eos = self.scfg.eos_id
        for slot in range(b):
            req = self._slots[slot]
            if req is None or not self._active[slot]:
                continue
            self.spec_slot_rounds += 1
            r = int(self._remaining[slot])
            e = 0
            # a replay longer than k spills into the next round: while
            # committed tokens remain buffered the bonus token must not
            # be emitted (it would splice a new token into a stream the
            # client has already seen)
            more_forced = bool(self._slot_forced[slot])
            for j in range(k + 1):
                if j == k and more_forced:
                    break
                tok = int(out[slot, j])
                req.tokens.append(tok)
                if len(req.t_tokens) < len(req.tokens):
                    # replayed tokens keep their original stamps
                    req.t_tokens.append(tnow)
                e += 1
                r -= 1
                self.spec_tokens += 1
                if j < k and forced[j, slot] < 0:
                    self.spec_proposed += 1
                    self.spec_accepted += bool(accept[slot, j])
                if (r <= 0 or (eos >= 0 and tok == eos) or j == k
                        or not accept[slot, j]):
                    break
            self._positions[slot] = int(start[slot]) + e
            self._remaining[slot] = r
            self._token[slot, 0] = int(req.tokens[-1])
            if (len(req.tokens) >= req.max_new_tokens
                    or (eos >= 0 and int(req.tokens[-1]) == eos)):
                self._finish(req, slot)
                self._slots[slot] = None
                self._active[slot] = False
            elif self._paged:
                self._spec_rollback(slot)

    def start(self, t0: float | None = None) -> None:
        """Anchor the run clock (arrivals and latency stamps)."""
        self._t0 = time.perf_counter() if t0 is None else t0

    def step(self, wait: bool = True) -> bool:
        """Admit arrived requests, advance the prefilling lanes by one wave
        (wave mode), then run one decode chunk (or speculation round) if
        any slot is active.  Returns ``False`` once nothing is queued or
        running."""
        if not (len(self._queue)
                or any(r is not None for r in self._slots)):
            return False
        now = time.perf_counter() - self._t0
        self._admit(now)
        # prefilling lanes are inactive but not idle: they progress
        # through the wave, so neither the idle wait nor the stall check
        # may fire while one prefills
        prefilling = self._wave and bool((self._prefill_next >= 0).any())
        if not self._active.any() and not prefilling:
            if not len(self._queue):
                return False
            nxt = self._queue.next_arrival()
            wait_s = nxt - (time.perf_counter() - self._t0)
            if wait_s > 0:
                if wait:
                    time.sleep(min(wait_s, 0.05))
                return True
            if nxt > now:
                return True           # arrived during this _admit window
            # an arrived request went unadmitted with every slot idle: an
            # idle engine holds no pages, so this is a leak or an
            # unsatisfiable request, not backpressure
            detail = ""
            if self._paged:
                detail = (f" ({self.allocator.in_use} pages still in use, "
                          f"{self.allocator.available} free of "
                          f"{self.allocator.capacity} allocatable)")
            raise RuntimeError(
                f"serve scheduler stalled: {len(self._queue)} arrived "
                f"request(s) cannot be admitted with all slots "
                f"idle{detail}")
        if prefilling:
            self._run_wave()
        if self._active.any():
            now = time.perf_counter() - self._t0
            if self._spec:
                self._run_spec_round(now)
            else:
                self._run_chunk(now)
        return True

    def drain(self) -> dict[int, Request]:
        """Hand over (and clear) the finished-request map."""
        out, self._finished = self._finished, {}
        return out

    def run(self) -> dict[int, Request]:
        """Serve until every submitted request has finished; returns
        ``{id: Request}``."""
        self.start()
        while self.step():
            pass
        return self.drain()

    def release_prefix_cache(self) -> None:
        """Drop every reference the prefix index holds, device and host
        (teardown and leak checks)."""
        if self.prefix_cache is not None:
            self.prefix_cache.drop()

    def leaked_pages(self) -> int:
        """Pages still held after a drained run, on the device pool and
        the host pool (call ``release_prefix_cache`` first when the prefix
        cache is on); 0 in dense mode."""
        if not self._paged:
            return 0
        host = self.host_pool.in_use if self.host_pool is not None else 0
        return self.allocator.in_use + host

    def generate(self, prompts, n_new: int, rng=None) -> torch.Tensor:
        """prompts: (B, S) ints -> (B, S + n_new) int32 tokens on the
        engine's device.  Lockstep wrapper over submit/run: B must equal
        the slot count and every request decodes exactly ``n_new`` tokens
        (build the engine with ``eos_id=-1``; an early EOS raises).
        ``rng`` is the run's base key (``reset``)."""
        prompts = np.asarray(torch.as_tensor(prompts).cpu(), np.int32)
        b, s = prompts.shape
        if b != self.scfg.batch:
            raise ValueError(f"prompts batch {b} != ServeConfig.batch "
                             f"{self.scfg.batch}")
        if s + n_new > self.scfg.max_len:
            raise ValueError(f"prompt_len {s} + n_new {n_new} exceeds "
                             f"max_len {self.scfg.max_len}")
        self.reset(rng=rng)
        ids = [self.submit(prompts[i], n_new) for i in range(b)]
        done = self.run()
        short = [i for i in ids if len(done[i].tokens) != n_new]
        if short:
            raise RuntimeError(
                f"generate() needs rectangular output but request(s) "
                f"{short} stopped at eos_id={self.scfg.eos_id} before "
                f"emitting n_new={n_new} tokens; use submit()/run() for "
                f"ragged workloads or build the engine with eos_id=-1")
        gen = np.stack([np.asarray(done[i].tokens, np.int32) for i in ids])
        return torch.as_tensor(np.concatenate([prompts, gen], axis=1),
                               device=self.device)
