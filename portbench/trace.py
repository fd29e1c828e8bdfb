"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over a
slice of the measured window, reduced to kernel intervals, busy time and
idle gaps.

The harness marks the traced slice and each engine step with
``record_function`` spans (``portbench.window``, ``portbench.step``) and
tells the trace which steps admitted requests, so an idle gap is named
by what the host was doing: a step that prefilled, a step that ran only
the decode chunk, or the harness between steps.  Gaps under 20 us are
pooled as launch gaps between kernels.
"""

from __future__ import annotations

import dataclasses
import time

import torch

__all__ = ["Kernel", "DeviceTrace", "Tracer", "CSRC_KERNELS", "kernel_class"]

# the program's hand-written kernels (``src/repro_torch/csrc``), by the
# names their ``__global__`` functions carry in a trace
CSRC_KERNELS = {"nibble_mm_kernel": "nibble",
                "paged_decode_mma_kernel": "paged_decode",
                "paged_decode_kernel": "paged_decode_f32",
                "flash_fwd_mma_kernel": "flash_prefill",
                "flash_fwd_f32_kernel": "flash_prefill_f32",
                "bwd_dq_kernel": "flash_bwd", "bwd_dkv_kernel": "flash_bwd",
                "bwd_dq_f32_kernel": "flash_bwd",
                "bwd_dkv_f32_kernel": "flash_bwd",
                "lut_matmul_kernel": "lut"}
SHORT_GAP_NS = 20_000
_WINDOW, _STEP = "portbench.window", "portbench.step"


def kernel_class(name: str) -> str:
    """The csrc kernel a device op is, or ``"torch"`` for every other
    (PyTorch's own kernels, copies and fills)."""
    for key, cls in CSRC_KERNELS.items():
        if key in name:
            return cls
    return "torch"


@dataclasses.dataclass(frozen=True)
class Kernel:
    name: str
    start_ns: int
    dur_ns: int


@dataclasses.dataclass
class DeviceTrace:
    kernels: list            # Kernel, in start order, inside the window
    window_s: float
    busy_s: float            # union of device intervals
    gaps: dict               # class -> (count, seconds)
    longest_gaps: list       # (class, seconds), longest first

    def seconds(self, cls: str) -> float:
        return sum(k.dur_ns for k in self.kernels
                   if kernel_class(k.name) == cls) / 1e9

    def device_ops(self, top: int = 10) -> list:
        by: dict[str, float] = {}
        for k in self.kernels:
            by[k.name] = by.get(k.name, 0.0) + k.dur_ns / 1e9
        return sorted(([n[:64], s] for n, s in by.items()),
                      key=lambda e: -e[1])[:top]


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _device_op(ev) -> bool:
    """A kernel, copy or fill: not the device-side copy of a
    ``record_function`` range, which the profiler also files there."""
    marked = getattr(ev, "is_user_annotation", None)
    if marked is not None and marked():
        return False
    return not ev.name().startswith("portbench.")


def reduce(events, step_labels: list) -> DeviceTrace:
    """Reduce the profiler's raw events; ``step_labels[i]`` names what
    the ``i``-th ``portbench.step`` span did."""
    window = None
    steps = []
    kernels = []
    for ev in events:
        name = ev.name()
        if "CUDA" in str(ev.device_type()):
            if _device_op(ev):
                kernels.append(Kernel(name, _ns(ev, "start"),
                                      _ns(ev, "duration")))
        elif name == _WINDOW:
            window = (_ns(ev, "start"), _ns(ev, "start") + _ns(ev, "duration"))
        elif name == _STEP:
            steps.append((_ns(ev, "start"), _ns(ev, "duration")))
    if window is None:
        raise RuntimeError("the trace holds no portbench.window span")
    lo, hi = window
    kernels = sorted((k for k in kernels
                      if k.start_ns >= lo and k.start_ns < hi),
                     key=lambda k: k.start_ns)
    steps.sort()
    spans = [(s, s + d, step_labels[i] if i < len(step_labels) else "step")
             for i, (s, d) in enumerate(steps)]
    busy = 0
    gaps: dict[str, list] = {}
    longest = []
    cur_lo = cur_hi = None
    j = 0

    def host_at(t):
        nonlocal j
        while j < len(spans) and spans[j][1] <= t:
            j += 1
        if j < len(spans) and spans[j][0] <= t:
            return spans[j][2]
        return "harness"

    def gap(a, b):
        if b <= a:
            return
        cls = ("between_kernels_under_20us" if b - a < SHORT_GAP_NS
               else host_at(a))
        c = gaps.setdefault(cls, [0, 0.0])
        c[0] += 1
        c[1] += (b - a) / 1e9
        if b - a >= SHORT_GAP_NS:
            longest.append((cls, (b - a) / 1e9))

    prev_end = lo
    for k in kernels:
        end = min(k.start_ns + k.dur_ns, hi)
        if cur_hi is None or k.start_ns > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            gap(prev_end, k.start_ns)
            cur_lo, cur_hi = k.start_ns, end
        else:
            cur_hi = max(cur_hi, end)
        prev_end = cur_hi
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    gap(prev_end, hi)
    longest.sort(key=lambda e: -e[1])
    return DeviceTrace(kernels=kernels, window_s=(hi - lo) / 1e9,
                       busy_s=busy / 1e9,
                       gaps={k: tuple(v) for k, v in gaps.items()},
                       longest_gaps=longest[:10])


class Tracer:
    """Profiles from :meth:`start` to :meth:`stop`; ``step(label)`` wraps
    one engine step.  On a CPU device (the tests) only host events are
    recorded."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._prof = None
        self._window = None
        self.labels: list[str] = []
        self.t0 = self.t1 = 0.0

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self._cuda:
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def _sync(self) -> None:
        if self._cuda:
            torch.cuda.synchronize()

    def warm(self) -> None:
        """Start and stop the profiler once, so its own set-up falls in
        the run's set-up and not in the traced slice."""
        with self._profile():
            self._sync()

    def start(self) -> None:
        self._sync()
        self._prof = self._profile()
        self._prof.start()
        self._window = torch.profiler.record_function(_WINDOW)
        self._window.__enter__()
        self.t0 = time.perf_counter()

    @property
    def active(self) -> bool:
        return self._prof is not None

    def step(self, fn, label_of):
        """Run ``fn()`` inside a ``portbench.step`` span; ``label_of(r)``
        names the step from its result once it has run."""
        with torch.profiler.record_function(_STEP):
            r = fn()
        self.labels.append(label_of(r))
        return r

    def stop(self) -> DeviceTrace:
        self._sync()
        self._window.__exit__(None, None, None)
        self._prof.stop()
        self.t1 = time.perf_counter()
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        return reduce(events, self.labels)
