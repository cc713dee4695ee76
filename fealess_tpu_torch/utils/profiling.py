"""Per-stage timing and device profiling (counterpart of
``fealess_tpu.utils.profiling``).

- :class:`StageTimer`: an accumulating named-stage stopwatch whose report
  is the structured analog of the reference's ``printTimeOfICP``
  (ICP/ICP.cpp:283-311);
- :func:`trace`: a ``torch.profiler`` trace of CPU and CUDA activity,
  exported as a Chrome trace;
- :func:`time_calls`: mean seconds per call of back-to-back calls with one
  synchronisation at the end;
- :func:`device_seconds`: the device's seconds per call of a body.  On a
  card the frame is launch-bound on the host (idle 0.93-0.95), so host
  clocks around back-to-back calls time the host; this takes the union of
  the device intervals of a profiled run instead.  On CPU tensors it takes
  the slope of wall time between a short and a long run;
- :func:`profile_calls` (device busy, wall time and device events of a
  profiled run; ``device_seconds`` and ``apps/profile_reco.py`` read it),
  :func:`busy_us`, :func:`graph_ms` and :func:`stage_ms`, the device-time
  primitives of ``apps/profile_reco.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch

# warm calls before a timed or profiled run (device_seconds makes WARMUP +
# iters calls on a card)
WARMUP = 3


@dataclasses.dataclass
class StageStats:
    calls: int = 0
    total_s: float = 0.0

    @property
    def mean_ms(self) -> float:
        return 1e3 * self.total_s / self.calls if self.calls else 0.0


def _devices(value) -> set:
    """The CUDA devices of the tensors and ``torch.device``s in ``value``
    (one of them, or a list, tuple, dict or dataclass of them, nested);
    other leaves (strings, numbers, numpy arrays) hold none."""
    if isinstance(value, torch.Tensor):
        return {value.device} if value.is_cuda else set()
    if isinstance(value, torch.device):
        return {value} if value.type == "cuda" else set()
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        value = [getattr(value, f.name) for f in dataclasses.fields(value)]
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        return set().union(*(_devices(v) for v in value)) if value else set()
    return set()


def synchronize(value) -> None:
    """Wait for the CUDA devices that hold ``value``'s tensors (nothing for
    CPU tensors, which are ready when returned)."""
    for dev in _devices(value):
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulating per-stage stopwatch.

    Usage::

        timer = StageTimer()
        with timer.stage("match", bgr):  # bgr's card is synchronised
            out = match_fn(bgr)          # before the clock stops
        timer.add("io", seconds)
        print(timer.report())

    ``sync(value)`` replaces the default :func:`synchronize`.
    """

    def __init__(self, sync: Optional[Callable[[Any], Any]] = None):
        self._stats: Dict[str, StageStats] = {}
        self._order: List[str] = []
        self._sync = sync or synchronize

    def _entry(self, name: str) -> StageStats:
        if name not in self._stats:
            self._stats[name] = StageStats()
            self._order.append(name)
        return self._stats[name]

    @contextlib.contextmanager
    def stage(self, name: str, value: Any = None):
        """Time the block as one call of ``name``; on exit, first wait for
        the device(s) of ``value``."""
        s = self._entry(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if value is not None:
                self._sync(value)
            s.calls += 1
            s.total_s += time.perf_counter() - t0

    def add(self, name: str, seconds: float) -> None:
        s = self._entry(name)
        s.calls += 1
        s.total_s += seconds

    def stats(self) -> Dict[str, StageStats]:
        return dict(self._stats)

    def report(self) -> str:
        """printTimeOfICP-style table (ICP/ICP.cpp:283-311)."""
        lines = [f"{'stage':<24}{'calls':>8}{'total ms':>12}{'mean ms':>10}"]
        for name in self._order:
            s = self._stats[name]
            lines.append(f"{name:<24}{s.calls:>8}{1e3 * s.total_s:>12.2f}"
                         f"{s.mean_ms:>10.3f}")
        return "\n".join(lines)

    def reset(self) -> None:
        self._stats.clear()
        self._order.clear()


def _activities():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block (CPU, and CUDA where
    there is a card) and write it to ``log_dir/trace.json`` (Chrome trace
    format: chrome://tracing or Perfetto)."""
    from torch.profiler import profile
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def time_calls(fn: Callable[[], Any], iters: int = 20,
               warmup: int = WARMUP) -> float:
    """Mean steady-state seconds per call of ``fn``: the calls are issued
    back to back and the devices of their results synchronised once, as a
    frame loop issues them."""
    for _ in range(warmup):
        synchronize(fn())
    t0 = time.perf_counter()
    outs = [fn() for _ in range(iters)]
    synchronize(outs)
    return (time.perf_counter() - t0) / iters


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


@dataclasses.dataclass
class Profiled:
    """One profiled run of ``n`` calls (:func:`profile_calls`)."""
    busy_ms: float           # device busy per call
    wall_ms: float           # host clock per call, to the last synchronisation
    device_events: list      # the trace's device events (kernels, copies, memsets)
    prof: Any                # the profiler: all its events, export_chrome_trace


def profile_calls(fn: Callable[[], Any], n: int) -> Profiled:
    """Run ``fn`` ``n`` times under ``torch.profiler``, after a
    synchronisation, recording device activity (and the CUDA runtime's
    calls, which come with it) but not the host's operators: recording
    them slows every profiled call on the card.  Device busy is the union
    of the intervals of every device event, so overlapping work counts
    once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in dev])
    return Profiled(busy / 1e3 / n, wall_ms, dev, prof)


def device_seconds(body: Callable[[Any], Any], x0: Any, iters: int = 20,
                   reps: int = 2) -> float:
    """Seconds of device time per call of ``body(carry) -> carry``, run as
    a chain from ``x0`` (JAX's ``chain_slope``).  With ``x0`` on a card:
    the device busy time of ``iters`` warm calls under the profiler
    (:func:`profile_calls`), per call; it repeats within 0.01 ms, so one
    run does.  On CPU tensors: the slope of wall time between chains of 2
    and 2 + ``iters`` calls, the least of ``reps`` runs each."""
    def chain(n):
        x = x0
        for _ in range(n):
            x = body(x)
        return x

    if _devices(x0):
        chain(WARMUP)
        state = {"x": x0}

        def step():
            state["x"] = body(state["x"])

        return profile_calls(step, iters).busy_ms / 1e3

    def run(n):
        t0 = time.perf_counter()
        chain(n)
        return time.perf_counter() - t0

    run(2)
    lo, hi = 2, 2 + iters
    ts = [run(n) for _ in range(reps) for n in (lo, hi)]
    return (min(ts[1::2]) - min(ts[0::2])) / iters


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``reps`` calls captured in one CUDA
    graph, between CUDA events around its replay: the device's time,
    without the host's launch cost between calls (which back-to-back
    events measure once a kernel takes less time than its wrapper)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def stage_ms(fn, reps: int = 5):
    """(host milliseconds per call of ``reps`` calls between two
    ``torch.cuda.synchronize()``, after one warm call; the last result)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps, out
