"""The device trace of one profiled call: kernel intervals, host operations,
busy and idle time, and the breakdown of a traced run's result line.

The events are read straight from the profiler's raw records
(`kineto_results.events()`), not from its per-event Python objects, which
take minutes to build for a decode loop's hundreds of thousands of
launches."""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import List, Optional, Tuple

import torch

WINDOW = "benchmark.window"
SYNC = "cudaDeviceSynchronize"
TOP = 10


class DeviceRecordsLost(RuntimeError):
    """The traced call launched work on the card and the profiler kept no
    device record of it."""


class Trace:
    """Kernel and host intervals of one traced window, in ns on one clock."""

    def __init__(self, events):
        self.kernels: List[Tuple[str, int, int]] = []
        self.host: List[Tuple[str, int, int]] = []
        self.window = None
        for e in events:
            start = e.start_ns()
            end = start + e.duration_ns()
            name = e.name()
            if name == WINDOW:
                if e.device_type() != torch.autograd.DeviceType.CUDA:
                    self.window = (start, end)
            elif getattr(e, "is_user_annotation", lambda: False)():
                continue
            elif e.device_type() == torch.autograd.DeviceType.CUDA:
                self.kernels.append((name, start, end))
            else:
                self.host.append((name, start, end))
        if self.window is None:
            raise RuntimeError(f"the trace holds no '{WINDOW}' range")
        lo, hi = self.window
        self.kernels = sorted((k for k in self.kernels if k[2] > lo and k[1] < hi),
                              key=lambda k: k[1])
        self.host.sort(key=lambda h: h[1])

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_s(self, lo: Optional[int] = None, hi: Optional[int] = None) -> float:
        """Seconds of [lo, hi] (the window by default) with a kernel running."""
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        busy, end = 0, lo
        for _, s, e in self.kernels:
            s, e = max(s, end), min(e, hi)
            if e > s:
                busy += e - s
                end = e
        return busy * 1e-9

    def kernel_s(self, pattern: str) -> Optional[float]:
        """Device seconds of the kernels whose name matches `pattern`; None
        when none ran in the window."""
        rx = re.compile(pattern)
        hit = [e - s for n, s, e in self.kernels if rx.search(n)]
        return sum(hit) * 1e-9 if hit else None

    def syncs(self) -> List[Tuple[int, int]]:
        """The device synchronisations the host made in the window."""
        lo, hi = self.window
        return [(s, e) for n, s, e in self.host if n == SYNC and lo <= s <= hi]

    def gaps(self) -> List[Tuple[int, int]]:
        """Idle intervals of the device inside the window."""
        out, end = [], self.window[0]
        for _, s, e in self.kernels:
            if s > end:
                out.append((end, s))
            end = max(end, e)
        if self.window[1] > end:
            out.append((end, self.window[1]))
        return out

    def host_op_at(self, t: int) -> str:
        """The innermost host operation running at time t."""
        i = bisect.bisect_right(self._starts(), t)
        for j in range(i - 1, max(-1, i - 400), -1):
            n, s, e = self.host[j]
            if e >= t:
                return n
        return "host (no operation recorded)"

    def _starts(self):
        if not hasattr(self, "_start_list"):
            self._start_list = [h[1] for h in self.host]
        return self._start_list

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle time by
        the host operation that ran while the device waited."""
        ops = defaultdict(int)
        for n, s, e in self.kernels:
            ops[n] += e - s
        idle = defaultdict(int)
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:20000]
        for s, e in gaps:
            idle[self.host_op_at((s + e) // 2)] += e - s
        top = lambda d: [[n[:160], v * 1e-9] for n, v in
                         sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def profiled(fn):
    """Run fn under torch.profiler (host and device); returns (fn's result,
    Trace). Raises DeviceRecordsLost where the profiler kept no device
    record of a window that launched work on the card."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            out = fn()
        if cuda:
            torch.cuda.synchronize()
    trace = Trace(prof.profiler.kineto_results.events())
    if not trace.kernels:
        launches = sum(1 for n, _, _ in trace.host if n.startswith(
            ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cudaMemset")))
        raise DeviceRecordsLost(
            f"the profiler kept no device record of the traced window "
            f"({launches} launch calls on the host)")
    return out, trace


class DevicePass:
    """Busy seconds of the device (its kernels, copies and sets, united)
    over the host's seconds of one call profiled with the device's activity
    alone."""

    def __init__(self, intervals, window_s: float):
        self.window_s = window_s
        busy, end = 0, None
        for s, e in sorted(intervals):
            s = s if end is None else max(s, end)
            if e > s:
                busy += e - s
            end = e if end is None else max(end, e)
        self.busy_s = busy * 1e-9


def device_pass(fn):
    """Run fn under torch.profiler with the device's activity alone, so that
    the host runs at nearly its untraced pace; returns (fn's result,
    DevicePass). The window is the host's wall time of fn, from a
    synchronised start to a synchronised end. Raises DeviceRecordsLost
    where the profiler kept no device record."""
    import time
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise DeviceRecordsLost("no CUDA device to trace")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    iv = [(e.start_ns(), e.start_ns() + e.duration_ns())
          for e in prof.profiler.kineto_results.events()
          if e.device_type() == torch.autograd.DeviceType.CUDA
          and not getattr(e, "is_user_annotation", lambda: False)()]
    if not iv:
        raise DeviceRecordsLost("the profiler kept no device record of the "
                                "device-only pass")
    return out, DevicePass(iv, wall)


def stage_intervals(trace: Trace, syncs_per_call: int, stages: dict):
    """{stage: [(lo, hi), ...]} from the synchronisations that the program's
    stage clock makes at each mark: each call makes `syncs_per_call` of
    them, and stage name runs from the end of its call's sync a to the end
    of sync b, for stages[name] = (a, b). None where the count does not
    fit."""
    s = trace.syncs()
    if not s or len(s) % syncs_per_call:
        return None
    out = defaultdict(list)
    for c in range(0, len(s), syncs_per_call):
        call = s[c:c + syncs_per_call]
        for name, (a, b) in stages.items():
            out[name].append((call[a][1], call[b][1]))
    return dict(out)
