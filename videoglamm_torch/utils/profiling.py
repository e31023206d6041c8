"""Tracing / profiling hooks (the port's counterpart of
videoglamm_tpu/utils/profiling.py): a `torch.profiler` trace written as a
Chrome trace, named regions that show on its timeline (and as NVTX ranges
when CUDA is present), a host-side step timer with percentile stats, and a
per-card memory report. `timing.StageClock` is the serving pipeline's
stage clock; this module is for a user's own runs.
"""
from __future__ import annotations

import contextlib
import os
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

TRACE_FILE = "trace.json"


class DeviceRecordsLost(RuntimeWarning):
    """A profiled window launched work on the card, and the profiler handed
    back no device record (kernel, copy or fill) for it."""


# host-side CUDA calls that put work on the card
_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel",
                 "cudaGraphLaunch", "cudaMemcpy", "cudaMemset")


def port_launches() -> int:
    """A sum that grows with every launch of the port's kernels: the
    wrappers' counters, which count only launches on the card."""
    from ..experiments import decode_mlp
    from ..ops import attention, fused_block, norms, quant
    return sum(sum(c.values()) for c in (attention.LAUNCHES, fused_block.LAUNCHES,
                                         norms.LAUNCHES, quant.LAUNCHES,
                                         decode_mlp.LAUNCHES))


def device_records_lost(prof, port_launched: int = 0) -> bool:
    """Whether a finished `torch.profiler.profile` window launched work on
    the card (`port_launched` of the port's kernels, or a CUDA launch, copy
    or fill call among its host events) and yet holds no device record."""
    rows = prof.key_averages()
    if any(e.device_type == torch.autograd.DeviceType.CUDA for e in rows):
        return False
    return port_launched > 0 or any(e.key.startswith(_LAUNCH_CALLS) for e in rows)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the CPU and, when a card is present, CUDA activity of the
    block; on exit write `log_dir/trace.json` (Chrome trace format, for
    chrome://tracing or Perfetto). Yields the `torch.profiler.profile`,
    whose `key_averages()` sums the events by name. Warns
    `DeviceRecordsLost` when the block launched work on the card and the
    trace holds no device record of it: the profiler now and then drops
    every device record of a window, late in a long-lived process."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    launched = port_launches()
    with profile(activities=acts) as prof:
        yield prof
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    launched = port_launches() - launched
    if device_records_lost(prof, launched):
        warnings.warn(f"profile_trace: the block launched work on the card "
                      f"(the port's launch counters moved by {launched}), and "
                      f"{path} holds no device record of it", DeviceRecordsLost,
                      stacklevel=3)


@contextlib.contextmanager
def annotate(name: str):
    """Named region on the trace timeline (`record_function`), and an NVTX
    range when CUDA is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Host-side step timing with percentile summaries. `stop(sync_value)`
    waits for the device work behind a tensor before it reads the clock:
    a CUDA tensor's device is synchronised (a failure there raises)."""

    def __init__(self):
        self.samples: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_value=None) -> float:
        if torch.is_tensor(sync_value) and sync_value.device.type == "cuda":
            torch.cuda.synchronize(sync_value.device)
        dt = time.perf_counter() - self._t0
        self.samples.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        s = np.asarray(self.samples)
        if not len(s):
            return {}
        return {
            "mean_s": float(s.mean()),
            "p50_s": float(np.percentile(s, 50)),
            "p90_s": float(np.percentile(s, 90)),
            "p99_s": float(np.percentile(s, 99)),
            "n": int(len(s)),
        }


def device_memory_report() -> List[Dict]:
    """Memory of each visible card (bytes), under the JAX report's keys:
    `bytes_in_use` and `peak_bytes_in_use` from `torch.cuda.memory_stats`
    (the caching allocator's live and peak allocated bytes), `bytes_limit`
    the card's total memory. Without a card: one CPU entry whose numbers
    are None, as JAX reports for its CPU device."""
    if not torch.cuda.is_available():
        return [{"device": "cpu", "bytes_in_use": None,
                 "peak_bytes_in_use": None, "bytes_limit": None}]
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i}",
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        })
    return out
