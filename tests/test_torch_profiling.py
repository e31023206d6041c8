"""The port's profiling hooks (videoglamm_torch.utils.profiling) against
videoglamm_tpu.utils.profiling on the CPU: `StepTimer.summary()` equal to
JAX's on the same samples, a `profile_trace` with `annotate` that writes a
Chrome trace holding the region's name, and `device_memory_report()` under
JAX's keys (the card's numbers: tests/test_torch_cuda.py)."""
import json
import os
import warnings

import numpy as np
import pytest
import torch

from videoglamm_tpu.utils import profiling as jprof
from videoglamm_torch.ops import norms
from videoglamm_torch.utils import (DeviceRecordsLost, StepTimer, annotate,
                                    device_memory_report, profile_trace)
from videoglamm_torch.utils import profiling as tprof
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("samples", [[], [0.5], [0.25, 1.0, 0.125, 3.0, 0.5],
                                     list(np.random.RandomState(0).rand(101))])
def test_step_timer_summary_equals_jax(samples):
    jt, tt = jprof.StepTimer(), StepTimer()
    jt.samples, tt.samples = list(samples), list(samples)
    assert tt.summary() == jt.summary()


def test_step_timer_times_a_step():
    t = StepTimer()
    for _ in range(3):
        t.start()
        x = torch.ones(64, 64) @ torch.ones(64, 64)
        assert t.stop(x) >= 0.0
    s = t.summary()
    assert s["n"] == 3 and 0.0 <= s["p50_s"] <= s["p99_s"]


def test_profile_trace_writes_the_annotation(tmp_path):
    with profile_trace(str(tmp_path)) as prof:
        with annotate("vp/region_under_test"):
            y = torch.randn(32, 32) @ torch.randn(32, 32)
            float(y.sum())
    path = os.path.join(str(tmp_path), tprof.TRACE_FILE)
    trace = json.load(open(path))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "vp/region_under_test" in names
    assert any(e.key == "vp/region_under_test" for e in prof.key_averages())


def test_profile_trace_warns_when_a_launch_leaves_no_device_record(tmp_path,
                                                                   monkeypatch):
    """A window in which a port kernel launched (its counter moved: here
    moved by hand, as a launch on the card moves it) but whose trace holds
    no device record is flagged; the trace is still written."""
    with pytest.warns(DeviceRecordsLost, match="counters moved by 1"):
        with profile_trace(str(tmp_path)):
            monkeypatch.setitem(norms.LAUNCHES, "rms", norms.LAUNCHES["rms"] + 1)
    assert os.path.exists(os.path.join(str(tmp_path), tprof.TRACE_FILE))


def test_profile_trace_without_card_work_does_not_warn(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeviceRecordsLost)
        with profile_trace(str(tmp_path)):
            float((torch.randn(32, 32) @ torch.randn(32, 32)).sum())


@pytest.mark.parametrize("port_launched,lost", [(0, False), (1, True)])
def test_device_records_lost_reads_launches_and_device_rows(port_launched, lost,
                                                            monkeypatch):
    """On a CPU-only profile (no device row, no CUDA call): lost exactly
    when the port's counters say a kernel launched; `port_launches` grows
    with any wrapper's counter."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        float((torch.randn(16, 16) @ torch.randn(16, 16)).sum())
    assert tprof.device_records_lost(prof, port_launched) is lost
    before = tprof.port_launches()
    monkeypatch.setitem(norms.LAUNCHES, "ln", norms.LAUNCHES["ln"] + port_launched)
    assert tprof.port_launches() == before + port_launched


def test_device_memory_report_has_jax_keys():
    want = set(jprof.device_memory_report()[0])
    rep = device_memory_report()
    assert rep and all(set(r) == want for r in rep)
    if not torch.cuda.is_available():
        assert rep == [{"device": "cpu", "bytes_in_use": None,
                        "peak_bytes_in_use": None, "bytes_limit": None}]
