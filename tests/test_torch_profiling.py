"""The port's profiling hooks (videoglamm_torch.utils.profiling) against
videoglamm_tpu.utils.profiling on the CPU: `StepTimer.summary()` equal to
JAX's on the same samples, a `profile_trace` with `annotate` that writes a
Chrome trace holding the region's name, and `device_memory_report()` under
JAX's keys (the card's numbers: tests/test_torch_cuda.py)."""
import json
import os

import numpy as np
import pytest
import torch

from videoglamm_tpu.utils import profiling as jprof
from videoglamm_torch.utils import (StepTimer, annotate, device_memory_report,
                                    profile_trace)
from videoglamm_torch.utils import profiling as tprof


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


def test_device_memory_report_has_jax_keys():
    want = set(jprof.device_memory_report()[0])
    rep = device_memory_report()
    assert rep and all(set(r) == want for r in rep)
    if not torch.cuda.is_available():
        assert rep == [{"device": "cpu", "bytes_in_use": None,
                        "peak_bytes_in_use": None, "bytes_limit": None}]
