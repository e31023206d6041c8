"""The yardstick: FLOP and byte counts against hand counts at the tiny
size, the metric readers on a made-up trace, and cells found by name."""
from __future__ import annotations

from bench_cells import one_thread  # noqa: F401  (sys.path, one thread)

import json
import shutil
import subprocess
import sys

import pytest

import flops as F
import harness
from bench_cells import BENCH, ROOT, tiny_config
from tracing import DevicePass, Trace


@pytest.fixture
def c():
    return tiny_config("videoglamm-phi3mini-sam2l-w8kv8")


def test_llm_counts_by_hand(c):
    # tiny Phi-3: hidden 64, 4 heads of 16, kv 4 heads, ffn 128, 2 layers
    per_token = 2 * (64 * (64 + 2 * 64) + 64 * 64 + 64 * 256 + 128 * 64)
    assert F.llm_tokens(c, 5) == 2 * 5 * per_token
    assert F.llm_attention(c, 5, 5, True) == 2 * 4 * 5 * 5 * 64 * 0.5
    assert F.lm_head(c, 3) == 2 * 3 * 64 * 513
    assert F.llm_decode_step(c, 7) == (2 * per_token + 2 * 4 * 7 * 64
                                       + 2 * 64 * 513)


def test_visual_tokens_and_towers_by_hand(c):
    # 4 frames x (2x2 pooled video + 2x2 pooled context)
    assert F.visual_tokens(c) == 4 * (4 + 4)
    # InternVideo2 tiny: embed 32, patch 14 on 28 -> 2x2 grid, 2-frame chunks,
    # ffn 64, depth 2 (1 block runs)
    n = 2 * 4 + 1
    block = 2 * n * 32 * 96 + 2 * n * 32 * 32 + 2 * 2 * n * 32 * 64 + 4 * n * n * 32
    assert F.internvideo2(c, 2, 2) == 2 * (2 * 8 * 3 * 196 * 32 + block)


def test_kernel_bytes_by_hand(c):
    fl, nb = F.k5_call(8, 192, 64)
    assert fl == 2 * 8 * 64 * 192
    assert nb == 192 * 64 + 4 * 192 + 2 * 8 * 64 + 2 * 8 * 192
    fl, nb = F.k4_call(c, [10, 12])
    assert fl == 4 * 4 * 16 * 22
    assert nb == 22 * 4 * (2 * 16 + 8) + 2 * 4 * 16 * 4
    fl, nb = F.k6_call(c, 4, [4, 3])
    assert F.causal_pairs(4, 3) == 6 + 3
    assert fl == 5 * 2 * (10 + 9) * 16 * 4
    assert nb == 2 * 4 * 4 * (8 * 16 * 2 + 8)
    assert F.least_s(989e12, 0) == 1.0 and F.least_s(0, 3.35e12) == 1.0


class _E:
    def __init__(self, name, start, dur, cuda):
        import torch
        self._n, self._s, self._d = name, start, dur
        self._t = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU

    def name(self): return self._n
    def start_ns(self): return self._s
    def duration_ns(self): return self._d
    def device_type(self): return self._t
    def is_user_annotation(self): return False


def _trace():
    return Trace([_E("benchmark.window", 0, 1000, False),
                  _E("aten::mm", 0, 400, False),
                  _E("cudaDeviceSynchronize", 500, 100, False),
                  _E("gemv_mma_kernel<false>", 100, 200, True),
                  _E("decode_q8_kernel<1, 24>", 250, 150, True),
                  _E("gemv_rows_kernel", 700, 100, True)])


def test_trace_busy_idle_and_breakdown():
    t = _trace()
    assert t.window_s == pytest.approx(1e-6)
    assert t.busy_s() == pytest.approx(400e-9)      # [100,400] + [700,800]
    assert t.busy_s(0, 300) == pytest.approx(200e-9)
    assert t.kernel_s("gemv_") == pytest.approx(300e-9)
    assert t.kernel_s("flash_bwd") is None
    b = t.breakdown()
    assert b["device_ops"][0] == ["gemv_mma_kernel<false>", pytest.approx(200e-9)]
    idle = dict((n, v) for n, v in b["idle_gaps"])
    assert idle["aten::mm"] == pytest.approx(100e-9)          # [0, 100]
    assert sum(idle.values()) == pytest.approx(600e-9)


def test_metric_readers_on_a_made_up_trace(c):
    layer = {"config": c, "traffic": {"new_tokens": 2}, "trace": _trace(),
             "traced_lengths": [6, 7], "peak_bytes": 2**30,
             "stage_intervals": {"generate": [(0, 500)]},
             "stage_times": [{"generate": 4e-7}, {"generate": 6e-7}],
             "device_pass": DevicePass([(100, 400), (300, 500), (700, 800)], 1e-6)}
    m = harness.read_metrics(
        [{"name": n, "unit": "%"} for n in
         ("generate_busy.serve", "device_idle.serve", "k5_roofline.serve",
          "k4_roofline.serve")] + [{"name": "peak_mem_gib.serve", "unit": "GiB"}],
        layer)
    # 300 ns of kernels in the traced stage over the untraced 500 ns
    assert m["generate_busy.serve"]["value"] == pytest.approx(60.0)
    # [100, 500] and [700, 800] busy of 1000 ns
    assert m["device_idle.serve"]["value"] == pytest.approx(50.0)
    assert m["peak_mem_gib.serve"]["value"] == 1.0
    # least time of the tiny products over 300 ns of K5 time
    rows, steps = 2, 2
    least = sum(F.least_s(*F.k5_call(rows, n, k))
                for n, k in F.llm_layer_weights(c).values()) * 2
    head = F.least_s(*F.k5_call(rows, 513, 64))
    want = 100 * (steps * (least + head) + head) / 300e-9
    assert m["k5_roofline.serve"]["value"] == pytest.approx(want)
    stage = {"stage_times": [{"generate": 1.0}, {"generate": 3.0}]}
    m = harness.read_metrics([{"name": "serve_stage_s.generate", "unit": "s"},
                              {"name": "serve_stage_s.track_test_absent", "unit": "s"}][:1],
                             stage)
    assert m["serve_stage_s.generate"]["value"] == 2.0


def test_dropped_in_traffic_and_metric_files_are_found(tmp_path):
    """A later change adds a cell, its traffic and a metric as files and
    entries only; the harness finds them by name."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "benchmark" / "traffic" / "gcg-closed-b2-short.json").write_text(
        json.dumps({"driver": "serve_closed_loop", "batch": 2}))
    (tmp_path / "benchmark" / "metrics" / "launches.serve.py").write_text(
        "def read(layer):\n    return layer['n'] * 2\n")
    bench["workloads"].append({"name": "serve-gcg-b2", "config": bench["configs"][0]["name"],
                               "traffic": "gcg-closed-b2-short", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "launches.serve", "unit": "launches", "better": "lower",
                               "source": "program_counter", "layer": "Device",
                               "moves": "serve_frames_per_s", "workloads": ["serve-gcg-b2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (f"import sys; sys.path[:0] = ['{tmp_path / 'benchmark'}']\n"
            "import harness\n"
            "cell = harness.load_cell('serve-gcg-b2')\n"
            "assert cell['traffic']['batch'] == 2, cell['traffic']\n"
            "assert [m['name'] for m in cell['per_layer']] == ['launches.serve']\n"
            "m = harness.read_metrics(cell['per_layer'], {'n': 21})\n"
            "assert m == {'launches.serve': {'value': 42.0, 'unit': 'launches'}}, m\n"
            "print('found')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path)
    assert out.returncode == 0 and "found" in out.stdout, out.stderr


def test_benchmark_files_refer_to_existing_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        t = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{t['driver']}.py").is_file()
    for m in bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_a_multimask_choice_within_bf16_rounding_goes_either_way():
    """Where the single mask is unstable, a served mask is judged against
    the multimask candidate nearest it among those whose predicted IoU is
    within IOU_TIE of the highest; outside that, and for a stable single
    mask, against the reference's own choice."""
    import torch
    import checks
    from vgref.serve import Followed
    sam2 = {"dynamic_multimask_stability_delta": 0.05,
            "dynamic_multimask_stability_thresh": 0.98}
    g = torch.Generator().manual_seed(0)
    cm = torch.randn(3, 1, 4, 8, 8, generator=g)      # 3 slots, 1 frame
    cm[2, 0, 0] = 5.0                                  # slot 2: single stable
    ci = torch.tensor([[[0.1, 0.5001, 0.5000, 0.4]],   # 1 and 2 tied
                       [[0.1, 0.5100, 0.5000, 0.4]],   # 1 ahead by far
                       [[0.1, 0.5001, 0.5000, 0.4]]])
    own = torch.stack([cm[0, 0, 1], cm[1, 0, 1], cm[2, 0, 0]])[:, None]
    f = Followed(torch.zeros(0), torch.ones(3, dtype=torch.bool), own, (cm, ci))
    served = torch.stack([cm[0, 0, 2], cm[1, 0, 2], cm[2, 0, 2]])[:, None] + 1e-3
    ref, moved = checks.judged_reference(served, f, sam2)
    assert torch.equal(ref[0, 0], cm[0, 0, 2]) and moved == 1
    assert torch.equal(ref[1, 0], cm[1, 0, 1])
    assert torch.equal(ref[2, 0], cm[2, 0, 0])
    ref, moved = checks.judged_reference(own, f, sam2)
    assert torch.equal(ref, own) and moved == 0
