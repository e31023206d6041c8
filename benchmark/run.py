"""The benchmark of videoglamm_torch on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json from the root of a checkout: the cell's
configuration (benchmark/configs/), its traffic (benchmark/traffic/<name>.json,
whose `driver` names the code in benchmark/drivers/) and, with --trace 1,
its per-layer metrics (benchmark/metrics/<name>.py). Prints one JSON line
last on stdout: correct, attempted, failed, metrics, device, and with
--trace 1 the breakdown. Exits non-zero, printing no result, without
enough CUDA devices, outside a checkout that holds the program, or with
JAX or the JAX package loaded once the window has closed. Caches of
compiled kernels stay in build/ of the checkout (nvcc's libraries in
build/kernels/, Triton's in build/triton/)."""
from __future__ import annotations

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["USE_FLAX"] = "0"
for p in (ROOT, HERE, os.path.join(HERE, "reference")):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="judge the lower-precision control in the program's "
                         "place (not part of a benchmark run)")
    a = ap.parse_args(argv)
    t_start = harness.process_start()
    cell = harness.load_cell(a.workload)
    chips = cell["workload"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"{a.workload} needs {chips} CUDA device(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    return execute(cell, a.seed, a.seconds, bool(a.trace), "cuda", t_start,
                   a.control)


def execute(cell, seed: int, seconds: float, trace: bool, device: str,
            t_start: float, control: bool = False) -> int:
    """Run the cell's driver, then print the checks and the result line;
    `correct` holds when every number compared is within its limit. With
    `control`, the control's numbers stand in the program's place. Returns
    the exit code."""
    try:
        import videoglamm_torch  # noqa: F401
    except ImportError as e:
        harness.log(f"the program is not in this checkout: {e}")
        return 3
    import torch
    from tracing import DeviceRecordsLost
    drv = harness.driver(cell["traffic"]["driver"])
    try:
        out = drv.run(cell, seed=seed, seconds=seconds, trace=trace,
                      device=device, t_start=t_start, control=control)
    except DeviceRecordsLost as e:
        harness.log(f"traced run failed: {e}")
        return 5
    found = harness.forbidden_modules()
    if found:
        harness.log(f"loaded in this process after the window: {found}")
        return 4
    checks = out["checks"]
    if control:
        for name, value, limit in checks:
            harness.log(f"program {name}: {value!r} (limit {limit!r})")
        checks = out["control"]
    metrics = harness.read_metrics(cell["per_layer"], out["layer"]) if trace \
        else dict(out["metrics"])
    if trace:
        missing = [m["name"] for m in cell["per_layer"] if m["name"] not in metrics]
        if missing:
            harness.log(f"per-layer metrics with nothing to read: {missing}")
    chips = cell["workload"]["chips"]
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
           "count": chips, "memory_peak_bytes": int(out["peak_bytes"])}
    result = {"correct": all(v <= lim for _, v, lim in checks),
              "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = out["layer"]["device_pass"].busy_s
        dev["window_s"] = out["layer"]["device_pass"].window_s
        result["breakdown"] = out["layer"]["trace"].breakdown()
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
