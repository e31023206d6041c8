"""What every cell shares: finding a cell's files by name, process start,
the guard against JAX in the process, and the result line."""
from __future__ import annotations

import importlib.util
import json
import os
import resource
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent           # benchmark/
ROOT = BENCH.parent                                # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "videoglamm_tpu")


def process_start() -> float:
    """time.time() at which this process started (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


class HostClock:
    """What the host gave this process from its start to `report`: the
    process's CPU seconds (all its threads), its page faults and
    involuntary context switches, and the machine's steal time
    (/proc/stat), which a host-paced loop feels first."""

    def __init__(self):
        self.ru = resource.getrusage(resource.RUSAGE_SELF)
        self.stat = self._stat()

    @staticmethod
    def _stat():
        try:
            with open("/proc/stat") as f:
                v = [int(x) for x in f.readline().split()[1:]]
            return v[7] if len(v) > 7 else 0, sum(v[:8])
        except (OSError, ValueError):
            return 0, 0

    def report(self, wall_s: float) -> str:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        user = ru.ru_utime - self.ru.ru_utime
        sys_s = ru.ru_stime - self.ru.ru_stime
        steal, total = (b - a for a, b in zip(self.stat, self._stat()))
        return (f"host over the window: process CPU {user:.2f} s user + "
                f"{sys_s:.2f} s system ({(user + sys_s) / wall_s:.3f} of the "
                f"wall), {ru.ru_minflt - self.ru.ru_minflt} minor page faults, "
                f"{ru.ru_nivcsw - self.ru.ru_nivcsw} involuntary switches, steal "
                f"{100.0 * steal / total if total else 0.0:.2f}% of the machine's "
                f"CPU time, load average {os.getloadavg()[0]:.2f}")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_cell(workload: str, bench: dict = None) -> dict:
    """The cell's workload entry with its configuration and traffic files
    read, and the metrics it reports: {"workload", "config", "traffic",
    "end_to_end", "per_layer"}."""
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: {sorted(cells)}")
    w = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())

    def applies(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if applies(m)
                 and ("workloads" in m or m["moves"] in reported)]
    return {"workload": w, "config": config, "traffic": traffic,
            "end_to_end": e2e, "per_layer": per_layer}


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return load_module(BENCH / "drivers" / f"{name}.py", f"driver_{name}")


def read_metrics(per_layer: list, layer: dict) -> dict:
    """Each per-layer metric from its own reader, metrics/<name>.py; a
    reader that finds nothing to read returns None and the metric is left
    out."""
    out = {}
    for m in per_layer:
        reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                             "metric_" + m["name"].replace(".", "_"))
        v = reader.read(layer)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def emit(result: dict, checks: list):
    """The checks as the last lines on stderr, then the result line (the
    checks under the key that comes last) as the last line on stdout."""
    for name, value, limit in checks:
        log(f"check {name}: {value!r} (limit {limit!r})")
    result = dict(result)
    result["checks"] = {n: {"value": v, "limit": l} for n, v, l in checks}
    print(json.dumps(result), flush=True)
