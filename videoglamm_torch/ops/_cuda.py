"""Build and load the hand-written CUDA kernels of `videoglamm_torch/csrc`.

Each `csrc/<name>.cu` has a plain C interface. At first use it is compiled
with nvcc for Hopper (sm_90a) into a shared library under `build/kernels/`
beside the package (listed in .gitignore), keyed by a hash of the source, the
shared headers `csrc/*.cuh` and the flags, and loaded with ctypes. Nothing is compiled at import time: the
CPU tests import every module on a machine with no nvcc.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float     # compile time of this process' build (0 if cached)
    ptxas_log: str     # nvcc's -Xptxas -v report (registers, shared memory)


_lock = threading.Lock()          # guards the two tables below
_name_locks: dict = {}            # one build at a time per source
_built: dict = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of videoglamm_torch "
                           "are built at first use and need the CUDA toolkit")
    return found


def load(name: str) -> Built:
    """Compile `csrc/<name>.cu` if needed and return the loaded library.
    Different sources may build at the same time (`load_all`)."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _built:
            return _built[name]
        src = CSRC / f"{name}.cu"
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        digest = hashlib.sha256(
            src.read_bytes() + headers
            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"lib{name}-{digest}.so"
        log, seconds = "", 0.0
        if not so.exists():
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                  capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
            log = proc.stderr
            os.replace(tmp, so)
        built = Built(ctypes.CDLL(str(so)), so, seconds, log)
        _built[name] = built
        return built


def constants(name: str) -> dict:
    """The `constexpr int NAME = <integer>;` lines of `csrc/<name>.cu` as
    {NAME: value}: a kernel's constants that its Python plan needs too,
    read from the source so that they have one definition."""
    return _constexprs((CSRC / f"{name}.cu").read_text())


def _constexprs(text: str) -> dict:
    return {m[1]: int(m[2]) for m in
            re.finditer(r"^constexpr int (\w+) = (-?\d+);", text, re.M)}


def build_variant(name: str, overrides: dict):
    """`csrc/<name>.cu` rebuilt with `overrides` ({NAME: value} of its
    `constexpr int` lines) into the build directory's `variants/`, for the
    experiments that time a kernel's constants against each other. Returns
    (the Built library, the variant's constants as `constants` gives them)."""
    src = (CSRC / f"{name}.cu").read_text()
    for key, value in overrides.items():
        src, n = re.subn(rf"^constexpr int {key} = -?\d+;",
                         f"constexpr int {key} = {value};", src, flags=re.M)
        if n != 1:
            raise ValueError(f"no constexpr int {key} in {name}.cu")
    tag = "_".join(f"{k}{v}" for k, v in sorted(overrides.items()))
    out = BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}_{tag}.cu", out / f"lib{name}_{tag}.so"
    cu.write_text(src)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stderr}")
    return (Built(ctypes.CDLL(str(so)), so, time.perf_counter() - t0,
                  proc.stderr), _constexprs(src))


def spills(log: str) -> list:
    """The lines of an nvcc log (`-Xptxas -v`) that report spilled registers."""
    return [l for l in log.splitlines() if "spill" in l
            and "0 bytes spill stores, 0 bytes spill loads" not in l]


def load_all(names) -> dict:
    """Build several sources at once, one nvcc process each, all started
    together. Returns {name: Built}."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(load, names)))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index` (persistent grids
    are sized from it)."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_ptr(t) -> int:
    """Raw handle of PyTorch's current stream on `t`'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def check_operand(t, name: str, dtype) -> None:
    """Kernel operands: on a CUDA device, of `dtype`, contiguous in the last
    dim, 16-byte aligned, with every stride a multiple of 8 elements."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the last dim must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer is not 16-byte aligned")
    if any(s % 8 for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1):
        raise ValueError(f"{name}: strides {t.stride()} are not multiples of 8")
