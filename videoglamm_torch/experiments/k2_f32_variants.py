"""A/B of K2's f32 route (csrc/gemm_f32.cu) against builds of the same
source with other tile constants, at the 16 products of Hiera-L's four
stages over 8 SAM frames at 1024 (M = 524,288 / 131,072 / 32,768 / 8,192
rows; C = 144 * 2^s: qkv [M,C] x [3C,C], proj [M,C] x [C,C] + residual,
fc1 [M,C] x [4C,C] + GELU, fc2 [M,4C] x [C,4C] + residual).

Each variant is the source with some `constexpr int NAME = value;` lines
changed, built with nvcc into `build/kernels/variants/` and called through
the same C entry (`vgt_gemm_f32`). Per product the built kernel and each
variant are timed in turns (base, variants, variants reversed, base) by
chip_smoke.py's `time_ms` (CUDA events over batches of calls of at least
5 ms), and held to the base's output within
1e-5 relative L2; `F.linear` f32 (TF32 off, torch's default) is timed
beside them. Prints ms per product and the sums over the launches of an
f32 request at the stages timed (42 blocks: 2, 5, 32, 3 a stage, 4
products each: 168 launches at all four).

    python -m videoglamm_torch.experiments.k2_f32_variants KBLOCK=32 [NAME=VALUE ...] [--stages 1,2,3,4]

A variant may be several overrides joined by commas (KBLOCK=32,STAGES=2).
Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
import statistics
import sys

import torch
import torch.nn.functional as F

from ..ops import _cuda
from ..ops import fused_block as FB

BLOCKS = (2, 5, 32, 3)         # Hiera-L's blocks a stage
ROWS = (524288, 131072, 32768, 8192)


def build_variant(overrides: dict):
    """The C entry of csrc/gemm_f32.cu rebuilt with `overrides`
    ({NAME: value} of its constexpr int lines)."""
    built, _ = _cuda.build_variant("gemm_f32", overrides)
    if _cuda.spills(built.ptxas_log):
        raise RuntimeError(f"{overrides} spills: {_cuda.spills(built.ptxas_log)}")
    fn = built.lib.vgt_gemm_f32
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [P, L, P, P, P, L, P, L, I, I, I, I, P]
    fn.restype = ctypes.c_int
    return fn


def call(fn, a, w, b, gelu, r):
    M, K = a.shape
    N = w.shape[0]
    out = torch.empty((M, N), device=a.device)
    err = fn(a.data_ptr(), a.stride(0), w.data_ptr(), b.data_ptr(),
             r.data_ptr() if r is not None else None,
             r.stride(0) if r is not None else 0, out.data_ptr(), out.stride(0),
             M, N, K, 1 if gelu else 0, _cuda.stream_ptr(a))
    _cuda.check_launch(err, "k2_f32_variants")
    return out


def main(argv=None) -> int:
    from chip_smoke import rel_l2, time_ms   # run from the repo's root
    argv = list(sys.argv[1:] if argv is None else argv)
    stages = (1, 2, 3, 4)
    if "--stages" in argv:
        i = argv.index("--stages")
        stages = tuple(int(s) for s in argv[i + 1].split(","))
        del argv[i:i + 2]
    variants = {}
    for spec in argv:
        variants[spec] = build_variant(
            {k: int(v) for k, v in (kv.split("=") for kv in spec.split(","))})
    base = FB._gemm_fn("gemm_f32", "vgt_gemm_f32")
    print(f"{torch.cuda.get_device_name(0)}; base {dict(FB.k2_f32_plan(1, 8, 8))}")
    g = torch.Generator(device="cuda").manual_seed(17)
    names = ["base", *variants, "F.linear"]
    totals = dict.fromkeys(names, 0.0)
    for s in stages:
        M, C = ROWS[s - 1], 144 * 2 ** (s - 1)
        for prod, (N, K, gelu, res) in (("qkv", (3 * C, C, False, False)),
                                        ("proj", (C, C, False, True)),
                                        ("fc1", (4 * C, C, True, False)),
                                        ("fc2", (C, 4 * C, False, True))):
            a = torch.randn(M, K, device="cuda", generator=g)
            w = torch.randn(N, K, device="cuda", generator=g) * K ** -0.5
            b = 0.1 * torch.randn(N, device="cuda", generator=g)
            r = torch.randn(M, N, device="cuda", generator=g) if res else None
            want = call(base, a, w, b, gelu, r)
            fns = {"base": lambda f=base: call(f, a, w, b, gelu, r)}
            for name, fn in variants.items():
                err = rel_l2(call(fn, a, w, b, gelu, r), want)
                if not err <= 1e-5:
                    raise AssertionError(f"{name} stage {s} {prod}: {err:.3e}")
                fns[name] = lambda f=fn: call(f, a, w, b, gelu, r)
            order = list(fns) + list(reversed(fns))
            got = {n: [] for n in fns}
            for n in order:
                got[n].append(time_ms(fns[n], min_ms=5.0))
            ms = {n: statistics.mean(v) for n, v in got.items()}
            ms["F.linear"] = time_ms(lambda: F.linear(a, w, b), min_ms=5.0)
            for n in names:
                totals[n] += BLOCKS[s - 1] * ms[n]
            print(f"stage {s} {prod:4s} [{M},{K}] x [{N},{K}]: "
                  + "  ".join(f"{n} {ms[n]:.4f}" for n in names), flush=True)
            del a, w, b, r, want
            torch.cuda.empty_cache()
    print(f"sum over an f32 request's launches at stages {stages} (ms): "
          + "  ".join(f"{n} {totals[n]:.1f}" for n in names))
    return 0


if __name__ == "__main__":
    sys.exit(main())
