"""A/B of K5's f32 routes (csrc/dequant_gemv.cu) at the five Phi-3 decode
products (qkv [9216,3072], o [3072,3072], gate_up [16384,3072], down
[3072,8192], lm_head [32065,3072]), int8 and int4 (group 128), f32 x of a
few rows:
- "cuda": the CUDA-core route (the one-row design in tiles of up to 4
  rows), forced through its plan, beside "tc": the tensor-core route as
  built. Their times at 2 to 5 rows choose the crossovers (`F32_TC_MIN_M`
  and its variants by the channels an SM holds);
- each NAME=VALUE[,NAME=VALUE] argument: the source rebuilt with those
  `constexpr int` lines changed (the planes' layout TC_PN_MAX_W, the stage
  depths TC_KS_*, the fresh accumulators' k-block TC_BK, ...), its tensor-core
  route planned with the variant's constants (`k5_plan(..., src=)`; left
  out of a case its plan refuses).
Every output is held to the plain f32 twin within 2e-6 relative L2. Each
call is timed by chip_smoke.py's `time_ms` as CUDA-graph replays over
weight copies rotated past the L2 (as its f32q phase times K5), in turns
(cuda, tc, variants, variants reversed, tc, cuda); the mean of the two
turns is printed per product, then the sums over the five products.

    python -m videoglamm_torch.experiments.k5_f32_variants [NAME=VALUE ...] [--rows 2,3,4,5,8,64] [--kinds int8,int4]

Run from the repo's root. Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
import math
import statistics
import sys

import torch

from ..ops import _cuda
from ..ops import quant as Q

PRODUCTS = (("qkv", 9216, 3072), ("o", 3072, 3072), ("gate_up", 16384, 3072),
            ("down", 3072, 8192), ("lm_head", 32065, 3072))
TOL_L2 = 2e-6


def build_variant(overrides: dict):
    """csrc/dequant_gemv.cu rebuilt with `overrides` ({NAME: value} of its
    constexpr int lines) -> (the library, the variant's constants)."""
    built, consts = _cuda.build_variant("dequant_gemv", overrides)
    serial = sum("serialized" in l for l in built.ptxas_log.splitlines())
    print(f"variant {overrides}: built; spills {len(_cuda.spills(built.ptxas_log))}, "
          f"serialized wgmma warnings {serial}", flush=True)
    return built.lib, consts


def call_lib(lib, kind, x, w, s, N, group, plan):
    """One launch of a variant library's f32 entry (`_launch_gemv`'s)."""
    fn = getattr(lib, f"vgt_dequant_gemv_{kind}_f32")
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [P, L, P, P, P, L, I, I, I] + ([I] if kind == "int4" else []) + [P, I, P]
    fn.restype = ctypes.c_int
    M, K = x.shape
    f = plan.fields()
    fields = (ctypes.c_int * len(f))(*f)
    out = torch.empty((M, N), device=x.device)
    tail = [group] if kind == "int4" else []
    err = fn(x.data_ptr(), x.stride(0), w.data_ptr(), s.data_ptr(),
             out.data_ptr(), out.stride(0), M, N, K, *tail, fields, len(fields),
             _cuda.stream_ptr(x))
    _cuda.check_launch(err, "k5_f32_variants")
    return out


def main(argv=None) -> int:
    from chip_smoke import rel_l2, time_ms   # run from the repo's root
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"--rows": "2,3,4,5,8,64", "--kinds": "int8,int4"}
    for key in list(opts):
        if key in argv:
            i = argv.index(key)
            opts[key] = argv[i + 1]
            del argv[i:i + 2]
    rows = [int(r) for r in opts["--rows"].split(",")]
    kinds = opts["--kinds"].split(",")
    variants = {spec: build_variant({k: int(v) for k, v in
                                     (kv.split("=") for kv in spec.split(","))})
                for spec in argv}
    print(f"{torch.cuda.get_device_name(0)}; the crossovers "
          + ", ".join(f"{k} {v}" for k, v in Q._K5.items() if k.startswith("F32_TC_")),
          flush=True)
    g = torch.Generator(device="cuda").manual_seed(22)
    sums = {}
    for name, N, K in PRODUCTS:
        wf = torch.randn(N, K, device="cuda", generator=g) * K ** -0.5
        q8, s8 = Q.quantize_int8(wf)
        p4, s4 = Q.quantize_int4(wf, 128)
        del wf
        ring = max(2, min(16, math.ceil(150e6 / (N * K))))
        weights = {"int8": [(q8, s8)] + [(q8.clone(), s8) for _ in range(ring - 1)],
                   "int4": [(p4, s4)] + [(p4.clone(), s4.clone())
                                         for _ in range(2 * ring - 1)]}
        for kind in kinds:
            group = 128 if kind == "int4" else 0
            ws = weights[kind]
            for M in rows:
                if kind == "int4" and M > Q.MATVEC4_MAX_M:
                    continue
                x = torch.randn(M, K, device="cuda", generator=g)
                ref = (Q._dequant4_matmul_plain(x, *ws[0], 128) if group
                       else Q._dequant_matmul_plain(x, *ws[0]))
                turn = iter(range(1 << 30))
                fns = {}
                for route, tc in (("cuda", False), ("tc", True)):
                    plan = Q.k5_plan(M, N, K, group, _cuda.sm_count(0), f32=True, tc=tc)
                    fns[route] = (lambda plan=plan: Q._launch_gemv(
                        kind, x, *ws[next(turn) % len(ws)], N, group, plan))
                for spec, (lib, consts) in variants.items():
                    try:
                        plan = Q.k5_plan(M, N, K, group, _cuda.sm_count(0),
                                         f32=True, tc=True, src=consts)
                    except ValueError:       # the variant's layout does not take it
                        continue
                    fns[spec] = (lambda lib=lib, plan=plan: call_lib(
                        lib, kind, x, *ws[next(turn) % len(ws)], N, group, plan))
                for route, fn in fns.items():
                    err = rel_l2(fn(), ref)
                    if not err <= TOL_L2:
                        raise AssertionError(f"{route} {kind} {name} M={M}: "
                                             f"relative L2 {err:.3e}")
                order = list(fns) + list(reversed(fns))
                got = {n: [] for n in fns}
                for n in order:
                    got[n].append(time_ms(fns[n], graphed=True))
                ms = {n: statistics.mean(v) for n, v in got.items()}
                for n, v in ms.items():
                    sums[(kind, M, n)] = sums.get((kind, M, n), 0.0) + v
                print(f"{kind} {name:7s} [{N},{K}] M={M}: "
                      + "  ".join(f"{n} {v:.4f}" for n, v in ms.items()), flush=True)
                del x, ref
        del weights, q8, s8, p4, s4
        torch.cuda.empty_cache()
    for kind in kinds:
        for M in rows:
            line = [f"{n} {v:.4f}" for (k, m, n), v in sums.items()
                    if k == kind and m == M]
            if line:
                print(f"sum of the five products, {kind} M={M} (ms): " + "  ".join(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
