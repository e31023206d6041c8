"""A/B of the decode-layer implementations at flagship scale (PyTorch port of
scripts/bench_decode_fused.py).

Times a stack of layers of the MLP half (norm -> gate_up -> GLU -> down ->
residual) over stacked int8 weights of the real size, each layer with its
own weights, so that at 32 layers (2.4 GB) every weight byte comes from
device memory and none from the L2 cache. Variants:

  chain     the port's serving chain as `Phi3DecoderLayer` runs it: `rms_norm`
            (plain below 64K elements, as the JAX package routes it) -> K5 ->
            silu * up -> K5 -> add
  chain_k3  the same with the norm forced onto K3 (`row_norm`)
  fused     K9 mlp, one launch a layer
  w8a8      K9 mlp_w8a8, one launch a layer

and the attention half's two programs the same way: `qkv` (K9 norm_matmul
against norm -> K5) and `o_proj` (K9 matmul_residual against K5 -> add).

Each variant runs eagerly (host clock around whole passes ending in a
synchronise: what a Python decode loop pays) and, on a CUDA device, as one
CUDA-graph replay of the whole stack (CUDA events: what the card needs).
Printed per variant: microseconds a layer, GB/s of weight bytes, and device
launches a layer from torch.profiler.

    python -m videoglamm_torch.experiments.bench_decode_fused [variants ...]
"""
from __future__ import annotations

import statistics
import sys
import time

import torch
import torch.nn.functional as F

from ..ops import norms, quant
from . import decode_mlp as dm

L = 32
K, I, D = 3072, 8192, 3072
N_QKV = 9216
EPS = 1e-5
MLP_VARIANTS = ("chain", "chain_k3", "fused", "w8a8")
ATTN_VARIANTS = ("qkv_chain", "qkv_fused", "o_chain", "o_fused")


def make_weights(layers: int, k: int, i: int, n_qkv: int, device, seed: int = 0):
    """Stacked random int8 codes and scales that keep the activations O(1)
    through the stack."""
    g = torch.Generator(device=device).manual_seed(seed)

    def codes(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, generator=g,
                             device=device)

    def scales(n, fan):
        return (0.5 + torch.rand(layers, n, generator=g, device=device)) \
            / (73.0 * fan ** 0.5)

    return dict(nw=torch.ones(layers, k, device=device),
                wgu=codes(layers, 2 * i, k), sgu=scales(2 * i, k),
                wd=codes(layers, k, i), sd=scales(k, i) * 0.1,
                wqkv=codes(layers, n_qkv, k), sqkv=scales(n_qkv, k),
                wo=codes(layers, k, k), so=scales(k, k) * 0.1)


def _norm(x, nw, forced_k3: bool):
    if forced_k3 and x.is_cuda:
        return norms.row_norm(x, nw, None, EPS, rms=True)
    return norms.rms_norm(x, nw, EPS)


def layer_fn(variant: str):
    """One layer of `variant`: (x, weights, layer index) -> x."""
    def chain(x, w, l, k3=False):
        h = _norm(x, w["nw"][l], k3)
        gate, up = quant.dequant_matmul(h, w["wgu"][l], w["sgu"][l]).chunk(2, -1)
        return x + quant.dequant_matmul(F.silu(gate) * up, w["wd"][l], w["sd"][l])

    def qkv_chain(x, w, l):
        # the product's rows feed nothing here: keep x and the stack's length
        quant.dequant_matmul(_norm(x, w["nw"][l], False), w["wqkv"][l],
                             w["sqkv"][l])
        return x

    def qkv_fused(x, w, l):
        dm.fused_norm_matmul_int8(x, w["nw"][l], w["wqkv"][l], w["sqkv"][l], EPS)
        return x

    return {
        "chain": chain,
        "chain_k3": lambda x, w, l: chain(x, w, l, True),
        "fused": lambda x, w, l: dm.fused_decode_mlp_int8(
            x, w["nw"][l], w["wgu"][l], w["sgu"][l], w["wd"][l], w["sd"][l], EPS),
        "w8a8": lambda x, w, l: dm.fused_decode_mlp_int8(
            x, w["nw"][l], w["wgu"][l], w["sgu"][l], w["wd"][l], w["sd"][l], EPS,
            w8a8=True),
        "qkv_chain": qkv_chain,
        "qkv_fused": qkv_fused,
        "o_chain": lambda x, w, l: x + quant.dequant_matmul(
            x, w["wo"][l], w["so"][l]),
        "o_fused": lambda x, w, l: dm.matmul_residual_int8(
            x, w["wo"][l], w["so"][l], x),
    }[variant]


def weight_bytes(variant: str, w) -> int:
    """int8 weight bytes one layer of `variant` streams."""
    names = {"qkv": ("wqkv",), "o": ("wo",)}.get(variant.split("_")[0],
                                                 ("wgu", "wd"))
    return sum(w[n][0].numel() for n in names)


def _device_launches(fn) -> float:
    """Device kernels of one call of fn, from torch.profiler (nan where the
    profiler sees no device time)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if "cuda" in str(e.device_type).lower()
            and (getattr(e, "self_device_time_total", 0)
                 or getattr(e, "self_cuda_time_total", 0))]
    return float(sum(e.count for e in rows)) if rows else float("nan")


def time_variant(variant: str, x, w, layers: int, reps: int = 8) -> dict:
    """Eager and graphed time of `layers` chained layers of `variant`."""
    step = layer_fn(variant)
    cuda = x.is_cuda

    def stack():
        y = x
        for l in range(layers):
            y = step(y, w, l)
        return y

    def sync():
        if cuda:
            torch.cuda.synchronize()

    with torch.no_grad():
        stack()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = stack()
        sync()
        eager_us = (time.perf_counter() - t0) / reps / layers * 1e6
        row = dict(variant=variant, rows=x.shape[0], eager_us=eager_us,
                   graph_us=None, launches=None,
                   finite=bool(torch.isfinite(out.float()).all()))
        if cuda:
            row["launches"] = _device_launches(stack) / layers
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                stack()
            graph.replay()
            sync()
            times = []
            for _ in range(reps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                graph.replay()
                b.record()
                sync()
                times.append(a.elapsed_time(b))
            row["graph_us"] = statistics.median(times) / layers * 1e3
    return row


def run_harness(variants=MLP_VARIANTS + ATTN_VARIANTS, rows=(1, 4),
                layers: int = L, k: int = K, i: int = I, n_qkv: int = N_QKV,
                device="cuda", dtype=torch.bfloat16, reps: int = 8,
                log=print) -> list:
    dev = torch.device(device)
    w = make_weights(layers, k, i, n_qkv, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    out = []
    for m in rows:
        x = (torch.randn(m, k, generator=g, device=dev) * 0.1).to(dtype)
        for variant in variants:
            row = time_variant(variant, x, w, layers, reps)
            mb = weight_bytes(variant, w) / 1e6
            row["weight_mb"] = mb

            def rate(us):
                return "not measured" if us is None else \
                    f"{us:8.1f} us/layer ({mb / us * 1e3:6.0f} GB/s)"

            launches = "not measured" if row["launches"] is None \
                else f"{row['launches']:.1f}"
            log(f"M={m} {variant:9s}: eager {rate(row['eager_us'])}, graph "
                f"{rate(row['graph_us'])}, {mb:.1f} MB of weights a layer, "
                f"{launches} device launches a layer")
            out.append(row)
    return out


if __name__ == "__main__":
    run_harness(tuple(sys.argv[1:]) or MLP_VARIANTS + ATTN_VARIANTS)
