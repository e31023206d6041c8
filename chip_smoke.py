#!/usr/bin/env python3
"""Drive the videoglamm_torch port once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each fatal on failure:

1. device: needs CUDA; prints the card's name and power limit
   (nvidia-smi) and turns TF32 off for matmuls and cuDNN;
2. build: compiles the four CUDA sources of videoglamm_torch/csrc (K1
   attention_fwd, K2 gemm_epilogue, K4 decode_attention_q8, K5
   dequant_gemv) from the checkout with one nvcc process each, all started
   together, and JIT-compiles K3 (the Triton row norm), printing build
   seconds and the -Xptxas -v lines;
3. kernels: holds every kernel against its plain PyTorch twin on the same
   inputs at the main path's shapes, with the stated tolerance, and times
   the kernel, the twin and, where one PyTorch call computes the same
   function, that library call (a yardstick only; the port never calls it).
   Each timing is the median of 7 CUDA-event pairs after 2 warm-up calls;
   a pair spans a batch of launches sized to last at least 1 ms. K4 and K5
   rotate over operands larger than the L2 cache, as the decode loop finds
   them. Beside each time stands the bound: the larger of bytes moved over
   3.35 TB/s and operations over the peak rate of their type;
4. serve: builds the flagship VideoGLaMM (seeded random weights, normal
   std 0.02, norm scales 1) on the card through `build_inference` and
   serves, with every launch counter set to 0 just before each path and
   read just after it:
   a. the bf16 path on preprocessed streams (1 warm-up + 1 timed request),
   b. the main path, the int8 LLM with the int8 KV cache from RAW uint8
      [1,16,480,854,3] frames (3 requests), then its decode step timed and
      profiled alone,
   c. the int4 LLM with the int8 KV cache from raw frames (1 warm-up + 1
      timed request);
   each request is 16 frames, 8 SAM frames, 64 prompt ids and 64 new
   tokens; a kernel of a path that was never launched, or launched another
   number of times than the path must, fails the run;
5. check: the served outputs are finite and of the expected shapes; the
   cached decode (bf16 cache: plain attention; int8 cache and weights: K4
   and K5) agrees with one uncached forward (K1 causal) over the same
   teacher-forced token stream; and a narrow model whose shapes still take
   every kernel (real image sizes and sequence lengths, a few layers)
   agrees on the card in bf16 with the same weights run on the CPU in f32
   through the plain twins, which the CPU tests hold to the JAX package:
   float, then int8 and int4 LLMs with the int8 cache on the same codes.

Prints one {"kernels": [...]} JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Exits nonzero, printing no result, without
a card or outside the repository.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
import traceback

TOL_BF16_ATTN = 2e-2    # max|d| / max(1, max|ref|): a few bf16 ulps (2^-8)
TOL_BF16_GEMM = 2e-2    # K2 and the fused block: same rounding points,
                        # other summation order -> 1-2 bf16 ulps
TOL_BF16_NORM = 1e-2    # one bf16 rounding of O(1) outputs
TOL_F32_NORM = 1e-5     # f32 statistics, other reduction order
TOL_DECODE_Q8 = 2e-2    # K4: p * v_scale is rounded to bf16 relative to the
                        # running maximum, the twin rounds the normalised
                        # probability -> a few bf16 ulps of the output
TOL_GEMV = 1e-2         # K5: one bf16 rounding of an f32 sum taken in
                        # another order than the twin's -> at most one ulp
TOL_LLM_TF = 5e-2       # relative L2, cached bf16 decode vs uncached
                        # forward after 32 layers of bf16 rounding
TOL_LLM_TF_Q = 1e-1     # the same with int8 weights and the int8 cache: the
                        # uncached forward quantises its activations per
                        # row (W8A8, M >= 256) where the cached decode
                        # (M = 1) does not, and the cache rounds K/V to
                        # amax/127; the tiny f32 control of
                        # tests/test_torch_slice_quant.py holds the two
                        # paths' arithmetic to the JAX package
TOL_SMALL_REF = 5e-2    # relative L2, bf16 kernels on the card vs f32 plain
                        # twins on the CPU, through a few layers each

N_REQUESTS = 3          # on the main path (int8 + int8 KV, raw frames)
MAX_NEW = 64
S_TEXT = 64
T_SAM = 8
RAW_H, RAW_W = 480, 854

HBM_BYTES_S = 3.35e12   # H100 SXM: device memory rate
PEAK_OPS = {"bf16": 989e12,    # dense tensor-core rate
            "f32": 67e12}      # outside the tensor cores


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else f"nvidia-smi failed: {out.stderr.strip()}"
    except (OSError, IndexError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi missing ({e})"


def time_ms(fn, reps: int = 7, warmup: int = 2, min_ms: float = 1.0,
            graphed: bool = False) -> float:
    """Median over `reps` event pairs of the time of one call; each pair
    spans a batch of calls sized (from one probe call) to last >= min_ms.

    graphed: the batch (10 to 200 calls) is captured once into a CUDA graph and
    the pairs time its replay. A launch of a few microseconds cannot be
    timed eagerly: Python enqueues one launch in tens of microseconds, so
    an eager batch measures the host. The replay measures the device."""
    import torch

    def pair(run, n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    def batch(n):
        for _ in range(n):
            fn()

    for _ in range(warmup):
        fn()
    probe = max(pair(lambda: batch(1), 1), 1e-3)
    if graphed:
        n = int(min(200, max(10, math.ceil(4.0 / probe))))
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            batch(n)
        run = graph.replay
        run()                                    # first replay, untimed
    else:
        n = int(min(200, max(1, math.ceil(min_ms / probe))))
        run = lambda: batch(n)
    return statistics.median(pair(run, n) for _ in range(reps))


def rel_err(got, ref) -> tuple:
    d = (got.float() - ref.float()).abs().max().item()
    return d, d / max(1.0, ref.float().abs().max().item())


class Kernels:
    """Collects the kernel-versus-plain measurements."""

    def __init__(self):
        self.rows = {}

    def compare(self, key, label, kernel_fn, plain_fn, tol, *, nbytes, ops,
                rate="bf16", library_fn=None, timed_fn=None, graphed=False):
        """nbytes: each input read once and each output written once; ops:
        the operations this run's data needs, of type `rate`. timed_fn: the
        launch to time where it differs from the one compared (operands
        rotated past the L2 cache). graphed: time the kernel and the
        library call as CUDA-graph replays (launches of microseconds)."""
        import torch
        got = kernel_fn()
        ref = plain_fn()
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        del got, ref
        ms = time_ms(timed_fn or kernel_fn, graphed=graphed)
        plain_ms = time_ms(plain_fn)
        library_ms = time_ms(library_fn, graphed=graphed) \
            if library_fn is not None else None
        t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / PEAK_OPS[rate] * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        ok = rel <= tol
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"  {label}: max_abs_err={err:.3e} rel={rel:.3e} tol={tol:g} "
            f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms library={lib} "
            f"bound={bound_ms:.4f} ms ({bound_by}) {'ok' if ok else 'MISS'}")
        if not ok:
            raise AssertionError(f"{label}: kernel disagrees with its plain twin")
        if key is not None:
            self.rows[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by,
                                  library_ms=library_ms)


CUDA_SOURCES = ("attention_fwd", "gemm_epilogue", "decode_attention_q8",
                "dequant_gemv")


def phase_build():
    import torch
    from videoglamm_torch.ops import _cuda, norms
    t0 = time.perf_counter()
    built = _cuda.load_all(CUDA_SOURCES)
    log(f"  {len(built)} nvcc builds side by side: "
        f"{time.perf_counter() - t0:.1f} s")
    for name, b in built.items():
        log(f"  built {name}: {b.seconds:.1f} s -> {b.path.name}")
        for line in b.ptxas_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line \
                    or "Compiling entry" in line:
                log("   ", line.strip())
    t0 = time.perf_counter()
    x = torch.randn(8, 256, device="cuda")
    norms.row_norm(x, torch.ones(256, device="cuda"), None, 1e-6, rms=True)
    torch.cuda.synchronize()
    log(f"  K3 Triton JIT (first shape): {time.perf_counter() - t0:.1f} s")


def attn_cost(B, H, Sq, Sk, D, pairs=None):
    """(bytes, ops) of bf16 attention: q, k, v read and o written once; two
    products of 2*D operations per attended (query, key) pair."""
    pairs = Sq * Sk if pairs is None else pairs
    return 2 * B * H * D * (2 * Sq + 2 * Sk), 4 * B * H * D * pairs


def phase_kernels(K: Kernels):
    import torch
    import torch.nn.functional as F
    from videoglamm_torch.ops import attention as A
    from videoglamm_torch.ops import fused_block as FB
    from videoglamm_torch.ops import norms as N
    from videoglamm_torch.ops import quant as Q

    g = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16

    def randn(*shape, dtype=bf, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    # K1 causal: Phi-3 prefill [1,32,3391,96]
    S = 3391
    q, k, v = (randn(1, 32, S, 96) for _ in range(3))
    kvl = torch.tensor([S], device="cuda", dtype=torch.int32)
    qs = torch.zeros(1, device="cuda", dtype=torch.int32)
    nb, ops = attn_cost(1, 32, S, S, 96, pairs=S * (S + 1) // 2)
    K.compare("attention_fwd[causal]", "K1 causal Phi-3 prefill [1,32,3391,96]",
              lambda: A.flash_attention(q, k, v, causal=True, kv_lens=kvl,
                                        q_start=qs),
              lambda: A._attention_plain(q, k, v, causal=True,
                                         sm_scale=96 ** -0.5, kv_lens=kvl,
                                         q_start=qs), TOL_BF16_ATTN,
              nbytes=nb, ops=ops,
              library_fn=lambda: F.scaled_dot_product_attention(
                  q, k, v, is_causal=True))
    # K1 flash: Hiera global block, 8 frames [8,8,4096,72] (BSHD views)
    qkv = randn(8, 4096, 3, 8, 72)
    gq, gk, gv = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    nb, ops = attn_cost(8, 8, 4096, 4096, 72)
    K.compare("attention_fwd[flash]", "K1 Hiera global [8,8,4096,72]",
              lambda: A.flash_attention(gq, gk, gv),
              lambda: A._attention_plain(gq, gk, gv, causal=False,
                                         sm_scale=72 ** -0.5), TOL_BF16_ATTN,
              nbytes=nb, ops=ops,
              library_fn=lambda: F.scaled_dot_product_attention(gq, gk, gv))
    del q, k, v, qkv, gq, gk, gv
    # K1 BSHD: CLIP [16,577,16,64]; InternVideo2 fused qkv [4,1025,3,16,88]
    cq, ck, cv = (randn(16, 577, 16, 64) for _ in range(3))
    nb, ops = attn_cost(16, 16, 577, 577, 64)
    K.compare("attention_fwd[bshd]", "K1 CLIP BSHD [16,577,16,64]",
              lambda: A.attention_bshd(cq, ck, cv),
              lambda: A._attention_plain_bshd(cq, ck, cv, 64 ** -0.5),
              TOL_BF16_ATTN, nbytes=nb, ops=ops,
              library_fn=lambda: F.scaled_dot_product_attention(
                  cq.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2)))
    iv = randn(4, 1025, 3 * 16 * 88)
    iv5 = iv.view(4, 1025, 3, 16, 88)
    nb, ops = attn_cost(4, 16, 1025, 1025, 88)
    K.compare(None, "K1 InternVideo2 fused qkv [4,1025,3*16*88]",
              lambda: A.attention_packed_qkv_padded(iv, 16, 88),
              lambda: A._attention_plain_bshd(iv5[:, :, 0], iv5[:, :, 1],
                                              iv5[:, :, 2], 88 ** -0.5
                                              ).reshape(4, 1025, 16 * 88),
              TOL_BF16_ATTN, nbytes=nb, ops=ops,
              library_fn=lambda: F.scaled_dot_product_attention(
                  *(iv5[:, :, i].transpose(1, 2) for i in range(3))))
    del cq, ck, cv, iv, iv5

    # K1 window mode as fused_window_block drives it (16/64/256 tokens)
    def window_case(NW, Sw, H, key):
        hd = 72
        fold = 64 // Sw if Sw < 64 else 1
        B_, S_ = NW // fold, Sw * fold
        qkv5 = randn(B_, S_, 3, H, hd)
        out = torch.empty(B_, S_, H, hd, dtype=bf, device="cuda")
        views = [qkv5[:, :, i] for i in range(3)]
        win = Sw if fold > 1 else 0
        # the same windows as a batch, for the library call
        wins = [t.reshape(NW, Sw, H, hd).transpose(1, 2) for t in views]

        def kernel():
            A.attention_fwd_kernel(*(t.transpose(1, 2) for t in views),
                                   out.transpose(1, 2), causal=False,
                                   sm_scale=hd ** -0.5, mode="window", win=win)
            return out

        nb, ops = attn_cost(NW, H, Sw, Sw, hd)
        K.compare(key, f"K1 window S={Sw} NW={NW} H={H} (fold {fold}, win {win})",
                  kernel, lambda: A._attention_plain_bshd(*views, hd ** -0.5, win),
                  TOL_BF16_ATTN, nbytes=nb, ops=ops,
                  library_fn=lambda: F.scaled_dot_product_attention(*wins))

    window_case(8192, 64, 2, "attention_fwd[window]")
    window_case(8192, 16, 4, None)
    window_case(128, 256, 8, None)

    # K3: RMS at 3072 and 1408, LN at 1024 (with/without bias), 256 f32.
    # One read and one write per element; ~8 f32 operations per element.
    ones = lambda d: torch.ones(d, device="cuda")

    def norm_cost(x):
        return 2 * x.numel() * x.element_size(), 8 * x.numel()

    x = randn(3391, 3072)
    w = randn(3072, dtype=torch.float32, scale=0.1) + 1
    wb = w.to(bf)
    nb, ops = norm_cost(x)
    K.compare("row_norm[rms]", "K3 RMS Phi-3 [3391,3072] bf16",
              lambda: N.row_norm(x, w, None, 1e-5, rms=True),
              lambda: N._rms_norm_plain(x, w, 1e-5), TOL_BF16_NORM,
              nbytes=nb, ops=ops, rate="f32", graphed=True,
              library_fn=lambda: F.rms_norm(x, (3072,), wb, 1e-5))
    x = randn(4, 1025, 1408)
    nb, ops = norm_cost(x)
    o1408 = ones(1408).to(bf)
    K.compare(None, "K3 RMS InternVideo2 [4,1025,1408] bf16",
              lambda: N.row_norm(x, ones(1408), None, 1e-6, rms=True),
              lambda: N._rms_norm_plain(x, ones(1408), 1e-6), TOL_BF16_NORM,
              nbytes=nb, ops=ops, rate="f32", graphed=True,
              library_fn=lambda: F.rms_norm(x, (1408,), o1408, 1e-6))
    x = randn(16, 577, 1024, scale=3.0)
    w = randn(1024, dtype=torch.float32, scale=0.1) + 1
    b = randn(1024, dtype=torch.float32, scale=0.1)
    wb, bb = w.to(bf), b.to(bf)
    nb, ops = norm_cost(x)
    K.compare("row_norm[ln]", "K3 LN CLIP [16,577,1024] bf16 +bias",
              lambda: N.row_norm(x, w, b, 1e-5, rms=False),
              lambda: N._layer_norm_plain(x, w, b, 1e-5), TOL_BF16_NORM,
              nbytes=nb, ops=ops, rate="f32", graphed=True,
              library_fn=lambda: F.layer_norm(x, (1024,), wb, bb, 1e-5))
    K.compare(None, "K3 LN CLIP [16,577,1024] bf16 no bias",
              lambda: N.row_norm(x, w, None, 1e-5, rms=False),
              lambda: N._layer_norm_plain(x, w, None, 1e-5), TOL_BF16_NORM,
              nbytes=nb, ops=ops, rate="f32", graphed=True,
              library_fn=lambda: F.layer_norm(x, (1024,), wb, None, 1e-5))
    x = randn(32, 4096, 256, dtype=torch.float32)
    w = randn(256, dtype=torch.float32, scale=0.1) + 1
    b = randn(256, dtype=torch.float32, scale=0.1)
    nb, ops = norm_cost(x)
    K.compare(None, "K3 LN SAM two-way [32,4096,256] f32 +bias",
              lambda: N.row_norm(x, w, b, 1e-5, rms=False),
              lambda: N._layer_norm_plain(x, w, b, 1e-5), TOL_F32_NORM,
              nbytes=nb, ops=ops, rate="f32", graphed=True,
              library_fn=lambda: F.layer_norm(x, (256,), w, b, 1e-5))
    del x

    # K2 at the Hiera stage-1 fc1 shape over 8 frames: [524288,144]x[576,144]^T.
    # No single PyTorch call computes bias + tanh-GELU after the product, so
    # the keyed row has no library time; the bias-only mode has F.linear.
    Mg, Kg, Ng = 524288, 144, 576
    a = randn(Mg, Kg, scale=0.5)
    w2 = randn(Ng, Kg, scale=Kg ** -0.5)
    b2 = randn(Ng, scale=0.02)
    nb, ops = 2 * (Mg * Kg + Ng * Kg + Ng + Mg * Ng), 2 * Mg * Kg * Ng
    K.compare("gemm_epilogue", "K2 fc1+bias+GELU [524288,144]x[144,576]",
              lambda: FB.gemm_epilogue(a, w2, b2, gelu=True),
              lambda: FB._gemm_plain(a, w2, b2, gelu=True), TOL_BF16_GEMM,
              nbytes=nb, ops=ops)
    K.compare(None, "K2 bias only [524288,144]x[144,576]",
              lambda: FB.gemm_epilogue(a, w2, b2),
              lambda: FB._gemm_plain(a, w2, b2), TOL_BF16_GEMM,
              nbytes=nb, ops=ops, library_fn=lambda: F.linear(a, w2, b2))
    del a

    # fused_window_block at the four Hiera-L geometries (fewer windows)
    def block_case(NW, Sw, C, H, key):
        M = 4 * C
        shapes = dict(ln1_weight=(C,), ln1_bias=(C,), qkv_weight=(3 * C, C),
                      qkv_bias=(3 * C,), proj_weight=(C, C), proj_bias=(C,),
                      ln2_weight=(C,), ln2_bias=(C,), fc1_weight=(M, C),
                      fc1_bias=(M,), fc2_weight=(C, M), fc2_bias=(C,))
        p = {}
        for n, shp in shapes.items():
            if n.startswith("ln"):
                p[n] = randn(*shp, dtype=torch.float32, scale=0.1) + (
                    1.0 if n.endswith("weight") else 0.0)
            else:
                p[n] = randn(*shp, scale=(shp[-1] if len(shp) == 2 else 2500) ** -0.5)
        xb = randn(NW, Sw, C, scale=0.5)
        rows = NW * Sw
        # x read and y written once, the weights once; the four products
        # (12 C^2 per row) and the window attention (2 Sw C per row)
        nb = 2 * (2 * rows * C + 12 * C * C)
        ops = 2 * rows * 12 * C * C + 4 * rows * Sw * C
        K.compare(key, f"fused_window_block S={Sw} C={C} NW={NW}",
                  lambda: FB.fused_window_block(xb, p, H),
                  lambda: FB._fused_block_ref(xb, p, H), TOL_BF16_GEMM,
                  nbytes=nb, ops=ops)

    block_case(2048, 64, 144, 2, "fused_window_block")
    block_case(2048, 16, 288, 4, None)
    block_case(128, 256, 576, 8, None)
    block_case(128, 64, 1152, 16, None)

    # K4: decode attention over a stacked int8 cache with different data
    # per layer; compared at one layer, timed rotating over the layers so
    # that every launch finds its slab outside the L2 cache
    def decode_case(L, Hq, Hkv, hd, C, kv_len, layer, key, label):
        HD = Hkv * hd
        kc, vc = (torch.randint(-127, 128, (L, 1, C, HD), dtype=torch.int8,
                                generator=g, device="cuda") for _ in range(2))
        ks, vs = (torch.rand(L, 1, Hkv, C, generator=g, device="cuda") * 0.02
                  + 0.005 for _ in range(2))
        dq = randn(1, Hq, 1, hd)
        kvl = torch.tensor([kv_len], device="cuda", dtype=torch.int32)
        qst = kvl - 1
        rot = itertools.count()

        def launch(layer_):
            return A.dot_product_attention(dq, kc, vc, causal=True, kv_lens=kvl,
                                           q_start=qst, k_scale=ks,
                                           v_scale=vs, layer=layer_)

        # live K and V rows, their scales, q and o; two FMAs per live code
        nb = 2 * kv_len * HD + 2 * Hkv * kv_len * 4 + 2 * Hq * hd * 2
        K.compare(key, label, lambda: launch(layer),
                  lambda: A._decode_attention_q8_plain(
                      dq, kc, vc, ks, vs, sm_scale=hd ** -0.5, kv_lens=kvl,
                      layer=layer), TOL_DECODE_Q8, nbytes=nb,
                  ops=4 * Hq * kv_len * hd, rate="f32", graphed=True,
                  timed_fn=lambda: launch(next(rot) % L))

    decode_case(32, 32, 32, 96, 3456, 3400, 17, "decode_attention_q8",
                "K4 decode Phi-3 [1,32,1,96] over [32,1,3456,3072] int8, "
                "layer 17, kv_len 3400")
    decode_case(4, 32, 8, 128, 3456, 3400, 2, None,
                "K4 decode GQA G=4 [1,32,1,128] over [4,1,3456,1024] int8")

    # K5: the five decode products of Phi-3 (M = 1) and one M = 8 case,
    # int8 and int4; timed over a ring of weight copies larger than L2
    def gemv_case(M, Kd, Nd, key8, key4, what):
        wf = randn(Nd, Kd, dtype=torch.float32, scale=Kd ** -0.5)
        x = randn(M, Kd)
        q8, s8 = Q.quantize_int8(wf)
        q8 = Q.pad_rows8(q8)
        p4, s4 = Q.quantize_int4(wf, 128)
        del wf
        ring = max(2, min(16, math.ceil(150e6 / (Nd * Kd))))
        ring8 = [q8] + [q8.clone() for _ in range(ring - 1)]
        ring4 = [(p4, s4)] + [(p4.clone(), s4.clone())
                              for _ in range(2 * ring - 1)]
        r8, r4 = itertools.count(), itertools.count()
        io = 2 * M * (Kd + Nd)
        K.compare(key8, f"K5 int8 {what} M={M} [{Nd},{Kd}]",
                  lambda: Q.dequant_matmul(x, q8, s8),
                  lambda: Q._dequant_matmul_plain(x, q8, s8), TOL_GEMV,
                  nbytes=Nd * Kd + 4 * Nd + io, ops=2 * M * Nd * Kd, rate="f32",
                  graphed=True, timed_fn=lambda: Q.dequant_matmul(
                      x, ring8[next(r8) % len(ring8)], s8))
        K.compare(key4, f"K5 int4 {what} M={M} [{Nd},{Kd}/2]",
                  lambda: Q.dequant4_matmul(x, p4, s4, 128),
                  lambda: Q._dequant4_matmul_plain(x, p4, s4, 128), TOL_GEMV,
                  nbytes=Nd * Kd // 2 + 4 * Nd * Kd // 128 + io,
                  ops=2 * M * Nd * Kd, rate="f32",
                  graphed=True, timed_fn=lambda: Q.dequant4_matmul(
                      x, *ring4[next(r4) % len(ring4)], 128))

    gemv_case(1, 3072, 9216, None, None, "qkv_proj")
    gemv_case(1, 3072, 3072, None, None, "o_proj")
    gemv_case(1, 3072, 16384, "dequant_gemv[int8]", "dequant_gemv[int4]",
              "gate_up_proj")
    gemv_case(1, 8192, 3072, None, None, "down_proj")
    gemv_case(1, 3072, 32065, None, None, "lm_head")
    gemv_case(8, 3072, 9216, None, None, "qkv_proj")


def seeded_init(model, g):
    """Random weights from a seed: normal std 0.02, norm scales 1, norm
    biases 0, the random-Fourier PE matrix standard normal."""
    import torch
    from videoglamm_torch.models.common import LayerNorm, RMSNorm
    norm_params = set()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (LayerNorm, RMSNorm)):
                m.weight.fill_(1.0)
                norm_params.add(id(m.weight))
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
                    norm_params.add(id(m.bias))
        for p in model.parameters():
            if id(p) not in norm_params:
                p.normal_(0.0, 0.02, generator=g)
        for b in model.buffers():     # the random-Fourier PE matrix
            b.normal_(0.0, 1.0, generator=g)
    return model


def build(cfg, quant: str, kv_cache: str, what: str):
    """The flagship model on the card through the port's own entry point,
    seeded random weights (quantised from their f32 values when asked)."""
    import torch
    from videoglamm_torch.inference.pipeline import build_inference

    t0 = time.perf_counter()
    gi = build_inference(
        cfg, device="cuda", dtype=torch.bfloat16, quant=quant,
        kv_cache=kv_cache, max_new_tokens=MAX_NEW,
        init=lambda m: seeded_init(
            m, torch.Generator(device="cuda").manual_seed(0)))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n = sum(p.numel() for p in gi.model.parameters()) \
        + sum(b.numel() for b in gi.model.buffers())
    log(f"  flagship VideoGLaMM, {what}: {n / 1e9:.3f} B parameters and "
        f"buffer elements, bf16 compute, built in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    return gi


def make_request(cfg, seed: int):
    """Preprocessed streams, as the first slice served them."""
    import torch
    from videoglamm_torch.constants import IMAGE_TOKEN_INDEX
    g = torch.Generator(device="cuda").manual_seed(seed)
    T = cfg.num_frames
    bf = torch.bfloat16
    frames = torch.randn(1, T, 224, 224, 3, generator=g, device="cuda").to(bf)
    context = torch.randn(1, T, 336, 336, 3, generator=g, device="cuda").to(bf)
    sam = torch.randn(1, T_SAM, 1024, 1024, 3, generator=g, device="cuda").to(bf)
    ids = torch.randint(1, 32000, (1, S_TEXT), generator=g, device="cuda")
    ids[:, 2] = IMAGE_TOKEN_INDEX
    lens = torch.full((1,), S_TEXT, dtype=torch.long, device="cuda")
    return frames, context, sam, ids, lens


def make_raw_request(cfg, seed: int):
    """One raw decoded clip [1,16,480,854,3] uint8, prompt ids, lengths."""
    import torch
    from videoglamm_torch.constants import IMAGE_TOKEN_INDEX
    g = torch.Generator(device="cuda").manual_seed(seed)
    raw = torch.randint(0, 256, (1, cfg.num_frames, RAW_H, RAW_W, 3),
                        dtype=torch.uint8, generator=g, device="cuda")
    ids = torch.randint(1, 32000, (1, S_TEXT), generator=g, device="cuda")
    ids[:, 2] = IMAGE_TOKEN_INDEX
    lens = torch.full((1,), S_TEXT, dtype=torch.long, device="cuda")
    return raw, ids, lens


def _counters():
    from videoglamm_torch.ops import attention, fused_block, norms, quant
    return attention.LAUNCHES, fused_block.LAUNCHES, norms.LAUNCHES, \
        quant.LAUNCHES


def reset_counts():
    for c in _counters():
        c.clear()


def read_counts() -> dict:
    attention, fused_block, norms, quant = _counters()
    return {
        "attention_fwd[causal]": attention["causal"],
        "attention_fwd[flash]": attention["flash"],
        "attention_fwd[bshd]": attention["bshd"],
        "attention_fwd[window]": attention["window"],
        "gemm_epilogue": fused_block["gemm"],
        "row_norm[rms]": norms["rms"],
        "row_norm[ln]": norms["ln"],
        "fused_window_block": fused_block["block"],
        "decode_attention_q8": attention["decode_q8"],
        "dequant_gemv[int8]": quant["int8"],
        "dequant_gemv[int4]": quant["int4"],
    }


# launches one flagship request must make: Phi-3 prefill, 32 causal
# layers; 3 Hiera global blocks; CLIP 23 + InternVideo2 39 BSHD layers;
# 42 fused Hiera window blocks of 4 K2 GEMMs each
EXPECTED_TOWERS = {"attention_fwd[causal]": 32, "attention_fwd[flash]": 3,
                   "attention_fwd[bshd]": 62, "attention_fwd[window]": 42,
                   "fused_window_block": 42, "gemm_epilogue": 168}
# int8 cache: one K4 launch per layer and decode step. Quantised weights:
# four K5 launches per layer and one for the lm_head per decode step, plus
# the lm_head on the last prompt position after the prefill. The prefill's
# own projections have M = 3391 rows and leave K5 (W8A8 resp. dequantise
# and matmul).
DECODE_Q8 = MAX_NEW * 32
GEMV = MAX_NEW * (4 * 32 + 1) + 1
EXPECTED_PER_REQUEST = {
    "bf16": dict(EXPECTED_TOWERS, **{"decode_attention_q8": 0,
                                     "dequant_gemv[int8]": 0,
                                     "dequant_gemv[int4]": 0}),
    "int8": dict(EXPECTED_TOWERS, **{"decode_attention_q8": DECODE_Q8,
                                     "dequant_gemv[int8]": GEMV,
                                     "dequant_gemv[int4]": 0}),
    "int4": dict(EXPECTED_TOWERS, **{"decode_attention_q8": DECODE_Q8,
                                     "dequant_gemv[int8]": 0,
                                     "dequant_gemv[int4]": GEMV}),
}


def phase_serve(gi, cfg, mode: str, requests, raw: bool):
    """Serve `requests` through the entry point with the counters set to 0
    just before and read just after; `mode` names the path's expected
    launches."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    results = []
    for i, req in enumerate(requests):
        timings = {}
        t0 = time.perf_counter()
        if raw:
            out = gi.serve_raw(*req, num_sam_frames=T_SAM, timings=timings)
        else:
            out = gi(*req, timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results.append(out)
        masks = out.pred_masks
        log(f"  {mode} request {i}: wall {wall:.3f} s, "
            + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
            + f", {cfg.num_frames / wall:.3f} frames/s, tokens "
            f"{int(out.lengths[0])}/{MAX_NEW}, [SEG] {int(out.seg_valid.sum())}, "
            f"masks {tuple(masks.shape)} finite={bool(torch.isfinite(masks).all())}")
    counts = read_counts()
    log(f"  {mode}: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  {mode}: launches over {len(requests)} requests: " + json.dumps(counts))
    expected = EXPECTED_PER_REQUEST[mode]
    for name, n in counts.items():
        per = expected.get(name)
        if per is None:
            if n == 0:
                raise AssertionError(f"{name} was never launched on the "
                                     f"{mode} path")
        elif n != per * len(requests):
            raise AssertionError(f"{name}: {n} launches on the {mode} path, "
                                 f"expected {per} per request x {len(requests)}")
    return results, counts


def check_outputs(cfg, results, what: str):
    import torch
    E4 = 4 * cfg.sam2.low_res_size
    for i, out in enumerate(results):
        shape = (1, cfg.max_seg_tokens, T_SAM, E4, E4)
        if tuple(out.pred_masks.shape) != shape:
            raise AssertionError(f"{what} request {i}: masks "
                                 f"{tuple(out.pred_masks.shape)}")
        if not torch.isfinite(out.pred_masks).all():
            raise AssertionError(f"{what} request {i}: non-finite mask logits")
        invalid = ~out.seg_valid[0]
        if not (out.pred_masks[0][invalid] <= -1e3).all():
            raise AssertionError(f"{what} request {i}: invalid [SEG] slots "
                                 "not masked")
        vocab = cfg.llm.vocab_size + 1
        if not ((out.tokens >= 0) & (out.tokens < vocab)).all():
            raise AssertionError(f"{what} request {i}: token ids out of range")
    log(f"  {what} outputs: finite, expected shapes, invalid slots <= -1e3, "
        "ids in vocab")


def check_teacher_forced(model, frames, context, ids, lens, tol, what: str):
    """Cached decode against one uncached forward (K1 causal) over the same
    teacher-forced stream, with the model's own weights and cache kind."""
    import torch
    from videoglamm_torch.inference.generate import decode_step, prefill
    from videoglamm_torch.models.multimodal import splice_visual_prefix

    g = torch.Generator(device="cuda").manual_seed(7)
    n = 16
    forced = torch.randint(1, 32000, (1, n), generator=g, device="cuda")
    with torch.no_grad():
        visual = model.encode_visual_prefix(frames, context)
        _, cache, sp, _ = prefill(model.llm, visual, ids, lens, n,
                                  quant_kv=model.quant_kv_int8)
        steps = [decode_step(model.llm, cache, forced[:, j], sp.attn_lens + j)[1]
                 for j in range(n)]
        got = torch.stack(steps, dim=1).float()
        full_ids = torch.cat([ids, forced], dim=1)
        spf = splice_visual_prefix(model.llm.embed(full_ids), full_ids, visual,
                                   lens + n)
        _, hidden, _ = model.llm(spf.embeds, spf.positions, spf.attn_lens)
        s0 = int(sp.attn_lens[0])
        ref = hidden[:, s0:s0 + n].float()
    rel = ((got - ref).norm() / ref.norm()).item()
    cos = torch.nn.functional.cosine_similarity(got.flatten(), ref.flatten(),
                                                dim=0).item()
    log(f"  LLM teacher-forced ({what}), {n} steps: cached decode vs uncached "
        f"K1 forward rel L2 {rel:.3e} (tol {tol:g}), cosine {cos:.6f}")
    if not rel <= tol:
        raise AssertionError(f"{what}: cached decode disagrees with the "
                             "uncached forward")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v:
            return float(v)
    return 0.0


def measure_decode(model, frames, context, ids, lens, what: str, steps: int = 16):
    """The decode step alone: host-clock ms per step over `steps` steps
    ending in a synchronise, then the same steps under torch.profiler for
    the device-busy share and the device launches per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from videoglamm_torch.inference.generate import decode_step, prefill

    with torch.no_grad():
        visual = model.encode_visual_prefix(frames, context)
        _, cache, sp, logits = prefill(model.llm, visual, ids, lens, 3 * steps,
                                       quant_kv=model.quant_kv_int8)
        tok = logits.argmax(dim=-1)

        def run(first: int):
            for j in range(first, first + steps):
                decode_step(model.llm, cache, tok, sp.attn_lens + j)
            torch.cuda.synchronize()

        run(0)                                   # warm-up
        t0 = time.perf_counter()
        run(steps)
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(2 * steps)
            prof_ms = (time.perf_counter() - t0) * 1e3 / steps
    # kernel rows only: an operator's row repeats its kernels' device time
    rows = [e for e in prof.key_averages()
            if _device_us(e) > 0 and "cuda" in str(e.device_type).lower()]
    busy_ms = sum(_device_us(e) for e in rows) / 1e3 / steps
    launches = sum(e.count for e in rows) / steps
    if not rows:
        log(f"  {what} decode step: {host_ms:.3f} ms host clock (mean of "
            f"{steps}); device time not measured (the profiler saw none)")
        return
    top = sorted(rows, key=_device_us, reverse=True)[:4]
    log(f"  {what} decode step: {host_ms:.3f} ms host clock (mean of {steps}); "
        f"under the profiler {prof_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({busy_ms / prof_ms:.2f}), {launches:.0f} device launches a step; top: "
        + "; ".join(f"{e.key[:48]} {_device_us(e) / 1e3 / steps:.3f} ms x"
                    f"{e.count / steps:.0f}" for e in top))


def small_config():
    """Flagship image sizes, frame counts and sequence lengths with narrow,
    shallow towers: every kernel still takes its main-path branch (CLIP
    S=577, InternVideo2 S=1025 at head dim 88, a 3391-token causal prefill,
    Hiera windows of 64/16/256 tokens and a 4096-token global block; K4 at
    head dim 64 and K5 at K = 128 and 256)."""
    from videoglamm_torch.config import HieraConfig, VideoGLaMMConfig
    f = VideoGLaMMConfig.flagship()
    R = dataclasses.replace
    return R(f,
             llm=R(f.llm, hidden_size=128, intermediate_size=256, num_layers=2,
                   num_heads=2, num_kv_heads=2, head_dim=64),
             clip=R(f.clip, hidden_size=128, num_layers=3, num_heads=2,
                    intermediate_size=256),
             internvideo=R(f.internvideo, embed_dim=176, depth=3, num_heads=2),
             sam2=R(f.sam2, d_model=32, hiera=HieraConfig(
                 embed_dim=16, num_heads=1, stages=(1, 2, 3, 1),
                 global_att_blocks=(5,))),
             out_dim=32)


def phase_small_reference():
    import torch
    from videoglamm_torch.inference.generate import decode_step, prefill
    from videoglamm_torch.inference.pipeline import build_inference
    from videoglamm_torch.models.videoglamm import SegExtraction
    from videoglamm_torch.constants import IMAGE_TOKEN_INDEX

    cfg = small_config()
    f32, bf = torch.float32, torch.bfloat16
    ref = build_inference(cfg, device="cpu", dtype=f32, init=lambda m: seeded_init(
        m, torch.Generator().manual_seed(3))).model
    dev = build_inference(cfg, ref.state_dict(), device="cuda", dtype=bf).model
    g = torch.Generator().manual_seed(4)
    T = cfg.num_frames
    frames = torch.randn(1, T, 224, 224, 3, generator=g).bfloat16()
    context = torch.randn(1, T, 336, 336, 3, generator=g).bfloat16()
    sam = torch.randn(1, 1, 1024, 1024, 3, generator=g).bfloat16()
    ids = torch.randint(1, 32000, (1, S_TEXT), generator=g)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    lens = torch.tensor([S_TEXT])
    seg_emb = torch.randn(1, cfg.max_seg_tokens, cfg.out_dim, generator=g)
    seg = SegExtraction(seg_emb, torch.ones(1, cfg.max_seg_tokens, dtype=torch.bool),
                        torch.arange(cfg.max_seg_tokens)[None])
    n_forced = 4
    forced = torch.randint(1, 32000, (1, n_forced), generator=g)

    def run(model, device, dtype):
        on = lambda t: t.to(device)
        visual = model.encode_visual_prefix(on(frames).to(dtype), on(context).to(dtype))
        _, _, _, logits = prefill(model.llm, visual, on(ids), on(lens), 1)
        feats, _ = model.encode_sam_features(on(sam).to(dtype))
        masks = model.decode_masks(feats, SegExtraction(*map(on, seg)),
                                   torch.arange(1, device=device))
        return dict(visual=visual, prefill_logits=logits, sam_s0=feats[0],
                    sam_s1=feats[1], sam_embed=feats[2], masks=masks)

    def run_llm(model, device, dtype, visual):
        """Prefill and teacher-forced cached decode of a quantised LLM on a
        given visual prefix: W8A8 (int8) or dequantise-and-matmul (int4) at
        the 3391-row prefill, K4 and K5 (their twins on the CPU) at decode."""
        on = lambda t: t.to(device)
        _, cache, sp, logits = prefill(model.llm, on(visual).to(dtype), on(ids),
                                       on(lens), n_forced,
                                       quant_kv=model.quant_kv_int8)
        out = [decode_step(model.llm, cache, on(forced)[:, j], sp.attn_lens + j)
               for j in range(n_forced)]
        return dict(prefill_logits=logits,
                    step_logits=torch.stack([o[0] for o in out], dim=1),
                    step_hidden=torch.stack([o[1] for o in out], dim=1))

    def hold(got, want, what):
        for k, w in want.items():
            a = got[k].float().cpu()
            rel = ((a - w).norm() / w.norm()).item()
            log(f"  small model{what}, {k} {tuple(w.shape)}: card bf16 vs CPU "
                f"f32 rel L2 {rel:.3e} (tol {TOL_SMALL_REF:g})")
            if not rel <= TOL_SMALL_REF:
                raise AssertionError(f"small model{what} {k}: kernels disagree "
                                     "with the CPU reference")

    with torch.no_grad():
        want = run(ref, "cpu", f32)
        hold(run(dev, "cuda", bf), want, "")
        del dev
        for quant in ("int8", "int4"):
            # quantise once on the CPU; the card gets the same codes
            ref_q = build_inference(cfg, ref.state_dict(), device="cpu",
                                    dtype=f32, quant=quant, kv_cache="int8").model
            dev_q = build_inference(cfg, ref_q.state_dict(), device="cuda",
                                    dtype=bf, quant=quant, kv_cache="int8").model
            reset_counts()
            got = run_llm(dev_q, "cuda", bf, want["visual"])
            counts = read_counts()
            hold(got, run_llm(ref_q, "cpu", f32, want["visual"]),
                 f" ({quant} LLM, int8 cache)")
            gemv = n_forced * (4 * cfg.llm.num_layers + 1) + 1
            if counts["decode_attention_q8"] != n_forced * cfg.llm.num_layers \
                    or counts[f"dequant_gemv[{quant}]"] != gemv:
                raise AssertionError(f"small model ({quant}): K4/K5 launches "
                                     f"{counts}")
            del dev_q, ref_q


SOURCES = {
    "attention_fwd": ("cuda", "videoglamm_torch/csrc/attention_fwd.cu"),
    "gemm_epilogue": ("cuda", "videoglamm_torch/csrc/gemm_epilogue.cu"),
    "row_norm": ("triton", "videoglamm_torch/ops/norms.py"),
    "fused_window_block": ("cuda", "videoglamm_torch/ops/fused_block.py"),
    "decode_attention_q8": ("cuda", "videoglamm_torch/csrc/decode_attention_q8.cu"),
    "dequant_gemv": ("cuda", "videoglamm_torch/csrc/dequant_gemv.cu"),
}
REPLACES = {
    "attention_fwd[causal]": "videoglamm_tpu/ops/attention.py:93",
    "attention_fwd[flash]": "videoglamm_tpu/ops/attention.py:93",
    "attention_fwd[bshd]": "videoglamm_tpu/ops/attention.py:738",
    "attention_fwd[window]": "videoglamm_tpu/ops/fused_block.py:108",
    "gemm_epilogue": "videoglamm_tpu/ops/fused_block.py:108",
    "row_norm[rms]": "videoglamm_tpu/ops/norms.py:45",
    "row_norm[ln]": "videoglamm_tpu/ops/norms.py:116",
    "fused_window_block": "videoglamm_tpu/ops/fused_block.py:108",
    "decode_attention_q8": "videoglamm_tpu/ops/attention.py:1061",
    "dequant_gemv[int8]": "videoglamm_tpu/ops/quant.py:36",
    "dequant_gemv[int4]": "videoglamm_tpu/ops/quant.py:132",
}


def main() -> int:
    try:
        import torch
    except ImportError as e:
        log(f"FAIL: torch is not importable ({e})")
        return 2
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device (torch.cuda.is_available() is False)")
        return 2
    try:
        import videoglamm_torch  # noqa: F401
    except ImportError as e:
        log(f"FAIL: run from the root of a videoglamm checkout ({e})")
        return 2
    from videoglamm_torch.config import VideoGLaMMConfig
    from videoglamm_torch.inference.pipeline import prepare_vision_inputs

    smi = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] TF32 off for matmul and cuDNN")

    t_start = time.perf_counter()
    K = Kernels()
    cfg = VideoGLaMMConfig.flagship()
    try:
        log("[build]")
        phase_build()
        log("[kernels] kernel vs plain twin at the main path's shapes")
        phase_kernels(K)
        torch.cuda.empty_cache()

        log("[serve] bf16 weights, bf16 cache, preprocessed streams")
        gi = build(cfg, "none", "bf16", "bf16 LLM")
        requests = [make_request(cfg, 100 + i) for i in range(2)]
        results, _ = phase_serve(gi, cfg, "bf16", requests, raw=False)
        log("[check] bf16")
        check_outputs(cfg, results, "bf16")
        frames, context, _, ids, lens = requests[0]
        check_teacher_forced(gi.model, frames, context, ids, lens, TOL_LLM_TF,
                             "bf16 weights, bf16 cache")
        measure_decode(gi.model, frames, context, ids, lens, "bf16")
        del gi, results, requests, frames, context
        torch.cuda.empty_cache()

        log("[serve] main path: int8 weights, int8 cache, raw uint8 "
            f"[1,{cfg.num_frames},{RAW_H},{RAW_W},3] frames")
        gi = build(cfg, "int8", "int8", "int8 LLM")
        raw_requests = [make_raw_request(cfg, 200 + i) for i in range(N_REQUESTS)]
        results, counts = phase_serve(gi, cfg, "int8", raw_requests, raw=True)
        log("[check] int8")
        check_outputs(cfg, results, "int8")
        raw, ids, lens = raw_requests[0]
        with torch.no_grad():
            frames, context, _ = prepare_vision_inputs(
                raw, cfg, num_sam_frames=T_SAM, dtype=torch.bfloat16)
        check_teacher_forced(gi.model, frames, context, ids, lens,
                             TOL_LLM_TF_Q, "int8 weights, int8 cache")
        measure_decode(gi.model, frames, context, ids, lens, "int8 + int8 KV")
        del gi, results
        torch.cuda.empty_cache()

        log("[serve] int4 weights, int8 cache, raw frames")
        gi = build(cfg, "int4", "int8", "int4 LLM")
        results, counts4 = phase_serve(gi, cfg, "int4", raw_requests[:2], raw=True)
        log("[check] int4")
        check_outputs(cfg, results, "int4")
        measure_decode(gi.model, frames, context, ids, lens, "int4 + int8 KV")
        counts["dequant_gemv[int4]"] = counts4["dequant_gemv[int4]"]
        del gi, results, raw_requests, frames, context, raw
        torch.cuda.empty_cache()

        log("[check] narrow model on the card against the CPU twins")
        phase_small_reference()
    except Exception:
        traceback.print_exc()
        log("FAIL")
        return 1
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    # launches: the main path's run (int8 + int8 KV from raw frames, 3
    # requests); the int4 entry's from the int4 path's run (2 requests)
    kernels = []
    for key, row in K.rows.items():
        route, source = SOURCES[key.split("[")[0]]
        kernels.append(dict(name=key, route=route, source=source,
                            replaces=REPLACES[key], launches=counts[key], **row))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
