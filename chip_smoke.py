#!/usr/bin/env python3
"""Drive the videoglamm_torch port once on one NVIDIA GPU.

    python3 chip_smoke.py [--phases all|kernels,experiments,serve,train]

Run from the root of a checkout. `--phases` (default all, as the contract
runs it) picks phases 3 (kernels), the experiment harnesses, 4-5 (serve and
check) and 6-7 (train) to run; the build always runs. Phases, each fatal on
failure:

1. device: needs CUDA; prints the card's name and power limit
   (nvidia-smi) and turns TF32 off for matmuls and cuDNN;
2. build: compiles the eight CUDA sources of videoglamm_torch/csrc (K1
   attention_fwd, K2 gemm_epilogue, K4 decode_attention_q8, K5
   dequant_gemv, K6 flash_bwd, K7 window_attention, K8 smallwin_attention,
   K9 decode_fused; K1, K2 and K6 over csrc/sm90_common.cuh, the Hopper
   helpers) from the checkout with one nvcc process each, all started together, and
   JIT-compiles K3 (the Triton row norm), printing build seconds and the
   -Xptxas -v lines (registers and spills of every instantiation);
3. kernels: holds every kernel against its plain PyTorch twin on the same
   inputs at the main path's shapes, with the stated tolerance, and times
   the kernel, the twin and, where one PyTorch call computes the same
   function, that library call (a yardstick only; the port never calls it).
   Each timing is the median of 7 CUDA-event pairs after 2 warm-up calls;
   a pair spans a batch of launches sized to last at least 1 ms (8 ms for
   K6 and the calls timed beside it, whose single call of 1 to 2 ms would
   otherwise carry the host's enqueue of that call). K4 and K5
   rotate over operands larger than the L2 cache, as the decode loop finds
   them. Beside each time stands the bound: the larger of bytes moved over
   3.35 TB/s and operations over the peak rate of their type. K6 (the
   flash-attention backward) is held against its twin at the training shape
   [2,32,3456,96] causal and non-causal and at the three small cases of
   the JAX package's own test, dq, dk and dv each by relative L2, with its
   TFLOP/s, the first (mma.sync) K6's recorded time beside this run's, and
   its three device kernels (the delta prepass, dq, dk/dv) timed apart
   under the profiler; K1's LSE
   output against the log-sum-exp of the twin's logits. K7 at the memory
   self-attention of the 32x32 grid [4,1,1024,256] f32 and at the two tower
   shapes its dispatch branch names, K8 at Hiera's stage-1 and stage-2
   windows over 8 frames and at an odd window count, K1 at head dim 256
   ([4,1,4096,256], f32 and bf16). K9's four fused decode-layer entries at
   the Phi-3 widths for 1, 4 and 8 rows and at a narrow case whose N and I
   are no multiples of 1024, each beside the unfused serving chain's time;
   the W8A8 entry's s32 sums must EQUAL integer products of its own codes.
   `flash_attention_bshd` (K1 on BSHD views) at [1,3456,32,96] over 3520
   keys against its twin and against K1 on the contiguous copy. K1's
   window mode at all four Hiera stages' windows, K2 at the four products
   of Hiera stages 1 and 3 (F.linear with the bias as the library time),
   the fused block at all four stages. K1 counts its launches by route as
   well as by mode ("wgmma" for bf16 at head dim <= 128, "mma_sync" for f32
   storage and head dim 256): every serving path must launch K1 on the
   wgmma route only, except the tracker's f32 memory self-attention;
   then the two experiment harnesses (the decode-layer A/B over 32 layers of
   stacked weights, eager and as CUDA-graph replays, and the BSHD attention
   harness), with the counters set to 0 just before and read just after;
4. serve: builds the flagship VideoGLaMM (seeded random weights, normal
   std 0.02, norm scales 1) on the card through `build_inference` and
   serves, with every launch counter set to 0 just before each path and
   read just after it:
   a. the bf16 path on preprocessed streams (1 warm-up + 1 timed request),
   b. the main path, the int8 LLM with the int8 KV cache from RAW uint8
      [1,16,480,854,3] frames (3 requests), then its decode step timed and
      profiled alone,
   c. the video branch on the main path's model: 2 requests from raw
      frames with `use_video_branch=True`, all 16 frames to SAM, the 4
      [SEG] slots tracked through them by the SAM-2 memory tracker (K1 at
      head dim 256: 4 layers x 15 frames a request),
   d. the int4 LLM with the int8 KV cache from raw frames (1 warm-up + 1
      timed request),
   e. the tracker at SAM image size 512 (a 32x32 memory grid, so that the
      memory self-attention takes K7), full width, bf16 LLM, 2 requests,
   f. speculative serving on the main path's model (`draft_k=4`, 2 requests
      from raw frames: the K-row verify forwards take K5 at 4 rows and the
      plain attention, the epilogue step K4), the 4-row verify forward held
      against 4 single-row cached steps fed the same tokens and timed beside
      a plain step,
   g. sampled serving on the same model (temperature 0.7, a seeded
      generator: the same seed must give the same tokens twice),
   h. the Llama-3.1-8B base at full width and depth (bf16 weights, int8 KV
      cache, 2 requests from raw frames): K4's GQA branch (G = 4, head dim
      128) launches 32 x 64 times a request, K1 causal 32 times;
   each request is 16 frames, 8 SAM frames (16 when tracking), 64 prompt
   ids and 64 new tokens; a kernel of a path that was never launched, or
   launched another number of times than the path must, fails the run.
   Then the Hiera trunk of the 1024 model on 8 frames with
   `hoist_layout=False` against the hoisted encoder of the same weights:
   10 K8 launches and 32 super-window launches of K1 a forward, outputs
   equal within the stated bf16 tolerance;
5. check: the served outputs are finite and of the expected shapes; the
   cached decode (bf16 cache: plain attention; int8 cache and weights: K4
   and K5) agrees with one uncached forward (K1 causal) over the same
   teacher-forced token stream; and a narrow model whose shapes still take
   every kernel (real image sizes and sequence lengths, a few layers)
   agrees on the card in bf16 with the same weights run on the CPU in f32
   through the plain twins, which the CPU tests hold to the JAX package:
   float, then int8 and int4 LLMs with the int8 cache on the same codes
   (single-row steps and one 4-row cached forward; on the CPU the
   speculative and the plain greedy tokens must be equal);
   and a narrow tracker (narrow Hiera, full-width memory modules, 4 frames,
   2 objects, at 1024 and at 512) on the card against the CPU twins in
   f32, step by step on the reference's memory bank: all mask candidates,
   IoUs, object scores and the encoded memories;
6. train: builds the flagship model for training through `build_training`
   (LoRA rank 8 on q and v, remat, f32 masters of the trainable weights,
   seeded random weights with a non-zero LoRA B) and takes four optimizer
   steps of two micro-steps each on a synthetic batch from the seed (2
   videos, 2 rows, 16 frames, 4 SAM frames at 1024 x 1024, 129 text tokens,
   so the LLM sees [2,3456,3072]), with the counters set to 0 just before
   and read just after. It fails unless every loss component is finite, the
   last loss is below the first, every frozen parameter is bit-equal to its
   start and a trainable one moved, K1 causal ran 2 x 32 and K6 32 times a
   micro-step, and a checkpoint saved and restored repeats the next step's
   loss. Prints per step the wall seconds, LLM positions/s, the forward /
   backward / optimizer split and the peak memory;
7. train check: a narrow model at the real sequence length (so K1 and K6
   are taken) in bf16 on the card against the same weights in f32 on the
   CPU through the plain twins: the loss and the gradient of every
   trainable leaf, by relative L2.

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
TOL_FUSED_MLP = 2e-2    # K9 mlp: g, u and h are rounded to bf16 where the twin
                        # rounds them, after f32 sums in another order; a
                        # flipped rounding moves one of 8192 terms by 2^-8
TOL_SPEC_VERIFY = 5e-2  # relative L2, the 4-row verify forward (plain
                        # attention over the dequantised int8 cache, K5 at 4
                        # rows) against 4 single-row steps (K4 folding the
                        # scales, K5 at 1 row) through 32 layers of bf16
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

TOL_FLASH_BWD = 1e-2    # K6, relative L2 of dq, dk, dv each: kernel and twin
                        # round p and ds to bf16 at the same place and sum
                        # in f32 in another order; entries differ by one
                        # bf16 ulp (2^-8) where a rounding flips
# K6's first version (mma.sync, synchronous staging) at the training shape
# [2,32,3456,96], kv_lens (3456, 3300): its reading on an NVIDIA H100 80GB
# HBM3, 700.00 W (PERF.md section 6), printed beside this run's time
K6_MMA_SYNC_MS = {True: 6.6156, False: 11.6856}
K6_BATCH_MS = 8.0       # K6 and its yardsticks are timed over batches this long
TOL_LSE = 1e-3          # K1's LSE, max|d|: f32 sums of the same bf16
                        # products, exp2/log2 against exp/log
TOL_TRAIN_LOSS = 2e-2   # narrow model, bf16 card vs f32 CPU, relative
TOL_TRAIN_GRAD = 1.5e-1  # the same, per-leaf relative L2 of the gradients:
                        # a bf16 backward through two layers and the CE over
                        # 32065 logits rounds every activation gradient to
                        # 2^-8 (LoRA leaves: 3e-2); text_hidden_fcs sees
                        # only the few [SEG] hidden states, so their bf16
                        # rounding, and the ReLU gates that flip on it, are
                        # not averaged over positions (9e-2 at width 128)
TOL_TRAIN_GRAD_ALL = 5e-2   # all trainable leaves together, relative L2

TOL_F32_ATTN = 2e-2     # K1 and K7 on f32 operands against the f32 twin:
                        # q, k, v and p are rounded to bf16 on the way in, so
                        # the error is bf16-class, a few 2^-9 of the output
TOL_ATTN_L2 = 1e-2      # relative L2 of every attention kernel's output. An
                        # output over S keys of unit variance is far below 1
                        # (deviation about sqrt(e / S): 0.026 at 4096 keys),
                        # so the floor of 1 under the max-norm ratio above
                        # holds it to nothing; the relative L2 does. A
                        # dropped 32-key tile, a softmax scale off by a tenth
                        # or a last tile left unmasked each move it by 2e-2
                        # and more. K1 and K4 round exp(s - m) to bf16 before
                        # the row sum is known and K1 / K7 round f32 operands
                        # to bf16, where the twin rounds the normalised
                        # probability or nothing: 3e-3 measured
TOL_ATTN_L2_EXACT = 5e-4  # K7 on bf16 operands and K8 round where the twin
                        # rounds; what is left is a bf16 ulp of an output
                        # where the summation order flips a rounding: 4e-5
                        # to 1.3e-4 measured
TOL_HOIST = 5e-2        # relative L2, unhoisted Hiera (K8, super-windows,
                        # plain norms and linears) against the hoisted one
                        # (fused blocks): other bf16 rounding points over 48
                        # blocks
TOL_TRACK_REF = 2e-2    # relative L2, narrow tracker, bf16 image encoder and
                        # bf16-rounded attention operands on the card against
                        # the f32 twins on the CPU, step by step on the
                        # reference's bank and running free on its own

N_REQUESTS = 3          # on the main path (int8 + int8 KV, raw frames)
MAX_NEW = 64
S_TEXT = 64
T_SAM = 8
N_TRACK_REQUESTS = 2    # video branch: all 16 frames go to SAM
RAW_H, RAW_W = 480, 854
S_TEXT_TRAIN = 129      # + 3328 visual tokens - 1 placeholder = 3456
T_SAM_TRAIN = 4
GT_HW = 256             # ground-truth masks at SAM image size / 4
TRAIN_STEPS = 4
GRAD_ACCUM = 2

DRAFT_K = 4             # rows of a speculative iteration
N_SPEC_REQUESTS = 2
N_LLAMA_REQUESTS = 2
HARNESS_REPS = 8        # timed passes of each harness variant

HBM_BYTES_S = 3.35e12   # H100 SXM: device memory rate
PEAK_OPS = {"bf16": 989e12,    # dense tensor-core rate
            "int8": 1979e12,   # dense tensor-core rate, s8 x s8 -> s32
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


def rel_l2(got, ref) -> float:
    """|got - ref| / |ref| over all elements: unlike `rel_err` it has no
    floor of 1 under it, so it also holds outputs far smaller than 1 (an
    attention output over S keys of unit variance has a deviation of about
    sqrt(e / S))."""
    g, r = got.double(), ref.double()
    return ((g - r).norm() / r.norm().clamp_min(1e-30)).item()


class Kernels:
    """Collects the kernel-versus-plain measurements."""

    def __init__(self):
        self.rows = {}

    def compare(self, key, label, kernel_fn, plain_fn, tol, *, nbytes, ops,
                rate="bf16", library_fn=None, timed_fn=None, graphed=False,
                tol_l2=None):
        """tol holds max|d| / max(1, max|ref|); tol_l2, where given, also
        holds the relative L2 error, which is printed for every kernel.
        nbytes: each input read once and each output written once; ops:
        the operations this run's data needs, of type `rate`. timed_fn: the
        launch to time where it differs from the one compared (operands
        rotated past the L2 cache). graphed: time the kernel and the
        library call as CUDA-graph replays (launches of microseconds)."""
        import torch
        got = kernel_fn()
        ref = plain_fn()
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        l2 = rel_l2(got, ref)
        del got, ref
        ms = time_ms(timed_fn or kernel_fn, graphed=graphed)
        plain_ms = time_ms(plain_fn)
        library_ms = time_ms(library_fn, graphed=graphed) \
            if library_fn is not None else None
        t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / PEAK_OPS[rate] * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        ok = rel <= tol and (tol_l2 is None or l2 <= tol_l2)
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        held = "" if tol_l2 is None else f" tol={tol_l2:g}"
        log(f"  {label}: max_abs_err={err:.3e} rel={rel:.3e} tol={tol:g} "
            f"rel_l2={l2:.3e}{held} kernel={ms:.4f} ms plain={plain_ms:.4f} ms library={lib} "
            f"bound={bound_ms:.4f} ms ({bound_by}) {'ok' if ok else 'MISS'}")
        if not ok:
            raise AssertionError(f"{label}: kernel disagrees with its plain twin")
        if key is not None:
            self.rows[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by,
                                  library_ms=library_ms)
        return ms


CUDA_SOURCES = ("attention_fwd", "gemm_epilogue", "decode_attention_q8",
                "dequant_gemv", "flash_bwd", "window_attention",
                "smallwin_attention", "decode_fused")


def phase_build():
    import torch
    from videoglamm_torch.ops import _cuda, norms
    t0 = time.perf_counter()
    built = _cuda.load_all(CUDA_SOURCES)
    log(f"  {len(built)} nvcc builds side by side: "
        f"{time.perf_counter() - t0:.1f} s")
    for name, b in built.items():
        log(f"  built {name}: {b.seconds:.1f} s -> {b.path.name}")
        spills = 0
        for line in b.ptxas_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line \
                    or "Compiling entry" in line:
                log("   ", line.strip())
            if "bytes spill stores" in line and \
                    "0 bytes spill stores, 0 bytes spill loads" not in line:
                spills += 1
        if spills:
            raise AssertionError(f"{name}: {spills} instantiations spill")
    t0 = time.perf_counter()
    x = torch.randn(8, 256, device="cuda")
    norms.row_norm(x, torch.ones(256, device="cuda"), None, 1e-6, rms=True)
    torch.cuda.synchronize()
    log(f"  K3 Triton JIT (first shape): {time.perf_counter() - t0:.1f} s")


def attn_cost(B, H, Sq, Sk, D, pairs=None, elt=2):
    """(bytes, ops) of attention over `elt`-byte operands: q, k, v read and
    o written once; two products of 2*D operations per attended (query,
    key) pair."""
    pairs = Sq * Sk if pairs is None else pairs
    return elt * B * H * D * (2 * Sq + 2 * Sk), 4 * B * H * D * pairs


def attended_pairs(Sq, Sk, kv_lens, q_start, causal) -> int:
    """(query, key) pairs per head that the mask lets through, from this
    run's kv_lens and q_start."""
    total = 0
    for kvl, qs in zip(kv_lens, q_start):
        kvl = min(kvl, Sk)
        for r in range(Sq):
            total += max(0, min(kvl, qs + r + 1)) if causal else kvl
    return total


def k6_parts_ms(bwd, calls: int = 5) -> dict:
    """Device ms a call of K6's three kernels (delta prepass, dq, dk/dv),
    from torch.profiler over `calls` calls of `bwd`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            bwd()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        for part in ("delta", "dq", "dkv"):
            if f"flash_bwd_{part}" in e.key:
                parts[part] = parts.get(part, 0.0) + _device_us(e) / 1e3 / calls
    if set(parts) != {"delta", "dq", "dkv"}:
        raise AssertionError(f"K6: the profiler saw its kernels as {parts}")
    return parts


def phase_flash_bwd(K: Kernels, randn):
    """K6 against `_flash_bwd_plain` and K1's LSE against the twin's, the
    twin run head by head (a whole [2,32,3456,3456] f32 temporary is 3 GB)."""
    import torch
    import torch.nn.functional as F
    from videoglamm_torch.ops import attention as A

    def by_heads(fn, tensors, n_out):
        """Apply fn to one (batch, head) slice at a time and stack."""
        B, H = tensors[0].shape[:2]
        outs = [[] for _ in range(n_out)]
        for b in range(B):
            for h in range(H):
                res = fn(b, *(t[b:b + 1, h:h + 1] for t in tensors))
                for o, r in zip(outs, res):
                    o.append(r)
        return [torch.cat(o, dim=1).reshape(B, H, *o[0].shape[2:]) for o in outs]

    def case(B, H, Sq, Sk, D, kv, qs, causal, key, time_it):
        q, k, v = (randn(B, H, s, D) for s in (Sq, Sk, Sk))
        # a gradient in the layout o.transpose(1, 2).reshape(...) hands back
        g = randn(B, Sq, H, D).transpose(1, 2)
        kvl = torch.tensor(kv, device="cuda", dtype=torch.int32)
        qst = kvl - Sq if qs is None else torch.tensor(
            qs, device="cuda", dtype=torch.int32)
        scale = D ** -0.5
        mode = "causal" if causal else "flash"
        out = torch.empty_like(q)
        lse = torch.empty(B, H, Sq, device="cuda", dtype=torch.float32)

        def fwd():
            A.attention_fwd_kernel(q, k, v, out, causal=causal, sm_scale=scale,
                                   mode=mode, kv_lens=kvl, q_start=qst, lse=lse)
            return lse

        def bwd():
            return A.flash_bwd_kernel(q, k, v, out, lse, g, causal=causal,
                                      sm_scale=scale, kv_lens=kvl, q_start=qst)

        def plain_fwd():
            return by_heads(lambda b, q_, k_, v_: A._flash_fwd_plain(
                q_, k_, v_, kvl[b:b + 1], qst[b:b + 1], causal, scale),
                (q, k, v), 2)

        def plain_bwd():
            return by_heads(lambda b, q_, k_, v_, o_, l_, g_: A._flash_bwd_plain(
                q_, k_, v_, o_, l_[:, :, :, 0], g_, kvl[b:b + 1], qst[b:b + 1],
                causal, scale), (q, k, v, out, lse[..., None], g), 3)

        label = (f"[{B},{H},{Sq},{D}] over Sk={Sk} "
                 f"{'causal' if causal else 'full'} kv_lens={tuple(kv)} "
                 f"q_start={'kv_len-Sq' if qs is None else tuple(qs)}")
        fwd()
        ref_out, ref_lse = plain_fwd()
        torch.cuda.synchronize()
        live = ref_lse > -1e29
        lse_err = (lse[live] - ref_lse[live]).abs().max().item()
        dead_ok = bool((lse[~live] == A.NEG_INF).all())
        out_rel, out_l2 = rel_err(out, ref_out)[1], rel_l2(out, ref_out)
        log(f"  K1 LSE {label}: max|d|={lse_err:.3e} (tol {TOL_LSE:g}), rows "
            f"with no key {int((~live).sum())} {'= -1e30' if dead_ok else 'WRONG'}, "
            f"out rel={out_rel:.3e} rel_l2={out_l2:.3e} (tol {TOL_ATTN_L2:g})")
        if not (lse_err <= TOL_LSE and dead_ok and out_rel <= TOL_BF16_ATTN
                and out_l2 <= TOL_ATTN_L2):
            raise AssertionError(f"K1 LSE {label}: disagrees with the plain twin")
        got = bwd()
        want = plain_bwd()
        torch.cuda.synchronize()
        errs, rels = [], []
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            if not torch.isfinite(a).all():
                raise AssertionError(f"K6 {label}: non-finite {name}")
            errs.append((a.float() - b.float()).abs().max().item())
            rels.append(((a.float() - b.float()).norm()
                         / b.float().norm()).item())
        pairs = attended_pairs(Sq, Sk, kv, qst.tolist(), causal)
        # five products of 2*D operations per attended pair; q, k, v, out,
        # dO read and dq, dk, dv written once in bf16, lse read and delta
        # written once in f32
        ops = 5 * 2 * D * pairs * H
        nb = 2 * B * H * D * (5 * Sq + 3 * Sk) + 2 * 4 * B * H * Sq
        t_bytes, t_ops = nb / HBM_BYTES_S * 1e3, ops / PEAK_OPS["bf16"] * 1e3
        bound_ms, bound_by = max(t_bytes, t_ops), \
            "bytes" if t_bytes >= t_ops else "operations"
        ok = max(rels) <= TOL_FLASH_BWD
        line = (f"  K6 {label}: rel L2 dq={rels[0]:.3e} dk={rels[1]:.3e} "
                f"dv={rels[2]:.3e} (tol {TOL_FLASH_BWD:g}) "
                f"max_abs_err={max(errs):.3e}")
        if time_it:
            # batches of >= 8 ms: one call's host work (checks, TMA plan,
            # seven tensor maps) shows in a pair of one call, not of several
            ms = time_ms(bwd, min_ms=K6_BATCH_MS)
            parts = k6_parts_ms(bwd)
            fwd_ms = time_ms(fwd, min_ms=K6_BATCH_MS)
            plain_ms = time_ms(plain_bwd, reps=3, warmup=1)
            plain_fwd_ms = time_ms(plain_fwd, reps=3, warmup=1)
            ql, kl, vl = (t.detach().clone().requires_grad_(True)
                          for t in (q, k, v))

            def lib_fwd():
                with torch.no_grad():
                    return F.scaled_dot_product_attention(ql, kl, vl,
                                                          is_causal=causal)

            def lib_fwd_bwd():
                o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
                return torch.autograd.grad(o, (ql, kl, vl), g)

            lib_f = time_ms(lib_fwd, min_ms=K6_BATCH_MS)
            lib_fb = time_ms(lib_fwd_bwd, min_ms=K6_BATCH_MS)
            library_ms = lib_fb - lib_f
            line += (f" kernel={ms:.4f} ms ({ops / ms / 1e9:.1f} TFLOP/s of the "
                     f"five products; the first, mma.sync K6 read "
                     f"{K6_MMA_SYNC_MS[causal]:.4f} ms, "
                     f"{K6_MMA_SYNC_MS[causal] / ms:.2f}x this) "
                     f"plain={plain_ms:.4f} ms library="
                     f"{library_ms:.4f} ms (forward+backward {lib_fb:.4f} - "
                     f"forward {lib_f:.4f}) bound={bound_ms:.4f} ms ({bound_by}); "
                     f"K1 forward with LSE at this shape {fwd_ms:.4f} ms "
                     f"({4 * D * pairs * H / fwd_ms / 1e9:.1f} TFLOP/s), its "
                     f"plain twin head by head {plain_fwd_ms:.4f} ms")
            if key is not None:
                K.rows[key] = dict(max_abs_err=max(errs), ms=ms,
                                   plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, library_ms=library_ms)
                # K1's forward with the LSE output at the training shape
                f_bytes = 2 * B * H * D * (2 * Sq + 2 * Sk) + 4 * B * H * Sq
                f_ops = 4 * D * pairs * H
                tb, to = f_bytes / HBM_BYTES_S * 1e3, f_ops / PEAK_OPS["bf16"] * 1e3
                K.rows[f"attention_fwd[{mode}]@train_lse"] = dict(
                    max_abs_err=(out.float() - ref_out.float()).abs().max().item(),
                    ms=fwd_ms, plain_ms=plain_fwd_ms, bound_ms=max(tb, to),
                    bound_by="bytes" if tb >= to else "operations",
                    library_ms=lib_f)
        log(line + (" ok" if ok else " MISS"))
        if time_it:
            log(f"  K6 {label}, its three device kernels under the profiler "
                "(ms a call): " + ", ".join(f"{n} {t:.4f}" for n, t in parts.items())
                + f"; {sum(parts.values()):.4f} together")
            log(f"  K6 delta prepass alone: {parts['delta']:.4f} ms (reading out "
                f"and dO once at the memory rate: "
                f"{2 * 2 * B * H * Sq * D / HBM_BYTES_S * 1e3:.4f} ms)")
        if not ok:
            raise AssertionError(f"K6 {label}: disagrees with its plain twin")

    case(2, 32, 3456, 3456, 96, (3456, 3300), (0, 0), True, "flash_bwd", True)
    case(2, 32, 3456, 3456, 96, (3456, 3300), (0, 0), False, None, True)
    # the three cases of the JAX package's backward test (tests/test_ops.py:489)
    case(2, 2, 200, 320, 64, (320, 260), (0, 0), True, None, False)
    case(2, 2, 200, 320, 64, (320, 260), None, True, None, False)
    case(2, 2, 200, 320, 64, (320, 260), None, False, None, False)
    # rows with no valid key (q_start < 0) and a zero-padded head dim
    case(1, 2, 96, 200, 80, (200,), (-40,), True, None, False)


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
              nbytes=nb, ops=ops, tol_l2=TOL_ATTN_L2,
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
              nbytes=nb, ops=ops, tol_l2=TOL_ATTN_L2,
              library_fn=lambda: F.scaled_dot_product_attention(gq, gk, gv))
    del q, k, v, qkv, gq, gk, gv
    phase_flash_bwd(K, randn)
    # K1 BSHD: CLIP [16,577,16,64]; InternVideo2 fused qkv [4,1025,3,16,88]
    cq, ck, cv = (randn(16, 577, 16, 64) for _ in range(3))
    nb, ops = attn_cost(16, 16, 577, 577, 64)
    K.compare("attention_fwd[bshd]", "K1 CLIP BSHD [16,577,16,64]",
              lambda: A.attention_bshd(cq, ck, cv),
              lambda: A._attention_plain_bshd(cq, ck, cv, 64 ** -0.5),
              TOL_BF16_ATTN, nbytes=nb, ops=ops, tol_l2=TOL_ATTN_L2,
              library_fn=lambda: F.scaled_dot_product_attention(
                  cq.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2)))
    iv = randn(4, 1025, 3 * 16 * 88)
    iv5 = iv.view(4, 1025, 3, 16, 88)
    nb, ops = attn_cost(4, 16, 1025, 1025, 88)
    K.compare("attention_fwd[bshd]@iv2", "K1 InternVideo2 fused qkv [4,1025,3*16*88]",
              lambda: A.attention_packed_qkv_padded(iv, 16, 88),
              lambda: A._attention_plain_bshd(iv5[:, :, 0], iv5[:, :, 1],
                                              iv5[:, :, 2], 88 ** -0.5
                                              ).reshape(4, 1025, 16 * 88),
              TOL_BF16_ATTN, nbytes=nb, ops=ops, tol_l2=TOL_ATTN_L2,
              library_fn=lambda: F.scaled_dot_product_attention(
                  *(iv5[:, :, i].transpose(1, 2) for i in range(3))))
    del cq, ck, cv, iv, iv5

    # K1 window mode as fused_window_block drives it (16/64/256 tokens),
    # windows folded into 128-row query tiles by FB.window_fold
    def window_case(NW, Sw, H, key):
        hd = 72
        fold = FB.window_fold(NW, Sw)
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
                  TOL_BF16_ATTN, nbytes=nb, ops=ops, tol_l2=TOL_ATTN_L2,
                  library_fn=lambda: F.scaled_dot_product_attention(*wins))

    window_case(8192, 64, 2, "attention_fwd[window]")
    window_case(8192, 16, 4, "attention_fwd[window]@stage2")
    window_case(128, 256, 8, "attention_fwd[window]@stage3")
    window_case(128, 64, 16, "attention_fwd[window]@stage4")

    # K7 (whole-row softmax, two passes): the memory self-attention at the
    # 32x32 grid in f32, and the two tower shapes its dispatch branch names.
    # The bound takes the bf16 tensor-core rate for f32 operands too: the
    # least time any kernel that rounds as this one does could take.
    def l2_tol(dtype):
        return TOL_ATTN_L2 if dtype == torch.float32 else TOL_ATTN_L2_EXACT

    def window_attn_case(B, H, S, D, dtype, key, what, tol):
        q, k, v = (randn(B, H, S, D, dtype=dtype) for _ in range(3))
        nb, ops = attn_cost(B, H, S, S, D, elt=q.element_size())
        K.compare(key, f"K7 {what} [{B},{H},{S},{D}] "
                  f"{'f32' if dtype == torch.float32 else 'bf16'}",
                  lambda: A.dot_product_attention(q, k, v),
                  lambda: A._window_attention_plain(q, k, v, D ** -0.5), tol,
                  nbytes=nb, ops=ops, tol_l2=l2_tol(dtype),
                  library_fn=lambda: F.scaled_dot_product_attention(q, k, v))

    window_attn_case(4, 1, 1024, 256, torch.float32, "window_attention",
                     "memory self-attention", TOL_F32_ATTN)
    window_attn_case(4, 16, 1025, 88, bf, None, "InternVideo2 shape",
                     TOL_BF16_ATTN)
    window_attn_case(16, 16, 577, 64, bf, None, "CLIP shape", TOL_BF16_ATTN)

    # K1 at head dim 256: the memory self-attention at the 64x64 grid
    def d256_case(dtype, key, tol):
        q, k, v = (randn(4, 1, 4096, 256, dtype=dtype) for _ in range(3))
        nb, ops = attn_cost(4, 1, 4096, 4096, 256, elt=q.element_size())
        K.compare(key, "K1 memory self-attention [4,1,4096,256] "
                  f"{'f32' if dtype == torch.float32 else 'bf16'}",
                  lambda: A.dot_product_attention(q, k, v),
                  lambda: A._attention_plain(q, k, v, causal=False,
                                             sm_scale=256 ** -0.5), tol,
                  nbytes=nb, ops=ops, tol_l2=TOL_ATTN_L2,
                  library_fn=lambda: F.scaled_dot_product_attention(q, k, v))

    d256_case(torch.float32, "attention_fwd[flash_d256]", TOL_F32_ATTN)
    d256_case(bf, None, TOL_BF16_ATTN)

    # K8: Hiera's stage-1 and stage-2 windows over 8 frames, and a window
    # count that no tile packing divides
    def smallwin_case(NW, Sw, H, key):
        hd = 72
        qkv = randn(NW, Sw, 3 * H * hd)
        x5 = qkv.view(NW, Sw, 3, H, hd)
        wins = [x5[:, :, i].transpose(1, 2) for i in range(3)]
        nb, ops = attn_cost(NW, H, Sw, Sw, hd)
        K.compare(key, f"K8 windows [{NW},{Sw},{3 * H * hd}] H={H}",
                  lambda: A.attention_packed_qkv_smallwin(qkv, H, hd),
                  lambda: A._smallwin_plain(qkv, H, hd ** -0.5), TOL_BF16_ATTN,
                  nbytes=nb, ops=ops, tol_l2=TOL_ATTN_L2_EXACT,
                  library_fn=lambda: F.scaled_dot_product_attention(*wins))

    smallwin_case(8192, 64, 2, "smallwin_attention")
    smallwin_case(8192, 16, 4, None)
    smallwin_case(1021, 64, 2, None)

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

    # K2 at the four products of Hiera stage 1 (C = 144, 8 frames of 65,536
    # tokens) and stage 3 (C = 576, 32,768 rows). No single PyTorch call
    # computes bias + tanh-GELU or + residual after the product: the library
    # time is F.linear with the bias alone, the nearest one call.
    def gemm_case(Mg, Kg, Ng, key, label, gelu=False, res=False):
        a = randn(Mg, Kg, scale=0.5)
        w2 = randn(Ng, Kg, scale=Kg ** -0.5)
        b2 = randn(Ng, scale=0.02)
        r = randn(Mg, Ng) if res else None
        nb = 2 * (Mg * Kg + Ng * Kg + Ng + Mg * Ng * (2 if res else 1))
        K.compare(key, f"K2 {label} [{Mg},{Kg}]x[{Kg},{Ng}]"
                  + (" +GELU" if gelu else "") + (" +residual" if res else ""),
                  lambda: FB.gemm_epilogue(a, w2, b2, gelu=gelu, residual=r),
                  lambda: FB._gemm_plain(a, w2, b2, gelu=gelu, residual=r),
                  TOL_BF16_GEMM, nbytes=nb, ops=2 * Mg * Kg * Ng,
                  library_fn=lambda: F.linear(a, w2, b2))
        if gelu and Kg == 144:   # the bias-only launch beside F.linear
            K.compare(None, f"K2 bias only [{Mg},{Kg}]x[{Kg},{Ng}]",
                      lambda: FB.gemm_epilogue(a, w2, b2),
                      lambda: FB._gemm_plain(a, w2, b2), TOL_BF16_GEMM,
                      nbytes=2 * (Mg * Kg + Ng * Kg + Ng + Mg * Ng),
                      ops=2 * Mg * Kg * Ng, library_fn=lambda: F.linear(a, w2, b2))
        del a, r

    for s, (Mg, C) in enumerate(((524288, 144), (32768, 576))):
        st = ("stage1", "stage3")[s]
        gemm_case(Mg, C, 3 * C, f"gemm_epilogue@{st}_qkv", f"{st} qkv+bias")
        gemm_case(Mg, C, C, f"gemm_epilogue@{st}_proj", f"{st} proj+bias",
                  res=True)
        gemm_case(Mg, C, 4 * C, "gemm_epilogue" if s == 0
                  else f"gemm_epilogue@{st}_fc1", f"{st} fc1+bias", gelu=True)
        gemm_case(Mg, 4 * C, C, f"gemm_epilogue@{st}_fc2", f"{st} fc2+bias",
                  res=True)
        torch.cuda.empty_cache()

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
    block_case(2048, 16, 288, 4, "fused_window_block@stage2")
    block_case(128, 256, 576, 8, "fused_window_block@stage3")
    block_case(128, 64, 1152, 16, "fused_window_block@stage4")

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
                      layer=layer), TOL_DECODE_Q8, tol_l2=TOL_ATTN_L2, nbytes=nb,
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


def phase_decode_fused(K: Kernels):
    """K9's four entries and `flash_attention_bshd` against their twins, at
    the shapes of the Phi-3 decode layer. Each K9 entry is timed as graph
    replays rotating over stacked weight sets larger than the L2 cache, and
    beside it the port's unfused serving chain for the same function, timed
    the same way (no single PyTorch call computes these, so no library
    time)."""
    import torch
    import torch.nn.functional as F
    from videoglamm_torch.experiments import bench_decode_fused as BD
    from videoglamm_torch.experiments import decode_mlp as DM
    from videoglamm_torch.experiments import flash_bshd as FB

    g = torch.Generator(device="cuda").manual_seed(9)
    bf = torch.bfloat16

    def w8a8_integers(x, w, l, group, what):
        """The W8A8 entry's integers: exact on its own codes, and its codes
        the twin's but where an f32 value that differs in its last bits
        (rsqrt, expf) falls across a rounding tie."""
        args = (x, w["nw"][l], w["wgu"][l], w["sgu"][l], w["wd"][l], w["sd"][l],
                BD.EPS)
        _, tr = DM.mlp_w8a8_kernel(*args, group, trace=True)
        _, rt = DM._mlp_w8a8_plain(*args, group, trace=True)
        torch.cuda.synchronize()
        grp = min(group, w["wd"].shape[-1])
        ok = torch.equal(tr.gu, DM._int_dot(tr.xq, w["wgu"][l]))
        for j in range(tr.down.shape[0]):
            cols = slice(j * grp, (j + 1) * grp)
            ok = ok and torch.equal(tr.down[j], DM._int_dot(
                tr.hq[:, cols], w["wd"][l][:, cols]))
        flips = {n: (a.int() - b.int()).abs() for n, a, b in
                 (("xq", tr.xq, rt.xq), ("hq", tr.hq, rt.hq))}
        same_codes = all(int(d.max()) == 0 for d in flips.values())
        if same_codes:
            ok = ok and torch.equal(tr.gu, rt.gu) and torch.equal(tr.down, rt.down)
        near = all(int(d.max()) <= 1 and float((d > 0).float().mean()) <= 2e-3
                   for d in flips.values())
        log(f"  K9 mlp_w8a8 {what}: s32 sums of gate/up {tuple(tr.gu.shape)} "
            f"and of down per group {tuple(tr.down.shape)} "
            f"{'EQUAL' if ok else 'DIFFER from'} the integer products of the "
            f"kernel's codes; codes differing from the twin's: "
            + ", ".join(f"{n} {int((d > 0).sum())} of {d.numel()}"
                        for n, d in flips.items())
            + (" (so the twin's sums are equal too)" if same_codes else ""))
        if not (ok and near):
            raise AssertionError(f"K9 mlp_w8a8 {what}: integer sums or codes "
                                 "disagree with the twin")

    def case(M, Kd, Id, Nq, ring, keyed, group=DM.W8A8_GROUP):
        w = BD.make_weights(ring, Kd, Id, Nq, "cuda", seed=2)
        x = torch.randn(M, Kd, generator=g, device="cuda").to(bf)
        o = torch.randn(M, Kd, generator=g, device="cuda").to(bf)

        def rotating(fn):
            c = itertools.count()
            return lambda: fn(next(c) % ring)

        def key(name):
            return f"decode_fused[{name}]" if keyed else None

        def chain_of(key_, variant, ms):
            chain_ms = time_ms(rotating(lambda l: BD.layer_fn(variant)(x, w, l)),
                               graphed=True)
            log(f"    the unfused chain ({variant}) over the same weights: "
                f"{chain_ms:.4f} ms, the fused entry {ms:.4f} ms")
            if key_ is not None:
                K.rows[key_]["chain_ms"] = chain_ms

        shape = f"M={M} K={Kd}"
        io = lambda n: 2 * M * (Kd + n)
        # norm_matmul (qkv): weights, scales and the norm weight once
        ms = K.compare(
            key("norm_matmul"), f"K9 norm_matmul {shape} N={Nq}",
            lambda: DM.fused_norm_matmul_int8(x, w["nw"][0], w["wqkv"][0],
                                              w["sqkv"][0], BD.EPS),
            lambda: DM._norm_matmul_plain(x, w["nw"][0], w["wqkv"][0],
                                          w["sqkv"][0], BD.EPS), TOL_GEMV,
            nbytes=Nq * Kd + 4 * Nq + 4 * Kd + io(Nq), ops=2 * M * Nq * Kd,
            rate="f32", graphed=True,
            timed_fn=rotating(lambda l: DM.fused_norm_matmul_int8(
                x, w["nw"][l], w["wqkv"][l], w["sqkv"][l], BD.EPS)))
        chain_of(key("norm_matmul"), "qkv_chain", ms)
        # matmul_residual (o_proj): weights, scales, x, res and out
        ms = K.compare(
            key("matmul_residual"), f"K9 matmul_residual {shape} N={Kd}",
            lambda: DM.matmul_residual_int8(o, w["wo"][0], w["so"][0], x),
            lambda: DM._matmul_residual_plain(o, w["wo"][0], w["so"][0], x),
            TOL_GEMV, nbytes=Kd * Kd + 4 * Kd + 2 * M * 3 * Kd,
            ops=2 * M * Kd * Kd, rate="f32", graphed=True,
            timed_fn=rotating(lambda l: DM.matmul_residual_int8(
                o, w["wo"][l], w["so"][l], x)))
        chain_of(key("matmul_residual"), "o_chain", ms)
        # the MLP half: gate_up and down weights once
        mlp_bytes = 3 * Id * Kd + 4 * (2 * Id + Kd) + 4 * Kd + 2 * M * 2 * Kd
        mlp_args = lambda l: (x, w["nw"][l], w["wgu"][l], w["sgu"][l],
                              w["wd"][l], w["sd"][l], BD.EPS)
        ms = K.compare(
            key("mlp"), f"K9 mlp {shape} I={Id}",
            lambda: DM.fused_decode_mlp_int8(*mlp_args(0)),
            lambda: DM._mlp_plain(*mlp_args(0)), TOL_FUSED_MLP,
            tol_l2=TOL_ATTN_L2, nbytes=mlp_bytes, ops=2 * M * 3 * Id * Kd,
            rate="f32", graphed=True,
            timed_fn=rotating(lambda l: DM.fused_decode_mlp_int8(*mlp_args(l))))
        chain_of(key("mlp"), "chain", ms)
        w8a8_integers(x, w, 0, group, f"{shape} I={Id} group={min(group, Id)}")
        K.compare(
            key("mlp_w8a8"), f"K9 mlp_w8a8 {shape} I={Id} group={min(group, Id)}",
            lambda: DM.fused_decode_mlp_int8(*mlp_args(0), w8a8=True, group=group),
            lambda: DM._mlp_w8a8_plain(*mlp_args(0), group), TOL_FUSED_MLP,
            tol_l2=TOL_ATTN_L2, nbytes=mlp_bytes, ops=2 * M * 3 * Id * Kd,
            rate="int8", graphed=True,
            timed_fn=rotating(lambda l: DM.fused_decode_mlp_int8(
                *mlp_args(l), w8a8=True, group=group)))
        if keyed:
            K.rows[key("mlp_w8a8")]["chain_ms"] = K.rows[key("mlp")]["chain_ms"]

    for M in (1, 4, 8):
        case(M, BD.K, BD.I, BD.N_QKV, ring=3, keyed=M == 1)
    # N and I that no 1024 divides (three groups of 512, then one of 768)
    case(4, 256, 1536, 1000, ring=2, keyed=False, group=512)
    case(8, 256, 768, 1000, ring=2, keyed=False)
    torch.cuda.empty_cache()

    # flash_attention_bshd: K1 through BSHD strides at the prefill shape
    B, Sq, Sk, H, D = 1, 3456, 3520, 32, 96
    q, k, v = (torch.randn(B, s, H, D, generator=g, device="cuda").to(bf)
               for s in (Sq, Sk, Sk))
    kvl = torch.full((B,), Sq, device="cuda", dtype=torch.int32)
    qs = torch.zeros(B, device="cuda", dtype=torch.int32)
    kw = dict(causal=True, sm_scale=D ** -0.5)
    nb, ops = attn_cost(B, H, Sq, Sk, D, pairs=Sq * (Sq + 1) // 2)
    K.compare("flash_bshd", f"flash_attention_bshd [{B},{Sq},{H},{D}] over "
              f"Sk={Sk} causal (K1 on BSHD views)",
              lambda: FB.flash_attention_bshd(q, k, v, kvl, qs, **kw),
              lambda: FB._flash_bshd_plain(q, k, v, kvl, qs, **kw),
              TOL_BF16_ATTN, nbytes=nb, ops=ops, tol_l2=TOL_ATTN_L2,
              library_fn=lambda: F.scaled_dot_product_attention(
                  q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  is_causal=True))
    via = FB.flash_attention_transposed(q, k, v, kvl, qs, **kw)
    got = FB.flash_attention_bshd(q, k, v, kvl, qs, **kw)
    torch.cuda.synchronize()
    t_ms = time_ms(lambda: FB.flash_attention_transposed(q, k, v, kvl, qs, **kw))
    same = torch.equal(via, got)
    log(f"  flash_attention_bshd against K1 on the contiguous [B,H,S,D] copy: "
        f"{'bit-equal' if same else 'DIFFERENT'}; transpose + contiguous + K1 + "
        f"transpose back {t_ms:.4f} ms")
    if not same:
        raise AssertionError("flash_attention_bshd differs from K1 on the "
                             "contiguous copy")


def phase_experiments():
    """The two harnesses at their real sizes, with the counters set to 0
    just before and read just after: the path that launches K9's four
    entries and `flash_attention_bshd`."""
    import torch
    from videoglamm_torch.experiments import bench_decode_fused as BD
    from videoglamm_torch.experiments import flash_bshd as FB

    reset_counts()
    rows = BD.run_harness(rows=(1, DRAFT_K), reps=HARNESS_REPS,
                          log=lambda line: log("  " + line))
    torch.cuda.empty_cache()
    res = FB.run_harness(reps=HARNESS_REPS, log=lambda line: log("  " + line))
    counts = read_counts()
    if not all(r["finite"] for r in rows):
        raise AssertionError("decode-layer harness: non-finite activations")
    if res["max_abs_diff"] != 0.0:
        raise AssertionError("BSHD harness: the two layouts differ by "
                             f"{res['max_abs_diff']}")
    # a variant runs 1 warm-up pass, the timed passes, one under the profiler
    # and one into the graph, for each of the two row counts; the attention
    # harness one warm-up chain, the timed chains and the compared call
    per_entry = 2 * BD.L * (HARNESS_REPS + 3)
    want = {f"decode_fused[{e}]": per_entry for e in
            ("norm_matmul", "matmul_residual", "mlp", "mlp_w8a8")}
    want["flash_bshd"] = 8 * (HARNESS_REPS + 1) + 1
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{name}: {counts[name]} launches in the "
                                 f"harnesses, expected {n}")
    log("  harness launches: " + json.dumps({k: counts[k] for k in want}))
    return counts


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
    from videoglamm_torch.experiments import decode_mlp
    from videoglamm_torch.ops import attention, fused_block, norms, quant
    return attention.LAUNCHES, fused_block.LAUNCHES, norms.LAUNCHES, \
        quant.LAUNCHES, decode_mlp.LAUNCHES


def reset_counts():
    for c in _counters():
        c.clear()


def read_counts() -> dict:
    attention, fused_block, norms, quant, fused = _counters()
    return {
        "attention_fwd[causal]": attention["causal"],
        "attention_fwd[flash]": attention["flash"],
        "attention_fwd[flash_d256]": attention["flash_d256"],
        "attention_fwd[bshd]": attention["bshd"],
        "attention_fwd[window]": attention["window"],
        "gemm_epilogue": fused_block["gemm"],
        "row_norm[rms]": norms["rms"],
        "row_norm[ln]": norms["ln"],
        "fused_window_block": fused_block["block"],
        "decode_attention_q8": attention["decode_q8"],
        "dequant_gemv[int8]": quant["int8"],
        "dequant_gemv[int4]": quant["int4"],
        "flash_bwd": attention["flash_bwd"],
        "window_attention": attention["window_attn"],
        "smallwin_attention": attention["smallwin"],
        "decode_fused[norm_matmul]": fused["norm_matmul"],
        "decode_fused[matmul_residual]": fused["matmul_residual"],
        "decode_fused[mlp]": fused["mlp"],
        "decode_fused[mlp_w8a8]": fused["mlp_w8a8"],
        "flash_bshd": attention["flash_bshd"],
        # K1 by route (csrc/attention_fwd.cu): every mode above that K1
        # serves, counted again by the body that ran it
        "k1_route[wgmma]": attention["route:wgmma"],
        "k1_route[mma_sync]": attention["route:mma_sync"],
    }


# launches one flagship request must make: Phi-3 prefill, 32 causal
# layers; 3 Hiera global blocks; CLIP 23 + InternVideo2 39 BSHD layers;
# 42 fused Hiera window blocks of 4 K2 GEMMs each. Every K1 launch of the
# main path is bf16 at head dim <= 128 and takes the wgmma route
K1_WGMMA = 32 + 3 + 62 + 42
EXPECTED_TOWERS = {"attention_fwd[causal]": 32, "attention_fwd[flash]": 3,
                   "attention_fwd[bshd]": 62, "attention_fwd[window]": 42,
                   "k1_route[wgmma]": K1_WGMMA, "k1_route[mma_sync]": 0,
                   "fused_window_block": 42, "gemm_epilogue": 168,
                   "flash_bwd": 0, "attention_fwd[flash_d256]": 0,
                   "window_attention": 0, "smallwin_attention": 0,
                   # K9 and the BSHD launcher are experiments: no serving or
                   # training path calls them
                   "decode_fused[norm_matmul]": 0,
                   "decode_fused[matmul_residual]": 0, "decode_fused[mlp]": 0,
                   "decode_fused[mlp_w8a8]": 0, "flash_bshd": 0}
# the video branch: the memory self-attention runs once a memory-attention
# layer on every frame but the first (the cross-attention carries a kv_mask
# and is plain in both packages)
TRACK_SELF_ATTN = 4 * (16 - 1)
# one training micro-step: the towers once, without a gradient; with remat
# every LLM layer runs K1 causal twice (forward and recompute) and K6 once;
# no decode kernels
EXPECTED_PER_MICRO_STEP = dict(
    EXPECTED_TOWERS, **{"attention_fwd[causal]": 2 * 32, "flash_bwd": 32,
                        "k1_route[wgmma]": K1_WGMMA + 32,
                        "decode_attention_q8": 0, "dequant_gemv[int8]": 0,
                        "dequant_gemv[int4]": 0})
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
# tracking on the main path's model: the towers and the decode as on the
# int8 path (Hiera takes the 16 frames as one batch, so its launches do not
# change), plus K1 at head dim 256 for the memory self-attention over the
# 64x64 grid (f32 storage: the mma_sync route)
EXPECTED_PER_REQUEST["track"] = dict(
    EXPECTED_PER_REQUEST["int8"],
    **{"attention_fwd[flash_d256]": TRACK_SELF_ATTN,
       "k1_route[mma_sync]": TRACK_SELF_ATTN})
# tracking at SAM image size 512, bf16 LLM: Hiera's three global blocks see
# 1024 tokens and take K1's BSHD mode, the memory self-attention over the
# 32x32 grid takes K7
EXPECTED_PER_REQUEST["track512"] = dict(
    EXPECTED_PER_REQUEST["bf16"],
    **{"attention_fwd[flash]": 0, "attention_fwd[bshd]": 62 + 3,
       "window_attention": TRACK_SELF_ATTN})


# speculative decoding on the main path's model: every cached forward of the
# int8 LLM, of 1 row or of DRAFT_K, launches K5 four times a layer and once
# for the lm_head; only the epilogue step has one row and takes K4 (the
# K-row verify forwards take the plain attention over the dequantised
# cache). The number of verify forwards depends on the tokens, so K5's count
# is left out here and held by `phase_speculative`.
GEMV_FORWARD = 4 * 32 + 1
EXPECTED_PER_REQUEST["spec"] = {
    k: v for k, v in dict(EXPECTED_PER_REQUEST["int8"],
                          **{"decode_attention_q8": 32}).items()
    if k != "dequant_gemv[int8]"}
# the Llama-3.1 base: bf16 weights (no K5), the int8 cache through K4's GQA
# branch once a layer and decode step, a 32-layer causal prefill on K1
EXPECTED_PER_REQUEST["llama"] = dict(
    EXPECTED_PER_REQUEST["bf16"], **{"decode_attention_q8": DECODE_Q8})


def phase_serve(gi, cfg, mode: str, requests, raw: bool, track: bool = False,
                serve_kw=None, timings_out=None):
    """Serve `requests` through the entry point with the counters set to 0
    just before and read just after; `mode` names the path's expected
    launches. track: the video branch, every frame to SAM. serve_kw: a
    callable that makes the further keyword arguments of one request (a
    fresh seeded generator); timings_out: a list that receives each
    request's stage seconds."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    results = []
    for i, req in enumerate(requests):
        timings = {}
        t0 = time.perf_counter()
        kw = serve_kw() if serve_kw is not None else {}
        if track:
            out = gi.serve_raw(*req, timings=timings, use_video_branch=True)
        elif raw:
            out = gi.serve_raw(*req, num_sam_frames=T_SAM, timings=timings, **kw)
        else:
            out = gi(*req, timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results.append(out)
        if timings_out is not None:
            timings_out.append(timings)
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
    log(f"  {mode}: K1 by route: wgmma {counts['k1_route[wgmma]']}, mma_sync "
        f"{counts['k1_route[mma_sync]']}")
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


def check_outputs(cfg, results, what: str, t_sam: int = T_SAM):
    import torch
    E4 = 4 * cfg.sam2.low_res_size
    for i, out in enumerate(results):
        shape = (1, cfg.max_seg_tokens, t_sam, E4, E4)
        if tuple(out.pred_masks.shape) != shape:
            raise AssertionError(f"{what} request {i}: masks "
                                 f"{tuple(out.pred_masks.shape)}")
        if not torch.isfinite(out.pred_masks).all():
            raise AssertionError(f"{what} request {i}: non-finite mask logits")
        invalid = ~out.seg_valid[0]
        if not (out.pred_masks[0][invalid] <= -1e3).all():
            raise AssertionError(f"{what} request {i}: invalid [SEG] slots "
                                 "not masked")
        vocab = cfg.llm_config.vocab_size + 1
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


def measure_decode(model, frames, context, ids, lens, what: str, steps: int = 16,
                   rows: int = 1):
    """The decode step alone: host-clock ms per step over `steps` steps
    ending in a synchronise, then the same steps under torch.profiler for
    the device-busy share and the device launches per step. rows > 1: the
    step is one cached forward of `rows` tokens, as a speculative iteration
    makes it. Returns the host-clock ms per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from videoglamm_torch.inference.generate import prefill

    llm = model.llm
    with torch.no_grad():
        visual = model.encode_visual_prefix(frames, context)
        _, cache, sp, logits = prefill(llm, visual, ids, lens, 3 * steps,
                                       quant_kv=model.quant_kv_int8, slack=rows)
        block = logits.argmax(dim=-1)[:, None].expand(-1, rows)
        ar = torch.arange(rows, device=block.device)[None]

        def run(first: int):
            for j in range(first, first + steps):
                pos = sp.attn_lens + j
                llm(llm.embed(block), pos[:, None] + ar, pos + rows, cache)
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
    kernels = [e for e in prof.key_averages()
               if _device_us(e) > 0 and "cuda" in str(e.device_type).lower()]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    what = f"{what} decode step" if rows == 1 else \
        f"{what} cached forward of {rows} rows"
    if not kernels:
        log(f"  {what}: {host_ms:.3f} ms host clock (mean of "
            f"{steps}); device time not measured (the profiler saw none)")
        return host_ms
    top = sorted(kernels, key=_device_us, reverse=True)[:4]
    log(f"  {what}: {host_ms:.3f} ms host clock (mean of {steps}); "
        f"under the profiler {prof_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({busy_ms / prof_ms:.2f}), {launches:.0f} device launches a step; top: "
        + "; ".join(f"{e.key[:48]} {_device_us(e) / 1e3 / steps:.3f} ms x"
                    f"{e.count / steps:.0f}" for e in top))
    return host_ms


def phase_speculative(gi, cfg, raw_requests, frames, context, ids, lens,
                      plain_step_ms: float):
    """Speculative serving on the main path's model: requests through
    `serve_raw` with `draft_k=DRAFT_K`, then one verify forward by hand. Seeded random
    weights accept few drafts and greedy tokens flip under rounding between
    the K-row and the 1-row kernels, so the tokens are not held to the plain
    greedy run; held are the launches, the masks, `lengths` against `tokens`,
    and the K-row verify forward against K single-row steps fed the same
    tokens."""
    import torch
    from videoglamm_torch.inference.generate import (decode_step, prefill,
                                                     terminators_for)
    from videoglamm_torch.inference.pipeline import GroundedInference

    model = gi.model
    spec = GroundedInference(model, max_new_tokens=MAX_NEW, draft_k=DRAFT_K)
    requests = raw_requests[:N_SPEC_REQUESTS]
    stages = []
    results, counts = phase_serve(spec, cfg, "spec", requests, raw=True,
                                  timings_out=stages)
    check_outputs(cfg, results, "speculative")
    # every request: the lm_head on the last prompt position, then one cached
    # forward an iteration and the epilogue step
    n = len(requests)
    forwards, rest = divmod(counts["dequant_gemv[int8]"] - n, GEMV_FORWARD)
    iterations = forwards - n
    if rest or not 0 <= iterations <= n * (MAX_NEW - 1):
        raise AssertionError(f"speculative: {counts['dequant_gemv[int8]']} K5 "
                             f"launches are no whole number of cached forwards")
    stop = torch.tensor(terminators_for(cfg.llm_type), device="cuda")
    emitted = 0
    for i, out in enumerate(results):
        length = int(out.lengths[0])
        toks = out.tokens[0]
        if (toks[length:] != 0).any() or torch.isin(toks[:length], stop).any():
            raise AssertionError(f"speculative request {i}: lengths {length} "
                                 f"against tokens {toks.tolist()}")
        emitted += length
    gen_s = sum(t["generate"] for t in stages)
    log(f"  speculative, draft_k={DRAFT_K}: {iterations} iterations for "
        f"{emitted} tokens over {n} requests ({emitted / max(iterations, 1):.3f} "
        f"tokens an iteration), generate stage {gen_s / n:.3f} s a request "
        "(prefill included)")

    # one verify forward of DRAFT_K rows against DRAFT_K single-row steps fed
    # the same tokens at the same positions of the same cache
    g = torch.Generator(device="cuda").manual_seed(8)
    forced = torch.randint(1, 32000, (1, DRAFT_K), generator=g, device="cuda")
    llm = model.llm
    with torch.no_grad():
        visual = model.encode_visual_prefix(frames, context)
        _, cache, sp, _ = prefill(llm, visual, ids, lens, DRAFT_K,
                                  quant_kv=model.quant_kv_int8, slack=DRAFT_K)
        single = [decode_step(llm, cache, forced[:, j], sp.attn_lens + j)
                  for j in range(DRAFT_K)]
        ar = torch.arange(DRAFT_K, device="cuda")[None]
        reset_counts()
        lg, h, _ = llm(llm.embed(forced), sp.attn_lens[:, None] + ar,
                       sp.attn_lens + DRAFT_K, cache)
        torch.cuda.synchronize()
        one = read_counts()
    launched = {k: v for k, v in one.items() if v}
    log(f"  one verify forward of {DRAFT_K} rows launches: {json.dumps(launched)}")
    if launched != {"dequant_gemv[int8]": GEMV_FORWARD}:
        raise AssertionError("speculative: a verify forward must launch K5 "
                             f"{GEMV_FORWARD} times and no other kernel")
    for name, got, want in (
            ("logits", lg, torch.stack([s[0] for s in single], dim=1)),
            ("hidden", h, torch.stack([s[1] for s in single], dim=1))):
        rel = rel_l2(got, want)
        log(f"  verify forward {name} {tuple(got.shape)} vs {DRAFT_K} single-row "
            f"steps: rel L2 {rel:.3e} (tol {TOL_SPEC_VERIFY:g})")
        if not rel <= TOL_SPEC_VERIFY:
            raise AssertionError(f"speculative: the verify forward's {name} "
                                 "disagree with single-row steps")
    del cache
    verify_ms = measure_decode(model, frames, context, ids, lens,
                               "int8 + int8 KV", rows=DRAFT_K)
    log(f"  a speculative iteration ({DRAFT_K} rows) {verify_ms:.3f} ms beside a "
        f"plain step {plain_step_ms:.3f} ms: it pays from "
        f"{verify_ms / plain_step_ms:.2f} tokens an iteration on")
    return counts


def phase_sampled(gi, cfg, raw_request):
    """Sampled serving on the main path's model: the same request twice with
    temperature 0.7 and a generator seeded alike must give the same tokens."""
    import torch
    from videoglamm_torch.inference.pipeline import GroundedInference

    sampled = GroundedInference(gi.model, max_new_tokens=MAX_NEW, temperature=0.7)
    results, _ = phase_serve(
        sampled, cfg, "int8", [raw_request, raw_request], raw=True,
        serve_kw=lambda: dict(
            generator=torch.Generator(device="cuda").manual_seed(11)))
    check_outputs(cfg, results, "sampled")
    a, b = (r.tokens for r in results)
    log(f"  sampled, temperature 0.7, seed 11 twice: tokens "
        f"{'equal' if torch.equal(a, b) else 'DIFFER'}, "
        f"{a[0].unique().numel()} distinct ids in {a.shape[1]}")
    if not torch.equal(a, b):
        raise AssertionError("sampled: the same seed gave other tokens")


def phase_llama(cfg, raw_requests):
    """The Llama-3.1-8B base at full width and depth, bf16 weights and the
    int8 KV cache: the first path through K4's GQA branch (4 query heads a
    KV head, head dim 128)."""
    import torch
    from videoglamm_torch.inference.pipeline import prepare_vision_inputs

    lcfg = dataclasses.replace(cfg, llm_type="llama3_1")
    gi = build(lcfg, "none", "int8", "Llama-3.1-8B bf16 LLM")
    results, counts = phase_serve(gi, lcfg, "llama",
                                  raw_requests[:N_LLAMA_REQUESTS], raw=True)
    check_outputs(lcfg, results, "Llama-3.1")
    raw, ids, lens = raw_requests[0]
    with torch.no_grad():
        frames, context, _ = prepare_vision_inputs(
            raw, lcfg, num_sam_frames=T_SAM, dtype=torch.bfloat16)
    check_teacher_forced(gi.model, frames, context, ids, lens, TOL_LLM_TF_Q,
                         "Llama-3.1, bf16 weights, int8 cache")
    measure_decode(gi.model, frames, context, ids, lens, "Llama-3.1 bf16 + int8 KV")
    return counts


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
    from videoglamm_torch.inference.generate import (decode_step,
                                                     generate_with_prefix,
                                                     prefill)
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
        # the same tokens again as one cached forward of n_forced rows, as a
        # speculative iteration feeds them (K5 at 4 rows, plain attention)
        ar = torch.arange(n_forced, device=device)[None]
        block_logits, block_hidden, _ = model.llm(
            model.llm.embed(on(forced)), sp.attn_lens[:, None] + ar,
            sp.attn_lens + n_forced, cache)
        return dict(prefill_logits=logits,
                    step_logits=torch.stack([o[0] for o in out], dim=1),
                    step_hidden=torch.stack([o[1] for o in out], dim=1),
                    block_logits=block_logits, block_hidden=block_hidden)

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
            gemv = (n_forced + 1) * (4 * cfg.llm.num_layers + 1) + 1
            if counts["decode_attention_q8"] != n_forced * cfg.llm.num_layers \
                    or counts[f"dequant_gemv[{quant}]"] != gemv:
                raise AssertionError(f"small model ({quant}): K4/K5 launches "
                                     f"{counts}")
            if quant == "int8":
                # on the CPU, in f32, speculative decoding gives the plain
                # greedy tokens
                gen = [generate_with_prefix(
                    ref_q, want["visual"], ids, lens, max_new_tokens=12,
                    eos_id=-1, draft_k=k) for k in (0, n_forced)]
                same = torch.equal(gen[0].tokens, gen[1].tokens)
                log(f"  small model (int8 LLM, int8 cache) on the CPU: "
                    f"speculative (draft_k={n_forced}) and plain greedy tokens "
                    f"{'equal' if same else 'DIFFER'}: {gen[1].tokens[0].tolist()}")
                if not same:
                    raise AssertionError("small model: speculative decoding "
                                         "changed the greedy tokens on the CPU")
            del dev_q, ref_q


def profile_track(gi, cfg, raw):
    """The tracker alone under torch.profiler: `track_masks` on one clip's
    16 SAM frames and 4 seeded [SEG] prompts; wall, device-busy share,
    launches and the kernels that take most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from videoglamm_torch.ops.preprocess import preprocess_sam_stream

    m = gi.model
    g = torch.Generator(device="cuda").manual_seed(41)
    seg = torch.randn(cfg.max_seg_tokens, cfg.out_dim, generator=g, device="cuda")
    with torch.no_grad():
        frames_sam = preprocess_sam_stream(raw, cfg.sam2.image_size,
                                           torch.bfloat16)[0]
        m.track_masks(frames_sam, seg)                       # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            masks = m.track_masks(frames_sam, seg)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    if not torch.isfinite(masks).all():
        raise AssertionError("profiled tracker: non-finite masks")
    rows = [e for e in prof.key_averages()
            if _device_us(e) > 0 and "cuda" in str(e.device_type).lower()]
    if not rows:
        log(f"  tracker under the profiler: {wall_ms:.1f} ms; device time not "
            "measured (the profiler saw none)")
        return
    busy_ms = sum(_device_us(e) for e in rows) / 1e3
    top = sorted(rows, key=_device_us, reverse=True)[:8]
    log(f"  tracker under the profiler ({tuple(frames_sam.shape)} frames, "
        f"{cfg.max_seg_tokens} objects): {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({busy_ms / wall_ms:.2f}), "
        f"{sum(e.count for e in rows)} device launches; top: "
        + "; ".join(f"{e.key[:56]} {_device_us(e) / 1e3:.1f} ms x{e.count}"
                    for e in top))


def phase_unhoisted_hiera(trunk):
    """`Hiera(hoist_layout=False)` on 8 flagship frames against the hoisted
    encoder of the same weights: every windowed block partitions on its own
    and takes the unfused branches (stage 1 and 2: K8; stage 3: K1 under a
    block-diagonal mask over two folded 256-token windows)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(31)
    x = torch.randn(8, 1024, 1024, 3, generator=g, device="cuda").bfloat16()

    def run(hoist):
        trunk.hoist_layout = hoist
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            outs = trunk(x)
        torch.cuda.synchronize()
        return outs, read_counts(), time.perf_counter() - t0

    try:
        run(True)                                         # warm-up
        hoisted, c_h, t_h = run(True)
        run(False)
        plain, c_p, t_p = run(False)
    finally:
        trunk.hoist_layout = True
    # stage 1: 2 blocks, stage 2: 5 windowed blocks after its pooling block,
    # stage 4: 3 after its pooling block (128 windows of 64 tokens: K8 takes
    # any window count) -> 10 K8 launches; stage 3: 36 blocks less 1 pooling
    # and 3 global -> 32 super-window launches of K1 in BSHD mode; the 3
    # global blocks stay on K1 flash; no fused block
    want = {"smallwin_attention": 10, "attention_fwd[bshd]": 32,
            "attention_fwd[flash]": 3, "fused_window_block": 0,
            "attention_fwd[window]": 0}
    for name, n in want.items():
        if c_p[name] != n:
            raise AssertionError(f"unhoisted Hiera: {name} launched "
                                 f"{c_p[name]} times, expected {n}")
    if c_h["smallwin_attention"] != 0 or c_h["fused_window_block"] != 42:
        raise AssertionError(f"hoisted Hiera: launches {c_h}")
    for i, (a, b) in enumerate(zip(plain, hoisted)):
        rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
        ok = rel <= TOL_HOIST and bool(torch.isfinite(a).all())
        log(f"  unhoisted Hiera stage {i} {tuple(a.shape)}: rel L2 against the "
            f"hoisted path {rel:.3e} (tol {TOL_HOIST:g}) {'ok' if ok else 'MISS'}")
        if not ok:
            raise AssertionError("unhoisted Hiera disagrees with the hoisted path")
    log(f"  Hiera-L on 8 frames: hoisted {t_h:.3f} s (42 fused blocks), "
        f"unhoisted {t_p:.3f} s (K8 x{c_p['smallwin_attention']}, K1 "
        f"super-windows x{c_p['attention_fwd[bshd]']})")
    return c_p


def track_config(image_size: int):
    """A narrow Hiera under full-width memory modules (d_model 256, mem_dim
    64, one 256-wide attention head), one memory-attention layer: the
    memory self-attention takes K1 at head dim 256 (image size 1024, a
    64x64 grid) or K7 (512, a 32x32 grid), in f32."""
    from videoglamm_torch.config import HieraConfig, SAM2Config
    return SAM2Config(hiera=HieraConfig(embed_dim=16, num_heads=1,
                                        stages=(1, 2, 3, 1),
                                        global_att_blocks=(5,)),
                      image_size=image_size, memory_attention_layers=1)


def phase_small_track_reference(image_size: int):
    """The narrow tracker on the card (bf16 image encoder, f32 memory
    modules with K1 / K7 on the self-attention) against the same weights on
    the CPU in f32 through the plain twins, over 4 frames and 2 objects.
    First teacher-forced, frame by frame on the reference's memory bank, so
    that each step's error stands alone: all mask candidates, their IoUs,
    the object scores and the encoded memories. Then both trackers run
    free, each on its own bank written in place: the frames held by the two
    rings must be equal, the object-score gate must fall the same way on
    every frame, and for each object the chosen mask, its object score and
    the ring's memory and pointer are held on the frames up to which every
    multimask argmax agreed with the reference's (how many choices differed
    is printed). The free run's conditioning memory is printed and not
    held: frame 0's mask is binarised before it is encoded, a step function
    of logits that differ by rounding, and the same memory is held above on
    the reference's mask. `track_video` then runs for its launch count and
    must repeat the free run's masks bit for bit."""
    import torch
    from videoglamm_torch.models.common import cast_compute
    from videoglamm_torch.models.sam2 import video_predictor as VP
    from videoglamm_torch.models.sam2.sam2_base import SAM2Base

    cfg = track_config(image_size)
    T, B = 4, 2
    ref = seeded_init(SAM2Base(cfg), torch.Generator().manual_seed(21)).eval()
    with torch.no_grad():
        # the object-score gate decided by a margin far above bf16 rounding
        ref.sam_mask_decoder.pred_obj_score_head.layers[-1].bias.fill_(2.0)
    dev = SAM2Base(cfg)
    dev.load_state_dict(ref.state_dict())
    dev = dev.cuda().eval()
    cast_compute(dev.image_encoder, torch.bfloat16)
    dev.sam_mask_decoder.conv_s0.to(torch.bfloat16)
    dev.sam_mask_decoder.conv_s1.to(torch.bfloat16)
    g = torch.Generator().manual_seed(22)
    frames = torch.randn(T, image_size, image_size, 3, generator=g)
    text = torch.randn(B, 1, cfg.d_model, generator=g)

    def hold(got, want, what, tol=TOL_TRACK_REF):
        a, w = got.float().cpu(), want.float()
        rel = ((a - w).norm() / w.norm().clamp_min(1e-12)).item()
        ok = rel <= tol and bool(torch.isfinite(a).all())
        log(f"  narrow tracker {image_size}, {what} {tuple(w.shape)}: card vs "
            f"CPU f32 rel L2 {rel:.3e} (tol {tol:g})"
            f"{'' if ok else ' MISS'}")
        if not ok:
            raise AssertionError(f"narrow tracker {image_size}, {what}: the "
                                 "card disagrees with the CPU reference")

    def per_obj(feats, t):
        return [f[t][None].expand(B, *f.shape[1:]) for f in feats]

    def bank_to(bank, device):
        return VP.MemoryBank(*(x.clone().to(device) for x in bank))

    with torch.no_grad():
        rfeats, rpos = ref.forward_image(frames)
        dfeats, dpos = dev.forward_image(frames.cuda().bfloat16())
        reset_counts()
        rheads, rbank = VP.track_init_frame(ref, per_obj(rfeats, 0), rpos[-1], text)
        dheads, _ = VP.track_init_frame(dev, per_obj(dfeats, 0), dpos[-1],
                                        text.cuda())
        for name in ("low_res_multimasks", "ious", "object_score_logits",
                     "obj_ptr"):
            hold(getattr(dheads, name), getattr(rheads, name), f"frame 0 {name}")
        mem, _ = dev.encode_new_memory(
            dfeats[-1][:1].expand(B, *dfeats[-1].shape[1:]),
            rheads.high_res_masks.permute(0, 2, 3, 1).cuda(),
            rheads.object_score_logits.cuda(), binarize=True)
        hold(mem, rbank.cond_mem, "frame 0 memory (binarised)")
        for t in range(1, T):
            dbank = bank_to(rbank, "cuda")
            rheads, rbank = VP.track_step(ref, per_obj(rfeats, t), rpos[-1],
                                          rbank, t, T)
            dheads, dbank = VP.track_step(dev, per_obj(dfeats, t), dpos[-1],
                                          dbank, t, T)
            for name in ("low_res_multimasks", "ious", "object_score_logits"):
                hold(getattr(dheads, name), getattr(rheads, name),
                     f"frame {t} {name}")
            mem, _ = dev.encode_new_memory(
                dfeats[-1][t:t + 1].expand(B, *dfeats[-1].shape[1:]),
                rheads.high_res_masks.permute(0, 2, 3, 1).cuda(),
                rheads.object_score_logits.cuda())
            hold(mem, rbank.mem_ring[:, t % rbank.mem_ring.shape[1]],
                 f"frame {t} memory")
        stepped = read_counts()

        def free_run(sam, feats, pos, txt):
            heads, bank = VP.track_init_frame(sam, per_obj(feats, 0), pos[-1], txt)
            frames_ = [heads]
            for t in range(1, T):
                heads, bank = VP.track_step(sam, per_obj(feats, t), pos[-1],
                                            bank, t, T)
                frames_.append(heads)
            return frames_, bank

        rfree, rbank = free_run(ref, rfeats, rpos, text)
        dfree, dbank = free_run(dev, dfeats, dpos, text.cuda())
        reset_counts()
        res = VP.track_video(dev, dfeats, dpos, text.cuda())
        torch.cuda.synchronize()
        counts = read_counts()
    key = "attention_fwd[flash_d256]" if image_size == 1024 else "window_attention"
    n = cfg.memory_attention_layers * (T - 1)
    if counts[key] != n or stepped[key] != n:
        raise AssertionError(f"narrow tracker {image_size}: {key} launched "
                             f"{stepped[key]} and {counts[key]} times, expected {n}")
    E4 = 4 * cfg.low_res_size
    if tuple(res.low_res_masks.shape) != (B, T, E4, E4) \
            or not torch.isfinite(res.low_res_masks).all():
        raise AssertionError(f"narrow tracker {image_size}: free-running masks")
    if not torch.equal(res.low_res_masks, torch.stack(
            [h.low_res_masks[:, 0] for h in dfree], dim=1)):
        raise AssertionError(f"narrow tracker {image_size}: track_video does "
                             "not repeat the step-by-step free run")

    # the free runs, each on its own bank
    for name in ("mem_frame", "ptr_frame"):
        got, want = getattr(dbank, name).cpu(), getattr(rbank, name)
        if not torch.equal(got, want):
            raise AssertionError(f"narrow tracker {image_size}: free run's "
                                 f"{name} {got.tolist()} != {want.tolist()}")
    pick = lambda run: torch.stack([h.ious.argmax(dim=-1).cpu() for h in run], 1)
    gate = lambda run: torch.stack(
        [h.object_score_logits[:, 0].float().cpu() > 0 for h in run], 1)
    same = pick(dfree) == pick(rfree)                        # [B, T]
    if not torch.equal(gate(dfree), gate(rfree)):
        raise AssertionError(f"narrow tracker {image_size}: the object-score "
                             "gate fell differently on the card")
    agreed = same.long().cumprod(dim=1).bool()    # every argmax so far agreed
    flipped = ((dfree[0].high_res_masks.cpu() > 0)
               != (rfree[0].high_res_masks > 0)).float().mean().item()
    log(f"  narrow tracker {image_size}, free run: ring frames "
        f"{dbank.mem_frame[0].tolist()}, pointer frames "
        f"{dbank.ptr_frame[0].tolist()} equal to the reference's; "
        f"{int((~same).sum())} of {B * T} (object, frame) argmax choices "
        f"differed, {int(agreed.sum())} compared")
    if not agreed[:, 0].all():
        raise AssertionError(f"narrow tracker {image_size}: the conditioning "
                             "frame's argmax differs, nothing to compare")
    S_ring, P_ring = rbank.mem_ring.shape[1], rbank.ptr_ring.shape[1]
    for t in range(T):
        objs = agreed[:, t].nonzero()[:, 0]
        if not len(objs):
            continue
        what = f"free run frame {t} (objects {objs.tolist()})"
        hold(dfree[t].low_res_masks.cpu()[objs], rfree[t].low_res_masks[objs],
             f"{what} mask")
        hold(dfree[t].object_score_logits.cpu()[objs],
             rfree[t].object_score_logits[objs], f"{what} object score")
        if t == 0:
            a, w = dbank.cond_mem.cpu()[objs], rbank.cond_mem[objs]
            log(f"  narrow tracker {image_size}, {what} conditioning memory, "
                f"each side from its own binarised mask ({flipped:.3e} of the "
                f"pixels differ): rel L2 {((a - w).norm() / w.norm()).item():.3e}"
                ", not held")
            hold(dbank.cond_ptr.cpu()[objs], rbank.cond_ptr[objs],
                 f"{what} conditioning pointer")
        else:
            hold(dbank.mem_ring.cpu()[objs, t % S_ring],
                 rbank.mem_ring[objs, t % S_ring], f"{what} ring memory")
            hold(dbank.ptr_ring.cpu()[objs, t % P_ring],
                 rbank.ptr_ring[objs, t % P_ring], f"{what} ring pointer")
    log(f"  narrow tracker {image_size}: track_video finite masks "
        f"{tuple(res.low_res_masks.shape)}, {key} x{counts[key]}")


def make_train_batch(cfg, seed: int, device="cuda", dtype=None, rows=2,
                     videos=2, text_lens=(S_TEXT_TRAIN, 73)):
    """One synthetic micro-batch in the shapes the data layer's collate
    gives: `videos` clips of 16 frames (4 of them for SAM), `rows`
    conversations of S_TEXT_TRAIN ids with one image placeholder and one or
    two [SEG] tokens, labels that ignore the prompt, and binary masks at
    GT_HW with all-ignore padding for the unused [SEG] slots."""
    import torch
    from videoglamm_torch.constants import (IGNORE_INDEX, IMAGE_TOKEN_INDEX,
                                            MASK_IGNORE_INDEX)
    dtype = dtype or torch.bfloat16
    g = torch.Generator().manual_seed(seed)
    T = cfg.num_frames
    S = S_TEXT_TRAIN
    ims, cls_, sam_s = (cfg.internvideo.image_size, cfg.clip.image_size,
                        cfg.sam2.image_size)
    frames = torch.randn(videos, T, ims, ims, 3, generator=g)
    context = torch.randn(videos, T, cls_, cls_, 3, generator=g)
    frames_sam = torch.randn(videos, T_SAM_TRAIN, sam_s, sam_s, 3, generator=g)
    ids = torch.randint(1, 32000, (rows, S), generator=g)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    gt = torch.full((rows, cfg.max_seg_tokens, T_SAM_TRAIN, GT_HW, GT_HW),
                    float(MASK_IGNORE_INDEX))
    for r in range(rows):
        n_seg = 1 + r % 2
        for j in range(n_seg):
            ids[r, 20 + 9 * j] = cfg.seg_token_idx
        gt[r, :n_seg] = (torch.rand(n_seg, T_SAM_TRAIN, GT_HW, GT_HW,
                                    generator=g) > 0.5).float()
    labels = ids.clone()
    labels[labels < 0] = IGNORE_INDEX
    labels[:, :10] = IGNORE_INDEX                   # the prompt
    lens = torch.tensor(text_lens[:rows])
    batch = dict(frames=frames.to(dtype), context_images=context.to(dtype),
                 frames_sam=frames_sam.to(dtype), input_ids=ids, text_lens=lens,
                 labels=labels, video_idx=torch.arange(rows) % videos,
                 gt_masks=gt)
    return {k: v.to(device) for k, v in batch.items()}


def phase_train(cfg, seed: int):
    """Four optimizer steps at flagship width through `build_training` and
    its train step; returns the launch counts of the four steps."""
    import tempfile
    import torch
    from videoglamm_torch.config import TrainConfig
    from videoglamm_torch.io.checkpoint import CheckpointManager
    from videoglamm_torch.training import build_training

    tcfg = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                       grad_accum_steps=GRAD_ACCUM)
    t0 = time.perf_counter()
    tr = build_training(
        cfg, tcfg, device="cuda", dtype=torch.bfloat16,
        init=lambda m: seeded_init(
            m, torch.Generator(device="cuda").manual_seed(0)))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    params = tr.state.params
    trainable = set(tr.tx.trainable)
    n_train = sum(params[n].numel() for n in trainable)
    n_all = sum(p.numel() for p in params.values())
    lora_b = [p for n, p in params.items() if "lora_b" in n]
    if not lora_b or not all(float(p.detach().abs().max()) > 0 for p in lora_b):
        raise AssertionError("train: LoRA B is zero (A would get no gradient)")
    log(f"  flagship VideoGLaMM for training: {n_all / 1e9:.3f} B parameters, "
        f"{n_train / 1e9:.3f} B trainable in {len(trainable)} leaves (f32 "
        f"masters), LoRA rank {tcfg.lora.r}, remat, bf16 compute, built in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    micro = [make_train_batch(cfg, seed + i) for i in range(GRAD_ACCUM)]
    batch = {k: torch.stack([m[k] for m in micro]) for k in micro[0]}
    positions = GRAD_ACCUM * batch["input_ids"].shape[1] * (
        S_TEXT_TRAIN - 1 + 16 * (144 + 64))
    t0 = time.perf_counter()
    frozen0 = {n: p.detach().cpu() for n, p in params.items()
               if n not in trainable}
    moved0 = {n: params[n].detach().clone() for n in
              ("llm.lm_head.weight", "llm.model.layers.0.self_attn.q_lora_a.weight",
               "text_hidden_fcs.0.0.weight",
               "visual_model.sam_mask_decoder.mask_tokens.weight")}
    log(f"  copy of the {len(frozen0)} frozen leaves on the host: "
        f"{time.perf_counter() - t0:.1f} s")

    state = tr.state
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for i in range(TRAIN_STEPS):
        timings = {}
        t0 = time.perf_counter()
        state, metrics = tr.train_step(state, batch, timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        m = {k: float(v) for k, v in metrics.items()}
        losses.append(m["loss"])
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"train step {i}: non-finite loss {m}")
        log(f"  train step {i}: wall {wall:.3f} s, {positions / wall:.1f} LLM "
            f"positions/s ({positions} positions in {GRAD_ACCUM} micro-steps), "
            + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
            + ", " + ", ".join(f"{k} {v:.4f}" for k, v in m.items()))
    counts = read_counts()
    log(f"  train: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB at micro-batch "
        f"{batch['input_ids'].shape[1]} rows x {S_TEXT_TRAIN - 1 + 16 * 208} positions")
    log(f"  train: launches over {TRAIN_STEPS} optimizer steps: "
        + json.dumps(counts))
    n_micro = TRAIN_STEPS * GRAD_ACCUM
    for name, n in counts.items():
        per = EXPECTED_PER_MICRO_STEP.get(name)
        if per is None:
            if n == 0:
                raise AssertionError(f"{name} was never launched on the "
                                     "training path")
        elif n != per * n_micro:
            raise AssertionError(f"{name}: {n} launches on the training path, "
                                 f"expected {per} per micro-step x {n_micro}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    if state.step != TRAIN_STEPS or state.opt_state["count"] != TRAIN_STEPS:
        raise AssertionError(f"train: step counter {state.step}")
    t0 = time.perf_counter()
    changed = [n for n, ref in frozen0.items()
               if not torch.equal(params[n].detach().cpu(), ref)]
    if changed:
        raise AssertionError(f"train: frozen parameters changed: {changed[:4]}")
    del frozen0
    still = [n for n, ref in moved0.items() if torch.equal(params[n], ref)]
    if still:
        raise AssertionError(f"train: trainable parameters did not move: {still}")
    log(f"  train: losses {', '.join(f'{x:.4f}' for x in losses)}: last below "
        f"first; all frozen leaves bit-equal to their start, the sampled "
        f"trainable leaves moved ({time.perf_counter() - t0:.1f} s)")

    # checkpoint: save, step, restore, step again -> the same loss
    with tempfile.TemporaryDirectory() as d:
        ckpt = CheckpointManager(d, max_to_keep=1)
        t0 = time.perf_counter()
        ckpt.save(state.step, state, metadata={"epoch": 0})
        t_save = time.perf_counter() - t0
        state5, m5 = tr.train_step(state, batch)
        loss5 = float(m5["loss"])
        t0 = time.perf_counter()
        back = ckpt.restore(state5)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        if back.step != TRAIN_STEPS or ckpt.restore_metadata() != {"epoch": 0}:
            raise AssertionError("train: the checkpoint's step or metadata")
        loss5b = profile_train_step(tr, back, batch)
    log(f"  train: checkpoint of the whole state saved in {t_save:.1f} s, "
        f"restored in {t_load:.1f} s; next-step loss {loss5:.6f} before, "
        f"{loss5b:.6f} after the restore")
    if not abs(loss5 - loss5b) <= 1e-6 * abs(loss5):
        raise AssertionError("train: the restored state does not repeat the "
                             "next step's loss")
    return counts


def profile_train_step(tr, state, batch) -> float:
    """One optimizer step under torch.profiler: wall, device-busy share, the
    device launches and the kernels that take most device time. Returns the
    step's loss."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, metrics = tr.train_step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if _device_us(e) > 0 and "cuda" in str(e.device_type).lower()]
    if not rows:
        log(f"  train step under the profiler: {wall_ms:.1f} ms; device time "
            "not measured (the profiler saw none)")
        return float(metrics["loss"])
    busy_ms = sum(_device_us(e) for e in rows) / 1e3
    top = sorted(rows, key=_device_us, reverse=True)[:12]
    log(f"  train step under the profiler: {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({busy_ms / wall_ms:.2f}), "
        f"{sum(e.count for e in rows)} device launches; top: "
        + "; ".join(f"{e.key[:56]} {_device_us(e) / 1e3:.1f} ms x{e.count}"
                    for e in top))
    # K6's kernels by name, in the top list or not
    k6 = {part: [e for e in rows if f"flash_bwd_{part}" in e.key]
          for part in ("delta", "dq", "dkv")}
    if not all(k6.values()):
        raise AssertionError("train step: the profiler does not name K6's "
                             f"kernels: {[e.key[:56] for e in top]}")
    k6_ms = {p: sum(_device_us(e) for e in es) / 1e3 for p, es in k6.items()}
    log("  train step, K6 under the profiler: "
        + ", ".join(f"{p} {k6_ms[p]:.1f} ms x{sum(e.count for e in k6[p])}"
                    for p in k6)
        + f"; {sum(k6_ms.values()):.1f} ms of {busy_ms:.1f} busy "
        f"({sum(k6_ms.values()) / busy_ms:.3f})")
    return float(metrics["loss"])


def phase_small_train_reference(seed: int):
    """A narrow model at the real sequence length: one micro-step in bf16 on
    the card (K1 with LSE, K6, K3) against the same weights in f32 on the
    CPU through the plain twins; loss and every trainable leaf's gradient."""
    import torch
    from videoglamm_torch.config import LoRAConfig, TrainConfig
    from videoglamm_torch.training import build_training

    cfg = small_config()
    tcfg = TrainConfig(warmup_steps=0, grad_accum_steps=1, lora=LoRAConfig(r=4))
    ref = build_training(cfg, tcfg, device="cpu", dtype=torch.float32,
                         init=lambda m: seeded_init(
                             m, torch.Generator().manual_seed(5)))
    dev = build_training(cfg, tcfg, ref.model.state_dict(), device="cuda",
                         dtype=torch.bfloat16)
    batch = make_train_batch(cfg, seed, device="cpu", dtype=torch.float32,
                             rows=1, videos=1)
    out_ref = ref.model(**batch)
    out_ref.loss.backward()
    reset_counts()
    out = dev.model(**{k: (v.bfloat16() if v.is_floating_point()
                           and k != "gt_masks" else v).cuda()
                       for k, v in batch.items()})
    out.loss.backward()
    torch.cuda.synchronize()
    counts = read_counts()
    L = cfg.llm.num_layers
    if counts["attention_fwd[causal]"] != 2 * L or counts["flash_bwd"] != L:
        raise AssertionError(f"small model (training): K1/K6 launches {counts}")
    for k in ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss"):
        a = float(getattr(out, k).detach())
        w = float(getattr(out_ref, k).detach())
        rel = abs(a - w) / max(abs(w), 1e-12)
        log(f"  small model (training), {k}: card bf16 {a:.5f} vs CPU f32 "
            f"{w:.5f} rel {rel:.3e} (tol {TOL_TRAIN_LOSS:g})")
        if not rel <= TOL_TRAIN_LOSS:
            raise AssertionError(f"small model (training) {k}: the card "
                                 "disagrees with the CPU reference")
    got = dict(dev.model.named_parameters())

    def group_of(n):
        return ("lora" if "lora_" in n else "lm_head" if "lm_head" in n else
                "embed_tokens" if "embed_tokens" in n else
                "text_hidden_fcs" if "text_hidden_fcs" in n else "mask_decoder")

    groups = {}     # group -> [sum |d|^2, sum |w|^2, [(|d|^2, |w|^2, name)]]
    for n in ref.tx.trainable:
        w = ref.state.params[n].grad
        if w is None:         # the mask decoder's unused IoU / score heads
            if got[n].grad is not None:
                raise AssertionError(f"small model (training): {n} has a "
                                     "gradient on the card only")
            continue
        a = got[n].grad.float().cpu()
        d2, w2 = float((a - w).norm()) ** 2, float(w.norm()) ** 2
        g = groups.setdefault(group_of(n), [0.0, 0.0, []])
        g[0], g[1] = g[0] + d2, g[1] + w2
        g[2].append((d2, w2, n))
    leaves = []
    for grp, (gd, gw, members) in sorted(groups.items()):
        log(f"  small model (training), gradients of {grp} ({len(members)} "
            f"leaves): card bf16 vs CPU f32 rel L2 {(gd / gw) ** 0.5:.3e}")
        # a leaf whose true gradient is zero (a softmax's key bias) holds
        # rounding on both sides; it counts in its group's total only
        leaves += [((d2 / w2) ** 0.5, n) for d2, w2, n in members
                   if w2 ** 0.5 > 1e-4 * gw ** 0.5]
    rel_all = (sum(g[0] for g in groups.values())
               / sum(g[1] for g in groups.values())) ** 0.5
    leaves.sort(reverse=True)
    worst = leaves[0]
    log(f"  small model (training), all trainable gradients: rel L2 "
        f"{rel_all:.3e} (tol {TOL_TRAIN_GRAD_ALL:g}); of {len(leaves)} leaves "
        f"with a gradient the worst (tol {TOL_TRAIN_GRAD:g}): "
        + ", ".join(f"{n} {r:.3e}" for r, n in leaves[:3]))
    if not (rel_all <= TOL_TRAIN_GRAD_ALL and worst[0] <= TOL_TRAIN_GRAD):
        raise AssertionError("small model (training): gradients on the card "
                             "disagree with the CPU reference")


PHASES = ("kernels", "experiments", "serve", "train")
SOURCES = {
    "attention_fwd": ("cuda", "videoglamm_torch/csrc/attention_fwd.cu"),
    "gemm_epilogue": ("cuda", "videoglamm_torch/csrc/gemm_epilogue.cu"),
    "row_norm": ("triton", "videoglamm_torch/ops/norms.py"),
    "fused_window_block": ("cuda", "videoglamm_torch/ops/fused_block.py"),
    "decode_attention_q8": ("cuda", "videoglamm_torch/csrc/decode_attention_q8.cu"),
    "dequant_gemv": ("cuda", "videoglamm_torch/csrc/dequant_gemv.cu"),
    "flash_bwd": ("cuda", "videoglamm_torch/csrc/flash_bwd.cu"),
    "window_attention": ("cuda", "videoglamm_torch/csrc/window_attention.cu"),
    "smallwin_attention": ("cuda", "videoglamm_torch/csrc/smallwin_attention.cu"),
    "decode_fused": ("cuda", "videoglamm_torch/csrc/decode_fused.cu"),
    # K1 through BSHD strides: no device code of its own
    "flash_bshd": ("cuda", "videoglamm_torch/csrc/attention_fwd.cu"),
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
    "flash_bwd": "videoglamm_tpu/ops/attention.py:302",
    "attention_fwd[flash_d256]": "videoglamm_tpu/ops/attention.py:93",
    "window_attention": "videoglamm_tpu/ops/attention.py:523",
    "smallwin_attention": "videoglamm_tpu/ops/attention.py:605",
    "decode_fused[norm_matmul]": "scripts/decode_mlp_experiment.py:304",
    "decode_fused[matmul_residual]": "scripts/decode_mlp_experiment.py:366",
    "decode_fused[mlp]": "scripts/decode_mlp_experiment.py:123",
    "decode_fused[mlp_w8a8]": "scripts/decode_mlp_experiment.py:212",
    "flash_bshd": "scripts/bench_flash_bshd.py:61",
}


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic training batch")
    ap.add_argument("--phases", default="all",
                    help="'all' (the default: every phase, as the contract "
                    "runs it) or a comma list of " + ", ".join(PHASES)
                    + "; the build always runs")
    args = ap.parse_args()
    chosen = set(PHASES) if args.phases == "all" else set(args.phases.split(","))
    if not chosen <= set(PHASES):
        ap.error(f"--phases: unknown {sorted(chosen - set(PHASES))}")
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

    def phase(title: str):
        log(f"{title} (at {time.perf_counter() - t_start:.0f} s)")

    K = Kernels()
    cfg = VideoGLaMMConfig.flagship()
    try:
        phase("[build]")
        phase_build()
        if "kernels" in chosen:
            phase("[kernels] kernel vs plain twin at the main path's shapes")
            phase_kernels(K)
            torch.cuda.empty_cache()
            phase("[kernels] the fused decode-layer entries (K9) and K1 on BSHD views")
            phase_decode_fused(K)
            torch.cuda.empty_cache()
        if "experiments" in chosen:
            phase("[experiment] decode-layer A/B over 32 layers of stacked "
                  "weights, then the BSHD attention harness")
            experiment_counts = phase_experiments()
            torch.cuda.empty_cache()

        if "serve" in chosen:
            phase("[serve] bf16 weights, bf16 cache, preprocessed streams")
            gi = build(cfg, "none", "bf16", "bf16 LLM")
            requests = [make_request(cfg, 100 + i) for i in range(2)]
            results, _ = phase_serve(gi, cfg, "bf16", requests, raw=False)
            phase("[check] bf16")
            check_outputs(cfg, results, "bf16")
            frames, context, _, ids, lens = requests[0]
            check_teacher_forced(gi.model, frames, context, ids, lens, TOL_LLM_TF,
                                 "bf16 weights, bf16 cache")
            measure_decode(gi.model, frames, context, ids, lens, "bf16")
            del gi, results, requests, frames, context
            torch.cuda.empty_cache()

            phase("[serve] main path: int8 weights, int8 cache, raw uint8 "
                f"[1,{cfg.num_frames},{RAW_H},{RAW_W},3] frames")
            gi = build(cfg, "int8", "int8", "int8 LLM")
            raw_requests = [make_raw_request(cfg, 200 + i) for i in range(N_REQUESTS)]
            results, counts = phase_serve(gi, cfg, "int8", raw_requests, raw=True)
            phase("[check] int8")
            check_outputs(cfg, results, "int8")
            raw, ids, lens = raw_requests[0]
            with torch.no_grad():
                frames, context, _ = prepare_vision_inputs(
                    raw, cfg, num_sam_frames=T_SAM, dtype=torch.bfloat16)
            check_teacher_forced(gi.model, frames, context, ids, lens,
                                 TOL_LLM_TF_Q, "int8 weights, int8 cache")
            step_ms = measure_decode(gi.model, frames, context, ids, lens,
                                     "int8 + int8 KV")
            del results

            phase(f"[serve] speculative decoding on the main path's model, "
                f"draft_k={DRAFT_K}, raw frames")
            phase_speculative(gi, cfg, raw_requests, frames, context, ids, lens,
                              step_ms)
            phase("[serve] sampled decoding on the main path's model, temperature "
                "0.7, raw frames")
            phase_sampled(gi, cfg, raw_requests[0])

            phase("[serve] video branch on the main path's model: SAM-2 memory "
                f"tracker, all {cfg.num_frames} frames to SAM, "
                f"{cfg.max_seg_tokens} [SEG] objects")
            results, track_counts = phase_serve(
                gi, cfg, "track", raw_requests[:N_TRACK_REQUESTS], raw=True,
                track=True)
            phase("[check] video branch")
            check_outputs(cfg, results, "video branch", t_sam=cfg.num_frames)
            profile_track(gi, cfg, raw)
            del results
            torch.cuda.empty_cache()
            phase("[check] Hiera(hoist_layout=False) against the hoisted encoder")
            hoist_counts = phase_unhoisted_hiera(
                gi.model.visual_model.image_encoder.trunk)
            del gi
            torch.cuda.empty_cache()

            phase("[serve] int4 weights, int8 cache, raw frames")
            gi = build(cfg, "int4", "int8", "int4 LLM")
            results, counts4 = phase_serve(gi, cfg, "int4", raw_requests[:2], raw=True)
            phase("[check] int4")
            check_outputs(cfg, results, "int4")
            measure_decode(gi.model, frames, context, ids, lens, "int4 + int8 KV")
            counts["dequant_gemv[int4]"] = counts4["dequant_gemv[int4]"]
            del gi, results, frames, context, raw
            torch.cuda.empty_cache()

            phase("[serve] video branch at SAM image size 512 (32x32 memory grid), "
                "bf16 weights, raw frames")
            cfg512 = dataclasses.replace(
                cfg, sam2=dataclasses.replace(cfg.sam2, image_size=512))
            gi = build(cfg512, "none", "bf16", "bf16 LLM, SAM image size 512")
            results, track512_counts = phase_serve(
                gi, cfg512, "track512", raw_requests[:N_TRACK_REQUESTS], raw=True,
                track=True)
            phase("[check] video branch at 512")
            check_outputs(cfg512, results, "video branch at 512",
                          t_sam=cfg.num_frames)
            del gi, results
            torch.cuda.empty_cache()

            phase("[serve] Llama-3.1-8B base at full width and depth, bf16 weights, "
                "int8 cache, raw frames")
            phase_llama(cfg, raw_requests)
            del raw_requests
            torch.cuda.empty_cache()

            phase("[check] narrow model on the card against the CPU twins")
            phase_small_reference()
            phase("[check] narrow tracker on the card against the CPU twins")
            for image_size in (1024, 512):
                phase_small_track_reference(image_size)

        if "train" in chosen:
            phase(f"[train] flagship, {TRAIN_STEPS} optimizer steps of {GRAD_ACCUM} "
                "micro-steps, LoRA + lm_head + embed_tokens + text_hidden_fcs + "
                "mask decoder")
            train_counts = phase_train(cfg, args.seed)
            torch.cuda.empty_cache()
            phase("[check] narrow model, one training micro-step on the card "
                "against the CPU twins")
            phase_small_train_reference(args.seed)
    except Exception:
        traceback.print_exc()
        log("FAIL")
        return 1
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    # launches: the serving main path's run (int8 + int8 KV from raw frames,
    # 3 requests); the int4 entry's from the int4 path's run (2 requests);
    # K6's from the training path's run, whose counts stand beside every
    # kernel as launches_train (4 optimizer steps of 2 micro-steps); K1 at
    # head dim 256 from the video branch's run on the main path's model (2
    # requests), whose counts stand beside every kernel as launches_track;
    # K7's from the video branch at image size 512 (2 requests); K8's from
    # the unhoisted Hiera forward; K9's four entries and the BSHD launcher
    # from the run of the two experiment harnesses. A row keyed
    # "<counter>@<shape>" is another shape of the counter's kernel. Phases
    # that did not run leave their counts null.
    if "serve" in chosen:
        counts["attention_fwd[flash_d256]"] = track_counts["attention_fwd[flash_d256]"]
        counts["window_attention"] = track512_counts["window_attention"]
        counts["smallwin_attention"] = hoist_counts["smallwin_attention"]
    else:
        counts = track_counts = {}
    if "train" in chosen:
        counts["flash_bwd"] = train_counts["flash_bwd"]
    else:
        train_counts = {}
    if "experiments" in chosen:
        for key in experiment_counts:
            if key.startswith("decode_fused") or key == "flash_bshd":
                counts[key] = experiment_counts[key]
    kernels = []
    for key, row in K.rows.items():
        counter = key.split("@")[0]
        route, source = SOURCES[counter.split("[")[0]]
        kernels.append(dict(name=key, route=route, source=source,
                            replaces=REPLACES[counter],
                            launches=counts.get(counter),
                            launches_train=train_counts.get(counter),
                            launches_track=track_counts.get(counter), **row))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    result = {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}
    if args.phases != "all":
        result["phases"] = sorted(chosen)
    log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
