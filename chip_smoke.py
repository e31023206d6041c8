#!/usr/bin/env python3
"""Drive the videoglamm_torch port once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each fatal on failure:

1. device: needs CUDA; prints the card's name and power limit
   (nvidia-smi) and turns TF32 off for matmuls and cuDNN;
2. build: compiles K1 (csrc/attention_fwd.cu) and K2 (csrc/gemm_epilogue.cu)
   from the checkout's sources with nvcc and JIT-compiles K3 (the Triton
   row norm), printing build seconds and the -Xptxas -v lines;
3. kernels: holds every kernel against its plain PyTorch twin on the same
   inputs at the main path's shapes, with the stated tolerance, and times
   both with CUDA events (median of 7 after 2 warm-up calls);
4. serve: builds the flagship VideoGLaMM (seeded random weights, normal
   std 0.02, norm scales 1) in bf16 on the card and serves 3 requests
   through GroundedInference (16 frames at 224^2 and 336^2, 8 SAM frames
   at 1024^2, 64 prompt ids, 64 new tokens), with every launch counter set
   to 0 just before and read just after; a kernel of the path that was
   never launched fails the run;
5. check: the served outputs are finite and of the expected shapes; the
   cached decode (plain attention) agrees with one uncached forward (K1
   causal) over the same teacher-forced token stream; and a narrow model
   whose shapes still take every kernel (real image sizes and sequence
   lengths, a few layers) agrees on the card in bf16 with the same weights
   run on the CPU in f32 through the plain twins, which the CPU tests hold
   to the JAX package.

Prints one {"kernels": [...]} JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Exits nonzero, printing no result, without
a card or outside the repository.
"""
from __future__ import annotations

import copy
import dataclasses
import json
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
TOL_LLM_TF = 5e-2       # relative L2, cached bf16 decode vs uncached
                        # forward after 32 layers of bf16 rounding
TOL_SMALL_REF = 5e-2    # relative L2, bf16 kernels on the card vs f32 plain
                        # twins on the CPU, through a few layers each

N_REQUESTS = 3
MAX_NEW = 64
S_TEXT = 64


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


def time_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def rel_err(got, ref) -> tuple:
    d = (got.float() - ref.float()).abs().max().item()
    return d, d / max(1.0, ref.float().abs().max().item())


class Kernels:
    """Collects the kernel-versus-plain measurements."""

    def __init__(self):
        self.rows = {}

    def compare(self, key, label, kernel_fn, plain_fn, tol):
        import torch
        got = kernel_fn()
        ref = plain_fn()
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        del got, ref
        ms = time_ms(kernel_fn)
        plain_ms = time_ms(plain_fn)
        ok = rel <= tol
        log(f"  {label}: max_abs_err={err:.3e} rel={rel:.3e} tol={tol:g} "
            f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
            f"{'ok' if ok else 'MISS'}")
        if not ok:
            raise AssertionError(f"{label}: kernel disagrees with its plain twin")
        if key is not None:
            self.rows[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_build():
    import torch
    from videoglamm_torch.ops import _cuda, norms
    for name in ("attention_fwd", "gemm_epilogue"):
        b = _cuda.load(name)
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


def phase_kernels(K: Kernels):
    import torch
    from videoglamm_torch.ops import attention as A
    from videoglamm_torch.ops import fused_block as FB
    from videoglamm_torch.ops import norms as N

    g = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16

    def randn(*shape, dtype=bf, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    # K1 causal: Phi-3 prefill [1,32,3391,96]
    S = 3391
    q, k, v = (randn(1, 32, S, 96) for _ in range(3))
    kvl = torch.tensor([S], device="cuda", dtype=torch.int32)
    qs = torch.zeros(1, device="cuda", dtype=torch.int32)
    K.compare("attention_fwd[causal]", "K1 causal Phi-3 prefill [1,32,3391,96]",
              lambda: A.flash_attention(q, k, v, causal=True, kv_lens=kvl,
                                        q_start=qs),
              lambda: A._attention_plain(q, k, v, causal=True,
                                         sm_scale=96 ** -0.5, kv_lens=kvl,
                                         q_start=qs), TOL_BF16_ATTN)
    # K1 flash: Hiera global block, 8 frames [8,8,4096,72] (BSHD views)
    qkv = randn(8, 4096, 3, 8, 72)
    gq, gk, gv = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    K.compare("attention_fwd[flash]", "K1 Hiera global [8,8,4096,72]",
              lambda: A.flash_attention(gq, gk, gv),
              lambda: A._attention_plain(gq, gk, gv, causal=False,
                                         sm_scale=72 ** -0.5), TOL_BF16_ATTN)
    del q, k, v, qkv, gq, gk, gv
    # K1 BSHD: CLIP [16,577,16,64]; InternVideo2 fused qkv [4,1025,3,16,88]
    cq, ck, cv = (randn(16, 577, 16, 64) for _ in range(3))
    K.compare("attention_fwd[bshd]", "K1 CLIP BSHD [16,577,16,64]",
              lambda: A.attention_bshd(cq, ck, cv),
              lambda: A._attention_plain_bshd(cq, ck, cv, 64 ** -0.5),
              TOL_BF16_ATTN)
    iv = randn(4, 1025, 3 * 16 * 88)
    iv5 = iv.view(4, 1025, 3, 16, 88)
    K.compare(None, "K1 InternVideo2 fused qkv [4,1025,3*16*88]",
              lambda: A.attention_packed_qkv_padded(iv, 16, 88),
              lambda: A._attention_plain_bshd(iv5[:, :, 0], iv5[:, :, 1],
                                              iv5[:, :, 2], 88 ** -0.5
                                              ).reshape(4, 1025, 16 * 88),
              TOL_BF16_ATTN)
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
        def kernel():
            A.attention_fwd_kernel(*(t.transpose(1, 2) for t in views),
                                   out.transpose(1, 2), causal=False,
                                   sm_scale=hd ** -0.5, mode="window", win=win)
            return out

        K.compare(key, f"K1 window S={Sw} NW={NW} H={H} (fold {fold}, win {win})",
                  kernel, lambda: A._attention_plain_bshd(*views, hd ** -0.5, win),
                  TOL_BF16_ATTN)

    window_case(8192, 64, 2, "attention_fwd[window]")
    window_case(8192, 16, 4, None)
    window_case(128, 256, 8, None)

    # K3: RMS at 3072 and 1408, LN at 1024 (with/without bias), 256 f32
    ones = lambda d: torch.ones(d, device="cuda")
    x = randn(3391, 3072)
    w = randn(3072, dtype=torch.float32, scale=0.1) + 1
    K.compare("row_norm[rms]", "K3 RMS Phi-3 [3391,3072] bf16",
              lambda: N.row_norm(x, w, None, 1e-5, rms=True),
              lambda: N._rms_norm_plain(x, w, 1e-5), TOL_BF16_NORM)
    x = randn(4, 1025, 1408)
    K.compare(None, "K3 RMS InternVideo2 [4,1025,1408] bf16",
              lambda: N.row_norm(x, ones(1408), None, 1e-6, rms=True),
              lambda: N._rms_norm_plain(x, ones(1408), 1e-6), TOL_BF16_NORM)
    x = randn(16, 577, 1024, scale=3.0)
    w = randn(1024, dtype=torch.float32, scale=0.1) + 1
    b = randn(1024, dtype=torch.float32, scale=0.1)
    K.compare("row_norm[ln]", "K3 LN CLIP [16,577,1024] bf16 +bias",
              lambda: N.row_norm(x, w, b, 1e-5, rms=False),
              lambda: N._layer_norm_plain(x, w, b, 1e-5), TOL_BF16_NORM)
    K.compare(None, "K3 LN CLIP [16,577,1024] bf16 no bias",
              lambda: N.row_norm(x, w, None, 1e-5, rms=False),
              lambda: N._layer_norm_plain(x, w, None, 1e-5), TOL_BF16_NORM)
    x = randn(32, 4096, 256, dtype=torch.float32)
    w = randn(256, dtype=torch.float32, scale=0.1) + 1
    b = randn(256, dtype=torch.float32, scale=0.1)
    K.compare(None, "K3 LN SAM two-way [32,4096,256] f32 +bias",
              lambda: N.row_norm(x, w, b, 1e-5, rms=False),
              lambda: N._layer_norm_plain(x, w, b, 1e-5), TOL_F32_NORM)
    del x

    # K2 at the Hiera stage-1 fc1 shape over 8 frames: [524288,144]x[576,144]^T
    a = randn(524288, 144, scale=0.5)
    w2 = randn(576, 144, scale=144 ** -0.5)
    b2 = randn(576, scale=0.02)
    K.compare("gemm_epilogue", "K2 fc1+bias+GELU [524288,144]x[144,576]",
              lambda: FB.gemm_epilogue(a, w2, b2, gelu=True),
              lambda: FB._gemm_plain(a, w2, b2, gelu=True), TOL_BF16_GEMM)
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
        K.compare(key, f"fused_window_block S={Sw} C={C} NW={NW}",
                  lambda: FB.fused_window_block(xb, p, H),
                  lambda: FB._fused_block_ref(xb, p, H), TOL_BF16_GEMM)

    block_case(2048, 64, 144, 2, "fused_window_block")
    block_case(2048, 16, 288, 4, None)
    block_case(128, 256, 576, 8, None)
    block_case(128, 64, 1152, 16, None)


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


def build_model():
    import torch
    from videoglamm_torch.config import VideoGLaMMConfig
    from videoglamm_torch.models.videoglamm import VideoGLaMM

    cfg = VideoGLaMMConfig.flagship()
    with torch.device("meta"):
        model = VideoGLaMM(cfg)
    model.to_empty(device="cuda")
    seeded_init(model, torch.Generator(device="cuda").manual_seed(0))
    model.to_compute_dtype(torch.bfloat16).eval()
    n = sum(p.numel() for p in model.parameters())
    log(f"  flagship VideoGLaMM: {n / 1e9:.3f} B parameters, bf16 compute, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    return model, cfg


def make_request(cfg, seed: int):
    import torch
    from videoglamm_torch.constants import IMAGE_TOKEN_INDEX
    g = torch.Generator(device="cuda").manual_seed(seed)
    T = cfg.num_frames
    bf = torch.bfloat16
    frames = torch.randn(1, T, 224, 224, 3, generator=g, device="cuda").to(bf)
    context = torch.randn(1, T, 336, 336, 3, generator=g, device="cuda").to(bf)
    sam = torch.randn(1, 8, 1024, 1024, 3, generator=g, device="cuda").to(bf)
    ids = torch.randint(1, 32000, (1, S_TEXT), generator=g, device="cuda")
    ids[:, 2] = IMAGE_TOKEN_INDEX
    lens = torch.full((1,), S_TEXT, dtype=torch.long, device="cuda")
    return frames, context, sam, ids, lens


def reset_counts():
    from videoglamm_torch.ops import attention, fused_block, norms
    for c in (attention.LAUNCHES, fused_block.LAUNCHES, norms.LAUNCHES):
        c.clear()


def read_counts() -> dict:
    from videoglamm_torch.ops import attention, fused_block, norms
    return {
        "attention_fwd[causal]": attention.LAUNCHES["causal"],
        "attention_fwd[flash]": attention.LAUNCHES["flash"],
        "attention_fwd[bshd]": attention.LAUNCHES["bshd"],
        "attention_fwd[window]": attention.LAUNCHES["window"],
        "gemm_epilogue": fused_block.LAUNCHES["gemm"],
        "row_norm[rms]": norms.LAUNCHES["rms"],
        "row_norm[ln]": norms.LAUNCHES["ln"],
        "fused_window_block": fused_block.LAUNCHES["block"],
    }


# launches one flagship request must make: Phi-3 prefill, 32 causal
# layers; 3 Hiera global blocks; CLIP 23 + InternVideo2 39 BSHD layers;
# 42 fused Hiera window blocks of 4 K2 GEMMs each
EXPECTED_PER_REQUEST = {"attention_fwd[causal]": 32, "attention_fwd[flash]": 3,
                        "attention_fwd[bshd]": 62, "attention_fwd[window]": 42,
                        "fused_window_block": 42, "gemm_epilogue": 168}


def phase_serve(model, cfg):
    import torch
    from videoglamm_torch.inference.pipeline import GroundedInference

    gi = GroundedInference(model, max_new_tokens=MAX_NEW)
    requests = [make_request(cfg, 100 + i) for i in range(N_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    results = []
    for i, req in enumerate(requests):
        timings = {}
        t0 = time.perf_counter()
        out = gi(*req, timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results.append(out)
        masks = out.pred_masks
        log(f"  request {i}: wall {wall:.3f} s, "
            + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
            + f", {cfg.num_frames / wall:.3f} frames/s, tokens "
            f"{int(out.lengths[0])}/{MAX_NEW}, [SEG] {int(out.seg_valid.sum())}, "
            f"masks {tuple(masks.shape)} finite={bool(torch.isfinite(masks).all())}")
    counts = read_counts()
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("  launches over the served requests: " + json.dumps(counts))
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"{name} was never launched on the main path")
    for name, per in EXPECTED_PER_REQUEST.items():
        if counts[name] != per * N_REQUESTS:
            raise AssertionError(f"{name}: {counts[name]} launches, expected "
                                 f"{per} per request x {N_REQUESTS}")
    return results, counts, requests


def phase_check(model, cfg, results, requests):
    import torch
    from videoglamm_torch.inference.generate import decode_step, prefill
    from videoglamm_torch.models.multimodal import splice_visual_prefix

    E4 = 4 * cfg.sam2.low_res_size
    for i, out in enumerate(results):
        shape = (1, cfg.max_seg_tokens, 8, E4, E4)
        if tuple(out.pred_masks.shape) != shape:
            raise AssertionError(f"request {i}: masks {tuple(out.pred_masks.shape)}")
        if not torch.isfinite(out.pred_masks).all():
            raise AssertionError(f"request {i}: non-finite mask logits")
        invalid = ~out.seg_valid[0]
        if not (out.pred_masks[0][invalid] <= -1e3).all():
            raise AssertionError(f"request {i}: invalid [SEG] slots not masked")
        vocab = cfg.llm.vocab_size + 1
        if not ((out.tokens >= 0) & (out.tokens < vocab)).all():
            raise AssertionError(f"request {i}: token ids out of range")
    log("  outputs: finite, expected shapes, invalid slots <= -1e3, ids in vocab")

    # teacher-forced LLM check: cached decode (plain attention over the
    # cache) vs one uncached forward (K1 causal) over the same stream
    frames, context, _, ids, lens = requests[0]
    g = torch.Generator(device="cuda").manual_seed(7)
    n = 16
    forced = torch.randint(1, 32000, (1, n), generator=g, device="cuda")
    with torch.no_grad():
        visual = model.encode_visual_prefix(frames, context)
        _, cache, sp, _ = prefill(model.llm, visual, ids, lens, n)
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
    log(f"  LLM teacher-forced, {n} steps: cached decode vs uncached K1 forward "
        f"rel L2 {rel:.3e} (tol {TOL_LLM_TF:g}), cosine {cos:.6f}")
    if not rel <= TOL_LLM_TF:
        raise AssertionError("cached decode disagrees with the uncached forward")


def small_config():
    """Flagship image sizes, frame counts and sequence lengths with narrow,
    shallow towers: every kernel still takes its main-path branch (CLIP
    S=577, InternVideo2 S=1025 at head dim 88, a 3391-token causal prefill,
    Hiera windows of 64/16/256 tokens and a 4096-token global block)."""
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
    from videoglamm_torch.inference.generate import prefill
    from videoglamm_torch.models.videoglamm import SegExtraction, VideoGLaMM
    from videoglamm_torch.constants import IMAGE_TOKEN_INDEX

    cfg = small_config()
    ref = seeded_init(VideoGLaMM(cfg), torch.Generator().manual_seed(3)).eval()
    dev = copy.deepcopy(ref).cuda().to_compute_dtype(torch.bfloat16).eval()
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

    def run(model, device, dtype):
        on = lambda t: t.to(device)
        visual = model.encode_visual_prefix(on(frames).to(dtype), on(context).to(dtype))
        _, _, _, logits = prefill(model.llm, visual, on(ids), on(lens), 1)
        feats, _ = model.encode_sam_features(on(sam).to(dtype))
        masks = model.decode_masks(feats, SegExtraction(*map(on, seg)),
                                   torch.arange(1, device=device))
        return dict(visual=visual, prefill_logits=logits, sam_s0=feats[0],
                    sam_s1=feats[1], sam_embed=feats[2], masks=masks)

    with torch.no_grad():
        got = run(dev, "cuda", torch.bfloat16)
        want = run(ref, "cpu", torch.float32)
    for k, w in want.items():
        a = got[k].float().cpu()
        rel = ((a - w).norm() / w.norm()).item()
        log(f"  small model, {k} {tuple(w.shape)}: card bf16 vs CPU f32 "
            f"rel L2 {rel:.3e} (tol {TOL_SMALL_REF:g})")
        if not rel <= TOL_SMALL_REF:
            raise AssertionError(f"small model {k}: kernels disagree with the "
                                 "CPU reference")


SOURCES = {
    "attention_fwd": ("cuda", "videoglamm_torch/csrc/attention_fwd.cu"),
    "gemm_epilogue": ("cuda", "videoglamm_torch/csrc/gemm_epilogue.cu"),
    "row_norm": ("triton", "videoglamm_torch/ops/norms.py"),
    "fused_window_block": ("cuda", "videoglamm_torch/ops/fused_block.py"),
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

    smi = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] TF32 off for matmul and cuDNN")

    t_start = time.perf_counter()
    K = Kernels()
    try:
        log("[build]")
        phase_build()
        log("[kernels] kernel vs plain twin at the main path's shapes")
        phase_kernels(K)
        torch.cuda.empty_cache()
        log("[serve]")
        model, cfg = build_model()
        results, counts, requests = phase_serve(model, cfg)
        log("[check]")
        phase_check(model, cfg, results, requests)
        del model, results, requests
        torch.cuda.empty_cache()
        phase_small_reference()
    except Exception:
        traceback.print_exc()
        log("FAIL")
        return 1
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for key, row in K.rows.items():
        base = key.split("[")[0]
        route, source = SOURCES[base]
        kernels.append(dict(name=key, route=route, source=source,
                            replaces=REPLACES[key], launches=counts[key],
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"]))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
