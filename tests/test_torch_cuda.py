"""Hand-written Hopper kernels of videoglamm_torch against their plain
PyTorch twins, on the card, at small shapes.

Every test here needs an NVIDIA GPU: the CUDA and Triton kernels have no
CPU mode. The `dev` fixture decides at run time and skips with a reason
on a machine without a card. Run on the card (which has no jax, hence no
conftest) with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

Tolerances: the kernels and the twins round to bf16 at the same points,
but sum in another order, and K1 rounds the unnormalised softmax weights
(in [0, 1]) where the twin rounds the normalised ones. So they differ by a
few bf16 ulps (2^-8 relative) of the output scale. K4 likewise rounds
p * v_scale relative to the running maximum where its twin rounds the
normalised probability. K5 rounds once, after an f32 sum taken in another
order than the twin's, so it differs by at most one bf16 ulp. K9's bf16
entries round where their twins round and sum in another order (a few bf16
ulps where a rounding of g, u or h flips); its W8A8 entry is held by its
integers, which are exact.
"""
import re

import numpy as np
import pytest
import torch

from videoglamm_torch.experiments import decode_mlp as dm
from videoglamm_torch.experiments import flash_bshd as fbshd
from videoglamm_torch.ops import attention as attn
from videoglamm_torch.ops import fused_block as fb
from videoglamm_torch.ops import norms
from videoglamm_torch.ops import quant
from videoglamm_torch.models import kvcache

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA/Triton kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dev, scale=1.0, dtype=torch.bfloat16):
    return torch.as_tensor(rng.standard_normal(shape) * scale,
                           dtype=torch.float32).to(dev, dtype)


def _close(got, ref, tol, what):
    err = (got.float() - ref.float()).abs().max().item()
    scale = max(ref.float().abs().max().item(), 1.0)
    assert err <= tol * scale, f"{what}: max|d|={err:.3e} > {tol}*{scale:.3g}"


def _close_l2(got, ref, tol, what):
    """Relative L2 over all elements. `_close` measures against max(|ref|, 1),
    which holds an output far below 1 to nothing: attention over S keys of
    unit variance has a deviation of about sqrt(e / S). A dropped key tile,
    a softmax scale off by a tenth or an unmasked last tile each move the
    relative L2 by 2e-2 and more."""
    g, r = got.double(), ref.double()
    rel = ((g - r).norm() / r.norm()).item()
    assert rel <= tol, f"{what}: relative L2 {rel:.3e} > {tol}"


@pytest.mark.parametrize("B,H,Sq,Sk,D,kv,qs", [
    (2, 4, 300, 300, 96, (300, 211), (0, 0)),      # prefill, ragged kv_len
    (1, 2, 130, 384, 64, (300,), None),            # decode convention
    (2, 2, 200, 200, 72, (200, 150), (0, 0)),
])
def test_k1_causal_matches_plain(dev, B, H, Sq, Sk, D, kv, qs):
    rng = np.random.default_rng(0)
    q, k, v = (_randn(rng, (B, H, s, D), dev) for s in (Sq, Sk, Sk))
    kv_lens = torch.tensor(kv, dtype=torch.int32, device=dev)
    q_start = None if qs is None else torch.tensor(qs, dtype=torch.int32, device=dev)
    got = attn.flash_attention(q, k, v, causal=True, kv_lens=kv_lens,
                               q_start=q_start)
    ref = attn._attention_plain(q, k, v, causal=True, sm_scale=D ** -0.5,
                                kv_lens=kv_lens,
                                q_start=kv_lens - Sq if q_start is None else q_start)
    torch.cuda.synchronize()
    offs = (kv_lens - Sq if q_start is None else q_start).tolist()
    for b in range(B):
        # rows with at least one valid key (the kernel writes 0 elsewhere)
        lo = max(0, -offs[b])
        _close(got[b, :, lo:], ref[b, :, lo:], 2e-2, f"causal b={b}")


@pytest.mark.parametrize("B,S,H,D,win", [
    (2, 577, 4, 64, 0), (1, 1025, 2, 88, 0), (4, 64, 2, 72, 16),
    (2, 256, 4, 72, 64), (1, 512, 2, 72, 256), (1, 4096, 2, 72, 0)])
def test_k1_bshd_matches_plain(dev, B, S, H, D, win):
    rng = np.random.default_rng(1)
    qkv = _randn(rng, (B, S, 3 * H * D), dev)
    got = attn.attention_packed_qkv_padded(qkv, H, D, win=win) if S <= 1536 \
        else None
    x = qkv.view(B, S, 3, H, D)
    ref = attn._attention_plain_bshd(x[:, :, 0], x[:, :, 1], x[:, :, 2],
                                     D ** -0.5, win)
    if got is None:   # long non-causal: the flash entry on [B,H,S,D] views
        got = attn.flash_attention(x[:, :, 0].transpose(1, 2),
                                   x[:, :, 1].transpose(1, 2),
                                   x[:, :, 2].transpose(1, 2)).transpose(1, 2)
    torch.cuda.synchronize()
    _close(got.reshape(ref.shape), ref, 2e-2, f"bshd S={S} win={win}")


@pytest.mark.parametrize("M,K,N,gelu,res", [
    (1000, 144, 432, False, False), (777, 288, 1152, True, False),
    (513, 576, 144, False, True), (64, 1152, 4608, True, False)])
def test_k2_gemm_matches_plain(dev, M, K, N, gelu, res):
    rng = np.random.default_rng(2)
    a = _randn(rng, (M, K), dev, 0.5)
    w = _randn(rng, (N, K), dev, K ** -0.5)
    b = _randn(rng, (N,), dev, 0.1)
    r = _randn(rng, (M, N), dev) if res else None
    got = fb.gemm_epilogue(a, w, b, gelu=gelu, residual=r)
    ref = fb._gemm_plain(a, w, b, gelu=gelu, residual=r)
    torch.cuda.synchronize()
    _close(got, ref, 2e-2, f"gemm M={M} K={K} N={N}")


@pytest.mark.parametrize("d,rms,bias,dtype", [
    (3072, True, False, torch.bfloat16), (1408, True, False, torch.bfloat16),
    (1024, False, True, torch.bfloat16), (256, False, True, torch.float32),
    (1152, False, False, torch.bfloat16), (144, False, True, torch.bfloat16)])
@pytest.mark.parametrize("rows", [37, 20000])
def test_k3_row_norm_matches_plain(dev, d, rms, bias, dtype, rows):
    """K3's persistent programs at row counts below and far above the
    number of SMs (each program then walks many blocks of rows)."""
    rng = np.random.default_rng(3)
    x = _randn(rng, (rows, d), dev, 2.0, dtype)
    w = _randn(rng, (d,), dev, 0.1, torch.float32) + 1.0
    b = _randn(rng, (d,), dev, 0.1, torch.float32) if bias else None
    got = norms.row_norm(x, w, b, 1e-6, rms=rms)
    ref = (norms._rms_norm_plain(x, w, 1e-6) if rms
           else norms._layer_norm_plain(x, w, b, 1e-6))
    torch.cuda.synchronize()
    _close(got, ref, 1e-5 if dtype == torch.float32 else 1e-2, f"norm d={d}")


@pytest.mark.parametrize("d", [144, 1408, 3072])
def test_k3_row_norm_takes_a_strided_input(dev, d):
    """A view whose rows are further apart than d (a slice of a wider
    tensor) and a 3-D view with padded rows."""
    rng = np.random.default_rng(4)
    wide = _randn(rng, (300, d + 64), dev, 2.0)
    x = wide[:, 32:32 + d]
    w = _randn(rng, (d,), dev, 0.1, torch.float32) + 1.0
    b = _randn(rng, (d,), dev, 0.1, torch.float32)
    for rms in (True, False):
        got = norms.row_norm(x, w, None if rms else b, 1e-6, rms=rms)
        ref = (norms._rms_norm_plain(x, w, 1e-6) if rms
               else norms._layer_norm_plain(x, w, b, 1e-6))
        torch.cuda.synchronize()
        _close(got, ref, 1e-2, f"strided norm d={d}")
    x3 = wide.view(3, 100, d + 64)[:, ::2, :d]
    _close(norms.row_norm(x3, w, b, 1e-6, rms=False),
           norms._layer_norm_plain(x3, w, b, 1e-6), 1e-2, "3-D view")


@pytest.mark.parametrize("NW,S,H,hd", [(16, 64, 2, 72), (32, 16, 4, 72),
                                       (4, 256, 8, 72), (4, 64, 16, 72)])
def test_fused_window_block_matches_plain(dev, NW, S, H, hd):
    rng = np.random.default_rng(4)
    C = H * hd
    Mh = 4 * C
    x = _randn(rng, (NW, S, C), dev, 0.5)
    shapes = dict(ln1_weight=(C,), ln1_bias=(C,), qkv_weight=(3 * C, C),
                  qkv_bias=(3 * C,), proj_weight=(C, C), proj_bias=(C,),
                  ln2_weight=(C,), ln2_bias=(C,), fc1_weight=(Mh, C),
                  fc1_bias=(Mh,), fc2_weight=(C, Mh), fc2_bias=(C,))
    p = {}
    for name, shp in shapes.items():
        if name.startswith("ln"):
            p[name] = _randn(rng, shp, dev, 0.1, torch.float32) + (
                1.0 if name.endswith("weight") else 0.0)
        else:
            fan_in = shp[-1] if len(shp) == 2 else 50
            p[name] = _randn(rng, shp, dev, fan_in ** -0.5)
    before = fb.LAUNCHES["block"]
    got = fb.fused_window_block(x, p, H)
    assert fb.LAUNCHES["block"] == before + 1
    ref = fb._fused_block_ref(x, p, H)
    torch.cuda.synchronize()
    _close(got, ref, 3e-2, f"block S={S} C={C}")


def _int8_cache(rng, L, B, Hkv, C, hd, dev):
    """A stacked int8 cache with different data per layer, made by the
    port's quantiser from random K/V."""
    cache = kvcache.init_cache(L, B, Hkv, C, hd, device=dev, quant_kv=True)
    for layer in range(L):
        kn, vn = (_randn(rng, (B, Hkv, C, hd), dev) for _ in range(2))
        kvcache.write(cache, layer, kn, vn,
                      torch.zeros(B, dtype=torch.long, device=dev))
    return cache


@pytest.mark.parametrize("B,Hq,Hkv,C,hd,L,layer,kv", [
    (1, 32, 32, 3456, 96, 3, 1, (3400,)),     # flagship geometry, MHA
    (2, 4, 4, 300, 96, 2, 0, (300, 211)),     # ragged kv_lens, ragged C
    (1, 8, 2, 700, 64, 2, 1, (650,)),         # GQA G = 4
    (2, 8, 4, 160, 96, 1, 0, (160, 97)),      # GQA G = 2
    (2, 4, 4, 40, 16, 2, 1, (33, 1)),         # tiny() head dim, one token
    (1, 2, 2, 3456, 64, 2, 1, (3391,)),       # narrow rows (R > 1)
    (1, 4, 4, 64, 128, 1, 0, (0,)),           # empty cache row -> zeros
    # Llama-3.1-8B (GQA G = 4, hd 128): ragged rows, kv_len = C, one token
    # past a 60-row stage, and one split's worth of tokens
    (4, 32, 8, 3456, 128, 2, 1, (3456, 3400, 61, 7)),
    (2, 32, 32, 3456, 96, 2, 0, (3456, 241)),  # Phi-3: = C, one past a stage
    (2, 8, 2, 999, 112, 2, 1, (999, 500)),    # G = 4 at a padded row pitch
])
def test_k4_decode_attention_matches_plain(dev, B, Hq, Hkv, C, hd, L, layer, kv):
    rng = np.random.default_rng(5)
    cache = _int8_cache(rng, L, B, Hkv, C, hd, dev)
    q = _randn(rng, (B, Hq, 1, hd), dev)
    kv_lens = torch.tensor(kv, dtype=torch.int32, device=dev)
    args = (q, cache["k"], cache["v"], cache["k_scale"], cache["v_scale"])
    before = attn.LAUNCHES["decode_q8"]
    got = attn.dot_product_attention(q, cache["k"], cache["v"], causal=True,
                                     kv_lens=kv_lens, q_start=kv_lens - 1,
                                     k_scale=cache["k_scale"],
                                     v_scale=cache["v_scale"], layer=layer)
    assert attn.LAUNCHES["decode_q8"] == before + 1
    ref = attn._decode_attention_q8_plain(*args, sm_scale=hd ** -0.5,
                                          kv_lens=kv_lens, layer=layer)
    torch.cuda.synchronize()
    for b in range(B):
        if kv[b] == 0:      # no valid key: K4 writes 0, the twin averages V
            assert not got[b].float().abs().max().item()
        else:
            _close(got[b], ref[b], 2e-2, f"decode b={b}")
    # a 3-D slab is layer 0
    slab = attn.decode_attention_q8(q, cache["k"][layer], cache["v"][layer],
                                    cache["k_scale"][layer],
                                    cache["v_scale"][layer], kv_lens,
                                    sm_scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(slab, got)


def test_k4_one_kernel_a_call_and_bit_equal_repeats(dev):
    """One device kernel a call (no combine kernel, no scratch fill once the
    workspace exists), and repeated calls give the same bits: the splits
    fold in split order, whichever finishes last. The profiler on the card
    now and then drops a kernel record from a window, so a window whose
    count falls short is taken again (at most three); no window may record
    another kernel."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(8)
    for B, Hq, Hkv, C, hd, kv in ((1, 32, 32, 3456, 96, (3400,)),
                                  (2, 32, 8, 3456, 128, (3400, 1200))):
        cache = _int8_cache(rng, 2, B, Hkv, C, hd, dev)
        q = _randn(rng, (B, Hq, 1, hd), dev)
        kv_lens = torch.tensor(kv, dtype=torch.int32, device=dev)
        args = (q, cache["k"], cache["v"], cache["k_scale"], cache["v_scale"],
                kv_lens, 1)
        first = attn.decode_attention_q8(*args, sm_scale=hd ** -0.5)
        torch.cuda.synchronize()
        outs = [attn.decode_attention_q8(*args, sm_scale=hd ** -0.5)
                for _ in range(5)]
        torch.cuda.synchronize()
        assert all(torch.equal(o, first) for o in outs)
        counts = []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    attn.decode_attention_q8(*args, sm_scale=hd ** -0.5)
                torch.cuda.synchronize()
            kernels = [(e.key, e.count) for e in prof.key_averages()
                       if (getattr(e, "self_device_time_total", 0)
                           or getattr(e, "self_cuda_time_total", 0))]
            assert all("decode_q8_kernel" in k for k, _ in kernels), kernels
            counts.append(sum(c for _, c in kernels))
            if counts[-1] == 5:
                break
        assert counts[-1] == 5, counts
    # every call leaves its tickets at 0 (the last split's arrival wraps it)
    assert not any(t.any() for _, t in attn._K4_WORKSPACE.values())


def test_k4_entry_refuses_a_plan_that_does_not_fit(dev):
    """The C entry derives K4's layout from the plan's choices and refuses,
    without launching, choices its kernel does not take: more splits than
    the fold takes or a split count that is not a power of two, more stages
    than barriers or fewer than two, a ring past the 227 KB, TMA boxes off
    the 128-byte grid or past 256 rows, and a workspace or a ticket array
    smaller than the call needs."""
    from videoglamm_torch.ops import _cuda
    rng = np.random.default_rng(9)
    B, Hq, Hkv, C, hd = 2, 32, 8, 3456, 128
    cache = _int8_cache(rng, 1, B, Hkv, C, hd, dev)
    q = _randn(rng, (B, Hq, 1, hd), dev)
    kv_lens = torch.tensor([3400, 1200], dtype=torch.int32, device=dev)
    plan = attn.k4_plan(B, Hq, Hkv, hd, C, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    out = torch.empty_like(q)
    ws = torch.empty(plan.ws_floats, dtype=torch.float32, device=dev)
    tickets = torch.zeros(B * Hkv, dtype=torch.int32, device=dev)
    ok = dict(splits=plan.splits, pitch=plan.pitch, box=plan.box,
              stages=plan.stages, ws_floats=ws.numel(), ntickets=B * Hkv)

    def call(**change):
        c = {**ok, **change}
        err = attn._decode_fn()(
            q.data_ptr(), q.stride(0), q.stride(1), cache["k"].data_ptr(),
            cache["v"].data_ptr(), cache["k_scale"].data_ptr(),
            cache["v_scale"].data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
            out.stride(0), out.stride(1), ws.data_ptr(), c["ws_floats"],
            tickets.data_ptr(), c["ntickets"], 0, 1, B, Hq, Hkv, C, hd,
            hd ** -0.5, c["splits"], c["pitch"], c["box"], c["stages"],
            _cuda.stream_ptr(q))
        torch.cuda.synchronize()
        return err

    assert call() == 0
    assert torch.equal(out, attn.decode_attention_q8(
        q, cache["k"], cache["v"], cache["k_scale"], cache["v_scale"],
        kv_lens, 0, sm_scale=hd ** -0.5))
    out.fill_(7.0)
    bad = [dict(splits=32), dict(splits=6),          # the split fold
           dict(stages=9), dict(stages=1),           # barriers, a ring of two
           dict(pitch=256, stages=8),                # shared memory
           dict(pitch=hd + 16),                      # a box off the grid
           dict(box=512),                            # past 256 rows
           dict(ws_floats=plan.ws_floats - 1),       # the workspace
           dict(ntickets=B * Hkv - 1)]
    for change in bad:
        assert call(**change) != 0, change
    assert bool((out == 7.0).all())                  # nothing launched
    assert not tickets.any()


def test_k4_entry_layout_is_the_plan(dev):
    """The C entry derives the same layout from the plan's choices as
    `k4_plan` (which the CPU tests check) gives."""
    import ctypes
    from videoglamm_torch.ops import _cuda
    layout = _cuda.load("decode_attention_q8").lib.vgt_decode_q8_layout
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, Hq, Hkv, hd, C in ((1, 32, 32, 96, 3456), (4, 32, 8, 128, 3456),
                              (2, 4, 4, 16, 40), (1, 16, 4, 80, 777),
                              (2, 8, 2, 112, 999), (2, 8, 4, 96, 160),
                              (1, 2, 2, 64, 3456), (8, 32, 32, 48, 512)):
        plan = attn.k4_plan(B, Hq, Hkv, hd, C, sms)
        got = (ctypes.c_int * len(plan.fields()))()
        assert layout(plan.G, hd, plan.splits, plan.pitch, plan.box,
                      plan.stages, got) == 0
        assert tuple(got) == plan.fields(), (B, Hq, Hkv, hd, C)


def test_k4_refuses_f32_and_unsupported_geometry(dev):
    """q of another dtype than bf16 or f32 (f32 takes K4's f32 route) and
    a GQA group K4 has no instantiation for raise."""
    rng = np.random.default_rng(6)
    cache = _int8_cache(rng, 1, 1, 2, 32, 16, dev)
    kv_lens = torch.tensor([32], dtype=torch.int32, device=dev)
    args = (cache["k"], cache["v"], cache["k_scale"], cache["v_scale"], kv_lens)
    with pytest.raises(ValueError):
        attn.decode_attention_q8(_randn(rng, (1, 2, 1, 16), dev,
                                        dtype=torch.float16), *args,
                                 sm_scale=0.25)
    with pytest.raises(ValueError):      # G = 3
        attn.decode_attention_q8(_randn(rng, (1, 6, 1, 16), dev), *args,
                                 sm_scale=0.25)


# K5: both sides round one f32 sum to bf16 once, in another order, so an
# entry differs by at most one bf16 ulp (max-norm 1e-2 of the output scale)
# and the relative L2 over all entries stays near 2^-9 / sqrt(3); 4e-3 holds
# it to about twice the 1.1e-3 that one flipped rounding in three gives.
K5_TOL_L2 = 4e-3
K5_SHAPES = [(3072, 9216), (8192, 3072), (3072, 32065), (128, 193)]


def _k5_operands(rng, dev, M, K, N, int4):
    x = _randn(rng, (M, K), dev)
    wf = _randn(rng, (N, K), dev, K ** -0.5, torch.float32)
    if int4:
        return x, quant.quantize_int4(wf, 128)
    q, s = quant.quantize_int8(wf)
    return x, (quant.pad_rows8(q), s)


def _k5(x, w, int4):
    if int4:
        return quant.dequant_gemv_int4(x, *w, 128)
    return quant.dequant_gemv_int8(x, *w)


def _k5_plain(x, w, int4):
    if int4:
        return quant._dequant4_matmul_plain(x, *w, 128)
    return quant._dequant_matmul_plain(x, *w)


@pytest.mark.parametrize("M", [1, 2, 3, 4, 8, 9, 64, 255])
@pytest.mark.parametrize("K,N", K5_SHAPES)
def test_k5_int8_gemv_matches_plain(dev, M, K, N):
    rng = np.random.default_rng(7)
    x = _randn(rng, (M, K), dev)
    q, s = quant.quantize_int8(_randn(rng, (N, K), dev, K ** -0.5,
                                      torch.float32))
    wq = quant.pad_rows8(q)
    before = quant.LAUNCHES["int8"]
    got = quant.dequant_matmul(x[None], wq, s)[0]
    assert quant.LAUNCHES["int8"] == before + 1
    ref = quant._dequant_matmul_plain(x, wq, s)
    torch.cuda.synchronize()
    _close(got, ref, 1e-2, f"int8 gemv M={M} K={K} N={N}")
    _close_l2(got, ref, K5_TOL_L2, f"int8 gemv M={M} K={K} N={N}")


@pytest.mark.parametrize("M", [1, 3, 4, 8, 64])
@pytest.mark.parametrize("K,N", K5_SHAPES)
def test_k5_int4_gemv_matches_plain(dev, M, K, N):
    rng = np.random.default_rng(8)
    x = _randn(rng, (M, K), dev)
    p, s = quant.quantize_int4(_randn(rng, (N, K), dev, K ** -0.5,
                                      torch.float32), 128)
    before = quant.LAUNCHES["int4"]
    got = quant.dequant4_matmul(x, p, s, 128)
    assert quant.LAUNCHES["int4"] == before + 1
    ref = quant._dequant4_matmul_plain(x, p, s, 128)
    torch.cuda.synchronize()
    _close(got, ref, 1e-2, f"int4 gemv M={M} K={K} N={N}")
    _close_l2(got, ref, K5_TOL_L2, f"int4 gemv M={M} K={K} N={N}")


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("M", [1, 8])
def test_k5_strided_x_and_two_calls_bit_equal(dev, int4, M):
    """x rows further apart than K (a slice of a wider tensor); two calls
    give the same bits (no atomics, a fixed-order combine of the warps)."""
    rng = np.random.default_rng(10)
    K, N = 3072, 9216
    _, w = _k5_operands(rng, dev, M, K, N, int4)
    x = _randn(rng, (M, K + 256), dev)[:, 128:128 + K]
    assert x.stride(0) == K + 256
    got, again = _k5(x, w, int4), _k5(x, w, int4)
    ref = _k5_plain(x, w, int4)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, ref, 1e-2, "strided x")
    _close_l2(got, ref, K5_TOL_L2, "strided x")


@pytest.mark.parametrize("int4", [False, True])
def test_k5_captures_into_a_cuda_graph(dev, int4):
    rng = np.random.default_rng(13)
    x, w = _k5_operands(rng, dev, 4, 3072, 3072, int4)
    x1 = x[:1].clone()                  # one row: the CUDA-core route
    want, want1 = _k5(x, w, int4), _k5(x[-1:].clone(), w, int4)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, y1 = _k5(x, w, int4), _k5(x1, w, int4)
    x.copy_(x.flip(0))
    x1.copy_(x[:1])
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, want.flip(0)) and torch.equal(y1, want1)


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("M", [1, 8])
def test_k5_entry_refuses_a_plan_its_kernels_do_not_fit(dev, int4, M):
    """The C entry holds every region of shared memory in the plan against
    the constants of the kernel that uses it, so a constant changed on one
    side only raises instead of writing past its region."""
    import dataclasses
    rng = np.random.default_rng(14)
    K, N = 3072, 9216
    x, w = _k5_operands(rng, dev, M, K, N, int4)
    kind, group = ("int4", 128) if int4 else ("int8", 0)
    plan = quant.k5_plan(M, N, K, group, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    got = quant._launch_gemv(kind, x, w[0], w[1], N, group, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, _k5(x, w, int4))
    if plan.mma:
        bad = [dict(ring_off=-(-(plan.red_off + 1024) // 128) * 128),  # warps' sums
               dict(red_off=plan.s_off + 16),            # the CTA's scales
               dict(s_off=plan.x_off + 7 * plan.xstride),  # 8 rows of x
               dict(per_sm=2)]
    else:
        bad = [dict(xstride=plan.xstride - 16),          # x's rows
               dict(smem=plan.s_off + 16),               # the units' sums
               dict(per_sm=3 - plan.per_sm),             # launch bounds
               dict(smem=116 * 1024)]                    # CTAs an SM side by side
    before = quant.LAUNCHES[kind]
    for change in bad:
        with pytest.raises(RuntimeError, match="CUDA error"):
            quant._launch_gemv(kind, x, w[0], w[1], N, group,
                               dataclasses.replace(plan, **change))
    assert quant.LAUNCHES[kind] == before


def test_k5_routing_and_refusals(dev):
    """Large M leaves K5: W8A8 through the s8 x s8 product (N padded to 8)
    and int4 through dequantise-then-matmul; fp16 operands raise (f32 ones
    take K5's f32 entries)."""
    rng = np.random.default_rng(9)
    K, N = 256, 193
    q, s = quant.quantize_int8(_randn(rng, (N, K), dev, K ** -0.5,
                                      torch.float32))
    wq = quant.pad_rows8(q)
    x = _randn(rng, (300, K), dev)
    before = dict(quant.LAUNCHES)
    y = quant.dequant_matmul(x, wq, s)
    ref = quant._dequant_matmul_plain(x, wq, s)
    p4, s4 = quant.quantize_int4(_randn(rng, (N, K), dev, K ** -0.5,
                                        torch.float32), 128)
    y4 = quant.dequant4_matmul(x, p4, s4, 128)
    ref4 = quant._dequant4_matmul_plain(x, p4, s4, 128)
    torch.cuda.synchronize()
    assert dict(quant.LAUNCHES) == before
    # activation quantisation: each of K terms is off by at most half a code
    _close(y, ref, 3e-2, "w8a8")
    _close(y4, ref4, 2e-2, "int4 large M")
    with pytest.raises(ValueError):
        quant.dequant_matmul(x[:2].half(), wq, s)
    with pytest.raises(ValueError):
        quant.dequant4_matmul(x[:2].half(), p4, s4, 128)


def _rel_l2(got, ref):
    return ((got.float() - ref.float()).norm()
            / ref.float().norm().clamp_min(1e-12)).item()


@pytest.mark.parametrize("B,H,Sq,Sk,D,kv,qs,causal", [
    (2, 2, 200, 320, 64, (320, 260), (0, 0), True),     # prefill q_start
    (2, 2, 200, 320, 64, (320, 260), None, True),       # decode convention
    (2, 2, 200, 320, 64, (320, 260), None, False),
    (2, 4, 300, 300, 96, (300, 211), (0, 0), True),     # Phi-3 head dim
    (1, 2, 130, 130, 80, (100,), (0,), True),           # zero-padded head dim
    (1, 2, 96, 200, 128, (200,), (-40,), True),         # rows with no valid key
    (2, 2, 200, 200, 72, (200, 150), (0, 0), True),     # D 72 padded to 80
    (2, 2, 200, 320, 88, (320, 260), None, False),      # D 88 padded to 96
    # several 128-row CTAs and 64-row ring tiles, Sq != Sk, two kv_lens
    # inside tiles, q_start per batch row (one negative)
    (2, 3, 450, 700, 96, (700, 517), (250, -30), True),
    (2, 2, 333, 270, 64, (270, 199), None, False),
    (1, 2, 150, 150, 32, (150,), (0,), True),           # D 32: one 64-column box
    (2, 2, 130, 200, 64, (0, 177), (0, 0), False),      # a batch row with no key
])
def test_k6_flash_backward_matches_plain(dev, B, H, Sq, Sk, D, kv, qs, causal):
    """K1's LSE output and K6's dq, dk, dv against the plain twins on the same
    bf16 inputs. Tolerance: relative L2 1e-2; kernel and twin round p and ds
    to bf16 at the same place and sum in f32 in another order, so single
    entries differ by one bf16 ulp (2^-8) and the L2 norm by far less."""
    rng = np.random.default_rng(10)
    q, k, v = (_randn(rng, (B, H, s, D), dev).requires_grad_(True)
               for s in (Sq, Sk, Sk))
    g = _randn(rng, (B, Sq, H, D), dev).transpose(1, 2)   # a strided gradient
    kv_lens = torch.tensor(kv, dtype=torch.int32, device=dev)
    q_start = kv_lens - Sq if qs is None else \
        torch.tensor(qs, dtype=torch.int32, device=dev)
    scale = D ** -0.5
    attn.LAUNCHES.clear()
    out = attn.flash_attention(q, k, v, causal=causal, kv_lens=kv_lens,
                               q_start=None if qs is None else q_start)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    assert attn.LAUNCHES["flash_bwd"] == 1
    assert attn.LAUNCHES["causal" if causal else "flash"] == 1
    with torch.no_grad():
        ref_out, ref_lse = attn._flash_fwd_plain(q, k, v, kv_lens, q_start,
                                                 causal, scale)
        lse = torch.empty(B, H, Sq, dtype=torch.float32, device=dev)
        out2 = torch.empty_like(out)
        attn.attention_fwd_kernel(q, k, v, out2, causal=causal, sm_scale=scale,
                                  mode="causal" if causal else "flash",
                                  kv_lens=kv_lens, q_start=q_start, lse=lse)
        assert torch.equal(out2, out.detach())
        _close(out, ref_out, 2e-2, "out")
        live = ref_lse > -1e29
        assert torch.equal(lse > -1e29, live)
        assert (lse[~live] == -1e30).all()
        assert (lse[live] - ref_lse[live]).abs().max().item() <= 2e-2
        want = attn._flash_bwd_plain(q, k, v, out, lse, g, kv_lens, q_start,
                                     causal, scale)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert torch.isfinite(got).all(), name
        rel = _rel_l2(got, ref)
        assert rel <= 1e-2, f"{name}: rel L2 {rel:.3e}"
    if not live.all():
        assert (dq.transpose(1, 2)[(~live).transpose(1, 2)] == 0).all()


def _k6_inputs(rng, dev, B, H, Sq, Sk, D, kv, qs, causal):
    """bf16 q, k, v, a strided gradient, kv_lens, q_start, and K1's output
    and LSE for them."""
    q, k, v = (_randn(rng, (B, H, s, D), dev) for s in (Sq, Sk, Sk))
    g = _randn(rng, (B, Sq, H, D), dev).transpose(1, 2)
    kv_lens = torch.tensor(kv, dtype=torch.int32, device=dev)
    q_start = torch.tensor(qs, dtype=torch.int32, device=dev)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=dev)
    attn.attention_fwd_kernel(q, k, v, out, causal=causal, sm_scale=D ** -0.5,
                              mode="causal" if causal else "flash",
                              kv_lens=kv_lens, q_start=q_start, lse=lse)
    return q, k, v, g, kv_lens, q_start, out, lse


@pytest.mark.parametrize("D,causal", [(64, True), (96, True), (128, False)])
def test_k6_nan_slack_gives_exact_zeros(dev, D, causal):
    """Keys in [kv_len, Sk) are real memory and may hold NaN (a cache's
    slack): dq stays finite and equal to the twin on clean inputs, dk and dv
    are exactly 0 on those rows, and rows with no valid key (q_start < 0)
    get an exact 0 in dq."""
    rng = np.random.default_rng(20 + D)
    B, H, Sq, Sk = 2, 2, 260, 400
    kv, qs = (400, 301), (-35, 100)
    q, k, v, g, kv_lens, q_start, out, lse = _k6_inputs(
        rng, dev, B, H, Sq, Sk, D, kv, qs, causal)
    clean_k, clean_v = k.clone(), v.clone()
    for b, n in enumerate(kv):
        k[b, :, n:] = float("nan")
        v[b, :, n:] = float("nan")
        clean_k[b, :, n:] = 0
        clean_v[b, :, n:] = 0
    dq, dk, dv = attn.flash_bwd_kernel(q, k, v, out, lse, g, causal=causal,
                                       sm_scale=D ** -0.5, kv_lens=kv_lens,
                                       q_start=q_start)
    want = attn._flash_bwd_plain(q, clean_k, clean_v, out, lse, g, kv_lens,
                                 q_start, causal, D ** -0.5)
    torch.cuda.synchronize()
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert torch.isfinite(got).all(), name
        rel = _rel_l2(got, ref)
        assert rel <= 1e-2, f"{name}: rel L2 {rel:.3e}"
    for b, n in enumerate(kv):
        assert (dk[b, :, n:] == 0).all() and (dv[b, :, n:] == 0).all()
    if causal:
        assert (dq[0, :, :35] == 0).all() and (dq[0, :, 35:] != 0).any()


@pytest.mark.parametrize("causal", [True, False])
def test_k6_two_calls_are_bit_equal(dev, causal):
    """No atomics: the same inputs give the same dq, dk, dv bit for bit."""
    rng = np.random.default_rng(30)
    args = _k6_inputs(rng, dev, 2, 4, 390, 390, 96, (390, 277), (0, 0), causal)
    q, k, v, g, kv_lens, q_start, out, lse = args
    first = attn.flash_bwd_kernel(q, k, v, out, lse, g, causal=causal,
                                  sm_scale=96 ** -0.5, kv_lens=kv_lens,
                                  q_start=q_start)
    again = attn.flash_bwd_kernel(q, k, v, out, lse, g, causal=causal,
                                  sm_scale=96 ** -0.5, kv_lens=kv_lens,
                                  q_start=q_start)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_k1_d256_f32_and_k7_two_calls_are_bit_equal(dev):
    """No atomics and a fixed order: K1 at head dim 256 on f32 storage (the
    staging pass and the body) and K7 give the same bits twice."""
    rng = np.random.default_rng(31)
    q, k, v = (_randn(rng, (4, 1, 1024, 256), dev, dtype=torch.float32)
               for _ in range(3))
    first = attn.flash_attention(q, k, v)
    again = attn.flash_attention(q, k, v)
    w1 = attn.window_attention_kernel(q, k, v, sm_scale=256 ** -0.5)
    w2 = attn.window_attention_kernel(q, k, v, sm_scale=256 ** -0.5)
    qb, kb, vb = (_randn(rng, (2, 16, 1025, 88), dev) for _ in range(3))
    b1 = attn.window_attention_kernel(qb, kb, vb, sm_scale=88 ** -0.5)
    b2 = attn.window_attention_kernel(qb, kb, vb, sm_scale=88 ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert torch.equal(w1, w2) and torch.equal(b1, b2)


def test_k1_f32_d256_nan_slack_is_finite(dev):
    """The f32 route at head dim 256 with NaN in the K/V slack past kv_len
    (staged to bf16 NaN): finite outputs equal to the twin on clean
    operands, zeros and -1e30 on rows with no valid key; the LSE equals
    the twin's on the staged (bf16-rounded) operands, whose logits the
    kernel sums."""
    rng = np.random.default_rng(32)
    B, H, Sq, Sk, D = 2, 1, 300, 400, 256
    kv, qs = (400, 333), (-40, 33)
    q, k, v = (_randn(rng, (B, H, s, D), dev, dtype=torch.float32)
               for s in (Sq, Sk, Sk))
    kv_lens = torch.tensor(kv, dtype=torch.int32, device=dev)
    q_start = torch.tensor(qs, dtype=torch.int32, device=dev)
    clean_k, clean_v = k.clone(), v.clone()
    for b, n in enumerate(kv):
        k[b, :, n:] = float("nan")
        v[b, :, n:] = float("nan")
        clean_k[b, :, n:] = 0
        clean_v[b, :, n:] = 0
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=dev)
    attn.attention_fwd_kernel(q, k, v, out, causal=True, sm_scale=D ** -0.5,
                              mode="causal", kv_lens=kv_lens, q_start=q_start,
                              lse=lse)
    ref, _ = attn._flash_fwd_plain(q, clean_k, clean_v, kv_lens, q_start,
                                   True, D ** -0.5)
    _, ref_lse = attn._flash_fwd_plain(
        *(t.to(torch.bfloat16).float() for t in (q, clean_k, clean_v)),
        kv_lens, q_start, True, D ** -0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert torch.all(out[0, :, :40] == 0)
    assert torch.all(lse[0, :, :40] == attn.NEG_INF)
    _close_l2(out[1], ref[1], 1e-2, "f32 d256 causal")
    live = ref_lse > -1e29
    assert (lse[live] - ref_lse[live]).abs().max().item() <= 1e-3


def test_tma_kernels_launch_from_a_fresh_thread(dev):
    """K1 (both ways in: bf16, and f32 through the staging pass), K7, K2
    and K6 encode tensor maps against the current context. A fresh host
    thread (the autograd engine runs a backward, and a remat recompute, on
    one) has none bound while its tensors come from the caching allocator;
    the entries bind the operands' device."""
    import threading
    rng = np.random.default_rng(40)
    q, k, v, g, kv_lens, q_start, out, lse = _k6_inputs(
        rng, dev, 1, 2, 200, 200, 64, (200,), (0,), True)
    a = _randn(rng, (256, 144), dev)
    w = _randn(rng, (144, 144), dev, 0.1)
    m = _randn(rng, (2, 1, 600, 256), dev, dtype=torch.float32)
    out2 = torch.empty_like(out)
    torch.empty(64 << 20, device=dev)   # freed at once: later allocations come from the cache
    got = {}

    def work():
        try:
            attn.attention_fwd_kernel(q, k, v, out2, causal=True,
                                      sm_scale=64 ** -0.5, mode="causal",
                                      kv_lens=kv_lens, q_start=q_start)
            got["k6"] = attn.flash_bwd_kernel(q, k, v, out, lse, g, causal=True,
                                              sm_scale=64 ** -0.5,
                                              kv_lens=kv_lens, q_start=q_start)
            got["k2"] = fb.gemm_epilogue(a, w, None)
            got["k1_f32"] = attn.flash_attention(m, m, m)
            got["k7"] = attn.window_attention_kernel(m, m, m, sm_scale=1 / 16)
            torch.cuda.synchronize()
        except Exception as e:   # handed to the test's thread
            got["error"] = e

    th = threading.Thread(target=work)
    th.start()
    th.join(timeout=120)
    assert not th.is_alive()
    assert "error" not in got, got.get("error")
    assert torch.equal(out2, out)
    want = attn._flash_bwd_plain(q, k, v, out, lse, g, kv_lens, q_start, True,
                                 64 ** -0.5)
    for name, x, ref in zip(("dq", "dk", "dv"), got["k6"], want):
        assert _rel_l2(x, ref) <= 1e-2, name
    _close(got["k2"], fb._gemm_plain(a, w, None), 2e-2, "K2 on a fresh thread")
    ref_m = attn._window_attention_plain(m, m, m, 1 / 16)
    _close_l2(got["k1_f32"], ref_m, 1e-2, "K1 f32 on a fresh thread")
    _close_l2(got["k7"], ref_m, 1e-2, "K7 on a fresh thread")


def test_bshd_backward_recomputes_through_the_plain_twin(dev):
    """K1 in BSHD mode under a gradient: the forward is the kernel, the
    backward autograd through the twin on the saved inputs."""
    rng = np.random.default_rng(11)
    q, k, v = (_randn(rng, (2, 577, 4, 64), dev).requires_grad_(True)
               for _ in range(3))
    g = _randn(rng, (2, 577, 4, 64), dev)
    attn.LAUNCHES.clear()
    out = attn.attention_bshd(q, k, v)
    assert attn.LAUNCHES["bshd"] == 1
    got = torch.autograd.grad(out, (q, k, v), g)
    ref = attn._attention_plain_bshd(q, k, v, 64 ** -0.5)
    want = torch.autograd.grad(ref, (q, k, v), g)
    torch.cuda.synchronize()
    _close(out, ref, 2e-2, "bshd forward")
    for a, b in zip(got, want):
        assert torch.equal(a, b)      # the same plain backward on both sides


@pytest.mark.parametrize("rms,bias", [(True, False), (False, True)])
def test_k3_backward_recomputes_through_the_plain_twin(dev, rms, bias):
    rng = np.random.default_rng(12)
    x = _randn(rng, (600, 3072), dev).requires_grad_(True)
    w = _randn(rng, (3072,), dev, 0.1, torch.float32).add_(1).requires_grad_(True)
    b = _randn(rng, (3072,), dev, 0.1, torch.float32).requires_grad_(True) \
        if bias else None
    g = _randn(rng, (600, 3072), dev)
    norms.LAUNCHES.clear()
    y = norms.rms_norm(x, w, 1e-5) if rms else norms.layer_norm(x, w, b, 1e-5)
    assert norms.LAUNCHES["rms" if rms else "ln"] == 1
    ins = [x, w] + ([b] if bias else [])
    got = torch.autograd.grad(y, ins, g)
    ref = norms._rms_norm_plain(x, w, 1e-5) if rms else \
        norms._layer_norm_plain(x, w, b, 1e-5)
    want = torch.autograd.grad(ref, ins, g)
    torch.cuda.synchronize()
    _close(y, ref, 1e-2, "forward")
    for a, r in zip(got, want):
        assert a.dtype == r.dtype
        _close(a, r, 1e-5, "gradient")   # the same f32 twin, atomics aside


# ---------------------------------------------------------------------------
# K7 (whole-row-softmax window attention), K8 (tiny-window attention) and
# K1 at head dim 256 / f32 storage. Tolerance 2e-2 of the output scale: f32
# operands are rounded to bf16 by the staging pass and p is rounded to bf16
# before p v, so against the twin (f32 products of the same operands, p
# rounded at the same place for bf16 operands) entries differ by a few bf16
# ulps (2^-8).
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,H,S,D,dtype", [
    (4, 1, 1024, 256, torch.float32),       # memory self-attention, 32x32 grid
    (2, 16, 1025, 88, torch.bfloat16),      # InternVideo2
    (2, 16, 577, 64, torch.bfloat16),       # CLIP
    (2, 3, 256, 72, torch.float32),         # the JAX test's shapes
    (1, 2, 577, 64, torch.float32),
    (1, 1, 130, 88, torch.bfloat16),
    (1, 2, 1536, 96, torch.bfloat16),
    (1, 2, 700, 128, torch.bfloat16),
    (3, 1, 520, 256, torch.bfloat16),
])
def test_k7_window_attention_matches_plain(dev, B, H, S, D, dtype):
    rng = np.random.default_rng(20)
    q, k, v = (_randn(rng, (B, H, S, D), dev, dtype=dtype) for _ in range(3))
    before = attn.LAUNCHES["window_attn"]
    got = attn.window_attention_kernel(q, k, v, sm_scale=D ** -0.5)
    assert attn.LAUNCHES["window_attn"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    ref = attn._window_attention_plain(q, k, v, D ** -0.5)
    torch.cuda.synchronize()
    _close(got, ref, 2e-2, f"window S={S} D={D}")
    # bf16 operands: the kernel rounds where the twin rounds (1.3e-4
    # measured); f32 operands are rounded to bf16 on the way in (3.4e-3)
    _close_l2(got, ref, 1e-2 if dtype == torch.float32 else 1e-3,
              f"window S={S} D={D}")


def test_k7_is_the_medium_branch_of_the_dispatcher(dev):
    """Non-causal self-attention with 512 < S <= 1536 launches K7, through
    strided [B,S,H,D] views too; under a gradient the backward recomputes
    through the plain twin."""
    rng = np.random.default_rng(21)
    x = _randn(rng, (2, 640, 3, 4, 64), dev)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    attn.LAUNCHES.clear()
    got = attn.dot_product_attention(q, k, v)
    assert attn.LAUNCHES["window_attn"] == 1 and attn.LAUNCHES["flash"] == 0
    ref = attn._window_attention_plain(q, k, v, 64 ** -0.5)
    _close(got, ref, 2e-2, "dispatcher")
    _close_l2(got, ref, 1e-3, "dispatcher")
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    g = _randn(rng, tuple(got.shape), dev)
    out = attn.dot_product_attention(qg, kg, vg)
    assert attn.LAUNCHES["window_attn"] == 2
    grads = torch.autograd.grad(out, (qg, kg, vg), g)
    want = torch.autograd.grad(
        attn._window_attention_plain(qg, kg, vg, 64 ** -0.5), (qg, kg, vg), g)
    torch.cuda.synchronize()
    for a, b in zip(grads, want):
        assert torch.equal(a, b)      # the same plain backward on both sides


@pytest.mark.parametrize("NW,S,H,hd", [
    (1024, 64, 2, 72), (1024, 16, 4, 72),     # Hiera stages 1 and 2
    (16, 64, 2, 72), (32, 16, 4, 72), (8, 64, 16, 72), (6, 64, 2, 40),
    (24, 16, 1, 88), (3, 64, 2, 72), (7, 16, 4, 72), (5, 32, 3, 128),
    (9, 32, 2, 32),
])
def test_k8_smallwin_attention_matches_plain(dev, NW, S, H, hd):
    rng = np.random.default_rng(22)
    qkv = _randn(rng, (NW, S, 3 * H * hd), dev)
    before = attn.LAUNCHES["smallwin"]
    got = attn.attention_packed_qkv_smallwin(qkv, H, hd)
    assert attn.LAUNCHES["smallwin"] == before + 1
    ref = attn._smallwin_plain(qkv, H, hd ** -0.5)
    torch.cuda.synchronize()
    _close(got, ref, 2e-2, f"smallwin NW={NW} S={S} H={H} hd={hd}")
    _close_l2(got, ref, 1e-3, f"smallwin NW={NW} S={S} H={H} hd={hd}")


def test_k8_backward_recomputes_through_the_plain_twin(dev):
    rng = np.random.default_rng(23)
    qkv = _randn(rng, (4, 64, 3 * 2 * 72), dev).requires_grad_(True)
    g = _randn(rng, (4, 64, 2 * 72), dev)
    out = attn.attention_packed_qkv_smallwin(qkv, 2, 72)
    (got,) = torch.autograd.grad(out, qkv, g)
    (want,) = torch.autograd.grad(attn._smallwin_plain(qkv, 2, 72 ** -0.5), qkv, g)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("B,H,Sq,Sk,D,dtype,causal", [
    (2, 1, 2048, 2048, 256, torch.float32, False),   # memory self-attention
    (1, 2, 1100, 1100, 256, torch.bfloat16, False),
    (1, 1, 300, 500, 200, torch.bfloat16, True),     # padded to 256
    (2, 4, 300, 300, 96, torch.float32, True),       # f32 at a narrow head
    (1, 2, 2100, 2100, 72, torch.float32, False),
])
def test_k1_head_dim_256_and_f32_match_plain(dev, B, H, Sq, Sk, D, dtype, causal):
    rng = np.random.default_rng(24)
    q, k, v = (_randn(rng, (B, H, s, D), dev, dtype=dtype) for s in (Sq, Sk, Sk))
    attn.LAUNCHES.clear()
    got = attn.flash_attention(q, k, v, causal=causal)
    mode = "causal" if causal else ("flash_d256" if D > 128 else "flash")
    assert attn.LAUNCHES[mode] == 1
    assert got.dtype == dtype
    kvl = torch.full((B,), Sk, dtype=torch.int32, device=dev)
    ref = attn._attention_plain(q, k, v, causal=causal, sm_scale=D ** -0.5,
                                kv_lens=kvl, q_start=kvl - Sq)
    torch.cuda.synchronize()
    _close(got, ref, 2e-2, f"K1 D={D} {dtype}")
    _close_l2(got, ref, 1e-2, f"K1 D={D} {dtype}")


def test_k1_k7_k8_refuse_unsupported_operands(dev):
    rng = np.random.default_rng(25)
    q = _randn(rng, (1, 1, 600, 264), dev)
    with pytest.raises(ValueError):                 # D > 256
        attn.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        attn.window_attention_kernel(q, q, q, sm_scale=1.0)
    h = _randn(rng, (1, 1, 600, 64), dev, dtype=torch.float16)
    with pytest.raises(ValueError):                 # fp16
        attn.window_attention_kernel(h, h, h, sm_scale=1.0)
    with pytest.raises(ValueError):                 # mixed dtypes
        attn.flash_attention(q[..., :64].contiguous().float(),
                             q[..., :64].contiguous(), q[..., :64].contiguous())
    long = _randn(rng, (1, 1, 1600, 64), dev)
    with pytest.raises(ValueError):                 # S > 1536
        attn.window_attention_kernel(long, long, long, sm_scale=1.0)
    x = _randn(rng, (4, 24, 3 * 2 * 72), dev)
    with pytest.raises(ValueError):                 # 24-token windows
        attn.attention_packed_qkv_smallwin(x, 2, 72)
    with pytest.raises(ValueError):                 # f32 qkv
        attn.attention_packed_qkv_smallwin(
            _randn(rng, (4, 16, 3 * 2 * 72), dev, dtype=torch.float32), 2, 72)
    with pytest.raises(ValueError):                 # head dim 136
        attn.attention_packed_qkv_smallwin(
            _randn(rng, (4, 16, 3 * 136), dev), 1, 136)


@pytest.mark.parametrize("image_size,counter", [(512, "window_attn"),
                                                (1024, "flash_d256")])
def test_narrow_tracker_on_the_card_matches_cpu(dev, image_size, counter):
    """The tracker's memory path on the card against the CPU twins in f32:
    a narrow Hiera under full-width memory modules (d_model 256, one
    memory-attention layer), two objects, the conditioning frame and one
    memory-conditioned step on the reference's bank. Both sides get the
    reference's f32 image features, so the card runs the f32 memory
    attention through K7 (32x32 grid) or K1 at head dim 256 (64x64 grid),
    whose operands are rounded to bf16: 2e-2 of the output scale on every
    mask candidate, IoU, object score and the conditioned features."""
    from videoglamm_torch.config import HieraConfig, SAM2Config
    from videoglamm_torch.models.common import LayerNorm
    from videoglamm_torch.models.sam2 import video_predictor as vp
    from videoglamm_torch.models.sam2.sam2_base import SAM2Base

    cfg = SAM2Config(hiera=HieraConfig(embed_dim=16, num_heads=1,
                                       stages=(1, 1, 1, 1),
                                       global_att_blocks=(2,)),
                     image_size=image_size, memory_attention_layers=1)
    g = torch.Generator().manual_seed(30)
    ref = SAM2Base(cfg).eval()
    with torch.no_grad():
        norms_ = {id(p) for m in ref.modules() if isinstance(m, LayerNorm)
                  for p in m.parameters()}
        for p in ref.parameters():
            if id(p) not in norms_:
                p.normal_(0.0, 0.05, generator=g)
        # the object-score gate decided by a margin far above the rounding
        ref.sam_mask_decoder.pred_obj_score_head.layers[-1].bias.fill_(2.0)
    card = SAM2Base(cfg).eval()
    card.load_state_dict(ref.state_dict())
    card.to(dev)
    T, B = 2, 2
    frames = torch.randn(T, image_size, image_size, 3, generator=g)
    text = torch.randn(B, 1, cfg.d_model, generator=g)

    def per_obj(feats, t, device):
        return [f[t][None].expand(B, *f.shape[1:]).to(device) for f in feats]

    with torch.no_grad():
        feats, pos = ref.forward_image(frames)
        heads0, bank = vp.track_init_frame(ref, per_obj(feats, 0, "cpu"),
                                           pos[-1], text)
        cheads0, _ = vp.track_init_frame(card, per_obj(feats, 0, dev),
                                         pos[-1].to(dev), text.to(dev))
        cbank = vp.MemoryBank(*(x.clone().to(dev) for x in bank))
        memory, mem_pos, kv_mask, n_ptr = vp.assemble_memory(ref, bank, 1, T)
        want_cond = ref.condition_features(
            per_obj(feats, 1, "cpu")[-1], pos[-1].expand(B, *pos[-1].shape),
            memory, mem_pos, n_ptr, kv_mask)
        attn.LAUNCHES.clear()
        got_cond = card.condition_features(
            per_obj(feats, 1, dev)[-1], pos[-1].to(dev).expand(B, *pos[-1].shape),
            memory.to(dev), mem_pos.to(dev), n_ptr, kv_mask.to(dev))
        assert attn.LAUNCHES[counter] == 1
        heads1, _ = vp.track_step(ref, per_obj(feats, 1, "cpu"), pos[-1], bank,
                                  1, T)
        cheads1, _ = vp.track_step(card, per_obj(feats, 1, dev), pos[-1].to(dev),
                                   cbank, 1, T)
    torch.cuda.synchronize()
    _close(got_cond.cpu(), want_cond, 2e-2, "conditioned features")
    _close_l2(got_cond.cpu(), want_cond, 2e-2, "conditioned features")
    for t, (c, r) in enumerate(((cheads0, heads0), (cheads1, heads1))):
        for name in ("low_res_multimasks", "ious", "object_score_logits"):
            _close(getattr(c, name).cpu(), getattr(r, name), 2e-2,
                   f"frame {t} {name}")
            _close_l2(getattr(c, name).cpu(), getattr(r, name), 2e-2,
                      f"frame {t} {name}")
    assert attn.LAUNCHES[counter] == 2


# ---------------------------------------------------------------------------
# K9 (csrc/decode_fused.cu) and flash_attention_bshd
# ---------------------------------------------------------------------------
def _decode_layer_weights(rng, dev, K, I, N):
    def q8(rows, cols):
        return torch.as_tensor(rng.integers(-127, 128, (rows, cols)),
                               dtype=torch.int8).to(dev)

    def scales(n, fan):
        return torch.as_tensor((0.5 + rng.random(n)) / (73.0 * fan ** 0.5),
                               dtype=torch.float32).to(dev)

    return dict(nw=torch.as_tensor(1 + 0.1 * rng.standard_normal(K),
                                   dtype=torch.float32).to(dev),
                w=q8(N + (-N % 8), K), s=scales(N, K),
                wgu=q8(2 * I, K), sgu=scales(2 * I, K),
                wd=q8(K, I), sd=scales(K, I))


K9_SHAPES = [(3072, 8192, 9216), (256, 1536, 1000), (4096, 14336, 6144)]


@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("K,I,N", K9_SHAPES)
def test_k9_bf16_entries_match_plain(dev, M, K, I, N):
    """norm_matmul, matmul_residual and mlp at the Phi-3 widths, at a narrow
    case whose N and I are no multiples of 1024, and at the Llama widths
    (where h takes two passes through shared memory from 4 rows on): the
    CUDA-core route (1 to 3 rows) and the tensor-core route (4 to 8)."""
    rng = np.random.default_rng(90 + M)
    p = _decode_layer_weights(rng, dev, K, I, N)
    x = _randn(rng, (M, K), dev)
    res = _randn(rng, (M, N), dev)
    before = dict(dm.LAUNCHES)
    got = dm.fused_norm_matmul_int8(x, p["nw"], p["w"], p["s"], 1e-5)
    _close(got, dm._norm_matmul_plain(x, p["nw"], p["w"], p["s"], 1e-5), 1e-2,
           "norm_matmul")
    got = dm.matmul_residual_int8(x, p["w"], p["s"], res)
    _close(got, dm._matmul_residual_plain(x, p["w"], p["s"], res), 1e-2,
           "matmul_residual")
    got = dm.fused_decode_mlp_int8(x, p["nw"], p["wgu"], p["sgu"], p["wd"],
                                   p["sd"], 1e-5)
    ref = dm._mlp_plain(x, p["nw"], p["wgu"], p["sgu"], p["wd"], p["sd"], 1e-5)
    torch.cuda.synchronize()
    _close(got, ref, 2e-2, "mlp")
    _close_l2(got, ref, 1e-2, "mlp")
    for name in ("norm_matmul", "matmul_residual", "mlp"):
        assert dm.LAUNCHES[name] == before.get(name, 0) + 1


@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("K,I,group", [(3072, 8192, 1024), (256, 1536, 512),
                                       (256, 768, 1024), (4096, 14336, 1024)])
def test_k9_w8a8_integers_equal(dev, M, K, I, group):
    """The W8A8 entry's s32 sums are exact: on the kernel's own codes they
    equal an integer product; the codes equal the twin's but where an f32
    value that differs in its last bits falls across a rounding tie."""
    rng = np.random.default_rng(70 + M)
    p = _decode_layer_weights(rng, dev, K, I, 16)
    x = _randn(rng, (M, K), dev)
    args = (x, p["nw"], p["wgu"], p["sgu"], p["wd"], p["sd"], 1e-5)
    got, tr = dm.mlp_w8a8_kernel(*args, group, trace=True)
    ref, rt = dm._mlp_w8a8_plain(*args, group, trace=True)
    torch.cuda.synchronize()
    g = min(group, I)
    assert torch.equal(tr.gu, dm._int_dot(tr.xq, p["wgu"]))
    for j in range(I // g):
        cols = slice(j * g, (j + 1) * g)
        assert torch.equal(tr.down[j], dm._int_dot(tr.hq[:, cols],
                                                   p["wd"][:, cols]))
    for name, a, b in (("xq", tr.xq, rt.xq), ("hq", tr.hq, rt.hq)):
        d = (a.int() - b.int()).abs()
        assert d.max() <= 1 and (d > 0).float().mean() <= 2e-3, name
    _close(got, ref, 2e-2, "mlp_w8a8")
    _close_l2(got, ref, 1e-2, "mlp_w8a8")
    if torch.equal(tr.xq, rt.xq) and torch.equal(tr.hq, rt.hq):
        assert torch.equal(tr.gu, rt.gu) and torch.equal(tr.down, rt.down)
    # each group's scale is that of its largest |h| (the maximum over the
    # slots of the CTAs covering it): that value's code is 127
    assert (tr.hq.view(M, I // g, g).abs().amax(-1) == 127).all()
    assert torch.allclose(tr.hs, rt.hs, rtol=1e-5, atol=0)


def test_k9_captures_into_a_cuda_graph(dev):
    rng = np.random.default_rng(5)
    p = _decode_layer_weights(rng, dev, 3072, 8192, 3072)
    x = _randn(rng, (4, 3072), dev)

    def layer(x_):
        qkv = dm.fused_norm_matmul_int8(x_, p["nw"], p["w"], p["s"])
        y = dm.matmul_residual_int8(qkv, p["w"], p["s"], x_)
        y = dm.fused_decode_mlp_int8(y, p["nw"], p["wgu"], p["sgu"], p["wd"],
                                     p["sd"])
        return dm.fused_decode_mlp_int8(y, p["nw"], p["wgu"], p["sgu"],
                                        p["wd"], p["sd"], w8a8=True)

    eager = layer(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = layer(x)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def test_k9_refuses_unsupported_operands(dev):
    rng = np.random.default_rng(6)
    p = _decode_layer_weights(rng, dev, 256, 512, 64)
    x = _randn(rng, (9, 256), dev)
    with pytest.raises(ValueError):               # more than 8 rows, launched
        dm.norm_matmul_kernel(x, p["nw"], p["w"], p["s"], 1e-5)
    with pytest.raises(ValueError):               # f32 rows on the card
        dm.fused_decode_mlp_int8(x[:2].float(), p["nw"], p["wgu"], p["sgu"],
                                 p["wd"], p["sd"])
    with pytest.raises(ValueError):               # a group that does not divide I
        dm.fused_decode_mlp_int8(x[:2], p["nw"], p["wgu"], p["sgu"], p["wd"],
                                 p["sd"], w8a8=True, group=384)


@pytest.mark.parametrize("M", [9, 16])
def test_k9_above_8_rows_takes_the_chain(dev, M):
    """More rows than a fused program takes go, as in the JAX entries, to
    the unfused chain: on the card the K3 norm, K5, SiLU times up, K5 and an
    add, counted under those kernels and not under K9, with the chain's
    rounding points; the W8A8 variant runs K9 on tiles of 8 rows."""
    rng = np.random.default_rng(16)
    K, I, N = 3072, 8192, 3072
    p = _decode_layer_weights(rng, dev, K, I, N)
    x = _randn(rng, (M, K), dev)
    res = _randn(rng, (M, N), dev)
    k9, k5, k3 = dict(dm.LAUNCHES), quant.LAUNCHES["int8"], norms.LAUNCHES["rms"]
    got = dm.fused_norm_matmul_int8(x, p["nw"], p["w"], p["s"], 1e-5)
    _close(got, dm._norm_matmul_ref(x, p["nw"], p["w"], p["s"], 1e-5), 1e-2,
           "norm_matmul")
    got = dm.matmul_residual_int8(x, p["w"], p["s"], res)
    _close(got, dm._matmul_residual_ref(x, p["w"], p["s"], res), 1e-2,
           "matmul_residual")
    args = (x, p["nw"], p["wgu"], p["sgu"], p["wd"], p["sd"], 1e-5)
    got = dm.fused_decode_mlp_int8(*args)
    ref = dm._fused_mlp_ref(*args)
    torch.cuda.synchronize()
    _close(got, ref, 2e-2, "mlp")
    _close_l2(got, ref, 1e-2, "mlp")
    assert {e: dm.LAUNCHES[e] - k9.get(e, 0) for e in dm.ENTRIES} == dict.fromkeys(
        dm.ENTRIES, 0)
    assert quant.LAUNCHES["int8"] - k5 == 4 and norms.LAUNCHES["rms"] - k3 == 2
    got = dm.fused_decode_mlp_int8(*args, w8a8=True)
    ref = dm._mlp_w8a8_plain(*args)
    torch.cuda.synchronize()
    _close(got, ref, 2e-2, "mlp_w8a8")
    _close_l2(got, ref, 1e-2, "mlp_w8a8")
    assert dm.LAUNCHES["mlp_w8a8"] - k9.get("mlp_w8a8", 0) == -(-M // 8)


def _k9_calls(p, x, res):
    """The four entries on one set of operands."""
    args = (x, p["nw"], p["wgu"], p["sgu"], p["wd"], p["sd"], 1e-5)
    return {"norm_matmul": lambda: dm.fused_norm_matmul_int8(
                x, p["nw"], p["w"], p["s"], 1e-5),
            "matmul_residual": lambda: dm.matmul_residual_int8(
                x, p["w"], p["s"], res),
            "mlp": lambda: dm.fused_decode_mlp_int8(*args),
            "mlp_w8a8": lambda: dm.fused_decode_mlp_int8(*args, w8a8=True)}


@pytest.mark.parametrize("M", [1, 3, 4, 8])
def test_k9_one_kernel_a_call_and_bit_equal_repeats(dev, M):
    """Each entry is one device kernel a call (the profiler; a window that
    falls short of the launches is taken again, at most three, as the
    profiler now and then drops a record), and repeated calls give the
    same bits: fixed summation orders, exact maxima, no atomics."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(17)
    K, I, N = 3072, 8192, 3072
    p = _decode_layer_weights(rng, dev, K, I, N)
    x = _randn(rng, (M, K), dev)
    res = _randn(rng, (M, N), dev)
    for name, call in _k9_calls(p, x, res).items():
        first = call()
        torch.cuda.synchronize()
        assert all(torch.equal(call(), first) for _ in range(3)), name
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(4):
                    call()
                torch.cuda.synchronize()
            kernels = [(e.key, e.count) for e in prof.key_averages()
                       if (getattr(e, "self_device_time_total", 0)
                           or getattr(e, "self_cuda_time_total", 0))]
            assert all("k9_kernel" in k for k, _ in kernels), (name, kernels)
            if sum(n for _, n in kernels) == 4:
                break
        assert sum(n for _, n in kernels) == 4, (name, kernels)


@pytest.mark.parametrize("entry", ["norm_matmul", "mlp", "mlp_w8a8"])
@pytest.mark.parametrize("M", [1, 8])
def test_k9_entry_refuses_a_plan_that_does_not_fit(dev, entry, M):
    """The C entry holds every region of shared memory in the plan against
    its own constants, so a constant changed on one side only raises
    instead of writing past its region."""
    import dataclasses
    rng = np.random.default_rng(18)
    K, I, N = 3072, 8192, 9216
    p = _decode_layer_weights(rng, dev, K, I, N)
    x = _randn(rng, (M, K), dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n, d = (N, 0) if entry == "norm_matmul" else (I, K)
    plan = dm.k9_plan(entry, M, n, K, d, sms)

    def launch(pl):
        if entry == "norm_matmul":
            return dm.norm_matmul_kernel(x, p["nw"], p["w"], p["s"], 1e-5, plan=pl)
        args = (x, p["nw"], p["wgu"], p["sgu"], p["wd"], p["sd"], 1e-5)
        if entry == "mlp":
            return dm.mlp_kernel(*args, plan=pl)
        return dm.mlp_w8a8_kernel(*args, plan=pl)

    got = launch(plan)
    torch.cuda.synchronize()
    assert torch.equal(got, launch(None))
    bad = [dict(xstride=plan.xstride - 48),               # the rows of x / h
           dict(sc_off=plan.x_off + 16),                   # scales over x
           dict(red_off=plan.sc_off + 16),                 # sums over scales
           dict(smem=plan.ring_off + 16),                  # the ring
           dict(stages=9),                                 # mbarriers
           dict(kseg1=2 * dm.k9_constants()["KSEG"])]      # segment > KSEG
    if entry != "norm_matmul":
        bad.append(dict(segs_pass=plan.nseg2 + 1))
    before = dm.LAUNCHES[entry]
    for change in bad:
        with pytest.raises(RuntimeError, match="CUDA error"):
            launch(dataclasses.replace(plan, **change))
    assert dm.LAUNCHES[entry] == before


@pytest.mark.parametrize("B,Sq,Sk,H,D,kv,qs", [
    (2, 300, 364, 4, 96, (300, 211), (0, 0)), (1, 130, 384, 2, 64, (300,), (170,))])
def test_flash_bshd_matches_plain_and_k1(dev, B, Sq, Sk, H, D, kv, qs):
    rng = np.random.default_rng(8)
    q, k, v = (_randn(rng, (B, s, H, D), dev) for s in (Sq, Sk, Sk))
    kv_lens = torch.tensor(kv, dtype=torch.int32, device=dev)
    q_start = torch.tensor(qs, dtype=torch.int32, device=dev)
    kw = dict(causal=True, sm_scale=D ** -0.5)
    n0 = attn.LAUNCHES["flash_bshd"]
    got = fbshd.flash_attention_bshd(q, k, v, kv_lens, q_start, **kw)
    assert attn.LAUNCHES["flash_bshd"] == n0 + 1 and got.is_contiguous()
    ref = fbshd._flash_bshd_plain(q, k, v, kv_lens, q_start, **kw)
    via_k1 = fbshd.flash_attention_transposed(q, k, v, kv_lens, q_start, **kw)
    torch.cuda.synchronize()
    _close(got, ref, 2e-2, "flash_bshd vs plain")
    _close_l2(got, ref, 1e-2, "flash_bshd vs plain")
    assert torch.equal(got, via_k1)       # the same kernel on the same values


# ---------------------------------------------------------------------------
# K1's wgmma route and K2 (TMA, mbarrier ring, warp specialisation, wgmma)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D", [64, 72, 88, 96, 128, 200, 256])
def test_k1_wgmma_causal_lse_and_nan_slack(dev, D):
    """Causal with q_start and kv_lens, a row with no valid key (q_start <
    0), Sq not a multiple of the 128-row tile, and keys in [kv_len, Sk)
    filled with NaN (a KV cache's slack): the output is finite, equals the
    plain twin on the valid rows and 0 on the empty ones, and the LSE
    equals the twin's (-1e30 on the empty rows)."""
    rng = np.random.default_rng(10 + D)
    B, H, Sq, Sk = 2, 2, 300, 400
    kv, qs = (400, 333), (-40, 33)
    q, k, v = (_randn(rng, (B, H, s, D), dev) for s in (Sq, Sk, Sk))
    kv_lens = torch.tensor(kv, dtype=torch.int32, device=dev)
    q_start = torch.tensor(qs, dtype=torch.int32, device=dev)
    clean_k, clean_v = k.clone(), v.clone()
    for b, n in enumerate(kv):
        k[b, :, n:] = float("nan")
        v[b, :, n:] = float("nan")
        clean_k[b, :, n:] = 0
        clean_v[b, :, n:] = 0
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=dev)
    before = attn.LAUNCHES["route:wgmma"]
    attn.attention_fwd_kernel(q, k, v, out, causal=True, sm_scale=D ** -0.5,
                              mode="causal", kv_lens=kv_lens, q_start=q_start,
                              lse=lse)
    assert attn.LAUNCHES["route:wgmma"] == before + 1
    ref, ref_lse = attn._flash_fwd_plain(q, clean_k, clean_v, kv_lens, q_start,
                                         True, D ** -0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert torch.all(out[0, :, :40] == 0)
    assert torch.all(lse[0, :, :40] == attn.NEG_INF)
    _close(out, ref, 2e-2, f"wgmma causal D={D}")
    _close_l2(out[1], ref[1], 1e-2, f"wgmma causal D={D}")
    live = ref_lse > -1e29
    assert (lse[live] - ref_lse[live]).abs().max().item() <= 1e-3


@pytest.mark.parametrize("S,H", [(16, 4), (64, 2), (256, 8)])
def test_k1_wgmma_windows_match_plain(dev, S, H):
    """The window mode as fused_window_block drives it: S-token windows read
    from a fused qkv, folded by `window_fold` into 128-row query tiles
    (eight 16-token or two 64-token windows a tile, one 256-token window as
    two tiles)."""
    rng = np.random.default_rng(20 + S)
    NW, hd = 32, 72
    fold = fb.window_fold(NW, S)
    assert fold == {16: 8, 64: 2, 256: 1}[S]
    B_, S_ = NW // fold, S * fold
    qkv5 = _randn(rng, (B_, S_, 3, H, hd), dev)
    views = [qkv5[:, :, i] for i in range(3)]
    out = torch.empty(B_, S_, H, hd, dtype=torch.bfloat16, device=dev)
    win = S if fold > 1 else 0
    attn.attention_fwd_kernel(*(t.transpose(1, 2) for t in views),
                              out.transpose(1, 2), causal=False,
                              sm_scale=hd ** -0.5, mode="window", win=win)
    ref = attn._attention_plain_bshd(*views, hd ** -0.5, win)
    torch.cuda.synchronize()
    _close(out, ref, 2e-2, f"window S={S}")
    _close_l2(out, ref, 1e-2, f"window S={S}")


@pytest.mark.parametrize("B,S,H,D,fused", [
    (2, 577, 4, 64, False), (1, 1025, 3, 88, True), (1, 300, 2, 128, False),
    (2, 200, 2, 96, True), (1, 260, 2, 32, False)])
def test_k1_wgmma_bshd_and_fused_strides(dev, B, S, H, D, fused):
    """BSHD views and fused-qkv [B,S,3,H,D] views go in through their
    strides; the head-dim padding (72 -> 80, 88 -> 96) reads zeros past D
    even where the next head's data lies behind it."""
    rng = np.random.default_rng(30 + D)
    if fused:
        x = _randn(rng, (B, S, 3, H, D), dev)
        q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    else:
        q, k, v = (_randn(rng, (B, S, H, D), dev) for _ in range(3))
    before = attn.LAUNCHES["route:wgmma"]
    got = attn._bshd_launch(q, k, v, D ** -0.5)
    assert attn.LAUNCHES["route:wgmma"] == before + 1
    ref = attn._attention_plain_bshd(q, k, v, D ** -0.5)
    torch.cuda.synchronize()
    _close(got, ref, 2e-2, f"bshd D={D}")
    _close_l2(got, ref, 1e-2, f"bshd D={D}")


def test_k1_routes_by_dtype_and_head_dim(dev):
    """Every K1 launch takes the one wgmma body: bf16 operands directly at
    any head dim up to 256, f32 storage through one staging launch."""
    rng = np.random.default_rng(40)
    for dtype, D, route in ((torch.bfloat16, 128, "wgmma"),
                            (torch.float32, 64, "wgmma_f32"),
                            (torch.bfloat16, 256, "wgmma")):
        q, k, v = (_randn(rng, (1, 1, 200, D), dev, dtype=dtype)
                   for _ in range(3))
        before = dict(attn.LAUNCHES)
        out = torch.empty_like(q)
        attn.attention_fwd_kernel(q, k, v, out, causal=False,
                                  sm_scale=D ** -0.5, mode="flash")
        assert attn.LAUNCHES["route:" + route] == before.get("route:" + route, 0) + 1
        staged = attn.LAUNCHES["stage_bf16"] - before.get("stage_bf16", 0)
        assert staged == (dtype == torch.float32)
        ref = attn._attention_plain(q, k, v, causal=False, sm_scale=D ** -0.5)
        torch.cuda.synchronize()
        _close_l2(out, ref, 1e-2, f"{route} D={D}")


def test_stage_bf16_rounds_as_tensor_to(dev):
    """The staging pass of the f32 routes: contiguous bf16 copies of f32
    views (BSHD strides, Sq != Sk) equal to `Tensor.to(bfloat16)`, bit for
    bit (round to nearest even), in one launch."""
    rng = np.random.default_rng(41)
    q = _randn(rng, (2, 300, 4, 256), dev, dtype=torch.float32).transpose(1, 2)
    k = _randn(rng, (2, 4, 500, 256), dev, dtype=torch.float32)
    v = _randn(rng, (2, 500, 4, 264), dev, dtype=torch.float32)[..., :256].transpose(1, 2)
    before = attn.LAUNCHES["stage_bf16"]
    got = attn.stage_bf16(q, k, v)
    assert attn.LAUNCHES["stage_bf16"] == before + 1
    torch.cuda.synchronize()
    for g, t in zip(got, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.is_contiguous()
        assert torch.equal(g, t.to(torch.bfloat16))


# Hiera-L's four stages (C = 144 * 2^s): qkv, proj + residual, fc1 + GELU,
# fc2 + residual, all with their bias, at a ragged reduced row count
K2_HIERA = [(m, c, p) for m, c in ((1000, 144), (777, 288), (513, 576),
                                   (301, 1152))
            for p in ("qkv", "proj", "fc1", "fc2")]


@pytest.mark.parametrize("M,C,product", K2_HIERA)
def test_k2_hiera_products_match_plain(dev, M, C, product):
    rng = np.random.default_rng(50 + C)
    K, N = {"qkv": (C, 3 * C), "proj": (C, C), "fc1": (C, 4 * C),
            "fc2": (4 * C, C)}[product]
    a = _randn(rng, (M, K), dev, 0.5)
    w = _randn(rng, (N, K), dev, K ** -0.5)
    b = _randn(rng, (N,), dev, 0.1)
    r = _randn(rng, (M, N), dev) if product in ("proj", "fc2") else None
    gelu = product == "fc1"
    got = fb.gemm_epilogue(a, w, b, gelu=gelu, residual=r)
    ref = fb._gemm_plain(a, w, b, gelu=gelu, residual=r)
    torch.cuda.synchronize()
    _close(got, ref, 2e-2, f"K2 {product} M={M} K={K} N={N}")


@pytest.mark.parametrize("M,K,N,bias,gelu,res", [
    (129, 144, 144, False, False, False), (255, 144, 144, False, True, True),
    (64, 72, 200, True, False, True), (3, 1152, 4608, False, True, False),
    (40000, 576, 144, True, False, True), (40000, 2304, 576, True, False, True)])
def test_k2_epilogue_options_match_plain(dev, M, K, N, bias, gelu, res):
    """Without bias, GELU without bias, N not a multiple of 144 (tiles of
    128 with a ragged last one), K not a multiple of 16, M below a tile;
    and grids where every persistent CTA walks several tiles of many
    reduction chunks, so the ring's stages turn over many phases."""
    rng = np.random.default_rng(60)
    a = _randn(rng, (M, K), dev, 0.5)
    w = _randn(rng, (N, K), dev, K ** -0.5)
    b = _randn(rng, (N,), dev, 0.1) if bias else None
    r = _randn(rng, (M, N), dev) if res else None
    got = fb.gemm_epilogue(a, w, b, gelu=gelu, residual=r)
    ref = fb._gemm_plain(a, w, b, gelu=gelu, residual=r)
    torch.cuda.synchronize()
    _close(got, ref, 2e-2, f"K2 M={M} K={K} N={N}")


def _sass_functions(path):
    """{mangled function name: SASS text} of a built library."""
    import shutil
    import subprocess
    from pathlib import Path
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    exe = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if exe is None:
        pytest.skip("cuobjdump not found")
    text = subprocess.run([exe, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return {n: "\n".join(body) for n, body in funcs.items()}


def test_wgmma_routes_compile_to_hgmma(dev):
    """K1's body and K7 issue warpgroup MMAs (HGMMA) and no mma.sync (HMMA)
    at every padded head dim, and nothing else in their libraries (the
    staging pass) issues HMMA; K2's GEMM the same."""
    from videoglamm_torch.ops import _cuda
    k1 = _sass_functions(_cuda.load("attention_fwd").path)
    k7 = _sass_functions(_cuda.load("window_attention").path)
    k2 = _sass_functions(_cuda.load("gemm_epilogue").path)
    body = {n: s for n, s in k1.items() if "attn_fwd_sm90" in n}
    win = {n: s for n, s in k7.items() if "window_attn_sm90" in n}
    gemm = {n: s for n, s in k2.items() if "gemm_sm90" in n}
    assert len(body) == len(win) == len(attn.K1_DEPTHS) and len(gemm) == 2
    assert any("stage_bf16" in n for n in k1)
    for n, s in {**body, **win, **gemm}.items():
        assert "HGMMA" in s and "HMMA" not in s, n
    assert not any("HMMA" in s for s in {**k1, **k7}.values())


def test_k6_compiles_to_hgmma(dev):
    """K6's dq and dk/dv kernels issue warpgroup MMAs (HGMMA) and no
    mma.sync (HMMA), at every padded head dim."""
    from videoglamm_torch.ops import _cuda
    k6 = _sass_functions(_cuda.load("flash_bwd").path)
    mma = {n: s for n, s in k6.items()
           if "flash_bwd_dq" in n or "flash_bwd_dkv" in n}
    assert len(mma) == 2 * len(attn.K6_DEPTHS)
    for n, s in mma.items():
        assert "HGMMA" in s and "HMMA" not in s, n
    assert not any("HMMA" in s for s in k6.values())


def test_k4_compiles_without_i2f(dev):
    """K4 turns codes into f32 images with byte permutes and FFMAs (its f32
    route into signed codes by the magic number): no I2F in any
    instantiation (G = 1 at 16 and 24 dims a lane, G = 2, G = 4, each bf16
    and f32), and no runtime integer division either (its reciprocal step
    is an I2F)."""
    from videoglamm_torch.ops import _cuda
    k4 = _sass_functions(_cuda.load("decode_attention_q8").path)
    body = {n: s for n, s in k4.items() if "decode_q8_kernel" in n}
    assert len(body) == 8
    for n, s in k4.items():
        assert "I2F" not in s, n


def test_k9_compiles_without_i2f(dev):
    """K9 turns codes into floats by magic numbers and bf16 subtractions,
    s32 sums into f32 by two exact halves, quantises by a magic-number
    rounding and divides by no runtime integer: no I2F in any of its
    sixteen instantiations (four entries x one, two, three rows on the CUDA
    cores and the tensor-core route). The tensor-core route issues HMMA
    (bf16 entries) or IMMA (W8A8), the CUDA-core route neither."""
    from videoglamm_torch.ops import _cuda
    k9 = _sass_functions(_cuda.load("decode_fused").path)
    body = {n: s for n, s in k9.items() if "k9_kernel" in n}
    assert len(body) == 16
    for n, s in k9.items():
        assert "I2F" not in s, n
    # the mangled template arguments <MT, KIND>: MT 8 is the tensor-core
    # route, KIND 3 the W8A8 entry
    for n, s in body.items():
        mt, kind = (int(v) for v in re.search(r"k9_kernelILi(\d)ELi(\d)E", n).groups())
        assert ("IMMA" in s) == (mt == 8 and kind == 3), n
        assert ("HMMA" in s) == (mt == 8 and kind != 3), n


def test_k5_compiles_without_i2f(dev):
    """K5's int -> float steps are magic-number integer logic and FADDs (or
    bf16 subtractions): no I2F anywhere in its kernels, at every
    instantiation (int8 / int4 x one to three rows on the CUDA cores with
    bf16 x, one to four with f32 x / the tensor-core route), and only the
    tensor-core route issues mma (HMMA)."""
    from videoglamm_torch.ops import _cuda
    k5 = _sass_functions(_cuda.load("dequant_gemv").path)
    rows = {n: s for n, s in k5.items() if "gemv_rows_kernel" in n}
    mma = {n: s for n, s in k5.items() if "gemv_mma_kernel" in n}
    assert len(rows) == 14 and len(mma) == 2
    for n, s in rows.items():
        assert "I2F" not in s and "HMMA" not in s, n
    for n, s in mma.items():
        assert "I2F" not in s and "HMMA" in s, n


# ---------------------------------------------------------------------------
# the SAM-2 surfaces: connected components, the image predictor, the
# automatic mask generator and the interactive predictor on the card
# ---------------------------------------------------------------------------
def _narrow_sam2(dev):
    """A narrow SAM-2 at image size 256 built through `build_sam2`: f32 on
    the CPU (the plain twins) and bf16 on the card, the same weights."""
    from videoglamm_torch.config import HieraConfig, SAM2Config
    from videoglamm_torch.inference.pipeline import build_sam2
    cfg = SAM2Config(hiera=HieraConfig(embed_dim=16, num_heads=1,
                                       stages=(1, 2, 3, 1),
                                       global_att_blocks=(5,)),
                     image_size=256, memory_attention_layers=1)
    g = torch.Generator().manual_seed(0)

    def init(m):
        with torch.no_grad():
            for p in m.parameters():
                p.normal_(0.0, 0.02, generator=g)
            for b in m.buffers():
                b.normal_(0.0, 1.0, generator=g)
            m.sam_mask_decoder.pred_obj_score_head.layers[-1].bias.fill_(2.0)

    ref = build_sam2(cfg, device="cpu", dtype=torch.float32, init=init)
    return ref, build_sam2(cfg, ref.state_dict(), device=dev, dtype=torch.bfloat16)


def test_connected_components_on_card_equal_cpu(dev):
    """The same sweeps on the card: labels, areas and the filled logits
    equal to the CPU's bit for bit."""
    from videoglamm_torch.ops import connected_components as cc
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((6, 64, 80)), dtype=torch.float32)
    for _ in range(3):
        x = (x + x.roll(1, 1) + x.roll(1, 2)) / 3
    for m in (x > 0, x > 0.3, torch.as_tensor(rng.random((3, 33, 47)) > 0.5)):
        got, ref = cc.connected_components(m.to(dev)), cc.connected_components(m)
        for a, b in zip(got, ref):
            assert torch.equal(a.cpu(), b)
    assert torch.equal(cc.postprocess_mask_scores(x.to(dev), 20.0, 20.0).cpu(),
                       cc.postprocess_mask_scores(x, 20.0, 20.0))


def test_image_predictor_and_amg_on_card_match_cpu(dev):
    from videoglamm_torch.models.sam2.amg import (SAM2AutomaticMaskGenerator,
                                                  rles_from_device_masks)
    from videoglamm_torch.models.sam2.image_predictor import SAM2ImagePredictor
    from videoglamm_torch.data.rle import rle_decode
    ref, card = _narrow_sam2(dev)
    img = torch.as_tensor(np.random.default_rng(1).integers(0, 256, (120, 200, 3)),
                          dtype=torch.uint8)
    preds = [SAM2ImagePredictor(m) for m in (ref, card)]
    preds[0].set_image(img)
    preds[1].set_image(img.to(dev))
    outs = [p.predict(point_coords=np.array([[50.0, 60.0]]),
                      point_labels=np.array([1]), return_logits=True) for p in preds]
    for a, b, what in zip(outs[1], outs[0], ("logits", "ious", "low-res")):
        _close_l2(torch.as_tensor(a), torch.as_tensor(b), 2e-2, what)
    gens = [SAM2AutomaticMaskGenerator(m, points_per_side=4, pred_iou_thresh=0.0,
                                       stability_score_thresh=0.0, box_nms_thresh=1.0,
                                       output_mode="uncompressed_rle")
            for m in (ref, card)]
    recs = [g.generate(im) for g, im in zip(gens, (img, img.to(dev)))]
    assert len(recs[0]) == len(recs[1]) == 48
    for side in recs:
        assert sorted(r["point_coords"] for r in side) == \
            sorted(r["point_coords"] for r in recs[0])
        for r in side:
            assert int(rle_decode(r["segmentation"]).sum()) == r["area"]
    # the run boundaries found on the card, bit for bit
    masks = torch.as_tensor(np.stack([rle_decode(r["segmentation"]) for r in recs[1]]))
    assert rles_from_device_masks(masks.to(dev), (5, 3), (130, 210)) == \
        rles_from_device_masks(masks, (5, 3), (130, 210))


def test_interactive_step_on_card_matches_cpu(dev):
    """Prompts and one propagated frame on the reference's bank: the masks
    of every candidate, the IoUs and the object scores."""
    from videoglamm_torch.models.sam2 import interactive as I
    ref, card = _narrow_sam2(dev)
    frames = torch.randn(3, 256, 256, 3, generator=torch.Generator().manual_seed(2))
    sess = [I.SAM2InteractivePredictor(m, frames.to(I.model_device(m)), num_objects=2)
            for m in (ref, card)]
    pts = np.array([[[60.0, 50.0]], [[180.0, 200.0]]])
    outs = [s.add_new_points(0, pts, np.ones((2, 1), np.int32)) for s in sess]
    _close_l2(outs[1].cpu(), outs[0], 2e-2, "points prompt")
    rb = sess[0].bank
    db = I.InteractiveBank(*(x.clone().to(dev) if torch.is_tensor(x) else x.copy()
                             for x in rb))
    with torch.no_grad():
        heads = [I.propagate_step(m, [f[1][None].expand(2, *f.shape[1:]) for f in s.feats],
                                  s.pos[-1], b, 1, 3)
                 for m, s, b in ((ref, sess[0], rb), (card, sess[1], db))]
    for name in ("low_res_multimasks", "ious", "object_score_logits"):
        _close_l2(getattr(heads[1], name).cpu(), getattr(heads[0], name), 2e-2, name)
    assert list(db.mem_frame) == list(rb.mem_frame)


# ---------------------------------------------------------------------------
# SAM-1 on the card: K3 at every norm, the plain biased attention
# ---------------------------------------------------------------------------
def test_sam1_on_card_matches_cpu(dev):
    """A narrow SAM-1 built through `build_sam1` (256 wide, 3 blocks, the
    last global, windows of 14 on a 32x32 grid padded to 42x42, the ITM
    head): bf16 encoder on the card against the f32 CPU twin on the same
    weights, by relative L2 (a few bf16 roundings a block), through the
    predictor and `track_frames`; every encoder norm launches K3."""
    from videoglamm_torch.config import SAM1Config
    from videoglamm_torch.inference.pipeline import build_sam1
    from videoglamm_torch.models.sam1_predictor import SAM1ImagePredictor
    cfg = SAM1Config(image_size=512, encoder_embed_dim=256, encoder_depth=3,
                     encoder_num_heads=4, encoder_global_attn_indexes=(2,),
                     with_itm=True)
    g = torch.Generator().manual_seed(0)

    def init(m):
        with torch.no_grad():
            for p in m.parameters():
                p.normal_(0.0, 0.02, generator=g)
            for b in m.buffers():
                b.normal_(0.0, 1.0, generator=g)

    ref = build_sam1(cfg, device="cpu", dtype=torch.float32, init=init)
    card = build_sam1(cfg, ref.state_dict(), device=dev, dtype=torch.bfloat16)
    img = torch.as_tensor(np.random.default_rng(2).integers(0, 256, (120, 200, 3)),
                          dtype=torch.uint8)
    preds = [SAM1ImagePredictor(m) for m in (ref, card)]
    preds[0].set_image(img)
    norms.LAUNCHES.clear()
    preds[1].set_image(img.to(dev))
    assert norms.LAUNCHES["ln"] == 2 * cfg.encoder_depth + 2
    _close_l2(preds[1].get_image_embedding().cpu(), preds[0].get_image_embedding(),
              2e-2, "embedding")
    outs = [p.predict(point_coords=np.array([[50.0, 60.0]]), point_labels=np.array([1]),
                      box=np.array([10.0, 20.0, 150.0, 100.0]), return_logits=True)
            for p in preds]
    for a, b, what in zip(outs[1], outs[0], ("logits", "ious", "low-res")):
        _close_l2(torch.as_tensor(a), torch.as_tensor(b), 2e-2, what)
    x = torch.randn(2, 512, 512, 3, generator=g)
    text = torch.randn(3, 1, 256, generator=g)
    with torch.no_grad():
        r, d = ref.track_frames(x, text), card.track_frames(x.to(dev), text.to(dev))
    _close_l2(d.cpu(), r, 2e-2, "track_frames")


def test_prefetch_copy_to_the_card_is_bit_equal(dev):
    """The train CLI's copy onto the card: pinned, non_blocking, made by
    the prefetch worker thread on the consumer's stream. Copied back, each
    device batch equals the host batch it came from (the pixel streams
    after the same cast to bf16; masks stay f32, ids int64)."""
    from videoglamm_torch.data.collate import build_batch
    from videoglamm_torch.data.prefetch import device_copier, prefetch_to_device
    rng = np.random.RandomState(0)

    def sample():
        return dict(frames=rng.randn(4, 28, 28, 3),
                    context_images=rng.randn(4, 56, 56, 3),
                    frames_sam=rng.randn(2, 128, 128, 3),
                    conversations=[(list(range(7)), list(range(7)))],
                    masks=rng.rand(1, 2, 32, 32).round())

    host = [build_batch([sample(), sample()], max_text_len=16)
            for _ in range(5)]
    it = prefetch_to_device(iter(host), device_copier(dev, torch.bfloat16),
                            prefetch=2)
    for want in host:
        got = next(it)
        assert got["frames"].dtype == torch.bfloat16
        assert got["gt_masks"].dtype == torch.float32
        assert got["input_ids"].dtype == torch.int64
        for k, v in want.items():
            assert got[k].is_cuda, k
            assert torch.equal(got[k].cpu(), v.to(got[k].dtype)), k
    it.close()


@pytest.mark.parametrize("shape,hw", [((4, 2, 256, 256), (480, 854)),
                                      ((1, 3, 32, 32), (48, 85))])
def test_masks_to_original_size_on_the_card_matches_the_cpu(dev, shape, hw):
    """The serving CLIs' mask postprocess: the resize runs on the card,
    only the boolean masks come back. Against the same function on the
    CPU in f32: equal but at pixels whose CPU logit lies within 1e-4 of
    the threshold (another summation order)."""
    from videoglamm_torch.evals.postprocess import masks_to_original_size
    from videoglamm_torch.ops.resize import resize_bilinear
    rng = np.random.RandomState(sum(shape))
    logits = torch.from_numpy((rng.randn(*shape) * 4).astype(np.float32))
    got = masks_to_original_size(logits.to(dev), hw)
    want = masks_to_original_size(logits, hw)
    assert got.shape == want.shape == shape[:-2] + hw
    ref = resize_bilinear(logits.reshape((-1,) + shape[-2:] + (1,)), hw)
    ref = ref[..., 0].reshape(shape[:-2] + hw).numpy()
    assert (np.abs(ref[got != want]) < 1e-4).all()


def test_profile_trace_on_the_card_records_k3_and_the_annotation(dev, tmp_path):
    """utils.profiling on the card: the Chrome trace holds the annotation
    and K3's Triton kernel as a device event (the function is `kernel` in
    ops/norms.py, which key_averages() lists, and the trace export names
    "Kernel"), and the counter moved by one launch."""
    import json
    import os
    from videoglamm_torch.utils import annotate, profile_trace
    from videoglamm_torch.utils.profiling import TRACE_FILE
    x = torch.randn(512, 1024, device=dev, dtype=torch.bfloat16)
    w = torch.ones(1024, device=dev, dtype=torch.bfloat16)
    before = norms.LAUNCHES["rms"]
    with profile_trace(str(tmp_path)) as prof:
        with annotate("vp/k3_under_test"):
            norms.row_norm(x, w, None, 1e-6, rms=True)
            torch.cuda.synchronize()
    assert norms.LAUNCHES["rms"] == before + 1
    events = json.load(open(os.path.join(str(tmp_path), TRACE_FILE)))["traceEvents"]
    assert any(e.get("name") == "vp/k3_under_test" for e in events)
    kernels = sorted({e.get("name") for e in events if e.get("cat") == "kernel"})
    assert kernels == ["Kernel"], kernels
    assert ("kernel", torch.autograd.DeviceType.CUDA) in {
        (e.key, e.device_type) for e in prof.key_averages()}


def test_step_timer_waits_for_a_cuda_tensor(dev):
    """StepTimer.stop(t) synchronises t's device: the timed span covers
    the queued work, so it is no shorter than the work's device time."""
    from videoglamm_torch.utils import StepTimer
    a = torch.randn(4096, 4096, device=dev)
    torch.cuda.synchronize()
    t = StepTimer()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t.start()
    start.record()
    for _ in range(20):
        a = a @ a / 64.0
    end.record()
    dt = t.stop(a)
    assert end.query()           # the work had finished when stop returned
    assert dt * 1e3 >= start.elapsed_time(end) * 0.99


# ---------------------------------------------------------------------------
# the full-precision f32 routes (K1 "simt_f32" and K6 in f32: 3xTF32 on
# wgmma; K2 in f32 FFMA) against their f32 twins with TF32 off: f32-accurate
# products summed in another order, so relative L2 within 1e-5 (1e-7 to
# 3e-6 measured at the path shapes; a bf16 or single TF32 rounding of an
# operand gives 1e-4 to 1e-3, tests/test_torch_tf32x3.py)
# ---------------------------------------------------------------------------
TOL_F32 = 1e-5


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,kv,win", [
    (2, 3, 300, 300, 96, True, (300, 250), 0),     # causal, kv_lens, LSE
    (1, 2, 100, 260, 72, True, (200,), 0),         # a longer cache
    (2, 2, 400, 400, 72, False, None, 0),          # flash (Hiera globals)
    (2, 1, 300, 300, 256, False, None, 0),         # flash_d256
    (3, 4, 256, 256, 64, False, None, 16),         # a window of 16 tokens
    (2, 2, 192, 192, 88, False, None, 64),         # a window of 64 tokens
    (2, 1, 200, 300, 256, False, (300, 270), 0),   # kv_len inside a 32-key tile
    (2, 1, 300, 400, 256, True, (400, 333), 0),    # causal at head dim 256
    (2, 2, 130, 130, 32, True, (130, 77), 0),      # head dim 32
    (2, 2, 130, 170, 40, False, (170, 99), 0)])    # head dim 40 (padded to 64)
def test_k1_f32_route_matches_plain(dev, B, H, Sq, Sk, D, causal, kv, win):
    rng = np.random.default_rng(41)
    q, k, v = (_randn(rng, (B, H, S, D), dev, dtype=torch.float32)
               for S in (Sq, Sk, Sk))
    kvl = torch.tensor(kv or (Sk,) * B, dtype=torch.int32, device=dev)
    qs = (kvl - Sq) if causal else torch.zeros(B, dtype=torch.int32, device=dev)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, device=dev)
    before = attn.LAUNCHES["route:simt_f32"], attn.LAUNCHES["stage_bf16"]
    attn.attention_fwd_kernel(q, k, v, out, causal=causal, sm_scale=D ** -0.5,
                              mode="test", kv_lens=kvl, q_start=qs, win=win,
                              lse=lse, exact=True)
    assert (attn.LAUNCHES["route:simt_f32"], attn.LAUNCHES["stage_bf16"]) == \
        (before[0] + 1, before[1])
    if win:
        ref = attn._attention_plain_bshd(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), D ** -0.5,
            win).transpose(1, 2)
    else:
        ref, ref_lse = attn._flash_fwd_plain(q, k, v, kvl, qs, causal, D ** -0.5)
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=2e-5)
    _close_l2(out, ref, TOL_F32, f"K1 simt_f32 {(B, H, Sq, Sk, D, win)}")


@pytest.mark.parametrize("M,K,N,gelu,res", [(300, 144, 432, False, False),
                                            (260, 144, 576, True, False),
                                            (130, 576, 144, False, True),
                                            (64, 1152, 4608, True, True)])
def test_k2_f32_route_matches_plain(dev, M, K, N, gelu, res):
    rng = np.random.default_rng(42)
    a = _randn(rng, (M, K), dev, dtype=torch.float32)
    w = _randn(rng, (N, K), dev, K ** -0.5, torch.float32)
    b = _randn(rng, (N,), dev, 0.1, torch.float32)
    r = _randn(rng, (M, N), dev, dtype=torch.float32) if res else None
    before = fb.LAUNCHES["gemm:simt_f32"]
    got = fb.gemm_epilogue(a, w, b, gelu=gelu, residual=r)
    assert fb.LAUNCHES["gemm:simt_f32"] == before + 1
    _close_l2(got, fb._gemm_plain(a, w, b, gelu=gelu, residual=r), TOL_F32,
              f"K2 f32 {(M, K, N)}")


@pytest.mark.parametrize("B,H,S,D,causal,kv", [(2, 3, 300, 96, True, (300, 250)),
                                               (2, 2, 333, 72, False, None),
                                               (1, 2, 130, 40, True, (120,))])
def test_k6_f32_route_matches_plain(dev, B, H, S, D, causal, kv):
    rng = np.random.default_rng(43)
    q, k, v, g = (_randn(rng, (B, H, S, D), dev, dtype=torch.float32)
                  for _ in range(4))
    kvl = torch.tensor(kv or (S,) * B, dtype=torch.int32, device=dev)
    qs = (kvl - S) if causal else torch.zeros(B, dtype=torch.int32, device=dev)
    out, lse = attn._flash_fwd_plain(q, k, v, kvl, qs, causal, D ** -0.5)
    before = attn.LAUNCHES["flash_bwd:simt_f32"]
    got = attn.flash_bwd_kernel(q, k, v, out, lse, g, causal=causal,
                                sm_scale=D ** -0.5, kv_lens=kvl, q_start=qs)
    assert attn.LAUNCHES["flash_bwd:simt_f32"] == before + 1
    want = attn._flash_bwd_plain(q, k, v, out, lse, g, kvl, qs, causal,
                                 D ** -0.5)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _close_l2(a, w, TOL_F32, f"K6 f32 {name}")


@pytest.mark.parametrize("D", [96, 256])
def test_f32_routes_keep_nan_in_the_key_slack_out(dev, D):
    """NaN in k and v past kv_len (a cache's slack): K1's f32 route and,
    up to head dim 128, K6's read those keys as zeros: finite outputs
    within TOL_F32 of the twins on clean operands, zero dk and dv there."""
    rng = np.random.default_rng(45)
    B, H, S = 2, 2, 200
    kv = (200, 133)
    q, k, v, g = (_randn(rng, (B, H, S, D), dev, dtype=torch.float32)
                  for _ in range(4))
    kvl = torch.tensor(kv, dtype=torch.int32, device=dev)
    qs = torch.zeros(B, dtype=torch.int32, device=dev)
    clean_k, clean_v = k.clone(), v.clone()
    for b, n in enumerate(kv):
        k[b, :, n:] = float("nan")
        v[b, :, n:] = float("nan")
        clean_k[b, :, n:] = 0
        clean_v[b, :, n:] = 0
    out = torch.empty_like(q)
    lse = torch.empty(B, H, S, device=dev)
    attn.attention_fwd_kernel(q, k, v, out, causal=True, sm_scale=D ** -0.5,
                              mode="test", kv_lens=kvl, q_start=qs, lse=lse,
                              exact=True)
    ref, ref_lse = attn._flash_fwd_plain(q, clean_k, clean_v, kvl, qs, True,
                                         D ** -0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    _close_l2(out, ref, TOL_F32, f"K1 f32 NaN slack D={D}")
    if D > 128:
        return
    got = attn.flash_bwd_kernel(q, k, v, ref, ref_lse, g, causal=True,
                                sm_scale=D ** -0.5, kv_lens=kvl, q_start=qs)
    want = attn._flash_bwd_plain(q, clean_k, clean_v, ref, ref_lse, g, kvl, qs,
                                 True, D ** -0.5)
    torch.cuda.synchronize()
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), name
        _close_l2(a, w, TOL_F32, f"K6 f32 NaN slack {name}")
    assert not got[1][1, :, kv[1]:].any() and not got[2][1, :, kv[1]:].any()


@pytest.mark.parametrize("layout", ["bshd", "fused qkv", "fused qkv, win 64"])
def test_k1_f32_route_reads_bshd_and_fused_qkv_views_in_place(dev, layout):
    """An f32 model's CLIP ([B,S,H,D]) and InternVideo2 (fused qkv
    [B,S,3*H*hd]) self-attention: K1's f32 route over the views' strides,
    no copy, within TOL_F32 of the twin."""
    rng = np.random.default_rng(46)
    B, S, H, hd = 2, 200, 3, 88
    before = attn.LAUNCHES["route:simt_f32"]
    if layout == "bshd":
        q, k, v = (_randn(rng, (B, S, H, hd), dev, dtype=torch.float32)
                   for _ in range(3))
        got = attn.attention_bshd(q, k, v, exact=True)
        ref = attn._attention_plain_bshd(q, k, v, hd ** -0.5)
    else:
        win = 64 if "win" in layout else 0
        qkv = _randn(rng, (B, S, 3 * H * hd), dev, dtype=torch.float32)
        got = attn.attention_packed_qkv_padded(qkv, H, hd, win=win, exact=True)
        x = qkv.view(B, S, 3, H, hd)
        ref = attn._attention_plain_bshd(x[:, :, 0], x[:, :, 1], x[:, :, 2],
                                         hd ** -0.5, win).reshape(B, S, H * hd)
    torch.cuda.synchronize()
    assert attn.LAUNCHES["route:simt_f32"] == before + 1
    _close_l2(got, ref, TOL_F32, f"K1 f32 {layout}")


def test_f32_plans_are_the_kernels(dev):
    """`k1_f32_plan` and `k6_f32_plan` give the tiles and shared memory
    that csrc/attention_f32.cu was built with, at every padded head dim."""
    import ctypes
    from videoglamm_torch.ops import _cuda
    fn = _cuda.load("attention_f32").lib.vgt_attention_f32_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    for dp in attn.K1_DEPTHS:
        out = (ctypes.c_int * 3)()
        assert fn(dp, 1, out) == 0
        plan = attn.k1_f32_plan(dp)
        assert tuple(out) == (plan["query_rows"], plan["key_tile"], plan["smem"])
        if dp <= 128:
            assert fn(dp, 0, out) == 0
            plan = attn.k6_f32_plan(dp)
            assert tuple(out) == (plan["rows"], plan["tile"], plan["smem"])
    assert fn(256, 0, (ctypes.c_int * 3)()) == -1


def test_f32_attention_compiles_to_tf32_hgmma(dev):
    """The f32 forward and both backward kernels issue warpgroup MMAs on
    TF32 operands (HGMMA ... TF32) at every padded head dim, and no
    mma.sync (HMMA)."""
    from videoglamm_torch.ops import _cuda
    funcs = _sass_functions(_cuda.load("attention_f32").path)
    fwd = {n: s for n, s in funcs.items() if "attn_fwd_tf32" in n}
    bwd = {n: s for n, s in funcs.items() if "attn_dq_tf32" in n or "attn_dkv_tf32" in n}
    assert len(fwd) == len(attn.K1_DEPTHS) and len(bwd) == 2 * len(attn.K6_DEPTHS)
    for n, s in {**fwd, **bwd}.items():
        mma = [line for line in s.splitlines() if "HGMMA" in line]
        assert mma and all("TF32" in line for line in mma), n
        assert "HMMA" not in s, n


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_block_gradient_through_its_function(dev, dtype):
    """Under a gradient the block's kernel chain runs inside `_FusedBlock`:
    the output has a grad_fn, and the gradients of x and of the 12
    parameters (the recompute through the twin) equal autograd through
    `_fused_block_ref`."""
    rng = np.random.default_rng(44)
    NW, S, H, hd = 8, 64, 2, 72
    C = H * hd
    x = _randn(rng, (NW, S, C), dev, 0.5, dtype).requires_grad_(True)
    shapes = dict(ln1_weight=(C,), ln1_bias=(C,), qkv_weight=(3 * C, C),
                  qkv_bias=(3 * C,), proj_weight=(C, C), proj_bias=(C,),
                  ln2_weight=(C,), ln2_bias=(C,), fc1_weight=(4 * C, C),
                  fc1_bias=(4 * C,), fc2_weight=(C, 4 * C), fc2_bias=(C,))
    p = {}
    for name, shp in shapes.items():
        if name.startswith("ln"):
            t = _randn(rng, shp, dev, 0.1, torch.float32) + (
                1.0 if name.endswith("weight") else 0.0)
        else:
            t = _randn(rng, shp, dev, (shp[-1] if len(shp) == 2 else 50) ** -0.5,
                       dtype)
        p[name] = t.requires_grad_(True)
    before = fb.LAUNCHES["block"]
    y = fb.fused_window_block(x, p, H, exact=dtype == torch.float32)
    assert fb.LAUNCHES["block"] == before + 1
    assert "FusedBlock" in type(y.grad_fn).__name__
    dy = _randn(rng, (NW, S, C), dev, 1.0, dtype)
    leaves = [x] + [p[k] for k in fb.PKEYS]
    got = torch.autograd.grad(y, leaves, dy)
    want = torch.autograd.grad(fb._fused_block_ref(x, p, H), leaves, dy)
    for name, a, w in zip(["x", *fb.PKEYS], got, want):
        assert torch.equal(a, w), name


def test_f32_model_stages_nothing_and_bf16_model_keeps_staging(dev):
    """The SAM-2 memory self-attention [1,1,4096,256] in f32: marked f32
    (an f32 model) it takes K1 "simt_f32" and no staging launch; unmarked
    (a bf16 model's f32 memory attention) the staged "wgmma_f32" route."""
    from videoglamm_torch.models.common import set_exact_f32
    from videoglamm_torch.models.sam2.transformer import RoPEAttention
    torch.manual_seed(45)
    mod = RoPEAttention(256, 1, (64, 64)).to(dev)
    x = torch.randn(1, 4096, 256, device=dev)
    for exact, route, staged in ((True, "route:simt_f32", 0),
                                 (False, "route:wgmma_f32", 1)):
        set_exact_f32(mod, exact)
        before = dict(attn.LAUNCHES)
        with torch.no_grad():
            y = mod(x, x, x)
        torch.cuda.synchronize()
        assert torch.isfinite(y).all()
        assert attn.LAUNCHES[route] == before.get(route, 0) + 1
        assert attn.LAUNCHES["stage_bf16"] == before.get("stage_bf16", 0) + staged


# ---------------------------------------------------------------------------
# the f32 routes of K4, K5, K7 and K8 (an f32 model's serving kernels)
# against their f32 twins with TF32 off: the same f32 products summed in
# another order, relative L2 within 2e-6 (a bf16 rounding anywhere gives
# 1e-3)
# ---------------------------------------------------------------------------
TOL_F32_SERVE = 2e-6


@pytest.mark.parametrize("B,Hq,Hkv,C,hd,L,layer,kv", [
    (1, 32, 32, 3456, 96, 3, 1, (3400,)),     # Phi-3
    (4, 32, 8, 3456, 128, 2, 1, (3456, 3400, 61, 7)),   # Llama-3.1-8B GQA
    (2, 8, 4, 160, 96, 1, 0, (160, 97)),      # G = 2
    (2, 4, 4, 40, 16, 2, 1, (33, 1)),         # tiny() head dim, one token
    (1, 4, 4, 64, 128, 1, 0, (0,)),           # empty cache row -> zeros
])
def test_k4_f32_route_matches_plain(dev, B, Hq, Hkv, C, hd, L, layer, kv):
    """f32 q through the dispatcher: one launch counted as "decode_q8:f32"
    (none as "decode_q8"), f32 out, equal bits on a repeat."""
    rng = np.random.default_rng(51)
    cache = _int8_cache(rng, L, B, Hkv, C, hd, dev)
    q = _randn(rng, (B, Hq, 1, hd), dev, dtype=torch.float32)
    kv_lens = torch.tensor(kv, dtype=torch.int32, device=dev)
    before = dict(attn.LAUNCHES)
    call = lambda: attn.dot_product_attention(
        q, cache["k"], cache["v"], causal=True, kv_lens=kv_lens,
        q_start=kv_lens - 1, k_scale=cache["k_scale"],
        v_scale=cache["v_scale"], layer=layer)
    got = call()
    assert attn.LAUNCHES["decode_q8:f32"] == before.get("decode_q8:f32", 0) + 1
    assert attn.LAUNCHES["decode_q8"] == before.get("decode_q8", 0)
    ref = attn._decode_attention_q8_plain(
        q, cache["k"], cache["v"], cache["k_scale"], cache["v_scale"],
        sm_scale=hd ** -0.5, kv_lens=kv_lens, layer=layer)
    again = call()
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, again)
    for b in range(B):
        if kv[b]:
            _close_l2(got[b], ref[b], TOL_F32_SERVE, f"K4 f32 {(B, Hq, Hkv, hd)} b={b}")
        else:               # no valid key: K4 writes 0, the twin averages V
            assert not got[b].abs().max().item()


@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 8, 64, 255])
@pytest.mark.parametrize("K,N", K5_SHAPES)
@pytest.mark.parametrize("int4", [False, True])
def test_k5_f32_route_matches_plain(dev, M, K, N, int4):
    """f32 x through the dispatchers below the W8A8 gate (int4: up to its
    matvec gate, 64): one launch counted as "gemv_int8:f32" or
    "gemv_int4:f32", f32 y, equal bits on a repeat."""
    if int4 and M > quant.MATVEC4_MAX_M:
        pytest.skip("int4 above its matvec gate dequantises for a matmul")
    rng = np.random.default_rng(52)
    x, w = _k5_operands(rng, dev, M, K, N, int4)
    x = x.float()
    kind = "gemv_int4:f32" if int4 else "gemv_int8:f32"
    before = dict(quant.LAUNCHES)
    got = (quant.dequant4_matmul(x, *w, 128) if int4
           else quant.dequant_matmul(x, *w))
    again = _k5(x, w, int4)
    assert quant.LAUNCHES[kind] == before.get(kind, 0) + 2
    assert quant.LAUNCHES["int8"] == before.get("int8", 0)
    assert quant.LAUNCHES["int4"] == before.get("int4", 0)
    ref = _k5_plain(x, w, int4)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, again)
    _close_l2(got, ref, TOL_F32_SERVE, f"K5 f32 {'int4' if int4 else 'int8'} "
              f"M={M} K={K} N={N}")


@pytest.mark.parametrize("B,H,S,D", [(4, 1, 1024, 256),   # memory self-attention
                                     (2, 3, 600, 72), (1, 2, 1536, 96)])
def test_k7_f32_route_matches_plain(dev, B, H, S, D):
    """An f32 model's medium self-attention through the dispatcher: K7's
    full-precision route, counted as "window:simt_f32", nothing staged; a
    bf16 model's f32 operands keep the staged route."""
    rng = np.random.default_rng(53)
    q, k, v = (_randn(rng, (B, H, S, D), dev, dtype=torch.float32)
               for _ in range(3))
    before = dict(attn.LAUNCHES)
    got = attn.dot_product_attention(q, k, v, exact=True)
    assert attn.LAUNCHES["window:simt_f32"] == before.get("window:simt_f32", 0) + 1
    for name in ("window_attn", "stage_bf16", "route:simt_f32"):
        assert attn.LAUNCHES[name] == before.get(name, 0), name
    ref = attn._window_attention_plain(q, k, v, D ** -0.5)
    staged = attn.dot_product_attention(q, k, v)
    assert attn.LAUNCHES["stage_bf16"] == before.get("stage_bf16", 0) + 1
    torch.cuda.synchronize()
    _close_l2(got, ref, TOL_F32_SERVE, f"K7 f32 {(B, H, S, D)}")
    _close_l2(staged, ref, 1e-2, f"K7 staged {(B, H, S, D)}")


@pytest.mark.parametrize("NW,S,H,hd", [
    (1024, 64, 2, 72), (1024, 16, 4, 72), (16, 64, 16, 72),   # Hiera-L stages 1, 2, 4
    (7, 16, 4, 72), (5, 32, 3, 128), (9, 32, 2, 32), (3, 64, 2, 40)])
def test_k8_f32_route_matches_plain(dev, NW, S, H, hd):
    """An f32 model's packed small windows: K8's full-precision route
    (windows of S tokens in 64-row tiles, the others' keys masked),
    counted as "smallwin:simt_f32"; odd window counts leave a partial last
    tile. A bf16 model's f32 qkv raises."""
    rng = np.random.default_rng(54)
    qkv = _randn(rng, (NW, S, 3 * H * hd), dev, dtype=torch.float32)
    before = dict(attn.LAUNCHES)
    got = attn.attention_packed_qkv_smallwin(qkv, H, hd, exact=True)
    assert attn.LAUNCHES["smallwin:simt_f32"] == \
        before.get("smallwin:simt_f32", 0) + 1
    assert attn.LAUNCHES["smallwin"] == before.get("smallwin", 0)
    ref = attn._smallwin_plain(qkv, H, hd ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (NW, S, H * hd)
    _close_l2(got, ref, TOL_F32_SERVE, f"K8 f32 {(NW, S, H, hd)}")
    with pytest.raises(ValueError, match="K8 takes bf16 only"):
        attn.attention_packed_qkv_smallwin(qkv, H, hd)


def test_f32_hiera_unhoisted_matches_hoisted(dev):
    """A narrow Hiera marked f32 on the card: without hoisting (K8's f32
    route at stages 1, 2 and 4) against the hoisted fused blocks, to f32
    reduction-order noise."""
    from videoglamm_torch.config import HieraConfig
    from videoglamm_torch.models.common import set_exact_f32
    from videoglamm_torch.models.sam2.hiera import Hiera
    torch.manual_seed(55)
    cfg = HieraConfig(embed_dim=144, num_heads=2, stages=(1, 2, 2, 2),
                      global_att_blocks=(4,), window_spec=(8, 4, 14, 8))
    trunk = Hiera(cfg).to(dev)
    set_exact_f32(trunk, True)
    x = torch.randn(2, 512, 512, 3, device=dev)
    before = dict(attn.LAUNCHES)
    with torch.no_grad():
        hoisted = trunk(x)
        trunk.hoist_layout = False
        plain = trunk(x)
    assert attn.LAUNCHES["smallwin:simt_f32"] > before.get("smallwin:simt_f32", 0)
    assert attn.LAUNCHES["stage_bf16"] == before.get("stage_bf16", 0)
    for a, b in zip(plain, hoisted):
        _close_l2(a, b, 1e-5, "unhoisted vs hoisted f32 Hiera")


# ---------------------------------------------------------------------------
# the sharded train step (videoglamm_torch.parallel) on the card: one NCCL
# rank, and the gather-at-use Function over two gloo ranks on CUDA tensors
# ---------------------------------------------------------------------------
def _narrow_cfg():
    """Flagship image sizes and sequence lengths, narrow shallow towers and
    LLM (chip_smoke.py's small_config)."""
    import dataclasses
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


def _narrow_batch(cfg, dev, dtype):
    from videoglamm_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    g = torch.Generator().manual_seed(7)
    T, S, R = cfg.num_frames, 40, 2
    frames = torch.randn(2, T, 224, 224, 3, generator=g)
    context = torch.randn(2, T, 336, 336, 3, generator=g)
    sam = torch.randn(2, 2, 1024, 1024, 3, generator=g)
    ids = torch.randint(1, 32000, (R, S), generator=g)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    ids[:, 20] = cfg.seg_token_idx
    labels = ids.clone()
    labels[labels < 0] = IGNORE_INDEX
    gt = torch.full((R, cfg.max_seg_tokens, 2, 256, 256), 255.0)
    gt[:, 0] = (torch.rand(R, 2, 256, 256, generator=g) > 0.5).float()
    b = dict(frames=frames.to(dtype), context_images=context.to(dtype),
             frames_sam=sam.to(dtype), input_ids=ids,
             text_lens=torch.tensor([S, S - 5]), labels=labels,
             video_idx=torch.arange(R), gt_masks=gt)
    return {k: v.to(dev) for k, v in b.items()}


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_sharded_step_on_one_nccl_rank_is_make_train_step(dev):
    """A process group of one rank over NCCL, the mesh (1, 1): two steps of
    `make_sharded_train_step` equal `make_train_step`'s from the same start
    on the same model bit for bit, under deterministic algorithms (the
    step's index backwards accumulate with atomics otherwise)."""
    import torch.distributed as dist
    from videoglamm_torch.config import TrainConfig
    from videoglamm_torch.parallel import create_mesh, initialize_distributed
    from videoglamm_torch.training import (build_training, create_train_state,
                                           make_sharded_train_step)
    cfg = _narrow_cfg()
    torch.manual_seed(0)
    tr = build_training(cfg, TrainConfig(lr=1e-3, warmup_steps=1,
                                         total_steps=10, grad_accum_steps=1),
                        device="cuda", dtype=torch.bfloat16)
    batch = _narrow_batch(cfg, dev, torch.bfloat16)
    params = dict(tr.model.named_parameters())
    start = {n: params[n].detach().clone() for n in tr.tx.trainable}
    initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        assert dist.get_backend() == "nccl"
        state, want = tr.state, []
        for _ in range(2):
            state, m = tr.train_step(state, batch)
            want.append(m)
        end = {n: params[n].detach().clone() for n in start}
        with torch.no_grad():
            for n in start:
                params[n].copy_(start[n])
        step, sstate, split = make_sharded_train_step(
            tr.model, tr.tx, create_mesh(), create_train_state(tr.model, tr.tx))
        for i in range(2):
            sstate, m = step(sstate, split(batch))
            assert all(torch.equal(m[k], want[i][k]) for k in m), i
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    for n in start:
        assert torch.equal(params[n], end[n]), n


GATHER_WORKER = r"""
import sys, torch
from videoglamm_torch.parallel import initialize_distributed, create_mesh
from videoglamm_torch.parallel.collectives import gather_shard
from videoglamm_torch.parallel.partitioning import Sharding
rank, addr, dev = int(sys.argv[1]), sys.argv[2], sys.argv[3]
initialize_distributed(addr, 2, rank, backend="gloo", device=dev)
axis = create_mesh(data=1, model=2).axis("model")
g = torch.Generator(device=dev).manual_seed(0)
full = torch.randn(3 * 64, 48, device=dev, generator=g)    # q, k, v rows
x = torch.randn(40, 48, device=dev, generator=g)
dy = torch.randn(40, 3 * 64, device=dev, generator=g)
for sh in (Sharding(0, (64, 64, 64), axis), Sharding(1, (48,), axis)):
    shard = torch.nn.Parameter(sh.take(full))
    w = gather_shard(shard, sh)
    assert w.device.type == dev and torch.equal(w, full), "gathered weight"
    ((x @ w.t()) * dy).sum().backward()
    ref = full.clone().requires_grad_(True)
    ((x @ ref.t()) * dy).sum().backward()
    assert torch.equal(shard.grad, sh.take(ref.grad)), "gradient shard"
print(f"rank {rank} ok", flush=True)
"""


def test_gather_at_use_over_two_gloo_ranks_on_cuda(dev):
    """Two processes on the card over gloo (which takes CUDA tensors):
    `gather_shard` of a qkv-segmented and of a plain column split gives the
    full weight, and its backward this rank's part of the full gradient."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    addr = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", GATHER_WORKER, str(r),
                               addr, "cuda"], cwd=root, env=dict(os.environ,
                                                         PYTHONPATH=root),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {r} ok" in out, out[-3000:]
