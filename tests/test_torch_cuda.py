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
def test_k3_row_norm_matches_plain(dev, d, rms, bias, dtype):
    rng = np.random.default_rng(3)
    x = _randn(rng, (37, d), dev, 2.0, dtype)
    w = _randn(rng, (d,), dev, 0.1, torch.float32) + 1.0
    b = _randn(rng, (d,), dev, 0.1, torch.float32) if bias else None
    got = norms.row_norm(x, w, b, 1e-6, rms=rms)
    ref = (norms._rms_norm_plain(x, w, 1e-6) if rms
           else norms._layer_norm_plain(x, w, b, 1e-6))
    torch.cuda.synchronize()
    _close(got, ref, 1e-5 if dtype == torch.float32 else 1e-2, f"norm d={d}")


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


def test_k4_refuses_f32_and_unsupported_geometry(dev):
    rng = np.random.default_rng(6)
    cache = _int8_cache(rng, 1, 1, 2, 32, 16, dev)
    kv_lens = torch.tensor([32], dtype=torch.int32, device=dev)
    args = (cache["k"], cache["v"], cache["k_scale"], cache["v_scale"], kv_lens)
    with pytest.raises(ValueError):
        attn.decode_attention_q8(_randn(rng, (1, 2, 1, 16), dev,
                                        dtype=torch.float32), *args,
                                 sm_scale=0.25)
    with pytest.raises(ValueError):      # G = 3
        attn.decode_attention_q8(_randn(rng, (1, 6, 1, 16), dev), *args,
                                 sm_scale=0.25)


@pytest.mark.parametrize("M", [1, 3, 64])
@pytest.mark.parametrize("K,N", [(3072, 9216), (8192, 3072), (3072, 32065),
                                 (128, 193)])
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


@pytest.mark.parametrize("M", [1, 3, 64])
@pytest.mark.parametrize("K,N", [(3072, 9216), (8192, 3072), (3072, 32065),
                                 (128, 193)])
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


def test_k5_routing_and_refusals(dev):
    """Large M leaves K5: W8A8 through the s8 x s8 product (N padded to 8)
    and int4 through dequantise-then-matmul; f32 operands raise."""
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
        quant.dequant_matmul(x[:2].float(), wq, s)
    with pytest.raises(ValueError):
        quant.dequant4_matmul(x[:2].float(), p4, s4, 128)


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


def test_tma_kernels_launch_from_a_fresh_thread(dev):
    """K1's wgmma route, K2 and K6 encode tensor maps against the current
    context. A fresh host thread (the autograd engine runs a backward, and
    a remat recompute, on one) has none bound while its tensors come from
    the caching allocator; the entries bind the operands' device."""
    import threading
    rng = np.random.default_rng(40)
    q, k, v, g, kv_lens, q_start, out, lse = _k6_inputs(
        rng, dev, 1, 2, 200, 200, 64, (200,), (0,), True)
    a = _randn(rng, (256, 144), dev)
    w = _randn(rng, (144, 144), dev, 0.1)
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
# operands are rounded to bf16 on the way into shared memory and p is
# rounded to bf16 before p v, so against the twin (f32 products of the same
# operands, p rounded at the same place for bf16 operands) entries differ by
# a few bf16 ulps (2^-8).
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


@pytest.mark.parametrize("M", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("K,I,N", K9_SHAPES)
def test_k9_bf16_entries_match_plain(dev, M, K, I, N):
    """norm_matmul, matmul_residual and mlp at the Phi-3 widths, at a narrow
    case whose N and I are no multiples of 1024, and at the Llama widths."""
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


@pytest.mark.parametrize("M", [1, 4, 8])
@pytest.mark.parametrize("K,I,group", [(3072, 8192, 1024), (256, 1536, 512),
                                       (256, 768, 1024)])
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
    with pytest.raises(ValueError):               # more than 8 rows
        dm.fused_norm_matmul_int8(x, p["nw"], p["w"], p["s"])
    with pytest.raises(ValueError):               # f32 rows on the card
        dm.fused_decode_mlp_int8(x[:2].float(), p["nw"], p["wgu"], p["sgu"],
                                 p["wd"], p["sd"])
    with pytest.raises(ValueError):               # a group that does not divide I
        dm.fused_decode_mlp_int8(x[:2], p["nw"], p["wgu"], p["sgu"], p["wd"],
                                 p["sd"], w8a8=True, group=384)


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
@pytest.mark.parametrize("D", [64, 72, 88, 96, 128])
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
    rng = np.random.default_rng(40)
    for dtype, D, route in ((torch.bfloat16, 128, "wgmma"),
                            (torch.float32, 64, "mma_sync"),
                            (torch.bfloat16, 256, "mma_sync")):
        q, k, v = (_randn(rng, (1, 1, 200, D), dev, dtype=dtype)
                   for _ in range(3))
        before = attn.LAUNCHES["route:" + route]
        out = torch.empty_like(q)
        attn.attention_fwd_kernel(q, k, v, out, causal=False,
                                  sm_scale=D ** -0.5, mode="flash")
        assert attn.LAUNCHES["route:" + route] == before + 1
        ref = attn._attention_plain(q, k, v, causal=False, sm_scale=D ** -0.5)
        torch.cuda.synchronize()
        _close_l2(out, ref, 1e-2, f"{route} D={D}")


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
    """The new routes issue warpgroup MMAs (HGMMA) and no mma.sync (HMMA);
    the mma_sync route of K1 is still HMMA."""
    from videoglamm_torch.ops import _cuda
    k1 = _sass_functions(_cuda.load("attention_fwd").path)
    k2 = _sass_functions(_cuda.load("gemm_epilogue").path)
    new = {n: s for n, s in k1.items() if "attn_fwd_sm90" in n}
    old = {n: s for n, s in k1.items() if "attn_fwd_kernel" in n}
    gemm = {n: s for n, s in k2.items() if "gemm_sm90" in n}
    assert len(new) == 5 and old and len(gemm) == 2
    for n, s in {**new, **gemm}.items():
        assert "HGMMA" in s and "HMMA" not in s, n
    for n, s in old.items():
        assert "HMMA" in s, n


def test_k6_compiles_to_hgmma(dev):
    """K6's dq and dk/dv kernels issue warpgroup MMAs (HGMMA) and no
    mma.sync (HMMA), at every padded head dim."""
    from videoglamm_torch.ops import _cuda
    k6 = _sass_functions(_cuda.load("flash_bwd").path)
    mma = {n: s for n, s in k6.items()
           if "flash_bwd_dq" in n or "flash_bwd_dkv" in n}
    assert len(mma) == 2 * len(attn.K1_DEPTHS)
    for n, s in mma.items():
        assert "HGMMA" in s and "HMMA" not in s, n
    assert not any("HMMA" in s for s in k6.values())
