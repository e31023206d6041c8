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
order than the twin's, so it differs by at most one bf16 ulp.
"""
import numpy as np
import pytest
import torch

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
