"""Attention ops (PyTorch port of videoglamm_tpu/ops/attention.py).

K1 (`csrc/attention_fwd.cu`) is one online-softmax forward kernel. It takes
the place of two Pallas kernels: the flash kernel `_flash_kernel`
(attention.py:93) and the BSHD single-block kernel `_bshd_kernel`
(attention.py:738). It reads q, k, v and writes o through element strides,
so the [B,H,S,D], [B,S,H,D] and fused [B,S,3,H,D] layouts all go in with
no copies.

K4 (`csrc/decode_attention_q8.cu`) is the single-query attention over the
int8 token-major KV cache. It replaces the Pallas kernel `_decode_q_kernel`
(attention.py:1061): the stacked cache is read in place (the layer is a
pointer offset), the per-token and per-head scales fold into the logits (K)
and the probabilities (V), GQA is native, and kv_lens is read on the
device. `dot_product_attention` sends every Sq == 1 call with `k_scale` on
a CUDA tensor to K4 (the TPU's lane-layout condition `_decode_group_plan`
has no counterpart here).

The dispatch mirrors the JAX package. A call site takes K1 exactly where
the JAX package takes a Pallas kernel on the TPU, and takes the plain
PyTorch twin where JAX used XLA. Each condition cites its JAX line. The
kernel wrappers take the plain twins only for CPU tensors. On a CUDA
tensor they launch K1 or raise.

Shapes follow the JAX functions: [B, H, S, D] for `dot_product_attention`
and `flash_attention`, and [B, S, H, D] for the BSHD entries.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from . import _cuda

NEG_INF = -1e30

# K1 launches by mode: "causal" (LLM prefill), "flash" (long non-causal,
# Hiera global blocks), "bshd" (CLIP / InternVideo2 self-attention),
# "window" (Hiera window attention inside fused_window_block); K4 launches
# under "decode_q8"
LAUNCHES = collections.Counter()

# K4 splits the cache axis over this many thread blocks per SM (per batch)
DECODE_SPLITS_PER_SM = 1


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------
def _attention_plain(q, k, v, *, causal: bool, sm_scale: float,
                     kv_lens=None, bias=None, kv_mask=None, q_start=None,
                     k_scale=None, v_scale=None):
    """Twin of `_attention_xla` (attention.py:34-87).
    q: [B,H,Sq,D]; k/v: [B,H,Sk,D]. Products accumulate in f32. With
    k_scale/v_scale ([B,H,Sk] f32) k and v are int8 codes: the K scale
    folds into the logits, the V scale into the probabilities before they
    are rounded to q's dtype."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if k_scale is not None:
        logits = logits * k_scale[:, :, None, :].float()
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        # q_start is the absolute KV position of query 0; without it the
        # queries are the LAST Sq valid tokens (attention.py:60-69)
        if q_start is not None:
            offs = q_start
        elif kv_lens is not None:
            offs = kv_lens - Sq
        else:
            offs = torch.full((B,), Sk - Sq, dtype=torch.int64, device=q.device)
        qi = (torch.arange(Sq, device=q.device)[None, :, None]
              + offs.to(q.device).view(B, 1, 1))
        ki = torch.arange(Sk, device=q.device)[None, None, :]
        logits = torch.where((qi >= ki)[:, None], logits, NEG_INF)
    if kv_lens is not None:
        valid = (torch.arange(Sk, device=q.device)[None, :]
                 < kv_lens.to(q.device)[:, None])
        logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    if kv_mask is not None:
        logits = torch.where(kv_mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        probs = (probs * v_scale[:, :, None, :].float()).to(q.dtype)
    else:
        probs = probs.to(v.dtype)
    out = torch.matmul(probs.float(), v.float())
    return out.to(q.dtype)


def _decode_attention_q8_plain(q, k, v, k_scale, v_scale, *, sm_scale: float,
                               kv_lens=None, layer=None, causal: bool = False,
                               bias=None, kv_mask=None, q_start=None):
    """Twin of K4 and of the JAX fallback (attention.py:1276-1294): take the
    layer's slab if the cache is stacked, view the token-major int8 rows
    head-major, repeat the kv heads for GQA, and run the scale-folding path
    of `_attention_plain`. q: [B,Hq,Sq,hd]; k/v: [(L,) B, C, Hkv*hd] int8;
    k_scale/v_scale: [(L,) B, Hkv, C] f32."""
    if k.dim() == 4:
        k, v, k_scale, v_scale = (t[layer] for t in (k, v, k_scale, v_scale))
    B, Hq, _, hd = q.shape
    Hkv, C = k_scale.shape[-2], k.shape[-2]
    k = k.view(B, C, Hkv, hd).transpose(1, 2)
    v = v.view(B, C, Hkv, hd).transpose(1, 2)
    if Hq != Hkv:
        rep = Hq // Hkv
        k, v, k_scale, v_scale = (t.repeat_interleave(rep, dim=1)
                                  for t in (k, v, k_scale, v_scale))
    return _attention_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                            kv_lens=kv_lens, bias=bias, kv_mask=kv_mask,
                            q_start=q_start, k_scale=k_scale, v_scale=v_scale)


def _attention_plain_bshd(q, k, v, sm_scale: float, win: int = 0):
    """Twin of `_attention_xla_bshd` (attention.py:846-856).
    q: [B,Sq,H,D]; k/v: [B,Sk,H,D] -> [B,Sq,H,D]."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if win and win < k.shape[1]:
        row = torch.arange(q.shape[1], device=q.device)[:, None] // win
        col = torch.arange(k.shape[1], device=q.device)[None, :] // win
        logits = torch.where((row == col)[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# K1 launcher
# ---------------------------------------------------------------------------
def _kernel_fn():
    built = _cuda.load("attention_fwd")
    fn = built.lib.vgt_attention_fwd
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [P, P, P, P] + [L] * 12 + [P, P] + [I] * 7 + [
            ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def _as_int32(t, B: int, device):
    if t is None:
        return None
    t = t.to(device=device, dtype=torch.int32).reshape(B).contiguous()
    return t


def attention_fwd_kernel(q, k, v, out, *, causal: bool, sm_scale: float,
                         mode: str, kv_lens=None, q_start=None, win: int = 0):
    """Launch K1. q: [B,H,Sq,D], k/v: [B,H,Sk,D], out: [B,H,Sq,D] — any
    strides with a contiguous head dim (views of BSHD or fused-qkv tensors
    are read in place). kv_lens/q_start: [B] ints or None. `mode` names the
    launch counter. Raises unless every operand is a bf16 CUDA tensor."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _cuda.check_operand(t, name, torch.bfloat16)
    if k.shape != (B, H, Sk, D) or v.shape != k.shape or out.shape != q.shape:
        raise ValueError(f"attention_fwd: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"out{tuple(out.shape)}")
    if D % 8 or D > 128:
        raise ValueError(f"attention_fwd: head dim {D} unsupported "
                         "(needs D % 8 == 0 and D <= 128)")
    if causal and q_start is None:
        raise ValueError("attention_fwd: causal launches need q_start")
    kvl = _as_int32(kv_lens, B, q.device)
    qs = _as_int32(q_start, B, q.device)
    err = _kernel_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        kvl.data_ptr() if kvl is not None else None,
        qs.data_ptr() if qs is not None else None,
        B, H, Sq, Sk, D, int(causal), int(win), float(sm_scale),
        _cuda.stream_ptr(q))
    _cuda.check_launch(err, "attention_fwd")
    LAUNCHES[mode] += 1
    return out


# ---------------------------------------------------------------------------
# K4 launcher
# ---------------------------------------------------------------------------
def _decode_fn():
    fn = _cuda.load("decode_attention_q8").lib.vgt_decode_attention_q8
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [P, L, L, P, P, P, P, P, P, L, L, P, P] + [I] * 7 + [
            ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def decode_attention_q8(q, k, v, k_scale, v_scale, kv_lens, layer=None, *,
                        sm_scale: float):
    """Launch K4. q: [B,Hq,1,hd] bf16 (q head i reads kv head i // G);
    k/v: the token-major int8 cache, one layer's slab [B,C,Hkv*hd] or the
    stacked [L,B,C,Hkv*hd] with `layer` an int, read in place; k_scale /
    v_scale: [(L,) B,Hkv,C] f32; kv_lens: [B] ints on the device.
    Returns [B,Hq,1,hd] bf16. Supports hd % 16 == 0, hd <= 128,
    Hkv*hd <= 4096 and G = Hq/Hkv in (1, 2, 4); raises otherwise, and
    unless q is a bf16 CUDA tensor."""
    B, Hq, Sq, hd = q.shape
    if k.dim() == 3:
        k, v, k_scale, v_scale = (t[None] for t in (k, v, k_scale, v_scale))
        layer = 0
    L, _, C, HD = k.shape
    Hkv = k_scale.shape[-2]
    _cuda.check_operand(q, "q", torch.bfloat16)
    if Sq != 1 or HD != Hkv * hd or v.shape != k.shape or k.shape[1] != B \
            or k_scale.shape != (L, B, Hkv, C) or v_scale.shape != k_scale.shape:
        raise ValueError(f"decode_attention_q8: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"k_scale{tuple(k_scale.shape)} "
                         f"v_scale{tuple(v_scale.shape)}")
    G = Hq // Hkv
    if hd % 16 or hd > 128 or HD > 4096 or Hq != G * Hkv or G not in (1, 2, 4):
        raise ValueError(f"decode_attention_q8: head dim {hd}, Hkv*hd {HD}, "
                         f"Hq/Hkv {Hq}/{Hkv} unsupported (needs hd % 16 == 0, "
                         "hd <= 128, Hkv*hd <= 4096, Hq/Hkv in 1, 2, 4)")
    if layer is None or not 0 <= int(layer) < L:
        raise ValueError(f"decode_attention_q8: layer {layer} of {L}")
    for name, t, dt in (("k", k, torch.int8), ("v", v, torch.int8),
                        ("k_scale", k_scale, torch.float32),
                        ("v_scale", v_scale, torch.float32)):
        if t.device != q.device or t.dtype != dt or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"decode_attention_q8: {name} must be a "
                             f"contiguous {dt} tensor on {q.device}")
    kvl = _as_int32(kv_lens, B, q.device)
    # launch geometry (mirrors the kernel): R tokens in parallel per block
    # for narrow rows; one split of the cache axis per SM, at least R tokens
    R = max(1, 256 // (HD // 16))
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    nsplit = max(1, min(-(-C // R), sms * DECODE_SPLITS_PER_SM // B))
    out = torch.empty((B, Hq, 1, hd), dtype=q.dtype, device=q.device)
    part_acc = torch.empty((B, Hq, nsplit * R, hd), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, Hq, nsplit * R, 2), dtype=torch.float32,
                          device=q.device)
    err = _decode_fn()(
        q.data_ptr(), q.stride(0), q.stride(1), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), kvl.data_ptr(),
        out.data_ptr(), out.stride(0), out.stride(1), part_acc.data_ptr(),
        part_ml.data_ptr(), int(layer), B, Hq, Hkv, C, hd, nsplit,
        float(sm_scale), _cuda.stream_ptr(q))
    _cuda.check_launch(err, "decode_attention_q8")
    LAUNCHES["decode_q8"] += 1
    return out


# ---------------------------------------------------------------------------
# entries
# ---------------------------------------------------------------------------
def flash_attention(q, k, v, *, causal: bool = False, kv_lens=None,
                    q_start=None, sm_scale: Optional[float] = None):
    """Port of `flash_attention` (attention.py:504). q/k/v: [B,H,S,D].
    q_start: [B] absolute KV position of query 0 (defaults to
    kv_lens - Sq, the decode convention)."""
    B, H, Sq, D = q.shape
    if sm_scale is None:
        sm_scale = D ** -0.5
    if kv_lens is None:
        kv_lens = torch.full((B,), k.shape[2], dtype=torch.int32,
                             device=q.device)
    if q_start is None:
        q_start = kv_lens - Sq
    if q.device.type == "cpu":
        return _attention_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                                kv_lens=kv_lens, q_start=q_start)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return attention_fwd_kernel(q, k, v, out, causal=causal, sm_scale=sm_scale,
                                mode="causal" if causal else "flash",
                                kv_lens=kv_lens, q_start=q_start)


def _bshd_fwd(q, k, v, sm_scale: float, win: int = 0):
    """K1 in BSHD mode: q/k/v [B,S,H,D] (views allowed) -> [B,S,H,D]."""
    if q.device.type == "cpu":
        return _attention_plain_bshd(q, k, v, sm_scale, win)
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    attention_fwd_kernel(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), out.transpose(1, 2),
                         causal=False, sm_scale=sm_scale, mode="bshd", win=win)
    return out


def attention_bshd(q, k, v, *, sm_scale: Optional[float] = None):
    """Full non-causal self-attention in [B,S,H,D] (port of
    attention_bshd, attention.py:985). Returns [B,S,H,D]."""
    B, S, H, D = q.shape
    if sm_scale is None:
        sm_scale = D ** -0.5
    # attention.py:997
    if q.is_cuda and 128 <= S <= 1536 and D <= 128:
        return _bshd_fwd(q, k, v, float(sm_scale))
    return _attention_plain_bshd(q, k, v, sm_scale)


def attention_packed_qkv_padded(qkv, num_heads: int, head_dim: int, *,
                                win: int = 0,
                                sm_scale: Optional[float] = None):
    """Port of attention_packed_qkv_padded (attention.py:968). The JAX
    entry takes heads pre-padded to 128 lanes, which is a TPU layout device.
    This port takes the UNPADDED fused qkv [B,S,3*H*hd] and returns
    [B,S,H*hd]. win > 0 = block-diagonal attention over win-token windows."""
    B, S, _ = qkv.shape
    if sm_scale is None:
        sm_scale = head_dim ** -0.5
    x = qkv.view(B, S, 3, num_heads, head_dim)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    # attention.py:980
    if qkv.is_cuda and 128 <= S <= 1536:
        o = _bshd_fwd(q, k, v, float(sm_scale), win)
    else:
        o = _attention_plain_bshd(q, k, v, sm_scale, win)
    return o.reshape(B, S, num_heads * head_dim)


def attention_bshd_cross(q, k, v, *, sm_scale: Optional[float] = None):
    """Cross-length BSHD attention (Sq != Sk) of the pooled-query Hiera
    blocks. JAX runs it on XLA (attention.py:1020-1028), so it stays plain."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _attention_plain_bshd(q, k, v, float(sm_scale))


def dot_product_attention(q, k, v, *, causal: bool = False, kv_lens=None,
                          kv_mask=None, bias=None, q_start=None,
                          sm_scale: Optional[float] = None,
                          k_scale=None, v_scale=None, layer=None):
    """Attention entry used by every model stack (attention.py:1231).
    q/k/v: [B,H,S,D]; kv_mask: [B,Sk] bool, True = attendable.

    With k_scale/v_scale (the int8 KV cache) k and v arrive as int8,
    token-major and unrepeated: one layer's slab [B,C,Hkv*hd] or the stacked
    cache [L,B,C,Hkv*hd] with `layer` an int. Decode (Sq == 1) on a CUDA
    tensor launches K4 or raises; it never takes the plain twin. Sq == 1
    with causal and q_start == kv_len - 1 reduces to the kv_lens mask that
    K4 applies."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together (the int8 KV cache)")
    if k_scale is not None:
        if k.dim() == 4 and layer is None:
            raise ValueError("a stacked int8 cache [L,B,C,Hkv*hd] needs `layer`")
        if q.is_cuda and q.shape[2] == 1:
            if bias is not None or kv_mask is not None or kv_lens is None:
                raise ValueError("int8-cache decode attention on the card "
                                 "takes kv_lens and no bias or kv_mask")
            return decode_attention_q8(q, k, v, k_scale, v_scale, kv_lens,
                                       layer, sm_scale=float(sm_scale))
        # CPU tensors, and Sq > 1, which the JAX package leaves to XLA
        # (attention.py:1276)
        return _decode_attention_q8_plain(
            q, k, v, k_scale, v_scale, sm_scale=sm_scale, kv_lens=kv_lens,
            layer=layer, causal=causal, bias=bias, kv_mask=kv_mask,
            q_start=q_start)
    # attention.py:1295: biased / per-token-masked attention and non-device
    # tensors stay plain
    if bias is not None or kv_mask is not None or not q.is_cuda:
        return _attention_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                                kv_lens=kv_lens, bias=bias, kv_mask=kv_mask,
                                q_start=q_start)
    Sq, Sk = q.shape[2], k.shape[2]
    # attention.py:1308-1310 sends medium non-causal self-attention to the
    # single-block `_window_kernel`; K1 serves that branch here
    if (not causal and kv_lens is None and q_start is None and Sq == Sk
            and 512 < Sq <= 1536):
        return flash_attention(q, k, v, sm_scale=sm_scale)
    # attention.py:1315: short and windowed shapes stay plain
    long_enough = Sq >= 1024 and Sk >= 1024 and (causal or Sq >= 2048)
    if not long_enough:
        return _attention_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                                kv_lens=kv_lens, q_start=q_start)
    return flash_attention(q, k, v, causal=causal, kv_lens=kv_lens,
                           q_start=q_start, sm_scale=sm_scale)
