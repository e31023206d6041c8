"""Static-shape KV cache for the Phi-3 decoder (PyTorch port of
videoglamm_tpu/models/kvcache.py).

bf16 cache: [L, B, Hkv, max_len, hd], attention-ready.

int8 cache (`quant_kv=True`): K and V are stored per token and per head as
symmetric int8 with f32 scales [L, B, Hkv, max_len], in a TOKEN-MAJOR flat
layout [L, B, max_len, Hkv*hd]: one contiguous row per token, which is what
the decode kernel K4 (`csrc/decode_attention_q8.cu`) streams and what a
decode step writes. Decode is bound by the bytes it reads; the int8 cache
halves the cache's share of them and its residency. Nothing dequantises
the cache into memory at decode: K4 folds the scales into the logits and
the probabilities.

Unlike the JAX arrays, the port's cache is updated IN PLACE: each write is
an indexed store into the preallocated buffers with device-side indices,
so no cache copy exists per step and no write synchronises with the host.
"""
from __future__ import annotations

import torch


def init_cache(num_layers: int, batch: int, num_kv_heads: int, max_len: int,
               head_dim: int, dtype=torch.bfloat16, device=None,
               quant_kv: bool = False):
    shape = (num_layers, batch, num_kv_heads, max_len, head_dim)
    if not quant_kv:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    flat = (num_layers, batch, max_len, num_kv_heads * head_dim)
    return {"k": torch.zeros(flat, dtype=torch.int8, device=device),
            "v": torch.zeros(flat, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device)}


def _quantize(x):
    """[..., H, S, hd] -> (int8 same shape, f32 [..., H, S]) per token and head:
    amax / 127, scale 1.0 on all-zero rows (kvcache.py:53)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def write(cache, layer_idx: int, kn, vn, starts):
    """Store this block's K/V at each row's start position, in place.
    kn/vn: [B, Hkv, S, hd]; starts: [B] (positions are contiguous per row).
    Device-side indices: no host sync."""
    B, Hkv, S, hd = kn.shape
    dev = cache["k"].device
    rows = torch.arange(B, device=dev)[:, None]
    cols = starts.to(dev)[:, None] + torch.arange(S, device=dev)[None, :]
    if "k_scale" in cache:
        # K and V in one pass (half the launches of a decode step's write);
        # token-major flat rows [2, B, S, Hkv*hd], scales [2, B, S, Hkv]
        q, s = _quantize(torch.stack([kn, vn]))
        q = q.transpose(2, 3).reshape(2, B, S, Hkv * hd)
        s = s.transpose(2, 3)
        for i, name in enumerate(("k", "v")):
            cache[name][layer_idx][rows, cols] = q[i]
            cache[f"{name}_scale"][layer_idx][rows, :, cols] = s[i]
        return cache
    for name, val in (("k", kn), ("v", vn)):
        buf = cache[name][layer_idx]            # [B, Hkv, C, hd] view
        buf[rows, :, cols] = val.transpose(1, 2).to(buf.dtype)
    return cache


def update_and_fetch(cache, layer_idx: int, kn, vn, starts, compute_dtype):
    """Write, then return (cache, k_att, v_att, k_scale, v_scale)
    (kvcache.py:95).

    bf16 cache: this layer's [B, Hkv, C, hd] slabs (views, no copy), scales
    None. int8 cache, decode (S == 1): the FULL stacked int8 buffers and
    stacked scales, untouched; the caller passes `layer_idx` on to the
    attention, and K4 selects the layer by pointer offset. int8 cache,
    S > 1: one dequantised head-major slab of this layer in
    `compute_dtype`, scales None."""
    cache = write(cache, layer_idx, kn, vn, starts)
    B, Hkv, S, hd = kn.shape
    if "k_scale" not in cache:
        return cache, cache["k"][layer_idx], cache["v"][layer_idx], None, None
    if S == 1:
        return cache, cache["k"], cache["v"], cache["k_scale"], cache["v_scale"]
    C = cache["k"].shape[2]
    out = []
    for name in ("k", "v"):
        slab = cache[name][layer_idx].view(B, C, Hkv, hd).transpose(1, 2)
        scale = cache[f"{name}_scale"][layer_idx][..., None]
        out.append(slab.to(compute_dtype) * scale.to(compute_dtype))
    return cache, out[0], out[1], None, None
