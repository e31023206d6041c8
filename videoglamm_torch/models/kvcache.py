"""Static-shape bf16 KV cache for the Phi-3 decoder (PyTorch port of the
bf16 path of videoglamm_tpu/models/kvcache.py).

Layout [L, B, Hkv, max_len, hd], attention-ready. Unlike the JAX arrays,
the port's cache is updated IN PLACE: each write is an indexed store into
the preallocated buffers, so no cache copy exists per step. The int8
token-major cache comes with the int8 decode kernel (ROADMAP.md).
"""
from __future__ import annotations

import torch


def init_cache(num_layers: int, batch: int, num_kv_heads: int, max_len: int,
               head_dim: int, dtype=torch.bfloat16, device=None):
    shape = (num_layers, batch, num_kv_heads, max_len, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write(cache, layer_idx: int, kn, vn, starts):
    """Store this block's K/V at each row's start position, in place.
    kn/vn: [B, Hkv, S, hd]; starts: [B] (positions are contiguous per row).
    Device-side indices: no host sync."""
    B, Hkv, S, hd = kn.shape
    dev = cache["k"].device
    rows = torch.arange(B, device=dev)[:, None]
    cols = starts.to(dev)[:, None] + torch.arange(S, device=dev)[None, :]
    for name, val in (("k", kn), ("v", vn)):
        buf = cache[name][layer_idx]            # [B, Hkv, C, hd] view
        buf[rows, :, cols] = val.transpose(1, 2).to(buf.dtype)
    return cache


def update_and_fetch(cache, layer_idx: int, kn, vn, starts):
    """Write, then return (cache, k, v) with this layer's [B, Hkv, C, hd]
    slabs (views of the cache, no copy)."""
    cache = write(cache, layer_idx, kn, vn, starts)
    return cache, cache["k"][layer_idx], cache["v"][layer_idx]
