"""Rotary position embeddings (PyTorch port of videoglamm_tpu/ops/rope.py):
the half-rotation 1-D RoPE of the LLM (rope.py:15-48), its Llama-3.1
frequency rescaling (videoglamm_tpu/models/llama.py:25) and the 2-D axial
RoPE of SAM-2 memory attention (rope.py:54-92)."""
from __future__ import annotations

import functools

import numpy as np
import torch


def rope_cos_sin(positions, head_dim: int, theta: float = 10000.0):
    """positions: [...] int -> cos, sin: [..., head_dim] f32 (frequencies
    tiled twice, HF layout). The frequencies are computed in f64 on the
    positions' device (as rope.py:15-16 does in numpy): a host table would
    cost a blocking copy per call."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float64,
                        device=positions.device) / head_dim
    inv = (1.0 / theta ** exps).float()
    ang = positions.float()[..., None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


@functools.lru_cache(maxsize=8)
def _llama31_inv_freq_np(head_dim: int, theta: float, factor: float,
                         low_freq_factor: float, high_freq_factor: float,
                         original_max_position: int):
    """The rescaled frequency table, numpy f64 on the host (llama.py:30-40),
    once per geometry."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    low_wavelen = original_max_position / low_freq_factor
    high_wavelen = original_max_position / high_freq_factor
    wavelen = 2 * np.pi / inv_freq
    scaled = np.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
    smooth = (original_max_position / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor)
    mid = (1 - smooth) / factor * inv_freq + smooth * inv_freq
    is_mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
    return np.where(is_mid, mid, scaled).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _llama31_inv_freq_on(device, *geometry):
    return torch.from_numpy(_llama31_inv_freq_np(*geometry)).to(device)


def llama31_rope_cos_sin(positions, head_dim: int, theta: float,
                         factor: float = 8.0, low_freq_factor: float = 1.0,
                         high_freq_factor: float = 4.0,
                         original_max_position: int = 8192):
    """Llama-3.1 RoPE (HF rope_scaling type "llama3", llama.py:25): long
    wavelengths are slowed by `factor`, short ones kept, the band between
    blended. positions: [...] int -> cos, sin: [..., head_dim] f32. The
    table is made once per geometry and kept on the positions' device."""
    inv = _llama31_inv_freq_on(positions.device, int(head_dim), float(theta),
                               float(factor), float(low_freq_factor),
                               float(high_freq_factor),
                               int(original_max_position))
    ang = positions.float()[..., None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rope(x, cos, sin):
    """x: [B, H, S, D]; cos/sin: [S, D] or [B, S, D]. Computed in x's dtype,
    as HF casts the tables to the query dtype (rope.py:33-48)."""
    if cos.ndim == 2:
        cos, sin = cos[None, None], sin[None, None]
    elif cos.ndim == 3:
        cos, sin = cos[:, None], sin[:, None]
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    return x * cos + rotate_half(x) * sin


# ---------------------------------------------------------------------------
# 2-D axial RoPE (SAM-2 memory attention / RoPEAttention)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=16)
def _axial_cis_np(dim: int, end_x: int, end_y: int, theta: float):
    """Complex rotation table over an (end_x, end_y) grid; `dim` is the
    per-head dim. Half of it rotates with the x coordinate, half with y
    (rope.py:55-67, f64 on the host, once per geometry)."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 4)[: dim // 4].astype(np.float64)
                             / dim))
    t = np.arange(end_x * end_y, dtype=np.float64)
    fx = np.outer(t % end_x, freqs)
    fy = np.outer(t // end_x, freqs)
    cis = np.concatenate([np.exp(1j * fx), np.exp(1j * fy)], axis=-1)
    return cis.astype(np.complex64)                       # [L, dim/2]


@functools.lru_cache(maxsize=16)
def _axial_cos_sin_on(dim: int, end_x: int, end_y: int, theta: float, device):
    cis = _axial_cis_np(dim, end_x, end_y, theta)
    return (torch.from_numpy(np.ascontiguousarray(cis.real)).to(device),
            torch.from_numpy(np.ascontiguousarray(cis.imag)).to(device))


def axial_rope_cos_sin(dim: int, end_x: int, end_y: int, theta: float = 10000.0,
                       device=None):
    """cos, sin: [end_x*end_y, dim/2] f32 on `device`. The table is copied
    to a device once and kept: the tracker asks for it at every layer of
    every frame."""
    return _axial_cos_sin_on(dim, end_x, end_y, float(theta),
                             torch.device(device or "cpu"))


def apply_axial_rope(x, cos, sin):
    """Interleaved complex rotation in f32 (rope.py:75-92). x: [B,H,S,D]
    with D even; the pair (x[2i], x[2i+1]) of token s rotates by table row
    s % L, so a sequence longer than the table (the k-repeat over memory
    frames) sees it tiled."""
    B, H, S, D = x.shape
    L = cos.shape[0]
    if S != L:
        reps = -(-S // L)
        cos = cos.repeat(reps, 1)[:S]
        sin = sin.repeat(reps, 1)[:S]
    xf = x.float().reshape(B, H, S, D // 2, 2)
    xr, xi = xf[..., 0], xf[..., 1]
    y = torch.stack([xr * cos - xi * sin, xr * sin + xi * cos], dim=-1)
    return y.reshape(B, H, S, D).to(x.dtype)
