"""1D rotary position embeddings for the LLM (PyTorch port of the
half-rotation RoPE in videoglamm_tpu/ops/rope.py:15-48). The 2-D axial
RoPE of SAM-2 memory attention comes with the tracking branch."""
from __future__ import annotations

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
