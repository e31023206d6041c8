"""InternVideo2-1B video encoder (PyTorch port of
videoglamm_tpu/models/internvideo2.py).

Parameter names follow the reference checkpoint (`patch_embed.proj`,
`blocks.{i}.attn.qkv`, `ls1.gamma`, ...). The fusion path runs blocks
0..depth-2 and returns the patch tokens without the cls token.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import InternVideo2Config
from ..ops.attention import attention_bshd, attention_packed_qkv_padded
from .common import RMSNorm, patchify_conv


# the fusion path returns the tokens after blocks 0..depth-2
# (internvideo2.py:207; reference utils.py:230-239)
X_VIS_RETURN_IDX = -2


def sincos_3d_pos_embed(embed_dim: int, grid_hw: int, t_size: int,
                        cls_token: bool = True) -> np.ndarray:
    """Joint 3D sin-cos position embedding (internvideo2.py:51-79)."""
    assert embed_dim % 4 == 0

    def sincos_1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid = np.meshgrid(np.arange(grid_hw, dtype=np.float32),
                       np.arange(grid_hw, dtype=np.float32))
    grid = np.stack(grid, axis=0).reshape(2, 1, grid_hw, grid_hw)
    d_spatial = embed_dim // 4 * 3
    emb_h = sincos_1d(d_spatial // 2, grid[0])
    emb_w = sincos_1d(d_spatial // 2, grid[1])
    pos_spatial = np.concatenate([emb_h, emb_w], axis=1)
    pos_t = sincos_1d(embed_dim // 4, np.arange(t_size, dtype=np.float32))
    pos_t = np.repeat(pos_t[:, None, :], grid_hw * grid_hw, axis=1)
    pos_spatial = np.repeat(pos_spatial[None], t_size, axis=0)
    pos = np.concatenate([pos_t, pos_spatial], axis=-1)
    pos = pos.reshape(t_size * grid_hw * grid_hw, embed_dim)
    if cls_token:
        pos = np.concatenate([np.zeros((1, embed_dim)), pos], axis=0)
    return pos.astype(np.float32)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x, residual):
        # applied in f32 (internvideo2.py:146-148, :156-158)
        return residual + (x.float() * self.gamma.float()).to(residual.dtype)


class _Attention(nn.Module):
    def __init__(self, cfg: InternVideo2Config):
        super().__init__()
        D = cfg.embed_dim
        self.qkv = nn.Linear(D, 3 * D, bias=cfg.qkv_bias)
        if cfg.qk_normalization:
            self.q_norm = RMSNorm(D, cfg.rms_eps)
            self.k_norm = RMSNorm(D, cfg.rms_eps)
        self.proj = nn.Linear(D, D)


class _FusedMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        # tanh GELU in every dtype: the reference runs flash-attn's FusedMLP
        # (internvideo2.py:152-154)
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class InternVideo2Block(nn.Module):
    """Pre-RMSNorm block with QK-RMSNorm over the FULL flattened dim and
    f32 LayerScale (internvideo2.py:96-158)."""

    exact_f32 = False      # models.common.set_exact_f32

    def __init__(self, cfg: InternVideo2Config):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        self.norm1 = RMSNorm(D, cfg.rms_eps)
        self.attn = _Attention(cfg)
        self.ls1 = LayerScale(D, cfg.init_values)
        self.norm2 = RMSNorm(D, cfg.rms_eps)
        self.mlp = _FusedMlp(D, int(D * cfg.mlp_ratio))
        self.ls2 = LayerScale(D, cfg.init_values)

    def forward(self, x):
        cfg = self.cfg
        B, N, D = x.shape
        nh = cfg.num_heads
        hd = D // nh
        qkv = self.attn.qkv(self.norm1(x))
        if cfg.qk_normalization:
            q, k, v = qkv.split(D, dim=-1)
            q = self.attn.q_norm(q)
            k = self.attn.k_norm(k)
            qkv = torch.cat([q, k, v], dim=-1)
        if 64 <= hd < 128:
            # internvideo2.py:110: JAX's head-padded route; the port reads
            # the unpadded fused qkv in place
            o = attention_packed_qkv_padded(qkv, nh, hd,
                                            exact=self.exact_f32)
        else:
            x5 = qkv.view(B, N, 3, nh, hd)
            o = attention_bshd(x5[:, :, 0], x5[:, :, 1], x5[:, :, 2],
                               exact=self.exact_f32)
            o = o.reshape(B, N, D)
        x = self.ls1(self.attn.proj(o), x)
        return self.ls2(self.mlp(self.norm2(x)), x)


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: InternVideo2Config):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv3d(3, cfg.embed_dim, (cfg.tubelet_size, p, p),
                              stride=(cfg.tubelet_size, p, p))


class InternVideo2Tower(nn.Module):
    """forward(frames [B, T, H, W, 3]) -> [B, T*tokens_per_frame, D] patch
    tokens (cls dropped). T must equal cfg.num_frames."""

    def __init__(self, cfg: InternVideo2Config):
        super().__init__()
        assert cfg.tubelet_size == 1, "tubelet_size != 1 is not supported"
        self.cfg = cfg
        D = cfg.embed_dim
        t_grid = cfg.num_frames // cfg.tubelet_size
        self.patch_embed = _PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.from_numpy(
            sincos_3d_pos_embed(D, cfg.grid, t_grid))[None])
        n_run = cfg.depth + X_VIS_RETURN_IDX + 1
        assert 0 < n_run <= cfg.depth
        self.blocks = nn.ModuleList(InternVideo2Block(cfg) for _ in range(n_run))

    def forward(self, frames):
        cfg = self.cfg
        B, T, H, W, _ = frames.shape
        assert T == cfg.num_frames, (T, cfg.num_frames)
        D = cfg.embed_dim
        w = self.patch_embed.proj.weight
        dt = w.dtype
        # tubelet 1: the 3D patch conv is a per-frame 2D patchify
        x = patchify_conv(frames.reshape(B * T, H, W, 3).to(dt), w[:, :, 0],
                          self.patch_embed.proj.bias, cfg.patch_size)
        x = x.reshape(B, T * cfg.tokens_per_frame, D)
        x = torch.cat([self.cls_token.to(dt).expand(B, 1, D), x], dim=1)
        x = x + self.pos_embed.to(dt)
        for blk in self.blocks:
            x = blk(x)
        return x[:, 1:]
