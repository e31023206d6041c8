"""V->L and L->V adapters (PyTorch port of videoglamm_tpu/models/
projectors.py). Reference checkpoint layouts: `mm_projector` is a
Sequential (Linear, GELU, Linear); `text_hidden_fcs.0` is a Sequential
(Linear, ReLU, Linear)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def build_vision_projector(projector_type: str, in_dim: int,
                           out_dim: int) -> nn.Module:
    if projector_type == "identity":
        return nn.Identity()
    if projector_type == "linear":
        return nn.Linear(in_dim, out_dim)
    if projector_type == "mlp2x_gelu":
        # erf GELU in every dtype (projectors.py:33-36)
        return nn.Sequential(nn.Linear(in_dim, out_dim), nn.GELU(),
                             nn.Linear(out_dim, out_dim))
    raise ValueError(f"unknown projector {projector_type}")


class TextHiddenFCs(nn.Sequential):
    """[SEG] hidden states -> SAM prompt space (out_dim 256), run in f32."""

    def __init__(self, dim: int, out_dim: int = 256):
        super().__init__(nn.Linear(dim, dim), nn.ReLU(), nn.Linear(dim, out_dim))


def _pool_tokens(tokens, output_size):
    """[N, g*g, C] square token grid -> [N, oh*ow, C] with torch's adaptive
    average pooling bins, in f32 (ops/pooling.py)."""
    N, L, C = tokens.shape
    g = int(round(L ** 0.5))
    assert g * g == L, f"token count {L} is not a square"
    x = tokens.float().view(N, g, g, C).permute(0, 3, 1, 2)
    y = F.adaptive_avg_pool2d(x, output_size)
    oh, ow = output_size
    return y.permute(0, 2, 3, 1).reshape(N, oh * ow, C).to(tokens.dtype)


def build_visual_prefix(video_tokens, context_tokens, *, chunk_size: int,
                        video_pool, context_pool):
    """video_tokens [B, T, Lv, H], context_tokens [B, T, Lc, H] (both
    projected) -> [B, T*pc + T*pv, H], context tokens first."""
    B, T, Lv, H = video_tokens.shape
    pooled_video = _pool_tokens(video_tokens.reshape(B * T, Lv, H), video_pool)
    pooled_video = pooled_video.reshape(B, T * video_pool[0] * video_pool[1], H)
    Lc = context_tokens.shape[2]
    pooled_ctx = _pool_tokens(context_tokens.reshape(B * T, Lc, H), context_pool)
    pooled_ctx = pooled_ctx.reshape(B, T * context_pool[0] * context_pool[1], H)
    return torch.cat([pooled_ctx, pooled_video], dim=1)
