"""Plain RMSNorm and LayerNorm over the last dim, f32 statistics."""
from __future__ import annotations

import torch


def rms_norm(x, weight, eps: float = 1e-6):
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * weight.float()).to(x.dtype)


def layer_norm(x, weight, bias=None, eps: float = 1e-5):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)
