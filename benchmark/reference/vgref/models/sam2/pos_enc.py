"""Position encodings for the SAM-2 stack (PyTorch port of
videoglamm_tpu/models/sam2/pos_enc.py): the normalised sine grid of the
FPN levels and the random-Fourier PE of the prompt encoder, both built on
the device."""
from __future__ import annotations

import math

import torch


def sine_pe(h: int, w: int, channels: int, device=None) -> torch.Tensor:
    """[h, w, channels] PositionEmbeddingSine (channels-last), normalised,
    temperature 1e4 (pos_enc.py:19-44). Built in f64 on `device`: at 256^2
    x 256 channels a host table would be a 64 MB blocking copy per call."""
    f64 = dict(dtype=torch.float64, device=device)
    half = channels // 2
    eps, scale = 1e-6, 2 * math.pi
    y = torch.arange(1, h + 1, **f64) / (h + eps) * scale
    x = torch.arange(1, w + 1, **f64) / (w + eps) * scale
    dim_t = torch.arange(half, **f64)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / half)

    def interleave(p):      # sin on even, cos on odd feature pairs
        return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()],
                           dim=-1).flatten(-2)

    py = interleave(y[:, None, None] / dim_t).expand(h, w, half)
    px = interleave(x[None, :, None] / dim_t).expand(h, w, half)
    return torch.cat([py, px], dim=-1).float()


def random_pe_grid(gauss_matrix, h: int, w: int) -> torch.Tensor:
    """[h, w, C] PositionEmbeddingRandom over a grid; gauss: [2, C/2]."""
    dev = gauss_matrix.device
    y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    gy, gx = torch.meshgrid(y, x, indexing="ij")
    c = 2.0 * torch.stack([gx, gy], dim=-1) - 1.0
    c = 2.0 * math.pi * (c @ gauss_matrix.float())
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)
