"""SAM-2 image encoder = Hiera trunk + FPN neck (PyTorch port of
videoglamm_tpu/models/sam2/fpn.py). 1x1 lateral convs to d_model, 2x
nearest top-down at the configured levels (in f32), sine PE per level,
`scalp` drops the lowest-resolution level."""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ...config import SAM2Config
from .hiera import Hiera
from .pos_enc import sine_pe


def conv1x1_nhwc(x, conv: nn.Conv2d):
    """A 1x1 Conv2d applied channels-last as a linear."""
    return F.linear(x, conv.weight[:, :, 0, 0], conv.bias)


class _Lateral(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1)


class FpnNeck(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.cfg = cfg
        # convs[j] consumes the (n-j)-th resolution level
        self.convs = nn.ModuleList(_Lateral(c, cfg.d_model)
                                   for c in cfg.hiera.channel_list)

    def forward(self, xs):
        """xs: trunk features, highest resolution first ->
        (features, pos), highest resolution first."""
        cfg = self.cfg
        n = len(xs) - 1
        out, pos = [None] * len(xs), [None] * len(xs)
        prev = None
        for i in range(n, -1, -1):
            conv = self.convs[n - i].conv
            lateral = conv1x1_nhwc(xs[i].to(conv.weight.dtype), conv)
            if i in cfg.fpn_top_down_levels and prev is not None:
                h, w = lateral.shape[1], lateral.shape[2]
                top_down = F.interpolate(prev.float().permute(0, 3, 1, 2),
                                         size=(h, w), mode="nearest")
                prev = lateral + top_down.permute(0, 2, 3, 1).to(lateral.dtype)
            else:
                prev = lateral
            out[i] = prev
            pos[i] = sine_pe(prev.shape[1], prev.shape[2], cfg.d_model,
                             prev.device)
        return out, pos


class SAM2ImageEncoder(nn.Module):
    """forward(images [B, H, W, 3]) -> (features, pos), channels-last,
    highest resolution first."""

    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.cfg = cfg
        self.trunk = Hiera(cfg.hiera)
        self.neck = FpnNeck(cfg)

    def forward(self, images):
        feats, pos = self.neck(self.trunk(images))
        if self.cfg.backbone_scalp > 0:
            feats = feats[: -self.cfg.backbone_scalp]
            pos = pos[: -self.cfg.backbone_scalp]
        return feats, pos
