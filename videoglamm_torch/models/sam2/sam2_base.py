"""SAM-2 composition for framewise decoding (PyTorch port of the image
encoder, prompt encoder and mask decoder parts of
videoglamm_tpu/models/sam2/sam2_base.py; memory encoder, memory attention
and the tracking parameters come with the video branch)."""
from __future__ import annotations

from torch import nn

from ...config import SAM2Config
from .fpn import SAM2ImageEncoder, conv1x1_nhwc
from .mask_decoder import MaskDecoder
from .prompt_encoder import PromptEncoder


class SAM2Base(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = SAM2ImageEncoder(cfg)
        self.sam_prompt_encoder = PromptEncoder(cfg)
        self.sam_mask_decoder = MaskDecoder(cfg)

    def forward_image(self, images):
        """images [B, S, S, 3] (SAM-normalised) -> (feats, pos): 3 levels,
        highest resolution first; levels 0/1 already through conv_s0/s1
        (sam2_base.py:78-84)."""
        feats, pos = self.image_encoder(images)
        dec = self.sam_mask_decoder
        feats = [conv1x1_nhwc(feats[0], dec.conv_s0),
                 conv1x1_nhwc(feats[1], dec.conv_s1), feats[2]]
        return feats, pos
