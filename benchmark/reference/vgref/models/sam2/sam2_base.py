"""SAM-2 base model (copied from the port's models/sam2/sam2_base.py): the
image encoder, prompt encoder and mask decoder the framewise path runs,
and the memory modules and parameters, which only the tracker runs, so
that the model holds every leaf of the program's. The image encoder,
prompt encoder and mask decoder run in f32 here.
"""
from __future__ import annotations

import torch
from torch import nn

from ...config import SAM2Config
from ..common import MLPBlock
from .fpn import SAM2ImageEncoder, conv1x1_nhwc
from .mask_decoder import MaskDecoder
from .memory import MemoryAttention, MemoryEncoder
from .prompt_encoder import PromptEncoder


class SAM2Base(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.cfg = cfg
        C = cfg.d_model
        self.image_encoder = SAM2ImageEncoder(cfg)
        self.sam_prompt_encoder = PromptEncoder(cfg)
        self.sam_mask_decoder = MaskDecoder(cfg)
        self.memory_encoder = MemoryEncoder(cfg)
        self.memory_attention = MemoryAttention(cfg)
        # memory parameters (sam2_base.py:59-75), with the reference
        # checkpoint's shapes
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, C))
        self.no_mem_pos_enc = nn.Parameter(torch.zeros(1, 1, C))
        self.maskmem_tpos_enc = nn.Parameter(
            torch.zeros(cfg.num_maskmem, 1, 1, cfg.mem_dim))
        self.no_obj_ptr = nn.Parameter(torch.zeros(1, C))
        self.obj_ptr_proj = MLPBlock(C, C, C, 3)
        self.mask_downsample = nn.Conv2d(1, 1, 4, stride=4)

    def forward_image(self, images):
        """images [B, S, S, 3] (SAM-normalised) -> (feats, pos): 3 levels,
        highest resolution first; levels 0/1 already through conv_s0/s1
        (sam2_base.py:78-84)."""
        feats, pos = self.image_encoder(images)
        dec = self.sam_mask_decoder
        feats = [conv1x1_nhwc(feats[0], dec.conv_s0),
                 conv1x1_nhwc(feats[1], dec.conv_s1), feats[2]]
        return feats, pos
