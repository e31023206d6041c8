"""SAM-2 prompt encoder, text-prompt hook only (PyTorch port of the part of
videoglamm_tpu/models/sam2/prompt_encoder.py that the GCG path runs: no
points, boxes or masks; `text_embeds` become the sparse prompts and the
dense prompt is the learned no-mask embedding). Points, boxes and mask
prompts come with the interactive predictors (ROADMAP.md)."""
from __future__ import annotations

import torch
from torch import nn

from ...config import SAM2Config
from .pos_enc import random_pe_grid


class _RandomPE(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn(2, num_pos_feats))


class PromptEncoder(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.cfg = cfg
        self.pe_layer = _RandomPE(cfg.d_model // 2)
        self.no_mask_embed = nn.Embedding(1, cfg.d_model)

    @property
    def embed_size(self) -> int:
        return self.cfg.image_size // self.cfg.backbone_stride

    def get_dense_pe(self):
        """[E, E, d_model] dense PE over the image-embedding grid."""
        e = self.embed_size
        return random_pe_grid(self.pe_layer.positional_encoding_gaussian_matrix,
                              e, e)

    def forward(self, text_embeds):
        """text_embeds [B, N, d] -> (sparse [B, N, d] f32, dense [B, E, E, d])."""
        B = text_embeds.shape[0]
        e = self.embed_size
        dense = self.no_mask_embed.weight[0].float().expand(B, e, e,
                                                             self.cfg.d_model)
        return text_embeds.float(), dense
