"""SAM-2 prompt encoder with the VideoGLaMM text-prompt extension (PyTorch
port of the parts of videoglamm_tpu/models/sam2/prompt_encoder.py that the
GCG and tracking paths run): `text_embeds` become sparse prompts, point
prompts get the random-Fourier PE plus a learned embedding per label
(label -1 is padding: the not-a-point embedding alone), and the dense
prompt is the learned no-mask embedding. Boxes and mask prompts come with
the interactive predictors (ROADMAP.md). Parameter names follow the
reference checkpoint."""
from __future__ import annotations

import math

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
        # 0: negative point, 1: positive point, 2/3: box corners
        self.point_embeddings = nn.ModuleList(
            nn.Embedding(1, cfg.d_model) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, cfg.d_model)
        self.no_mask_embed = nn.Embedding(1, cfg.d_model)

    @property
    def embed_size(self) -> int:
        return self.cfg.image_size // self.cfg.backbone_stride

    def get_dense_pe(self):
        """[E, E, d_model] dense PE over the image-embedding grid."""
        e = self.embed_size
        return random_pe_grid(self.pe_layer.positional_encoding_gaussian_matrix,
                              e, e)

    def embed_points(self, coords, labels):
        """coords [B, P, 2] pixel xy; labels [B, P] in {-1, 0, 1, 2, 3},
        -1 = padding -> [B, P, d] f32 (prompt_encoder.py:60-71)."""
        gauss = self.pe_layer.positional_encoding_gaussian_matrix.float()
        c = 2.0 * ((coords.float() + 0.5) / self.cfg.image_size) - 1.0
        c = 2.0 * math.pi * (c @ gauss)
        pe = torch.cat([torch.sin(c), torch.cos(c)], dim=-1)
        lab = labels[..., None]
        pe = torch.where(lab == -1, 0.0, pe)
        pe = pe + torch.where(lab == -1, self.not_a_point_embed.weight[0].float(),
                              0.0)
        for li, emb in enumerate(self.point_embeddings):
            pe = pe + torch.where(lab == li, emb.weight[0].float(), 0.0)
        return pe

    def forward(self, text_embeds=None, points=None):
        """points: (coords [B, P, 2], labels [B, P]) or None; text_embeds
        [B, N, d] or None -> (sparse [B, P + 1 + N, d] f32, dense
        [B, E, E, d]). Points are padded with one not-a-point entry, as the
        reference does when no box comes with them (prompt_encoder.py:92-99)."""
        parts = []
        if points is not None:
            coords, labels = points
            coords = torch.cat([coords, torch.zeros_like(coords[:, :1])], dim=1)
            labels = torch.cat([labels, -torch.ones_like(labels[:, :1])], dim=1)
            parts.append(self.embed_points(coords, labels))
        if text_embeds is not None:
            parts.append(text_embeds.float())
        B = parts[0].shape[0]
        sparse = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        e = self.embed_size
        dense = self.no_mask_embed.weight[0].float().expand(B, e, e,
                                                             self.cfg.d_model)
        return sparse, dense
