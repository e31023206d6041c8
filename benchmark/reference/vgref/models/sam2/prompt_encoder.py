"""SAM-2 prompt encoder with the VideoGLaMM text-prompt extension (PyTorch
port of videoglamm_tpu/models/sam2/prompt_encoder.py): `text_embeds` become
sparse prompts; point prompts get the random-Fourier PE plus a learned
embedding per label (label -1 is padding: the not-a-point embedding alone);
a box is its two corners as points labelled 2 and 3; a mask prompt
[B, 4E, 4E, 1] goes through the downscaling convs (2x2 stride 2,
LayerNorm, erf-GELU, twice, then 1x1 to d_model) as the dense prompt, which
is otherwise the learned no-mask embedding. Parameter names follow the
reference checkpoint (`mask_downscaling.{0,1,3,4,6}`)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...config import SAM2Config
from ..common import LayerNorm
from .fpn import conv1x1_nhwc
from .memory import _conv_nhwc
from .pos_enc import random_pe_grid


class _RandomPE(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn(2, num_pos_feats))


MASK_IN_CHANS = 16


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
        ch = MASK_IN_CHANS
        self.mask_downscaling = nn.ModuleDict({
            "0": nn.Conv2d(1, ch // 4, 2, stride=2),
            "1": LayerNorm(ch // 4, eps=1e-6),
            "3": nn.Conv2d(ch // 4, ch, 2, stride=2),
            "4": LayerNorm(ch, eps=1e-6),
            "6": nn.Conv2d(ch, cfg.d_model, 1)})

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

    def embed_boxes(self, boxes):
        """boxes [B, 4] xyxy pixels -> [B, 2, d] (prompt_encoder.py:73-78)."""
        B = boxes.shape[0]
        labels = torch.tensor([[2, 3]], dtype=torch.int32,
                              device=boxes.device).expand(B, 2)
        return self.embed_points(boxes.reshape(B, 2, 2), labels)

    def embed_masks(self, masks):
        """masks [B, 4E, 4E, 1] -> [B, E, E, d] (prompt_encoder.py:80-86)."""
        md = self.mask_downscaling
        x = F.gelu(md["1"](_conv_nhwc(masks.float(), md["0"])))
        x = F.gelu(md["4"](_conv_nhwc(x, md["3"])))
        return conv1x1_nhwc(x, md["6"])

    def forward(self, text_embeds=None, points=None, boxes=None, masks=None):
        """text_embeds [B, N, d]; points (coords [B, P, 2], labels [B, P]);
        boxes [B, 4]; masks [B, 4E, 4E, 1]; each or None -> (sparse
        [B, n, d] f32: points, box corners, text, in that order; dense
        [B, E, E, d]). Points are padded with one not-a-point entry when no
        box comes with them (prompt_encoder.py:93-99); with no sparse
        prompt at all, sparse is [B, 0, d]."""
        parts = []
        if points is not None:
            coords, labels = points
            if boxes is None:
                coords = torch.cat([coords, torch.zeros_like(coords[:, :1])], dim=1)
                labels = torch.cat([labels, -torch.ones_like(labels[:, :1])], dim=1)
            parts.append(self.embed_points(coords, labels))
        if boxes is not None:
            parts.append(self.embed_boxes(boxes))
        if text_embeds is not None:
            parts.append(text_embeds.float())
        d = self.cfg.d_model
        B = parts[0].shape[0] if parts else (
            masks.shape[0] if masks is not None else 1)
        sparse = torch.cat(parts, dim=1) if parts else torch.zeros(
            B, 0, d, device=self.no_mask_embed.weight.device)
        if masks is not None:
            return sparse, self.embed_masks(masks)
        e = self.embed_size
        return sparse, self.no_mask_embed.weight[0].float().expand(B, e, e, d)
