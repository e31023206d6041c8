"""CLIP ViT-L/336 context-image encoder (PyTorch port of
videoglamm_tpu/models/clip_vit.py). HF CLIPVisionModel parameter names;
only the layers up to the selected hidden state are built and run."""
from __future__ import annotations

import torch
from torch import nn

from ..config import CLIPVisionConfig
from .common import LayerNorm, MultiHeadAttention, patchify_conv


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class _ClipMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.self_attn = MultiHeadAttention(cfg.hidden_size, cfg.num_heads)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = _ClipMlp(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        D = cfg.hidden_size
        self.class_embedding = nn.Parameter(torch.zeros(D))
        self.patch_embedding = nn.Conv2d(3, D, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(cfg.num_patches + 1, D)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, n_run: int):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg) for _ in range(n_run))


class CLIPVisionTower(nn.Module):
    """forward(pixel_values [B, H, W, 3]) -> [B, num_patches, hidden]
    features of the selected hidden layer."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        # hidden_states[select_layer] is the output of this many layers
        n_run = (cfg.num_layers + cfg.select_layer + 1 if cfg.select_layer < 0
                 else cfg.select_layer)
        assert 0 < n_run <= cfg.num_layers
        self.embeddings = _Embeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.encoder = _Encoder(cfg, n_run)

    def forward(self, pixel_values):
        cfg = self.cfg
        emb = self.embeddings
        B, D = pixel_values.shape[0], cfg.hidden_size
        dt = emb.patch_embedding.weight.dtype
        x = patchify_conv(pixel_values.to(dt), emb.patch_embedding.weight, None,
                          cfg.patch_size)
        x = torch.cat([emb.class_embedding.to(dt).expand(B, 1, D), x], dim=1)
        x = self.pre_layrnorm(x + emb.position_embedding.weight.to(dt))
        for layer in self.encoder.layers:
            x = layer(x)
        if cfg.select_feature == "patch":
            return x[:, 1:]
        if cfg.select_feature == "cls_patch":
            return x
        raise ValueError(cfg.select_feature)
