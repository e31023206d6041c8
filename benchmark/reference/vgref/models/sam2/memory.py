"""SAM-2 memory encoder and memory attention (PyTorch port of
videoglamm_tpu/models/sam2/memory.py). Both run in f32 in the bf16 model
too, as the JAX modules do (sam2_base.py:52-53 builds them with their
default dtype).

- MemoryEncoder: a stride-16 mask conv pyramid (channels 1->4->16->64->256,
  then 1x1 to d_model), a 1x1 projection of the pixel features, their sum,
  two ConvNeXt blocks (7x7 depthwise), a 1x1 projection to mem_dim, and the
  sine position encoding of the memory grid.
- MemoryAttention: layers of pre-norm self-attention (2-D RoPE) on the
  current frame's tokens, cross-attention (RoPE tiled over the memory
  frames; the object-pointer key suffix is not rotated; keys and values
  come in at mem_dim) into the concatenated memory, and a ReLU FFN; the
  input is `curr + 0.1 * pos`, the output goes through a final LayerNorm.

The memory bank has a fixed shape; slots that hold nothing are masked out
by a [B, Sk] boolean attention mask. Channels-last throughout; parameter
names follow the reference checkpoint (`mask_downsampler.encoder.{0,1,3,
...,12}`, `fuser.layers.*`, `layers.{i}.self_attn`, ...). The GELU here is
the erf form (memory.py:43,:70).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...config import SAM2Config
from ..common import LayerNorm
from .fpn import conv1x1_nhwc
from .pos_enc import sine_pe
from .transformer import RoPEAttention


def _conv_nhwc(x, conv: nn.Conv2d):
    """A Conv2d applied channels-last."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias,
                 stride=conv.stride, padding=conv.padding, groups=conv.groups)
    return y.permute(0, 2, 3, 1)


class CXBlock(nn.Module):
    """ConvNeXt block, channels-last (memory.py:30-47). `weight` is the
    layer scale, under the name the reference checkpoint gives it."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.weight = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x):
        y = self.norm(_conv_nhwc(x, self.dwconv))
        y = self.pwconv2(F.gelu(self.pwconv1(y)))
        return x + self.weight.to(y.dtype) * y


class _MaskDownSampler(nn.Module):
    """`encoder`: four (3x3 stride-2 conv, LayerNorm over channels, GELU)
    groups at indices 0,1,2 / 3,4,5 / 6,7,8 / 9,10,11 and a 1x1 conv at 12;
    the activations hold no parameters and are applied in `forward`."""

    def __init__(self, d_model: int):
        super().__init__()
        mods, ch = {}, 1
        for i in range(4):
            mods[str(3 * i)] = nn.Conv2d(ch, ch * 4, 3, stride=2, padding=1)
            mods[str(3 * i + 1)] = LayerNorm(ch * 4, eps=1e-6)
            ch *= 4
        mods["12"] = nn.Conv2d(ch, d_model, 1)
        self.encoder = nn.ModuleDict(mods)

    def forward(self, x):
        for i in range(4):
            x = _conv_nhwc(x, self.encoder[str(3 * i)])
            x = F.gelu(self.encoder[str(3 * i + 1)](x))
        return conv1x1_nhwc(x, self.encoder["12"])


class _Fuser(nn.Module):
    def __init__(self, dim: int, num_layers: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(CXBlock(dim) for _ in range(num_layers))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class MemoryEncoder(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.cfg = cfg
        self.mask_downsampler = _MaskDownSampler(cfg.d_model)
        self.pix_feat_proj = nn.Conv2d(cfg.d_model, cfg.d_model, 1)
        self.fuser = _Fuser(cfg.d_model)
        self.out_proj = nn.Conv2d(cfg.d_model, cfg.mem_dim, 1)

    def forward(self, pix_feat, masks):
        """pix_feat [B, E, E, C]; masks [B, 16E, 16E, 1], already scaled
        (sigmoid * 20 - 10, or the binarised form) ->
        (memory [B, E, E, mem_dim] f32, pos [E, E, mem_dim])."""
        x = self.mask_downsampler(masks.float())
        y = conv1x1_nhwc(pix_feat.float(), self.pix_feat_proj) + x
        mem = conv1x1_nhwc(self.fuser(y), self.out_proj)
        pos = sine_pe(mem.shape[1], mem.shape[2], self.cfg.mem_dim, mem.device)
        return mem.float(), pos


class MemoryAttentionLayer(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        d, grid = cfg.d_model, cfg.low_res_size
        self.norm1 = LayerNorm(d)
        self.self_attn = RoPEAttention(d, 1, (grid, grid), cfg.memory_rope_theta)
        self.norm2 = LayerNorm(d)
        self.cross_attn_image = RoPEAttention(d, 1, (grid, grid),
                                              cfg.memory_rope_theta,
                                              kv_in_dim=cfg.mem_dim)
        self.norm3 = LayerNorm(d)
        self.linear1 = nn.Linear(d, cfg.memory_attention_dim_feedforward)
        self.linear2 = nn.Linear(cfg.memory_attention_dim_feedforward, d)

    def forward(self, tgt, memory, pos, num_obj_ptr_tokens: int, kv_mask=None):
        # self-attention (no position encoding added at the attention)
        t2 = self.norm1(tgt)
        tgt = tgt + self.self_attn(t2, t2, t2)
        # cross-attention into the memory (position encoding on the keys only)
        t2 = self.norm2(tgt)
        tgt = tgt + self.cross_attn_image(
            t2, memory + pos, memory, num_k_exclude_rope=num_obj_ptr_tokens,
            kv_mask=kv_mask)
        t2 = self.norm3(tgt)
        return tgt + self.linear2(F.relu(self.linear1(t2)))


class MemoryAttention(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.layers = nn.ModuleList(MemoryAttentionLayer(cfg)
                                    for _ in range(cfg.memory_attention_layers))
        self.norm = LayerNorm(cfg.d_model)

    def forward(self, curr, curr_pos, memory, memory_pos,
                num_obj_ptr_tokens: int, kv_mask=None):
        """curr [B, HW, C] current-frame tokens; memory [B, M, mem_dim]
        (spatial memories first, then the object-pointer tokens); kv_mask
        [B, M] bool -> conditioned tokens [B, HW, C]."""
        x = curr + 0.1 * curr_pos
        for layer in self.layers:
            x = layer(x, memory, memory_pos, num_obj_ptr_tokens, kv_mask)
        return self.norm(x)
