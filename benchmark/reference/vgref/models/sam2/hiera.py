"""Hiera hierarchical windowed ViT trunk of SAM-2 (PyTorch port of
videoglamm_tpu/models/sam2/hiera.py).

Channels-last throughout. Window layout hoisting (hiera.py:434-477) keeps
consecutive same-window blocks in the partitioned [B*nW, ws, ws, C] layout;
windowed non-pooling blocks then take `fused_window_block` (K3/K2/K1 on the
card) exactly where the JAX package takes its fused Pallas block
(hiera.py:305-309). Global blocks attend over the window-major token order
(attention is permutation-invariant), which at 1024^2 is the K1 flash path.
With `Hiera(hoist_layout=False)` every windowed block partitions and
unpartitions on its own and its attention takes the unfused branches of the
JAX module: tiny windows of 16 or 64 tokens go to K8
(`attention_packed_qkv_smallwin`), windows of 256 tokens and more are
folded into super-windows of up to 512 tokens under a block-diagonal mask
(K1's `win` mode). Frames run as one batch. Parameter names follow the
reference checkpoint.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ...config import HieraConfig
from ...ops.attention import (attention_bshd, attention_bshd_cross,
                              attention_packed_qkv_padded,
                              attention_packed_qkv_smallwin,
                              dot_product_attention)
from ...ops.fused_block import fused_window_block
from ..common import LayerNorm, Mlp


def window_partition(x, ws: int):
    """[B, H, W, C] -> [B*nW, ws, ws, C], zero-padded to multiples of ws."""
    B, H, W, C = x.shape
    pad_h, pad_w = (-H) % ws, (-W) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, C), (Hp, Wp)


def window_unpartition(wins, ws: int, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = wins.shape[0] // ((Hp // ws) * (Wp // ws))
    x = wins.reshape(B, Hp // ws, Wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, -1)[:, :H, :W]


# folded super-window token target and the smallest window that takes the
# super-window branch (hiera.py:132,141 without their environment knobs)
_SUPERWIN_TARGET = 512
_SUPERWIN_MIN = 256


def _superwindow_fold(n_windows: int, win_tokens: int) -> int:
    """Windows folded per attention row: the largest divisor of n_windows
    whose folded token count stays <= _SUPERWIN_TARGET (hiera.py:144-152)."""
    f = max(1, _SUPERWIN_TARGET // win_tokens)
    while f > 1 and n_windows % f:
        f -= 1
    return f


def _max_pool_2x(x):
    """2x2 max pool, stride 2, channels-last."""
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


class MultiScaleAttention(nn.Module):
    exact_f32 = False      # models.common.set_exact_f32

    def __init__(self, dim: int, dim_out: int, num_heads: int,
                 q_pool: bool = False, window_size: int = 0):
        super().__init__()
        self.dim_out, self.num_heads = dim_out, num_heads
        self.q_pool, self.window_size = q_pool, window_size
        self.qkv = nn.Linear(dim, 3 * dim_out)
        self.proj = nn.Linear(dim_out, dim_out)

    def forward(self, x):
        B, H, W, _ = x.shape
        nh, d = self.num_heads, self.dim_out
        hd = d // nh
        S = H * W
        windowed = not self.q_pool and self.window_size > 0 and hd <= 128
        # hiera.py:168-189: tiny windows (stages 1/2: 64 and 16 tokens)
        # straight from the fused projection. The JAX module also asks for
        # a window count that fills its packed tiles; K8 packs nothing, so
        # any count takes it.
        if windowed and S in (16, 64):
            qkv = self.qkv(x.reshape(B * S, x.shape[-1]))
            o = attention_packed_qkv_smallwin(qkv.view(B, S, 3 * d), nh, hd,
                                              exact=self.exact_f32)
            return self.proj(o.reshape(B * S, d)).view(B, H, W, d)
        # hiera.py:191-209: windows of 256 tokens and more, folded into
        # super-windows under a block-diagonal mask. The JAX module pads the
        # heads to 128 lanes in the projection weights, a TPU layout device;
        # here the unpadded fused qkv goes in.
        if windowed and _SUPERWIN_MIN <= S <= 1536:
            qkv = self.qkv(x.reshape(B * S, x.shape[-1]))
            f = _superwindow_fold(B, S)
            o = attention_packed_qkv_padded(qkv.view(B // f, f * S, 3 * d), nh,
                                            hd, win=S if f > 1 else 0,
                                            exact=self.exact_f32)
            return self.proj(o.reshape(B * S, d)).view(B, H, W, d)
        # hiera.py:211-239: pooling blocks, global blocks, other geometries
        qkv = self.qkv(x.reshape(B * S, x.shape[-1]))
        q = qkv[:, :d].reshape(B, S, nh, hd)
        k = qkv[:, d:2 * d].reshape(B, S, nh, hd)
        v = qkv[:, 2 * d:].reshape(B, S, nh, hd)
        if self.q_pool:
            q = _max_pool_2x(q.reshape(B, H, W, d))
            H, W = q.shape[1], q.shape[2]
            q = q.reshape(B, H * W, nh, hd)
        if q.shape[1] != k.shape[1]:
            o = attention_bshd_cross(q, k, v)
        elif q.shape[1] <= 1536:
            o = attention_bshd(q, k, v, exact=self.exact_f32)
        else:
            o = dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2),
                                      exact=self.exact_f32).transpose(1, 2)
        o = self.proj(o.reshape(B * H * W, d))
        return o.view(B, H, W, d)


class MultiScaleBlock(nn.Module):
    exact_f32 = False      # models.common.set_exact_f32

    def __init__(self, dim: int, dim_out: int, num_heads: int,
                 mlp_ratio: float, window_size: int, q_pool: bool = False):
        super().__init__()
        self.dim, self.dim_out, self.num_heads = dim, dim_out, num_heads
        self.window_size, self.q_pool = window_size, q_pool
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads, q_pool,
                                        window_size)
        self.norm2 = LayerNorm(dim_out, eps=1e-6)
        self.mlp = Mlp(dim_out, int(dim_out * mlp_ratio))
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)

    def _fused_params(self):
        return dict(
            ln1_weight=self.norm1.weight, ln1_bias=self.norm1.bias,
            qkv_weight=self.attn.qkv.weight, qkv_bias=self.attn.qkv.bias,
            proj_weight=self.attn.proj.weight, proj_bias=self.attn.proj.bias,
            ln2_weight=self.norm2.weight, ln2_bias=self.norm2.bias,
            fc1_weight=self.mlp.layers[0].weight, fc1_bias=self.mlp.layers[0].bias,
            fc2_weight=self.mlp.layers[1].weight, fc2_bias=self.mlp.layers[1].bias)

    def forward(self, x, pre_windowed: int = 0, true_batch: int = 1):
        """pre_windowed: ws of an already window-partitioned input layout
        [B*nW, ws, ws, C] (0 = spatial [B, H, W, C]); the output keeps the
        input's layout."""
        ws0 = self.window_size
        if (pre_windowed and ws0 > 0 and not self.q_pool
                and self.dim == self.dim_out and ws0 * ws0 in (16, 64, 256)
                and self.dim_out % self.num_heads == 0
                and self.dim_out // self.num_heads <= 128):
            # hiera.py:305-309: the whole block as one fused op
            NW, w_, _, C = x.shape
            y = fused_window_block(x.reshape(NW, w_ * w_, C),
                                   self._fused_params(), self.num_heads,
                                   exact=self.exact_f32)
            return y.view(NW, w_, w_, C)

        shortcut = x
        x = self.norm1(x)
        if self.dim != self.dim_out:
            sB, sH, sW, sC = x.shape
            shortcut = self.proj(x.reshape(-1, sC)).view(sB, sH, sW, self.dim_out)
            if self.q_pool:
                shortcut = _max_pool_2x(shortcut)
        ws = self.window_size
        if pre_windowed:
            if ws > 0:
                assert ws == pre_windowed and not self.q_pool
                x = self.attn(x)
            else:
                # global block over the window-major token order (windows are
                # image-major, so a reshape regroups per image losslessly)
                nwin, w_, _, C = x.shape
                bt = true_batch
                x = self.attn(x.reshape(bt, (nwin // bt) * w_ * w_, 1, C))
                x = x.reshape(nwin, w_, w_, -1)
        else:
            H, W = x.shape[1], x.shape[2]
            if ws > 0:
                x, pad_hw = window_partition(x, ws)
            x = self.attn(x)
            if self.q_pool:
                ws = ws // 2
                H, W = shortcut.shape[1], shortcut.shape[2]
                pad_hw = (H + (-H) % max(ws, 1), W + (-W) % max(ws, 1))
            if self.window_size > 0:
                x = window_unpartition(x, ws, pad_hw, (H, W))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: HieraConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_kernel,
                              stride=cfg.patch_stride, padding=cfg.patch_padding)


class Hiera(nn.Module):
    """hoist_layout: keep runs of same-window blocks in the partitioned
    layout (the serving path). False makes every block partition on its
    own, so that both layouts can be compared (hiera.py:388-391)."""

    def __init__(self, cfg: HieraConfig, hoist_layout: bool = True):
        super().__init__()
        self.cfg = cfg
        self.hoist_layout = hoist_layout
        self.patch_embed = _PatchEmbed(cfg)
        bh, bw = cfg.window_pos_embed_bkg_spatial_size
        w0 = cfg.window_spec[0]
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.embed_dim, bh, bw))
        self.pos_embed_window = nn.Parameter(torch.zeros(1, cfg.embed_dim, w0, w0))

        stages = cfg.stages
        self.stage_ends = [sum(stages[:i]) - 1 for i in range(1, len(stages) + 1)]
        q_pool_blocks = [e + 1 for e in self.stage_ends[:-1]][:cfg.q_pool]
        dim, heads, cur_stage = cfg.embed_dim, cfg.num_heads, 1
        blocks = []
        for i in range(sum(stages)):
            dim_out = dim
            window_size = cfg.window_spec[cur_stage - 1]
            if i in cfg.global_att_blocks:
                window_size = 0
            if i - 1 in self.stage_ends:
                dim_out = int(dim * cfg.dim_mul)
                heads = int(heads * cfg.head_mul)
                cur_stage += 1
            blocks.append(MultiScaleBlock(dim, dim_out, heads, cfg.mlp_ratio,
                                          window_size, i in q_pool_blocks))
            dim = dim_out
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x) -> List[torch.Tensor]:
        """x: [B, H, W, 3] -> per-stage features (channels-last), highest
        resolution first."""
        cfg = self.cfg
        conv = self.patch_embed.proj
        x = F.conv2d(x.to(conv.weight.dtype).permute(0, 3, 1, 2), conv.weight,
                     conv.bias, stride=conv.stride, padding=conv.padding)
        x = x.permute(0, 2, 3, 1).contiguous()
        B, H, W, _ = x.shape
        # background PE (bicubic, torch-exact) + tiled window PE (:406-415)
        w0 = cfg.window_spec[0]
        pe = F.interpolate(self.pos_embed.float(), size=(H, W), mode="bicubic",
                           align_corners=False)
        pe = pe + self.pos_embed_window.float().tile(1, 1, H // w0, W // w0)
        x = x + pe[0].permute(1, 2, 0).to(x.dtype)

        outputs = []
        layout_ws = 0            # ws of x's current layout (0 = spatial)
        cur_h, cur_w = H, W
        for i, blk in enumerate(self.blocks):
            ws = blk.window_size
            if blk.q_pool or (ws > 0 and layout_ws not in (0, ws)):
                if layout_ws:
                    x = window_unpartition(x, layout_ws, (cur_h, cur_w),
                                           (cur_h, cur_w))
                    layout_ws = 0
            if (self.hoist_layout and not blk.q_pool and ws > 0
                    and layout_ws == 0
                    and x.shape[1] % ws == 0 and x.shape[2] % ws == 0):
                x, _ = window_partition(x, ws)
                layout_ws = ws
            x = blk(x, pre_windowed=layout_ws, true_batch=B)
            if blk.q_pool:
                cur_h, cur_w = x.shape[1], x.shape[2]
            if i in self.stage_ends:
                if layout_ws:
                    x = window_unpartition(x, layout_ws, (cur_h, cur_w),
                                           (cur_h, cur_w))
                    layout_ws = 0
                outputs.append(x)
        return outputs
