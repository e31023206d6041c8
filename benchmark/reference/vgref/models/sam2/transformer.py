"""SAM two-way transformer and the RoPE attention of memory attention
(PyTorch port of videoglamm_tpu/models/sam2/transformer.py). Both run in
f32, inside the mask decoder and the memory attention."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import dot_product_attention
from ...ops.rope import apply_axial_rope, axial_rope_cos_sin
from ..common import LayerNorm, Mlp


class SAMAttention(nn.Module):
    def __init__(self, embedding_dim: int, num_heads: int,
                 downsample_rate: int = 1):
        super().__init__()
        inner = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embedding_dim, inner)
        self.k_proj = nn.Linear(embedding_dim, inner)
        self.v_proj = nn.Linear(embedding_dim, inner)
        self.out_proj = nn.Linear(inner, embedding_dim)

    def forward(self, q, k, v):
        nh = self.num_heads

        def split(t):
            return t.view(t.shape[0], t.shape[1], nh, -1).transpose(1, 2)

        q, k, v = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        o = dot_product_attention(split(q), split(k), split(v))
        o = o.transpose(1, 2).reshape(o.shape[0], -1, q.shape[-1])
        return self.out_proj(o)


class RoPEAttention(nn.Module):
    """Attention with the 2-D axial rotary embedding on the queries and on
    the spatial keys over a `feat_sizes` grid (transformer.py:47-85). The
    last `num_k_exclude_rope` keys (object pointers) are not rotated; keys
    longer than the grid (several memory frames) see the table tiled.
    `kv_in_dim`: width of the keys and values that come in (mem_dim).
    The memory attention runs in f32 in every model; its self-attention
    takes K1's full-precision route only in an f32 model (`exact_f32`,
    models.common.set_exact_f32), the staged route in a bf16 one."""

    exact_f32 = False

    def __init__(self, embedding_dim: int, num_heads: int, feat_sizes,
                 rope_theta: float = 10000.0, kv_in_dim: Optional[int] = None):
        super().__init__()
        kv = embedding_dim if kv_in_dim is None else kv_in_dim
        self.num_heads = num_heads
        self.feat_sizes = tuple(feat_sizes)
        self.rope_theta = rope_theta
        self.q_proj = nn.Linear(embedding_dim, embedding_dim)
        self.k_proj = nn.Linear(kv, embedding_dim)
        self.v_proj = nn.Linear(kv, embedding_dim)
        self.out_proj = nn.Linear(embedding_dim, embedding_dim)

    def forward(self, q, k, v, num_k_exclude_rope: int = 0, kv_mask=None):
        nh = self.num_heads

        def split(t):
            return t.view(t.shape[0], t.shape[1], nh, -1).transpose(1, 2)

        qh, kh, vh = (split(self.q_proj(q)), split(self.k_proj(k)),
                      split(self.v_proj(v)))
        ex, ey = self.feat_sizes
        assert qh.shape[2] == ex * ey, \
            f"RoPE grid {ex}x{ey} != q len {qh.shape[2]}"
        cos, sin = axial_rope_cos_sin(qh.shape[-1], ex, ey, self.rope_theta,
                                      q.device)
        qh = apply_axial_rope(qh, cos, sin)
        n_rope = kh.shape[2] - num_k_exclude_rope
        if n_rope > 0:
            k_rot = apply_axial_rope(kh[:, :, :n_rope], cos, sin)
            kh = torch.cat([k_rot, kh[:, :, n_rope:]], dim=2) \
                if num_k_exclude_rope > 0 else k_rot
        o = dot_product_attention(qh, kh, vh, kv_mask=kv_mask,
                                  exact=self.exact_f32)
        o = o.transpose(1, 2).reshape(o.shape[0], -1, qh.shape[1] * qh.shape[3])
        return self.out_proj(o)


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, embedding_dim: int, num_heads: int, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        d, r = embedding_dim, attention_downsample_rate
        self.self_attn = SAMAttention(d, num_heads)
        self.norm1 = LayerNorm(d)
        self.cross_attn_token_to_image = SAMAttention(d, num_heads, r)
        self.norm2 = LayerNorm(d)
        self.mlp = Mlp(d, mlp_dim, activation=F.relu)
        self.norm3 = LayerNorm(d)
        self.norm4 = LayerNorm(d)
        self.cross_attn_image_to_token = SAMAttention(d, num_heads, r)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    """SAM-2's decoder transformer: depth 2, 8 heads, MLP 2048, cross
    attention downsampled 2x (transformer.py:125-133)."""

    def __init__(self, embedding_dim: int):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, 8, skip_first_layer_pe=(i == 0))
            for i in range(2))
        self.final_attn_token_to_image = SAMAttention(embedding_dim, 8, 2)
        self.norm_final_attn = LayerNorm(embedding_dim)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding/image_pe [B, H, W, C]; point_embedding [B, N, C]
        -> (queries [B, N, C], keys [B, HW, C])."""
        B, H, W, C = image_embedding.shape
        keys = image_embedding.reshape(B, H * W, C)
        key_pe = image_pe.reshape(B, H * W, C)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys
