"""Shared building blocks (PyTorch port of videoglamm_tpu/models/common.py).

Norm parameters stay f32 and their statistics run in f32, as in the JAX
package (params f32, compute dtype separate). `cast_compute` stores the
matmul, conv and embedding weights in the compute dtype, which rounds
exactly as JAX's cast at use does. The JAX head-padding layout devices
(`HeadPaddedQKV`, `PadConsumingProj`) have no counterpart: their
parameters are stored unpadded and load into plain linears.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import quant
from ..ops.attention import attention_bshd
from ..ops.norms import layer_norm, rms_norm


class LayerNorm(nn.Module):
    """LayerNorm over the last dim with f32 statistics."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, eps=self.eps)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return rms_norm(x, self.weight, eps=self.eps)


class QDense(nn.Module):
    """Weight-only int8 linear, bias-free (common.py:41): buffers `weight`
    int8 [round_up(out, 8), in] in nn.Linear orientation (rows past `out`
    are zero padding for the s8 x s8 product of the W8A8 branch) and
    `scale` f32 [out], consumed by `ops.quant.dequant_matmul`. Calls with
    fewer than `w8a8_min_m` rows (decode) stream the weight through K5."""

    w8a8_min_m = quant.W8A8_MIN_M

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        rows = out_features + (-out_features % 8)
        self.register_buffer("weight", torch.zeros(rows, in_features,
                                                   dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "QDense":
        """Quantise a bias-free float linear (per output channel)."""
        q, s = quant.quantize_int8(lin.weight.detach())
        m = cls(lin.in_features, lin.out_features)
        m.weight, m.scale = quant.pad_rows8(q), s
        return m

    def forward(self, x):
        return quant.dequant_matmul(x, self.weight, self.scale,
                                    w8a8_min_m=self.w8a8_min_m)


class QDense4(nn.Module):
    """Weight-only int4 linear, bias-free (common.py:64): buffers `weight`
    packed int8 [out, in/2] (byte r of a row: k = 2r low nibble, k = 2r + 1
    high) and `scale` f32 [out, in/group], group = min(128, in), consumed
    by `ops.quant.dequant4_matmul`. Calls with at most `matvec_max_m` rows
    (decode) stream the weight through K5 at 4 bits."""

    matvec_max_m = quant.MATVEC4_MAX_M

    def __init__(self, in_features: int, out_features: int, group: int = 128):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.group = min(group, in_features)     # tiny configs: one group
        self.register_buffer("weight", torch.zeros(
            out_features, in_features // 2, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(
            out_features, in_features // self.group))

    @classmethod
    def from_linear(cls, lin: nn.Linear, group: int = 128) -> "QDense4":
        m = cls(lin.in_features, lin.out_features, group)
        m.weight, m.scale = quant.quantize_int4(lin.weight.detach(), m.group)
        return m

    def forward(self, x):
        return quant.dequant4_matmul(x, self.weight, self.scale, self.group,
                                     matvec_max_m=self.matvec_max_m)


def cast_compute(module: nn.Module, dtype, keep=None) -> nn.Module:
    """Store the weights of every linear, conv and embedding in `dtype`.
    Norm scales and parameters that the model reads in f32 are left as
    they are. keep: a compiled regex; submodules whose name (relative to
    `module`) it matches stay as they are (f32 masters of trainable
    weights, cast at use by `linear_cast`)."""
    for name, m in module.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d, nn.Embedding)) \
                and not (keep is not None and keep.search(name)):
            m.to(dtype)
    return module


def linear_cast(x, lin: nn.Linear):
    """`lin(x)` with the weight cast to x's dtype at use, as flax `Dense`
    does with `param_dtype=float32` (common.py:144-152): a trainable weight
    keeps its f32 master, the product runs in the compute dtype, and the
    gradient arrives in f32. A weight already stored in x's dtype is used
    as it is."""
    bias = lin.bias.to(x.dtype) if lin.bias is not None else None
    return F.linear(x, lin.weight.to(x.dtype), bias)


def gelu_exact(x):
    """torch's erf GELU in f32; the tanh form below f32 (common.py:203-214:
    its deviation from erf is 20x below the bf16 rounding quantum)."""
    if x.dtype in (torch.float32, torch.float64):
        return F.gelu(x)
    return F.gelu(x, approximate="tanh")


class MultiHeadAttention(nn.Module):
    """Self-attention over [B, S, D] with separate q/k/v/out projections
    (HF CLIP names). Plain self-attention takes the BSHD route of
    common.py:180-187."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, S, D = x.shape
        nh = self.num_heads
        q, k, v = (p(x).view(B, S, nh, D // nh)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(attention_bshd(q, k, v).reshape(B, S, D))


class Mlp(nn.Module):
    """Two linears with an activation between (SAM-2 `MLP` names:
    layers.0 / layers.1)."""

    def __init__(self, dim: int, hidden_dim: int,
                 activation: Callable = gelu_exact):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(dim, hidden_dim),
                                     nn.Linear(hidden_dim, dim)])
        self.activation = activation

    def forward(self, x):
        return self.layers[1](self.activation(self.layers[0](x)))


class MLPBlock(nn.Module):
    """N-layer MLP with ReLU between layers (SAM heads)."""

    def __init__(self, dim: int, hidden_dim: int, out_dim: int, num_layers: int,
                 sigmoid_output: bool = False):
        super().__init__()
        dims = [dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(
            [nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])])
        self.sigmoid_output = sigmoid_output

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


def patchify_conv(x, weight, bias, patch: int):
    """Non-overlapping patch embedding as a reshaped matmul.
    x: [B, H, W, C]; weight: torch conv layout [D, C, p, p] -> [B, L, D]."""
    B, H, W, C = x.shape
    p = patch
    D = weight.shape[0]
    x = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, (H // p) * (W // p), p * p * C)
    w = weight.permute(0, 2, 3, 1).reshape(D, p * p * C)
    y = F.linear(x, w.to(x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
