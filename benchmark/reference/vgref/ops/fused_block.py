"""The windowed Hiera block written out in plain operations."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .attention import attention_packed_qkv_padded
from .norms import layer_norm


def fused_window_block(x, p, num_heads: int, *, eps: float = 1e-6,
                       exact: bool = False):
    """x [NW,S,C] window tokens -> [NW,S,C]: LN, qkv, attention inside each
    window, proj + residual, LN, fc1 + erf GELU, fc2 + residual."""
    NW, S, C = x.shape
    h = layer_norm(x, p["ln1_weight"], p["ln1_bias"], eps)
    qkv = F.linear(h, p["qkv_weight"], p["qkv_bias"])
    o = attention_packed_qkv_padded(qkv, num_heads, C // num_heads)
    x1 = x + F.linear(o, p["proj_weight"], p["proj_bias"])
    h2 = layer_norm(x1, p["ln2_weight"], p["ln2_bias"], eps)
    mid = F.gelu(F.linear(h2, p["fc1_weight"], p["fc1_bias"]))
    return x1 + F.linear(mid, p["fc2_weight"], p["fc2_bias"])
