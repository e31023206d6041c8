"""Int8 and int4 weight quantisation and the products over quantised
weights, in plain operations. The quantisers follow the serving
configuration's rules: symmetric per output channel (int8), per output
channel and group of 128 inputs (int4); activations quantised per token
(W8A8) for calls of W8A8_MIN_M rows and more, which is the prefill."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

W8A8_MIN_M = 256       # rows from which the prefill's W8A8 product runs
MATVEC4_MAX_M = 64     # int4: up to this many rows the weights stream as they are


def quantize_int8(w) -> Tuple[torch.Tensor, torch.Tensor]:
    wf = w.float()
    amax = wf.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_rows(x) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) * (1.0 / 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_int4(w, group: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    N, K = w.shape
    wf = w.float().view(N, K // group, group)
    amax = wf.abs().amax(dim=2)
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale[:, :, None]), -8, 7)
    q = q.view(N, K).to(torch.int16)
    packed = (q[:, 0::2] & 0x0F) | ((q[:, 1::2] & 0x0F) << 4)
    return packed.to(torch.uint8).view(torch.int8), scale


def pad_rows8(w_q):
    pad = -w_q.shape[0] % 8
    return F.pad(w_q, (0, 0, 0, pad)) if pad else w_q


def _dequant4_weights(packed, scales, group: int, dtype):
    p32 = packed.to(torch.int32)
    lo, hi = ((p32 & 15) ^ 8) - 8, p32 >> 4
    N, K2 = packed.shape
    q = torch.stack([lo, hi], dim=2).view(N, 2 * K2)
    w = q.float() * scales.float().repeat_interleave(group, dim=1)
    return w.to(dtype)


def dequant_matmul(x, w_q, scale, *, w8a8_min_m: int = W8A8_MIN_M):
    """x [..., K] float; w_q [>= N, K] int8 codes (or the same codes as
    f32); scale [N] -> [..., N] in x's dtype, summed in f32. W8A8 (x
    quantised per row) from w8a8_min_m rows."""
    lead, K = x.shape[:-1], x.shape[-1]
    N = scale.shape[0]
    x2 = x.reshape(-1, K)
    w = w_q[:N].float()
    if x2.shape[0] >= w8a8_min_m:
        q, s = quantize_rows(x2)
        y = torch.matmul(q.float(), w.t()) * s * scale.float()
    else:
        y = torch.matmul(x2.float(), w.t()) * scale.float()
    return y.to(x.dtype).reshape(*lead, N)
