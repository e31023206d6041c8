"""Plain attention for the reference: f32 products and softmax, no kernel.

The entry points carry the names the model files call. Every one computes
the whole softmax in f32; a long query axis is cut into blocks of rows so
that the logits of one block fit."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
ROWS = 1024      # query rows of one block of logits


def _attention(q, k, v, *, causal: bool, sm_scale: float, kv_lens=None,
               q_start=None, kv_mask=None, bias=None, k_scale=None,
               v_scale=None):
    """q [B,H,Sq,D], k/v [B,H,Sk,D] -> [B,H,Sq,D] in q's dtype. q_start: the
    absolute key position of query 0 (default kv_lens - Sq, or Sk - Sq).
    k_scale / v_scale [B,H,Sk]: k and v are int8 codes, their scales folded
    into the logits and the probabilities."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    dev = q.device
    kf, vf = k.float(), v.float()
    if q_start is None:
        q_start = (kv_lens - Sq) if kv_lens is not None else \
            torch.full((B,), Sk - Sq, dtype=torch.int64, device=dev)
    ki = torch.arange(Sk, device=dev)
    keep = torch.ones(B, 1, 1, Sk, dtype=torch.bool, device=dev)
    if kv_lens is not None:
        keep = keep & (ki[None] < kv_lens.to(dev)[:, None])[:, None, None]
    if kv_mask is not None:
        keep = keep & kv_mask[:, None, None, :]
    out = []
    for r0 in range(0, Sq, ROWS):
        r1 = min(Sq, r0 + ROWS)
        s = torch.matmul(q[:, :, r0:r1].float(), kf.transpose(-1, -2)) * sm_scale
        if k_scale is not None:
            s = s * k_scale[:, :, None, :].float()
        if bias is not None:
            s = s + bias[..., r0:r1, :].float()
        m = keep
        if causal:
            qi = torch.arange(r0, r1, device=dev)[None, :, None] \
                + q_start.to(dev).view(B, 1, 1)
            m = m & (qi >= ki[None, None, :])[:, None]
        s = torch.where(m, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        if v_scale is not None:
            p = p * v_scale[:, :, None, :].float()
        out.append(torch.matmul(p, vf))
    return torch.cat(out, dim=2).to(q.dtype)


def _bshd(q, k, v, sm_scale: float, win: int = 0):
    """q [B,Sq,H,D], k/v [B,Sk,H,D] -> [B,Sq,H,D]; win > 0: block-diagonal
    attention over windows of `win` tokens."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if win and win < k.shape[1]:
        B, H, S, D = qt.shape
        n = S // win
        qt, kt, vt = (t.reshape(B, H, n, win, D).transpose(1, 2)
                      .reshape(B * n, H, win, D) for t in (qt, kt, vt))
        o = _attention(qt, kt, vt, causal=False, sm_scale=sm_scale)
        o = o.reshape(B, n, H, win, D).transpose(1, 2).reshape(B, H, S, D)
    else:
        o = _attention(qt, kt, vt, causal=False, sm_scale=sm_scale)
    return o.transpose(1, 2)


def attention_bshd(q, k, v, *, sm_scale: Optional[float] = None,
                   exact: bool = False):
    return _bshd(q, k, v, sm_scale or q.shape[-1] ** -0.5)


def attention_bshd_cross(q, k, v, *, sm_scale: Optional[float] = None):
    return _bshd(q, k, v, sm_scale or q.shape[-1] ** -0.5)


def attention_packed_qkv_padded(qkv, num_heads: int, head_dim: int, *,
                                win: int = 0, sm_scale: Optional[float] = None,
                                exact: bool = False):
    """qkv [B,S,3*H*hd] -> [B,S,H*hd]."""
    B, S, _ = qkv.shape
    x = qkv.view(B, S, 3, num_heads, head_dim)
    o = _bshd(x[:, :, 0], x[:, :, 1], x[:, :, 2],
              sm_scale or head_dim ** -0.5, win)
    return o.reshape(B, S, num_heads * head_dim)


def attention_packed_qkv_smallwin(qkv, num_heads: int, head_dim: int, *,
                                  sm_scale: Optional[float] = None,
                                  exact: bool = False):
    """qkv [NW,S,3*H*hd], attention inside each window -> [NW,S,H*hd]."""
    return attention_packed_qkv_padded(qkv, num_heads, head_dim,
                                       sm_scale=sm_scale)


def dot_product_attention(q, k, v, *, causal: bool = False, kv_lens=None,
                          kv_mask=None, bias=None, q_start=None,
                          sm_scale: Optional[float] = None,
                          k_scale=None, v_scale=None, layer=None,
                          exact: bool = False):
    """q/k/v [B,H,S,D]. With k_scale / v_scale, k and v are the int8 cache:
    token-major rows [B,C,Hkv*hd], or the stacked [L,B,C,Hkv*hd] with
    `layer`, and scales [(L,) B, Hkv, C]."""
    sm_scale = sm_scale or q.shape[-1] ** -0.5
    if k_scale is not None:
        if k.dim() == 4:
            k, v, k_scale, v_scale = (t[layer] for t in (k, v, k_scale, v_scale))
        B, Hq, _, hd = q.shape
        Hkv, C = k_scale.shape[-2], k.shape[-2]
        k = k.view(B, C, Hkv, hd).transpose(1, 2)
        v = v.view(B, C, Hkv, hd).transpose(1, 2)
        if Hq != Hkv:
            rep = Hq // Hkv
            k, v, k_scale, v_scale = (t.repeat_interleave(rep, dim=1)
                                      for t in (k, v, k_scale, v_scale))
    return _attention(q, k, v, causal=causal, sm_scale=sm_scale,
                      kv_lens=kv_lens, q_start=q_start, kv_mask=kv_mask,
                      bias=bias, k_scale=k_scale, v_scale=v_scale)
