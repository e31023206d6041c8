"""The arithmetic of the port's 3xTF32 kernels (the f32 attention of
`csrc/attention_f32.cu` and K2's f32 GEMM of `csrc/gemm_f32.cu`) in plain
torch, for the CPU tests (`tests/test_torch_tf32x3.py`,
`tests/test_torch_k2_tf32x3.py`); no model calls it.

The kernels run every product as three TF32 products on wgmma ("3xTF32"):
an f32 x is split into big = rna_tf32(x) (round to nearest, ties away, to
TF32's 10 stored mantissa bits) and small = rna_tf32(x - big); then a . b =
a_big b_small + a_small b_big + a_big b_big, the cross terms first, each
TF32 product exact in the f32 accumulator. `matmul_3xtf32` emulates that
on f32 tensors, `matmul_tf32` the single TF32 product that 3xTF32 exists to
avoid, `attention_fwd` / `attention_bwd` the attention kernels' forward and
backward with either, and `gemm_3xtf32` K2's f32 GEMM with its epilogue.
"""
from __future__ import annotations

import math

import torch

from .fused_block import _K2F, _gelu

LOG2E = 1.4426950408889634
NEG_INF = -1e30


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """`cvt.rna.tf32.f32` on f32 `x`: the 13 low mantissa bits rounded off,
    half away from zero (on the bit pattern, so the sign stays apart)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(big, small): big = rna_tf32(x), small = rna_tf32(x - big)."""
    big = tf32_round(x)
    return big, tf32_round(x.float() - big)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels take it: a_big b_small + a_small b_big, then +
    a_big b_big, in f32."""
    ab, as_ = split_tf32(a)
    bb, bs = split_tf32(b)
    return (ab @ bs + as_ @ bb) + ab @ bb


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one TF32 product (both operands rounded to TF32)."""
    return tf32_round(a) @ tf32_round(b)


def _valid(B, Sq, Sk, causal, kv_lens, q_start, win):
    """[B, Sq, Sk] the keys each query attends, as the kernels mask them."""
    rows = torch.arange(Sq)[None, :, None]
    keys = torch.arange(Sk)[None, None, :]
    kvl = torch.full((B,), Sk) if kv_lens is None else kv_lens.long().clamp(max=Sk)
    ok = keys < kvl[:, None, None]
    if causal:
        qs = torch.zeros(B, dtype=torch.long) if q_start is None else q_start.long()
        ok = ok & (keys <= qs[:, None, None] + rows)
    if win:
        ok = ok & (keys // win == rows // win)
    return ok, kvl


def _zero_slack(t, kvl):
    """Rows of k / v at or past kv_len read as zeros (the kernels' loads)."""
    keep = torch.arange(t.shape[2])[None, :] < kvl[:, None]
    return torch.where(keep[:, None, :, None], t.float(), 0.0)


def attention_fwd(q, k, v, *, sm_scale: float, causal: bool = False,
                  kv_lens=None, q_start=None, win: int = 0,
                  matmul=matmul_3xtf32):
    """The forward kernel's arithmetic: S = Q K^T, the softmax on exp2 from
    the row maximum, O = P V / l, LSE = m ln 2 + ln l (-1e30 and a 0 row
    for a query with no valid key). q: [B,H,Sq,D], k, v: [B,H,Sk,D], f32.
    Returns (o, lse)."""
    B, H, Sq, _ = q.shape
    ok, kvl = _valid(B, Sq, k.shape[2], causal, kv_lens, q_start, win)
    k, v = _zero_slack(k, kvl), _zero_slack(v, kvl)
    s = matmul(q.float(), k.transpose(-1, -2)) * (sm_scale * LOG2E)
    s = torch.where(ok[:, None], s, -math.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - torch.where(m == -math.inf, 0.0, m))
    l = p.sum(-1, keepdim=True)
    o = matmul(p, v) / torch.where(l > 0, l, 1.0)
    lse = torch.where(l > 0, m * math.log(2) + torch.log(l.clamp_min(1e-38)),
                      NEG_INF)
    return o, lse[..., 0]


def attention_bwd(q, k, v, out, lse, dout, *, sm_scale: float,
                  causal: bool = False, kv_lens=None, q_start=None,
                  matmul=matmul_3xtf32):
    """The backward kernels' arithmetic: delta = rowsum(dO * O) in f32, P
    from the forward's LSE, dS = P (dP - delta) scale, dQ = dS K, dK = dS^T
    Q, dV = P^T dO, every product by `matmul`. Returns (dq, dk, dv)."""
    B, H, Sq, _ = q.shape
    ok, kvl = _valid(B, Sq, k.shape[2], causal, kv_lens, q_start, 0)
    k, v = _zero_slack(k, kvl), _zero_slack(v, kvl)
    q, dout = q.float(), dout.float()
    delta = (dout * out.float()).sum(-1, keepdim=True)
    s = matmul(q, k.transpose(-1, -2))
    p = torch.where(ok[:, None],
                    torch.exp2(s * (sm_scale * LOG2E) - lse[..., None] * LOG2E), 0.0)
    dp = matmul(dout, v.transpose(-1, -2))
    ds = p * (dp - delta) * sm_scale
    return (matmul(ds, k), matmul(ds.transpose(-1, -2), q),
            matmul(p.transpose(-1, -2), dout))


def gemm_3xtf32(a: torch.Tensor, w: torch.Tensor, bias=None, *,
                gelu: bool = False, residual=None) -> torch.Tensor:
    """K2's f32 route (csrc/gemm_f32.cu) on f32 tensors: act(a @ w^T +
    bias) (+ residual). a: [M,K], w: [N,K], K a multiple of 8. Both
    operands split once; each k-block of the source's KBLOCK columns is
    summed apart, big.small + small.big first, then + big.big
    (inside a block in matmul's order, where the kernel adds k8 step after
    k8 step on the tensor core), and added to the running sum in f32; then
    + bias, the erf GELU (`_erf_as`), and residual + y."""
    a, w = a.float(), w.float()
    K = a.shape[1]
    if K % 8:
        raise ValueError(f"gemm_3xtf32: K={K} must be a multiple of 8")
    ab, as_ = split_tf32(a)
    wb, ws = split_tf32(w)
    kblock = _K2F["KBLOCK"]
    run = torch.zeros(a.shape[0], w.shape[0])
    for k0 in range(0, K, kblock):
        s = slice(k0, k0 + kblock)
        run = run + ((ab[:, s] @ ws[:, s].T + as_[:, s] @ wb[:, s].T)
                     + ab[:, s] @ wb[:, s].T)
    if bias is not None:
        run = run + bias.float()
    if gelu:
        run = _gelu(run)
    if residual is not None:
        run = residual.float() + run
    return run
