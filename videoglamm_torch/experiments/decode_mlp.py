"""Fused decode-step programs for int8-weight LLM serving (PyTorch port of
scripts/decode_mlp_experiment.py).

A decode step of the int8 LLM is a chain of about a dozen small launches a
layer (norm -> product -> GLU -> product -> add ...). This experiment folds
the layer into three programs for at most 8 rows (one decoded token a row,
or the `draft_k` rows of a speculative iteration):

  fused_norm_matmul_int8   rmsnorm(x) @ W_qkv * s            (K9 norm_matmul)
  matmul_residual_int8     res + (o @ W_o) * s               (K9 matmul_residual)
  fused_decode_mlp_int8    x + down(silu(gate) * up)(norm)   (K9 mlp, mlp_w8a8)

K9 (`csrc/decode_fused.cu`) holds the four kernels; its header says which
Pallas body each replaces and how the sum over the intermediate width
crosses thread blocks (a cooperative launch with grid barriers, one warp
per output channel, a fixed summation order). It is an experiment: no
serving path calls these functions, as in the JAX package, whose Phi-3 only
points at the script (videoglamm_tpu/models/phi3.py:81-86).
`experiments/bench_decode_fused.py` is the A/B harness against the port's
serving chain.

Weights are in the port's orientation, [N, K] int8 with [N] f32 scales, so
a `QDense`'s `weight` and `scale` go in with no copy (rows past N are its
padding); the JAX script keeps [K, N]. The gate rows come first in
`wgu_q` [2I, K], then the up rows, as the fused `gate_up_proj` holds them.

Beside each kernel stands its plain twin with the body's arithmetic step by
step (the same rounding points, the same `group`-wide activation
quantisation). A CPU tensor takes the twin; a CUDA tensor launches K9 or
raises. `_fused_mlp_ref` and `_norm_matmul_ref` are the unfused chain of the
script (the composition the fused programs are held to there).
"""
from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Optional

import torch

from ..ops import _cuda

# K9 launches by entry ("norm_matmul", "matmul_residual", "mlp", "mlp_w8a8")
LAUNCHES = collections.Counter()

MAX_ROWS = 8          # rows a fused program takes (decode, speculative rows)
W8A8_GROUP = 1024     # decode_mlp_experiment.py:201, `block_i`


# ---------------------------------------------------------------------------
# shared arithmetic
# ---------------------------------------------------------------------------
def _rmsnorm_f32(x2, norm_w, eps: float):
    """`_rmsnorm_block` (:71) before its cast: f32 statistics, f32 weight."""
    xf = x2.float()
    var = (xf * xf).sum(dim=-1, keepdim=True) / xf.shape[-1]
    return xf * torch.rsqrt(var + eps) * norm_w.float()


def _quant_rows_f32(x):
    """`_quant_rows_f32` (:152): per-row symmetric int8 in f32, scale floor
    1e-6. x: [M, C] f32 -> (int8 [M, C], f32 [M, 1])."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp(amax, min=1e-6) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x / s), -127, 127)
    return q.to(torch.int8), s


def _int_dot(q, w_q):
    """s8 [M, C] x s8 [N, C]^T -> s32 [M, N], exact. Integer matmul on the
    CPU; through f64 on a CUDA tensor (every sum is below 2^53), where torch
    has no integer product for so few rows."""
    if q.device.type == "cpu":
        return torch.matmul(q.to(torch.int32), w_q.to(torch.int32).t())
    return torch.matmul(q.double(), w_q.double().t()).to(torch.int32)


def _dot_f32(a, w_q):
    """[M, C] float x int8 [N, C]^T with f32 accumulation (the int8 codes
    are exact in bf16, so this is the bf16 x bf16 -> f32 dot of the body)."""
    return torch.matmul(a.float(), w_q.float().t())


# ---------------------------------------------------------------------------
# plain twins of K9's four entries
# ---------------------------------------------------------------------------
def _norm_matmul_plain(x2, norm_w, w_q, s, eps: float):
    """Twin of K9 norm_matmul, `_nm_kernel` (:282): the normalised rows land
    in x's dtype, f32 accumulation, the scale in the epilogue, one rounding.
    x2: [M, K]; w_q: [>= N, K] int8; s: [N] -> [M, N]."""
    N = s.shape[0]
    xn = _rmsnorm_f32(x2, norm_w, eps).to(x2.dtype)
    return (_dot_f32(xn, w_q[:N]) * s.float()).to(x2.dtype)


def _matmul_residual_plain(x2, w_q, s, res2):
    """Twin of K9 matmul_residual, `_mr_kernel` (:349): the residual is
    added in f32 before the one rounding."""
    N = s.shape[0]
    return (_dot_f32(x2, w_q[:N]) * s.float() + res2.float()).to(x2.dtype)


def _mlp_plain(x2, norm_w, wgu_q, wgu_s, wd_q, wd_s, eps: float):
    """Twin of K9 mlp, `_mlp_kernel` (:80): gate and up land in x's dtype
    before the GLU (:96-100), h in x's dtype before the down product, the
    down product accumulates in f32 over the whole of I, and the residual
    and the last rounding come after the whole sum (:107-108)."""
    I, D = wgu_q.shape[0] // 2, wd_s.shape[0]
    dt = x2.dtype
    xn = _rmsnorm_f32(x2, norm_w, eps).to(dt)
    sgu = wgu_s.float()
    g = (_dot_f32(xn, wgu_q[:I]) * sgu[:I]).to(dt).float()
    u = (_dot_f32(xn, wgu_q[I:2 * I]) * sgu[I:]).to(dt).float()
    h = (g * torch.sigmoid(g) * u).to(dt)
    acc = _dot_f32(h, wd_q[:D])
    return (acc * wd_s.float() + x2.float()).to(dt)


class W8A8Trace(NamedTuple):
    """The integers of one mlp_w8a8 call, for holding kernel and twin equal
    up to the f32 epilogue."""
    xq: torch.Tensor       # [M, K] int8 codes of the normalised rows
    xs: torch.Tensor       # [M] f32 row scales
    gu: torch.Tensor       # [M, 2I] s32 gate and up sums
    hq: torch.Tensor       # [M, I] int8 codes of h
    hs: torch.Tensor       # [M, I / group] f32 group scales
    down: torch.Tensor     # [I / group, M, D] s32 down sums per group


def _mlp_w8a8_plain(x2, norm_w, wgu_q, wgu_s, wd_q, wd_s, eps: float,
                    group: int = W8A8_GROUP, trace: bool = False):
    """Twin of K9 mlp_w8a8, `_mlp_w8a8_kernel` (:160): the normalised row
    is quantised to int8 once, in f32 with no rounding before it; gate and
    up are s8 x s8 -> s32 products scaled by (xs * s); h stays f32 and is
    quantised per row over each `group` columns of I (:189, one I-block of
    the Pallas grid); the down products of the groups are added in
    ascending order, each scaled by its group's hs."""
    I, D = wgu_q.shape[0] // 2, wd_s.shape[0]
    group = min(group, I)
    if I % group:
        raise ValueError(f"mlp_w8a8: I={I} is not a multiple of the group {group}")
    xq, xs = _quant_rows_f32(_rmsnorm_f32(x2, norm_w, eps))
    gu = _int_dot(xq, wgu_q[:2 * I])
    sgu = wgu_s.float()
    g = gu[:, :I].float() * (xs * sgu[:I])
    u = gu[:, I:].float() * (xs * sgu[I:])
    h = g * torch.sigmoid(g) * u
    acc = torch.zeros(x2.shape[0], D, dtype=torch.float32, device=x2.device)
    hqs, hss, downs = [], [], []
    for j in range(I // group):
        cols = slice(j * group, (j + 1) * group)
        hq, hs = _quant_rows_f32(h[:, cols])
        part = _int_dot(hq, wd_q[:D, cols])
        acc = acc + part.float() * hs
        hqs.append(hq), hss.append(hs), downs.append(part)
    out = (acc * wd_s.float() + x2.float()).to(x2.dtype)
    if not trace:
        return out
    return out, W8A8Trace(xq, xs[:, 0], gu, torch.cat(hqs, dim=1),
                          torch.cat(hss, dim=1), torch.stack(downs))


# ---------------------------------------------------------------------------
# the unfused chain of the script
# ---------------------------------------------------------------------------
# `_norm_matmul_ref` (:324), rmsnorm and then the dequantising product, rounds
# where the fused body rounds: the chain and the twin are one function
_norm_matmul_ref = _norm_matmul_plain


def _fused_mlp_ref(x2, norm_w, wgu_q, wgu_s, wd_q, wd_s, eps: float):
    """`_fused_mlp_ref` (:242): rmsnorm -> dequant gate_up -> silu * up ->
    dequant down -> + residual, each step rounded to x's dtype (the down
    product is rounded BEFORE the residual is added, where the fused body
    rounds after)."""
    I, D = wgu_q.shape[0] // 2, wd_s.shape[0]
    dt = x2.dtype
    h = _rmsnorm_f32(x2, norm_w, eps).to(dt)
    gu = (_dot_f32(h, wgu_q[:2 * I]) * wgu_s.float()).to(dt)
    gate, up = gu[:, :I].float(), gu[:, I:].float()
    m = (gate * torch.sigmoid(gate) * up).to(dt)
    y = _dot_f32(m, wd_q[:D])
    return x2 + (y * wd_s.float()).to(dt)


# ---------------------------------------------------------------------------
# K9 launchers
# ---------------------------------------------------------------------------
def _fn(entry: str):
    fn = getattr(_cuda.load("decode_fused").lib, f"vgt_decode_{entry}")
    if fn.argtypes is None:
        P, L, I, F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_float)
        fn.argtypes = {
            "norm_matmul": [P, L, P, P, P, P, L, I, I, I, F, P],
            "matmul_residual": [P, L, P, P, P, L, P, L, I, I, I, P],
            "mlp": [P, L, P, P, P, P, P, P, P, L, I, I, I, I, F, P],
            "mlp_w8a8": [P, L, P, P, P, P, P, P, P, P, P, L, I, I, I, I, I, F,
                         P, P, P, P, P],
        }[entry]
        fn.restype = ctypes.c_int
    return fn


def _check_x(x2, what: str):
    _cuda.check_operand(x2, f"{what}: x", torch.bfloat16)
    if not 1 <= x2.shape[0] <= MAX_ROWS:
        raise ValueError(f"{what}: {x2.shape[0]} rows; a fused decode program "
                         f"takes 1 to {MAX_ROWS}")


def _check_weight(w_q, s, K: int, what: str, rows: Optional[int] = None):
    """int8 [>= len(s), K] rows of 16-byte vectors with f32 scales, on the
    card."""
    N = s.shape[0] if rows is None else rows
    if w_q.dim() != 2 or w_q.shape[0] < N or w_q.shape[1] != K:
        raise ValueError(f"{what}: weight {tuple(w_q.shape)} for K={K} and "
                         f"{N} channels")
    for name, t, dt in ((f"{what} weight", w_q, torch.int8),
                        (f"{what} scale", s, torch.float32)):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA {dt} tensor")
    if K % 16 or w_q.data_ptr() % 16:
        raise ValueError(f"{what}: weight rows of {K} bytes are not 16-byte "
                         "vectors")


def _check_norm(norm_w, K: int, what: str):
    if not norm_w.is_cuda or norm_w.dtype != torch.float32 \
            or norm_w.shape != (K,) or not norm_w.is_contiguous():
        raise ValueError(f"{what}: the norm weight must be a contiguous CUDA "
                         f"f32 [{K}] tensor")


def norm_matmul_kernel(x2, norm_w, w_q, s, eps: float):
    """Launch K9 norm_matmul. x2: [M <= 8, K] bf16; norm_w: [K] f32; w_q:
    [>= N, K] int8, K % 16 == 0; s: [N] f32 -> [M, N] bf16."""
    M, K = x2.shape
    N = s.shape[0]
    _check_x(x2, "norm_matmul")
    _check_norm(norm_w, K, "norm_matmul")
    _check_weight(w_q, s, K, "norm_matmul")
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    err = _fn("norm_matmul")(
        x2.data_ptr(), x2.stride(0), norm_w.data_ptr(), w_q.data_ptr(),
        s.data_ptr(), out.data_ptr(), out.stride(0), M, N, K, float(eps),
        _cuda.stream_ptr(x2))
    _cuda.check_launch(err, "decode_fused norm_matmul")
    LAUNCHES["norm_matmul"] += 1
    return out


def matmul_residual_kernel(x2, w_q, s, res2):
    """Launch K9 matmul_residual. x2: [M <= 8, K] bf16; w_q: [>= N, K]
    int8; s: [N] f32; res2: [M, N] bf16 -> [M, N] bf16."""
    M, K = x2.shape
    N = s.shape[0]
    _check_x(x2, "matmul_residual")
    _check_weight(w_q, s, K, "matmul_residual")
    _cuda.check_operand(res2, "matmul_residual: res", torch.bfloat16)
    if res2.shape != (M, N):
        raise ValueError(f"matmul_residual: res {tuple(res2.shape)} for an "
                         f"output [{M},{N}]")
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    err = _fn("matmul_residual")(
        x2.data_ptr(), x2.stride(0), w_q.data_ptr(), s.data_ptr(),
        res2.data_ptr(), res2.stride(0), out.data_ptr(), out.stride(0),
        M, N, K, _cuda.stream_ptr(x2))
    _cuda.check_launch(err, "decode_fused matmul_residual")
    LAUNCHES["matmul_residual"] += 1
    return out


def _check_mlp(x2, norm_w, wgu_q, wgu_s, wd_q, wd_s, what: str):
    M, K = x2.shape
    I, D = wgu_s.shape[0] // 2, wd_s.shape[0]
    _check_x(x2, what)
    _check_norm(norm_w, K, what)
    _check_weight(wgu_q, wgu_s, K, f"{what} gate_up")
    _check_weight(wd_q, wd_s, I, f"{what} down")
    if wgu_s.shape[0] != 2 * I or D != K:
        raise ValueError(f"{what}: gate_up of {wgu_s.shape[0]} channels, down "
                         f"[{D},{I}] for x [{M},{K}] (the residual needs D == K)")
    return M, K, I, D


def mlp_kernel(x2, norm_w, wgu_q, wgu_s, wd_q, wd_s, eps: float):
    """Launch K9 mlp. x2: [M <= 8, K] bf16; wgu_q: [2I, K] int8 (gate rows,
    then up rows) with wgu_s [2I]; wd_q: [>= K, I] int8 with wd_s [K]; K
    and I multiples of 16 -> [M, K] bf16."""
    M, K, I, D = _check_mlp(x2, norm_w, wgu_q, wgu_s, wd_q, wd_s, "mlp")
    out = torch.empty((M, D), dtype=x2.dtype, device=x2.device)
    hbuf = torch.empty((M, I), dtype=x2.dtype, device=x2.device)
    err = _fn("mlp")(
        x2.data_ptr(), x2.stride(0), norm_w.data_ptr(), wgu_q.data_ptr(),
        wgu_s.data_ptr(), wd_q.data_ptr(), wd_s.data_ptr(), hbuf.data_ptr(),
        out.data_ptr(), out.stride(0), M, K, I, D, float(eps),
        _cuda.stream_ptr(x2))
    _cuda.check_launch(err, "decode_fused mlp")
    LAUNCHES["mlp"] += 1
    return out


def mlp_w8a8_kernel(x2, norm_w, wgu_q, wgu_s, wd_q, wd_s, eps: float,
                    group: int = W8A8_GROUP, trace: bool = False):
    """Launch K9 mlp_w8a8; operands as `mlp_kernel`. group: the columns of
    I that share one activation scale (min(group, I) must divide I and be a
    multiple of 16). trace=True also returns the kernel's integers as a
    `W8A8Trace`."""
    M, K, I, D = _check_mlp(x2, norm_w, wgu_q, wgu_s, wd_q, wd_s, "mlp_w8a8")
    group = min(int(group), I)
    if group % 16 or I % group:
        raise ValueError(f"mlp_w8a8: group {group} must be a multiple of 16 "
                         f"that divides I={I}")
    dev, G = x2.device, I // group
    out = torch.empty((M, D), dtype=x2.dtype, device=dev)
    hf = torch.empty((M, I), dtype=torch.float32, device=dev)
    hq = torch.empty((M, I), dtype=torch.int8, device=dev)
    hs = torch.empty((M, G), dtype=torch.float32, device=dev)
    dbg = [None] * 4
    if trace:
        dbg = [torch.empty((M, K), dtype=torch.int8, device=dev),
               torch.empty((M,), dtype=torch.float32, device=dev),
               torch.empty((M, 2 * I), dtype=torch.int32, device=dev),
               torch.empty((G, M, D), dtype=torch.int32, device=dev)]
    err = _fn("mlp_w8a8")(
        x2.data_ptr(), x2.stride(0), norm_w.data_ptr(), wgu_q.data_ptr(),
        wgu_s.data_ptr(), wd_q.data_ptr(), wd_s.data_ptr(), hf.data_ptr(),
        hq.data_ptr(), hs.data_ptr(), out.data_ptr(), out.stride(0), M, K, I,
        D, group, float(eps),
        *(t.data_ptr() if t is not None else None for t in dbg),
        _cuda.stream_ptr(x2))
    _cuda.check_launch(err, "decode_fused mlp_w8a8")
    LAUNCHES["mlp_w8a8"] += 1
    if not trace:
        return out
    return out, W8A8Trace(dbg[0], dbg[1], dbg[2], hq, hs, dbg[3])


# ---------------------------------------------------------------------------
# entries
# ---------------------------------------------------------------------------
def fused_norm_matmul_int8(x, norm_w, w_q, s, eps: float = 1e-5):
    """rmsnorm(x) @ dequant(w_q, s) in one program (decode qkv projection;
    `fused_norm_matmul_int8`, :333). x: [..., K] with at most 8 rows; w_q:
    [>= N, K] int8; s: [N] -> [..., N]."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if x2.device.type == "cpu":
        y = _norm_matmul_plain(x2, norm_w, w_q, s, float(eps))
    else:
        y = norm_matmul_kernel(x2, norm_w, w_q, s, float(eps))
    return y.reshape(*lead, s.shape[0])


def matmul_residual_int8(x, w_q, s, res):
    """res + x @ dequant(w_q, s) in one program (decode o_proj;
    `matmul_residual_int8`, :384). x: [..., K]; w_q: [>= N, K] int8; s:
    [N]; res: [..., N] -> [..., N]."""
    lead, K = x.shape[:-1], x.shape[-1]
    N = s.shape[0]
    x2, r2 = x.reshape(-1, K), res.reshape(-1, N)
    if x2.device.type == "cpu":
        y = _matmul_residual_plain(x2, w_q, s, r2)
    else:
        y = matmul_residual_kernel(x2, w_q, s, r2)
    return y.reshape(*lead, N)


def fused_decode_mlp_int8(x, norm_w, wgu_q, wgu_s, wd_q, wd_s,
                          eps: float = 1e-5, *, w8a8: bool = False,
                          group: int = W8A8_GROUP):
    """x + down(silu(gate) * up) over rmsnorm(x) in one program
    (`fused_decode_mlp_int8`, :259; w8a8=True is `_fused_mlp_pallas_w8a8`,
    :201). x: [..., D] with at most 8 rows; wgu_q: [2I, D] int8 (+ scale
    [2I]); wd_q: [>= D, I] int8 (+ scale [D]) -> [..., D]. group: the
    w8a8 variant's activation-scale width along I."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    args = (x2, norm_w, wgu_q, wgu_s, wd_q, wd_s, float(eps))
    if x2.device.type == "cpu":
        y = _mlp_w8a8_plain(*args, group) if w8a8 else _mlp_plain(*args)
    else:
        y = mlp_w8a8_kernel(*args, group) if w8a8 else mlp_kernel(*args)
    return y.reshape(*lead, wd_s.shape[0])
