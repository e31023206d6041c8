"""Hiera windowed transformer block (PyTorch port of
videoglamm_tpu/ops/fused_block.py).

On the TPU, one Pallas kernel (`_kernel`, fused_block.py:108) runs a whole
MultiScaleBlock over window tokens. On Hopper, the block is a chain of the
port's hand-written kernels, and every product that the TPU kernel computes
in its body runs in one of them:

    K3 LN1 -> K2 qkv + bias -> K1 window attention -> K2 proj + bias +
    residual -> K3 LN2 -> K2 fc1 + bias + GELU -> K2 fc2 + bias + residual

K2 (`csrc/gemm_epilogue.cu`) is a bf16 GEMM with the bias / GELU / residual
epilogue fused (TMA, wgmma, a persistent grid). Its f32 route
(`csrc/gemm_f32.cu`, counted as "gemm:simt_f32") computes the same function
at f32 accuracy with the erf GELU: the same shape of kernel, its products
as three TF32 products on wgmma (3xTF32) over 144-column tiles, tiled by
`k2_f32_plan`; `gemm_epilogue` dispatches by dtype. Windows shorter than
K1's 128-row query tile are packed
into one (eight of 16 tokens, two of 64) with a block-diagonal `win` mask
(`window_fold`). Fusing the chain into one launch, so that the activation
is read once as on the TPU, is queued in ROADMAP.md.

Training: under a gradient `fused_window_block` runs the chain inside
`_FusedBlock`, whose backward recomputes through `_fused_block_ref` on the
saved input and parameters, as the JAX `custom_vjp` does
(fused_block.py:219-235).

The plain twin `_fused_block_ref` mirrors the JAX reference op for op:
LayerNorm with f32 statistics, products with f32 accumulation rounded to
the working dtype before the bias, f32 softmax, and GELU chosen by dtype.
"""
from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from . import _cuda
from .attention import K1_BM, attention_fwd_kernel
from .norms import _layer_norm_plain, row_norm

# launches: "block" (fused_window_block on the kernel path), "gemm" (K2,
# either route), "gemm:simt_f32" (K2's f32 route)
LAUNCHES = collections.Counter()

PKEYS = ("ln1_weight", "ln1_bias", "qkv_weight", "qkv_bias", "proj_weight",
         "proj_bias", "ln2_weight", "ln2_bias", "fc1_weight", "fc1_bias",
         "fc2_weight", "fc2_bias")


def _erf_as(x):
    """Abramowitz & Stegun 7.1.26 erf, as in fused_block.py:39-51."""
    a1, a2, a3, a4, a5 = (0.254829592, -0.284496736, 1.421413741,
                          -1.453152027, 1.061405429)
    s = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    return s * (1.0 - poly * torch.exp(-ax * ax))


def _gelu(x):
    """erf form in f32 (via `_erf_as`), tanh form below f32
    (fused_block.py:54-59)."""
    if x.dtype in (torch.float32, torch.float64):
        return 0.5 * x * (1.0 + _erf_as(x * (2.0 ** -0.5)))
    return F.gelu(x, approximate="tanh")


def _gemm_plain(a, w, bias=None, *, gelu: bool = False, residual=None):
    """Twin of K2 with the rounding order of fused_block.py:83-105."""
    y = F.linear(a, w.to(a.dtype))
    if bias is not None:
        y = y + bias.to(a.dtype)
    if gelu:
        y = _gelu(y)
    if residual is not None:
        y = residual + y
    return y


def _fused_block_ref(x, p, num_heads: int, eps: float = 1e-6):
    """Twin of `_fused_block_ref` (fused_block.py:71-105).
    x: [NW, S, C] window tokens -> [NW, S, C]; p: PKEYS in nn.Linear
    layout ([out, in] weights)."""
    NW, S, C = x.shape
    H = num_heads
    hd = C // H
    dt = x.dtype
    h = _layer_norm_plain(x, p["ln1_weight"], p["ln1_bias"], eps)
    qkv = _gemm_plain(h, p["qkv_weight"], p["qkv_bias"]).view(NW, S, 3, H, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    logits = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()) * hd ** -0.5
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("nhqk,nkhd->nqhd", probs.to(dt).float(), v.float())
    o = o.to(dt).reshape(NW, S, C)
    x1 = _gemm_plain(o, p["proj_weight"], p["proj_bias"], residual=x)
    h2 = _layer_norm_plain(x1, p["ln2_weight"], p["ln2_bias"], eps)
    mid = _gemm_plain(h2, p["fc1_weight"], p["fc1_bias"], gelu=True)
    return _gemm_plain(mid, p["fc2_weight"], p["fc2_bias"], residual=x1)


# ---------------------------------------------------------------------------
# K2: GEMM + fused epilogue
# ---------------------------------------------------------------------------
_K2F = _cuda.constants("gemm_f32")


def k2_f32_plan(M: int, N: int, K: int) -> dict:
    """The tile plan of K2's f32 route (csrc/gemm_f32.cu) for out[M,N] =
    a[M,K] @ w[N,K]^T: rows and columns of a tile (BM, BN), the K-chunk of
    a ring stage (BK), the K columns a fresh accumulator sums (KBLOCK), the
    ring depths of the A / W chunks and of W's split small planes, the
    threads, the tiles and the dynamic shared memory (the ring, the small
    planes, two warpgroups' [64, BN] output staging, the mbarriers and 1024
    bytes of alignment slack). The constants are the source's `constexpr
    int` lines. Raises ValueError for what the kernel does not build: K or
    N not a positive multiple of 8, M not positive, coordinates or tiles
    past int32, or a plan that does not fit a CTA."""
    c = _K2F
    if M <= 0 or N <= 0 or K <= 0 or K % 8 or N % 8:
        raise ValueError(f"k2_f32_plan: M={M} must be positive and K={K}, "
                         f"N={N} positive multiples of 8")
    if max(M, N, K) >= 2 ** 31:
        raise ValueError(f"k2_f32_plan: {(M, N, K)} past the tensor map's "
                         "int32 coordinates")
    bm, bn, bk = c["BM"], c["BN"], c["BK"]
    tiles = -(-M // bm) * -(-N // bn)
    if tiles >= 2 ** 31:
        raise ValueError(f"k2_f32_plan: {tiles} tiles")
    ring = c["STAGES"] * (bm + bn) * bk * 4
    small = c["SPLIT_STAGES"] * bn * bk * 4
    out = 2 * 64 * bn * 4
    bars = 8 * (3 * c["STAGES"] + c["SPLIT_STAGES"] + 2)
    smem = ring + small + out + bars + c["SMEM_ALIGN"]
    if smem > c["SMEM_MAX"]:
        raise ValueError(f"k2_f32_plan: {smem} bytes of shared memory, above "
                         f"{c['SMEM_MAX']}")
    return dict(bm=bm, bn=bn, bk=bk, kblock=c["KBLOCK"], stages=c["STAGES"],
                split_stages=c["SPLIT_STAGES"], threads=c["NTHREADS"],
                tiles=tiles, col_tiles=-(-N // bn), chunks=-(-K // bk),
                smem=smem)


def _gemm_fn(name: str = "gemm_epilogue", entry: str = "vgt_gemm_epilogue"):
    fn = getattr(_cuda.load(name).lib, entry)
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [P, L, P, P, P, L, P, L, I, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def gemm_epilogue(a, w, bias=None, *, gelu: bool = False, residual=None):
    """K2 wrapper: act(a @ w^T + bias) (+ residual). a: [M,K]; w: [N,K]
    (nn.Linear layout); bias: [N]; residual: [M,N]. A CPU tensor takes the
    plain twin; a CUDA tensor launches K2 or raises. bf16 operands take the
    wgmma kernel (GELU in the tanh form, the rule for bf16); f32 operands
    take the f32 route `csrc/gemm_f32.cu` (3xTF32 on wgmma, the erf GELU
    of `_erf_as`; `k2_f32_plan` is checked first), K2's only way in for
    f32."""
    if a.device.type == "cpu":
        return _gemm_plain(a, w, bias, gelu=gelu, residual=residual)
    M, K = a.shape
    N = w.shape[0]
    if a.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gemm_epilogue: expected bf16 or f32 operands, got "
                         f"{a.dtype}")
    dt = a.dtype
    _cuda.check_operand(a, "a", dt)
    _cuda.check_operand(w, "w", dt)
    if w.shape != (N, K) or not w.is_contiguous():
        raise ValueError("gemm_epilogue: w must be a contiguous [N, K]")
    if K % 8 or N % 8:
        raise ValueError(f"gemm_epilogue: K={K} and N={N} must be multiples of 8")
    if bias is not None:
        _cuda.check_operand(bias, "bias", dt)
        if bias.shape != (N,):
            raise ValueError("gemm_epilogue: bias must be [N]")
    if residual is not None:
        _cuda.check_operand(residual, "residual", dt)
        if residual.shape != (M, N):
            raise ValueError("gemm_epilogue: residual must be [M, N]")
    f32 = dt == torch.float32
    if f32:
        k2_f32_plan(M, N, K)
    fn = _gemm_fn("gemm_f32", "vgt_gemm_f32") if f32 else _gemm_fn()
    out = torch.empty((M, N), dtype=dt, device=a.device)
    err = fn(
        a.data_ptr(), a.stride(0), w.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        residual.data_ptr() if residual is not None else None,
        residual.stride(0) if residual is not None else 0,
        out.data_ptr(), out.stride(0), M, N, K, 1 if gelu else 0,
        _cuda.stream_ptr(a))
    _cuda.check_launch(err, "gemm_epilogue")
    LAUNCHES["gemm"] += 1
    if f32:
        LAUNCHES["gemm:simt_f32"] += 1
    return out


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------
def window_fold(NW: int, S: int) -> int:
    """How many S-token windows K1 packs into one query tile of K1_BM rows
    (attended block-diagonally through `win`): K1_BM // S for windows
    shorter than the tile when that divides the window count, else 1."""
    f = K1_BM // S if S < K1_BM else 1
    return f if f > 1 and NW % f == 0 else 1


def _fused_block_kernels(x, p, num_heads: int, eps: float, exact: bool):
    NW, S, C = x.shape
    H = num_heads
    hd = C // H
    M = NW * S
    x2 = x.reshape(M, C)
    h = row_norm(x2, p["ln1_weight"], p["ln1_bias"], eps, rms=False)
    qkv = gemm_epilogue(h, p["qkv_weight"], p["qkv_bias"])
    # pack short windows into one K1 query tile (block-diagonal mask)
    f = window_fold(NW, S)
    B_, S_ = NW // f, S * f
    qkv5 = qkv.view(B_, S_, 3, H, hd)
    attn = torch.empty((M, C), dtype=x.dtype, device=x.device)
    attention_fwd_kernel(
        qkv5[:, :, 0].transpose(1, 2), qkv5[:, :, 1].transpose(1, 2),
        qkv5[:, :, 2].transpose(1, 2),
        attn.view(B_, S_, H, hd).transpose(1, 2),
        causal=False, sm_scale=hd ** -0.5, mode="window",
        win=S if f > 1 else 0, exact=exact)
    x1 = gemm_epilogue(attn, p["proj_weight"], p["proj_bias"], residual=x2)
    h2 = row_norm(x1, p["ln2_weight"], p["ln2_bias"], eps, rms=False)
    mid = gemm_epilogue(h2, p["fc1_weight"], p["fc1_bias"], gelu=True)
    y = gemm_epilogue(mid, p["fc2_weight"], p["fc2_bias"], residual=x1)
    LAUNCHES["block"] += 1
    return y.view(NW, S, C)


class _FusedBlock(torch.autograd.Function):
    """Counterpart of the block's `custom_vjp` (fused_block.py:219-235):
    the forward is `launch(x, *params)` (the kernel chain, or the plain
    twin for CPU tensors); the backward recomputes through
    `_fused_block_ref` on the saved input and parameters and returns the
    gradients of x and of the 12 parameters (PKEYS order) that ask for
    one."""

    @staticmethod
    def forward(ctx, launch, num_heads, eps, x, *params):
        ctx.save_for_backward(x, *params)
        ctx.num_heads, ctx.eps = num_heads, eps
        return launch(x, *params)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            y = _fused_block_ref(ins[0], dict(zip(PKEYS, ins[1:])),
                                 ctx.num_heads, ctx.eps)
            wrt = [t for t, n in zip(ins, need) if n]
            got = iter(torch.autograd.grad(y, wrt, dout))
        return (None, None, None,
                *(next(got) if n else None for n in need))


def fused_window_block(x, p, num_heads: int, *, eps: float = 1e-6,
                       exact: bool = False):
    """Full windowed transformer block over window tokens.

    x: [NW, S, C]; p: dict of PKEYS (nn.Linear layout). Returns [NW, S, C].
    A CPU tensor takes the plain twin. On the card the chain runs in x's
    dtype: bf16, or f32, where K2 takes its f32 route and K1 the route that
    `k1_route(dtype, hd, exact)` names ("simt_f32" for a model whose
    compute dtype is f32, which passes exact=True). When x or a parameter
    asks for a gradient (and grad mode is on) the chain runs inside
    `_FusedBlock`, whose backward is the recompute through the plain twin:
    no kernel output under a gradient lacks a grad_fn."""
    NW, S, C = x.shape
    hd = C // num_heads
    eps = float(eps)
    # fused_block.py:248
    if (x.is_cuda and S in (16, 64, 256) and hd <= 128
            and C == num_heads * hd):
        def launch(x_, *ps):
            return _fused_block_kernels(x_, dict(zip(PKEYS, ps)), num_heads,
                                        eps, exact)
    else:
        def launch(x_, *ps):
            return _fused_block_ref(x_, dict(zip(PKEYS, ps)), num_heads, eps)
    params = [p[k] for k in PKEYS]
    if torch.is_grad_enabled() and (x.requires_grad
                                    or any(t.requires_grad for t in params)):
        return _FusedBlock.apply(launch, num_heads, eps, x, *params)
    return launch(x, *params)
