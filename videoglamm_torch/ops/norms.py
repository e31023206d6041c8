"""RMSNorm and LayerNorm over the last dim, f32 statistics (PyTorch port of
videoglamm_tpu/ops/norms.py).

K3 is a Triton row-norm kernel with an RMS mode and a LayerNorm mode. It
replaces the Pallas kernels `_rms_kernel` (norms.py:45) and `_ln_kernel`
(norms.py:116). The op is bound by memory: one read and one write per
element, with the row statistics kept in registers. A norm has no product
for the tensor cores and no tile for TMA, so Triton serves it as well as
CUDA C++ would. The design (`k3_plan`): a few persistent programs per SM
walk blocks of rows in a strided loop; the f32 weight, and the bias where
there is one, load once per program, not once per row; the next block's
load is issued before the current one reduces; x streams with the
evict-first hint; rows up to 1024 wide go in blocks of rows reduced along
axis 1, and `num_warps` is sized to the row's 16-byte vectors, not to the
padded block. `triton` is imported inside the launcher, so this module
imports on machines that have no Triton.

Training: the JAX package has no Pallas backward for the norms. Its
`custom_vjp` rules recompute through the reference (`_rms_bwd` norms.py:100,
`_ln_bwd` norms.py:167), so here `_RowNorm` runs K3 forward and takes the
gradient of the plain twin on the saved input.
"""
from __future__ import annotations

import collections
import functools

import torch

from . import _cuda

# K3 launches by mode ("rms", "ln"); counted where the kernel launches
LAUNCHES = collections.Counter()


def _rms_norm_plain(x, weight, eps):
    """Op-for-op twin of `_rms_norm_ref` (norms.py:23-27)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def _layer_norm_plain(x, weight, bias, eps):
    """Op-for-op twin of `_layer_norm_ref` (norms.py:30-38)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


K3_BLOCK_ELEMS = 4096     # elements of a program's block of rows
K3_WARPS_PER_SM = 32      # warps of K3's persistent programs on one SM


def _next_pow2(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


def k3_plan(n_rows: int, d: int, elt: int, sms: int) -> dict:
    """K3's launch for n_rows rows of d elements of `elt` bytes on a card
    of `sms` SMs: BLOCK_D (d padded to a power of two), ROWS (rows of a
    block: 1 past d = 1024), num_warps (one per four 16-byte vectors of the
    block's real elements a lane, a power of two up to 8) and `programs`
    (persistent, at most K3_WARPS_PER_SM warps of them an SM). Program p
    takes the blocks p, p + programs, ... (`k3_rows`)."""
    block_d = _next_pow2(d)
    rows = max(1, K3_BLOCK_ELEMS // block_d) if block_d <= 1024 else 1
    vecs = -(-rows * d * elt // 16)
    warps = min(8, _next_pow2(-(-vecs // (32 * 4))))
    blocks = -(-n_rows // rows)
    programs = max(1, min(blocks, sms * max(1, K3_WARPS_PER_SM // warps)))
    return dict(block_d=block_d, rows=rows, num_warps=warps,
                programs=programs, blocks=blocks)


def k3_rows(plan: dict, n_rows: int, program: int):
    """The rows a program of `plan` normalises, in its order."""
    return [b * plan["rows"] + r
            for b in range(program, plan["blocks"], plan["programs"])
            for r in range(plan["rows"]) if b * plan["rows"] + r < n_rows]


@functools.lru_cache(maxsize=None)
def _row_norm_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def kernel(x_ptr, w_ptr, b_ptr, o_ptr, n_rows, d, stride_x, stride_o, eps,
               n_blocks, n_progs, RMS: tl.constexpr, HAS_BIAS: tl.constexpr,
               BLOCK_D: tl.constexpr, ROWS: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK_D)
        cmask = cols < d
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        if HAS_BIAS:
            b = tl.load(b_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        r = tl.arange(0, ROWS)
        # the first block's load, then each block's next before it reduces
        rows = (pid * ROWS + r).to(tl.int64)
        m = (rows < n_rows)[:, None] & cmask[None, :]
        x_next = tl.load(x_ptr + rows[:, None] * stride_x + cols[None, :],
                         mask=m, other=0.0, eviction_policy="evict_first")
        for blk in range(pid, n_blocks, n_progs):
            x = x_next.to(tl.float32)
            rows = (blk * ROWS + r).to(tl.int64)
            m = (rows < n_rows)[:, None] & cmask[None, :]
            nrows = rows + n_progs * ROWS
            mn = (nrows < n_rows)[:, None] & cmask[None, :]
            x_next = tl.load(x_ptr + nrows[:, None] * stride_x + cols[None, :],
                             mask=mn, other=0.0, eviction_policy="evict_first")
            if RMS:
                var = tl.sum(x * x, axis=1) / d
                y = x * tl.rsqrt(var + eps)[:, None] * w[None, :]
            else:
                mean = tl.sum(x, axis=1) / d
                xc = tl.where(cmask[None, :], x - mean[:, None], 0.0)  # pad lanes stay out of var
                var = tl.sum(xc * xc, axis=1) / d
                y = xc * tl.rsqrt(var + eps)[:, None] * w[None, :]
                if HAS_BIAS:
                    y = y + b[None, :]
            tl.store(o_ptr + rows[:, None] * stride_o + cols[None, :],
                     y.to(o_ptr.dtype.element_ty), mask=m)

    return kernel


def row_norm(x, weight, bias, eps: float, *, rms: bool):
    """K3 wrapper: RMSNorm (rms=True) or LayerNorm over the last dim.

    A CPU tensor takes the plain twin. A CUDA tensor launches the Triton
    kernel or raises. x: bf16 or f32 [..., d]; weight/bias: [d], any float
    dtype (read as f32)."""
    if x.device.type == "cpu":
        return (_rms_norm_plain(x, weight, eps) if rms
                else _layer_norm_plain(x, weight, bias, eps))
    if not x.is_cuda:
        raise ValueError(f"row_norm: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"row_norm: unsupported dtype {x.dtype}")
    d = x.shape[-1]
    if weight.shape != (d,) or (bias is not None and bias.shape != (d,)):
        raise ValueError("row_norm: weight/bias must be [d]")
    kernel = _row_norm_kernel()
    x2 = x.reshape(-1, d)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    n = x2.shape[0]
    out = torch.empty((n, d), dtype=x.dtype, device=x.device)
    plan = k3_plan(n, d, x.element_size(), _cuda.sm_count(x.device.index))
    w = weight.contiguous()
    b = bias.contiguous() if bias is not None else w
    kernel[(plan["programs"],)](
        x2, w, b, out, n, d, x2.stride(0), out.stride(0), float(eps),
        plan["blocks"], plan["programs"], RMS=rms, HAS_BIAS=bias is not None,
        BLOCK_D=plan["block_d"], ROWS=plan["rows"],
        num_warps=plan["num_warps"])
    LAUNCHES["rms" if rms else "ln"] += 1
    return out.view(x.shape)


class _RowNorm(torch.autograd.Function):
    """K3 forward; backward = autograd through the plain twin on the saved
    x, weight and bias (gradients to all three)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, rms):
        ctx.save_for_backward(x, weight, bias)
        ctx.eps, ctx.rms = eps, rms
        return row_norm(x, weight, bias, eps, rms=rms)

    @staticmethod
    def backward(ctx, dout):
        x, weight, bias = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need)
                   for t, need in zip((x, weight, bias), ctx.needs_input_grad)
                   if t is not None]
            y = _rms_norm_plain(ins[0], ins[1], ctx.eps) if ctx.rms else \
                _layer_norm_plain(ins[0], ins[1],
                                  ins[2] if bias is not None else None, ctx.eps)
            wanted = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, dout))
        out = [next(grads) if t.requires_grad else None for t in ins]
        if bias is None:
            out.append(None)
        return (*out, None, None)


def _kernel_norm(x, weight, bias, eps, rms):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        return _RowNorm.apply(x, weight, bias, eps, rms)
    return row_norm(x, weight, bias, eps, rms=rms)


def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm over the last dim. x: [..., d], weight: [d]."""
    # norms.py:111: the kernel only pays off from 64K elements
    if x.is_cuda and x.numel() >= (1 << 16):
        return _kernel_norm(x, weight, None, eps, True)
    return _rms_norm_plain(x, weight, eps)


def layer_norm(x, weight, bias=None, eps: float = 1e-5):
    """LayerNorm over the last dim, optional bias."""
    # norms.py:189: lane-aligned widths big enough to amortize a launch
    if x.is_cuda and x.shape[-1] % 128 == 0 and x.numel() >= (1 << 16):
        return _kernel_norm(x, weight, bias, eps, False)
    return _layer_norm_plain(x, weight, bias, eps)
