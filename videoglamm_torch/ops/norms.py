"""RMSNorm and LayerNorm over the last dim, f32 statistics (PyTorch port of
videoglamm_tpu/ops/norms.py).

K3 is a Triton row-norm kernel with an RMS mode and a LayerNorm mode. It
replaces the Pallas kernels `_rms_kernel` (norms.py:45) and `_ln_kernel`
(norms.py:116). The op is a memory-bound single pass: one read and one
write per element, with the row statistics kept in registers. Masked loads
with `BLOCK_D = next_pow2(d)` cover the widths that are not powers of two
(1408, 1152, 144) with coalesced access. A few rows go to each program
when rows are narrow. `triton` is imported inside the launcher, so this
module imports on machines that have no Triton.
"""
from __future__ import annotations

import collections
import functools

import torch

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


@functools.lru_cache(maxsize=None)
def _row_norm_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def kernel(x_ptr, w_ptr, b_ptr, o_ptr, n_rows, d, stride_x, stride_o, eps,
               RMS: tl.constexpr, HAS_BIAS: tl.constexpr,
               BLOCK_D: tl.constexpr, ROWS: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK_D)
        cmask = cols < d
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        if HAS_BIAS:
            b = tl.load(b_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        for i in tl.static_range(ROWS):
            row = (pid * ROWS + i).to(tl.int64)
            m = cmask & (row < n_rows)
            x = tl.load(x_ptr + row * stride_x + cols, mask=m,
                        other=0.0).to(tl.float32)
            if RMS:
                var = tl.sum(x * x, axis=0) / d
                y = x * tl.rsqrt(var + eps) * w
            else:
                mean = tl.sum(x, axis=0) / d
                xc = tl.where(cmask, x - mean, 0.0)   # pad lanes stay out of var
                var = tl.sum(xc * xc, axis=0) / d
                y = xc * tl.rsqrt(var + eps) * w
                if HAS_BIAS:
                    y = y + b
            tl.store(o_ptr + row * stride_o + cols,
                     y.to(o_ptr.dtype.element_ty), mask=m)

    return kernel, triton.next_power_of_2


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
    kernel, next_pow2 = _row_norm_kernel()
    x2 = x.reshape(-1, d)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    n = x2.shape[0]
    out = torch.empty((n, d), dtype=x.dtype, device=x.device)
    block_d = next_pow2(d)
    rows = 4 if block_d <= 1024 else 1
    w = weight.contiguous()
    b = bias.contiguous() if bias is not None else w
    kernel[((n + rows - 1) // rows,)](
        x2, w, b, out, n, d, x2.stride(0), out.stride(0), float(eps),
        RMS=rms, HAS_BIAS=bias is not None, BLOCK_D=block_d, ROWS=rows,
        num_warps=4 if block_d <= 1024 else 8)
    LAUNCHES["rms" if rms else "ln"] += 1
    return out.view(x.shape)


def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm over the last dim. x: [..., d], weight: [d]."""
    # norms.py:111: the kernel only pays off from 64K elements
    if x.is_cuda and x.numel() >= (1 << 16):
        return row_norm(x, weight, None, eps, rms=True)
    return _rms_norm_plain(x, weight, eps)


def layer_norm(x, weight, bias=None, eps: float = 1e-5):
    """LayerNorm over the last dim, optional bias."""
    # norms.py:189: lane-aligned widths big enough to amortize a launch
    if x.is_cuda and x.shape[-1] % 128 == 0 and x.numel() >= (1 << 16):
        return row_norm(x, weight, bias, eps, rms=False)
    return _layer_norm_plain(x, weight, bias, eps)
