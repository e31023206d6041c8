"""1-D resize matrices (the numpy builders of videoglamm_tpu/ops/resize.py
that preprocessing reads) and `resize_bilinear`, the differentiable resize
of mask logits to the ground-truth size in the training forward.

Every resize of the preprocessing front is a separable linear map with a
static (in_size, out_size) matrix, so `ops/preprocess.py` applies it as two
matrix products per stream. The builders are pure numpy and cached; the
device copies are cached by `ops/preprocess.py`.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _linear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Row-stochastic matrix of 1-D linear interpolation with half-pixel
    centers (align_corners=False) and edge clamping (resize.py:19)."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        m[:, 0] = 1.0
        return m
    scale = in_size / out_size
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        src = min(max(src, 0.0), in_size - 1.0)
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        w = src - lo
        m[i, lo] += 1.0 - w
        m[i, hi] += w
    return m


@functools.lru_cache(maxsize=256)
def _pil_matrix(in_size: int, out_size: int, mode: str) -> np.ndarray:
    """Row-stochastic matrix of PIL Image.resize's antialiased separable
    filter (resize.py:68): the kernel's support scales with the downscale
    factor, and boundary windows are clipped and renormalised."""
    if mode == "bilinear":
        support = 1.0

        def f(t):
            t = abs(t)
            return 1.0 - t if t < 1.0 else 0.0
    elif mode == "bicubic":
        support, a = 2.0, -0.5

        def f(t):
            t = abs(t)
            if t <= 1.0:
                return (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1
            if t < 2.0:
                return a * (t ** 3 - 5 * t ** 2 + 8 * t - 4)
            return 0.0
    else:
        raise ValueError(mode)

    m = np.zeros((out_size, in_size), dtype=np.float64)
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    sup = support * fscale
    for i in range(out_size):
        center = (i + 0.5) * scale
        jmin = max(int(center - sup + 0.5), 0)
        jmax = min(int(center + sup + 0.5), in_size)
        w = np.array([f((j + 0.5 - center) / fscale)
                      for j in range(jmin, jmax)])
        m[i, jmin:jmax] = w / w.sum()
    return m.astype(np.float32)


def pil_resize_matrix(in_size: int, out_size: int,
                      mode: str = "bilinear") -> np.ndarray:
    """The PIL-semantics 1-D resize matrix [out_size, in_size]."""
    return _pil_matrix(in_size, out_size, mode)


def _apply_separable(x, mh, mw):
    """x: [..., H, W, C] -> f32 [..., oh, ow, C] (resize.py:127)."""
    y = torch.einsum("oh,...hwc->...owc", mh, x.float())
    return torch.einsum("pw,...owc->...opc", mw, y)


def resize_bilinear(x, out_hw, channels_last: bool = True):
    """Bilinear resize matching torch align_corners=False (resize.py:135), as
    two matrix products, so autograd passes through it. x: [..., H, W, C],
    or [..., C, H, W] with channels_last=False."""
    oh, ow = out_hw
    if not channels_last:
        x = x.movedim(-3, -1)
    H, W = x.shape[-3], x.shape[-2]
    mh = torch.from_numpy(_linear_matrix(H, oh)).to(x.device)
    mw = torch.from_numpy(_linear_matrix(W, ow)).to(x.device)
    y = _apply_separable(x, mh, mw).to(x.dtype)
    if not channels_last:
        y = y.movedim(-1, -3)
    return y
