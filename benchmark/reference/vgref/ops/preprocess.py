"""On-device video preprocessing: decoded uint8 frames -> the three encoder
input streams (PyTorch port of videoglamm_tpu/ops/preprocess.py).

Every resize of the host pipeline is a separable linear map with a static
(in_size, out_size) matrix (`ops/resize.py`), so each stream is two matrix
products: the InternVideo2 stream a direct bilinear resize to 224 x 224, the
CLIP stream a shortest-edge bicubic resize with the center crop taken as a
row slice of the resize matrix, and the SAM stream the longest-side
bilinear resize composed with the bilinear resize to the square. The
matrices are row-stochastic, so the normalisations commute with the
resizes and are applied once at the end. The caller ships one uint8 tensor
per clip; all float traffic stays on the device.

The JAX package computes these products outside any Pallas kernel, so they
are `torch.einsum` here. The device copies of the matrices are cached per
(stream, H, W, size, device).
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..constants import (CLIP_IMAGE_SIZE, CLIP_MEAN, CLIP_STD, IMAGENET_MEAN,
                         IMAGENET_STD, INTERNVIDEO_IMAGE_SIZE, SAM_IMAGE_SIZE,
                         SAM_PIXEL_MEAN, SAM_PIXEL_STD)
from .resize import _linear_matrix, pil_resize_matrix


def _iv_mats(H: int, W: int, size: int):
    """Direct bilinear to size x size (preprocess.py:35)."""
    return (pil_resize_matrix(H, size, "bilinear"),
            pil_resize_matrix(W, size, "bilinear"))


def _clip_mats(H: int, W: int, size: int):
    """Shortest-edge bicubic + center crop; the crop is a row slice of the
    resize matrix (preprocess.py:43)."""
    short = min(W, H)
    nw, nh = round(W * size / short), round(H * size / short)
    mh = pil_resize_matrix(H, nh, "bicubic")
    mw = pil_resize_matrix(W, nw, "bicubic")
    top, left = (nh - size) // 2, (nw - size) // 2
    return mh[top:top + size], mw[left:left + size]


def _sam_mats(H: int, W: int, size: int):
    """Longest-side PIL bilinear, then bilinear to the square, composed into
    one matrix per axis (preprocess.py:56)."""
    scale = size / max(W, H)
    nw, nh = int(W * scale + 0.5), int(H * scale + 0.5)
    mh = pil_resize_matrix(H, nh, "bilinear")
    mw = pil_resize_matrix(W, nw, "bilinear")
    if nh != size:
        mh = _linear_matrix(nh, size) @ mh
    if nw != size:
        mw = _linear_matrix(nw, size) @ mw
    return mh, mw


_BUILDERS = {"iv": _iv_mats, "clip": _clip_mats, "sam": _sam_mats}


@functools.lru_cache(maxsize=64)
def _mats(stream: str, H: int, W: int, size: int, device: torch.device):
    mh, mw = _BUILDERS[stream](H, W, size)
    return tuple(torch.from_numpy(np.ascontiguousarray(m)).to(device)
                 for m in (mh, mw))


def _sep(x, mh, mw):
    """x: [..., H, W, C] f32 -> [..., oh, ow, C]."""
    y = torch.einsum("oh,...hwc->...owc", mh, x)
    return torch.einsum("pw,...owc->...opc", mw, y)


def _sep_clamped(x, mh, mw):
    """PIL's uint8 bicubic clamps overshoot to [0, 255] between its
    horizontal and its vertical pass; bilinear kernels are non-negative, so
    only the bicubic (CLIP) stream needs it (preprocess.py:78)."""
    y = torch.einsum("pw,...hwc->...hpc", mw, x).clamp(0.0, 255.0)
    return torch.einsum("oh,...hpc->...opc", mh, y).clamp(0.0, 255.0)


def _stats(mean, std, device):
    return (torch.tensor(mean, dtype=torch.float32, device=device),
            torch.tensor(std, dtype=torch.float32, device=device))


def preprocess_iv_stream(frames, size: int = INTERNVIDEO_IMAGE_SIZE,
                         dtype=torch.float32):
    """[..., H, W, 3] uint8/float 0-255 -> [..., size, size, 3]
    ImageNet-normalised."""
    H, W = frames.shape[-3], frames.shape[-2]
    mean, std = _stats(IMAGENET_MEAN, IMAGENET_STD, frames.device)
    iv = _sep(frames.float(), *_mats("iv", H, W, size, frames.device)) / 255.0
    return ((iv - mean) / std).to(dtype)


def preprocess_clip_stream(frames, size: int = CLIP_IMAGE_SIZE,
                           dtype=torch.float32):
    """[..., H, W, 3] -> [..., size, size, 3] CLIP-normalised (bicubic +
    crop)."""
    H, W = frames.shape[-3], frames.shape[-2]
    mean, std = _stats(CLIP_MEAN, CLIP_STD, frames.device)
    cl = _sep_clamped(frames.float(),
                      *_mats("clip", H, W, size, frames.device)) / 255.0
    return ((cl - mean) / std).to(dtype)


def preprocess_sam_stream(frames, size: int = SAM_IMAGE_SIZE,
                          dtype=torch.float32):
    """[..., H, W, 3] -> [..., size, size, 3] SAM-normalised. Separate from
    the other streams because the mask decoder may see other frames than
    the LLM prefix."""
    H, W = frames.shape[-3], frames.shape[-2]
    mean, std = _stats(SAM_PIXEL_MEAN, SAM_PIXEL_STD, frames.device)
    sam = _sep(frames.float(), *_mats("sam", H, W, size, frames.device))
    return ((sam - mean) / std).to(dtype)


def preprocess_streams(frames, iv_size: int = INTERNVIDEO_IMAGE_SIZE,
                       clip_size: int = CLIP_IMAGE_SIZE,
                       sam_size: int = SAM_IMAGE_SIZE, dtype=torch.float32
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[T, H, W, 3] uint8 (or float 0-255) RGB frames -> the three encoder
    streams ([T, 224, 224, 3] ImageNet-norm, [T, 336, 336, 3] CLIP-norm,
    [T, 1024, 1024, 3] SAM-norm)."""
    return (preprocess_iv_stream(frames, iv_size, dtype),
            preprocess_clip_stream(frames, clip_size, dtype),
            preprocess_sam_stream(frames, sam_size, dtype))


def sample_frame_indices(total: int, num: int) -> np.ndarray:
    """Uniform linspace subsampling of `total` frames down to `num`; fewer
    frames than `num` are padded by repeating the last one
    (videoglamm_tpu/data/preprocess.py:37)."""
    if total <= num:
        pad = np.full(num - total, total - 1 if total else 0)
        return np.concatenate([np.arange(total), pad]).astype(np.int64)
    return np.linspace(0, total - 1, num).astype(np.int64)
