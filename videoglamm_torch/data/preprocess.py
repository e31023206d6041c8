"""Host-side image and video preprocessing through PIL (the port's own copy
of videoglamm_tpu/data/preprocess.py, which the training data layer uses).
The on-device path for raw uint8 frames is `ops/preprocess.py`; this one
is kept apart from it.

- InternVideo2 frames: bilinear resize to 224x224, /255, ImageNet
  normalization;
- CLIP context images: shortest-edge bicubic resize to 336 and a centre
  crop, /255, CLIP normalization (HF CLIPImageProcessor's defaults);
- SAM-2 frames: longest side to 1024 (PIL bilinear), SAM pixel mean/std,
  then a per-channel f32 PIL bilinear resize to 1024x1024;
- frame sampling: uniform linspace subsampling.

All outputs are channels-last float32 numpy arrays.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from PIL import Image

from ..constants import (CLIP_IMAGE_SIZE, CLIP_MEAN, CLIP_STD, IMAGENET_MEAN,
                         IMAGENET_STD, INTERNVIDEO_IMAGE_SIZE,
                         SAM_IMAGE_SIZE, SAM_PIXEL_MEAN, SAM_PIXEL_STD)


def _to_pil(x) -> Image.Image:
    if isinstance(x, Image.Image):
        return x
    return Image.fromarray(np.asarray(x).astype(np.uint8))


def sample_frame_indices(total: int, num: int) -> np.ndarray:
    """Uniform linspace subsampling (reference chat.py:392-395)."""
    if total <= num:
        idx = np.arange(total)
        # pad by repeating the last frame (enc_preprocessors.py:146-151)
        pad = np.full(num - total, total - 1 if total else 0)
        return np.concatenate([idx, pad]).astype(np.int64)
    return np.linspace(0, total - 1, num).astype(np.int64)


def preprocess_internvideo(frames: Sequence,
                           size: int = INTERNVIDEO_IMAGE_SIZE) -> np.ndarray:
    """[T] images -> [T, size, size, 3] f32 (ImageNet-normalized)."""
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    out = []
    for f in frames:
        img = _to_pil(f).convert("RGB").resize((size, size), Image.BILINEAR)
        x = np.asarray(img, np.float32) / 255.0
        out.append((x - mean) / std)
    return np.stack(out)


def preprocess_clip(frames: Sequence,
                    size: int = CLIP_IMAGE_SIZE) -> np.ndarray:
    """[T] images -> [T, size, size, 3] f32 (CLIP-normalized).
    Shortest-edge bicubic resize + center crop, matching HF
    CLIPImageProcessor defaults."""
    mean = np.asarray(CLIP_MEAN, np.float32)
    std = np.asarray(CLIP_STD, np.float32)
    out = []
    for f in frames:
        img = _to_pil(f).convert("RGB")
        w, h = img.size
        short = min(w, h)
        nw, nh = round(w * size / short), round(h * size / short)
        img = img.resize((nw, nh), Image.BICUBIC)
        left = (nw - size) // 2
        top = (nh - size) // 2
        img = img.crop((left, top, left + size, top + size))
        x = np.asarray(img, np.float32) / 255.0
        out.append((x - mean) / std)
    return np.stack(out)


def preprocess_sam2(frames: Sequence,
                    size: int = SAM_IMAGE_SIZE) -> np.ndarray:
    """[T] images -> [T, size, size, 3] f32 (SAM-normalized).
    ResizeLongestSide -> normalize -> bilinear to size^2 (sam2 path)."""
    mean = np.asarray(SAM_PIXEL_MEAN, np.float32)
    std = np.asarray(SAM_PIXEL_STD, np.float32)
    out = []
    for f in frames:
        img = _to_pil(f).convert("RGB")
        w, h = img.size
        scale = size / max(w, h)
        nw, nh = int(w * scale + 0.5), int(h * scale + 0.5)
        img = img.resize((nw, nh), Image.BILINEAR)
        x = (np.asarray(img, np.float32) - mean) / std
        if (nh, nw) != (size, size):
            # torch F.interpolate(bilinear, align_corners=False) parity via
            # per-channel PIL resize of the normalized array
            chans = [Image.fromarray(x[..., c]).resize(
                (size, size), Image.BILINEAR) for c in range(3)]
            x = np.stack([np.asarray(c, np.float32) for c in chans], axis=-1)
        out.append(x)
    return np.stack(out)
