"""SAM-frame training augmentation in numpy (the port's own copy of
videoglamm_tpu/data/augment.py): joint random resize (scale 1.0-1.2) and a
random crop back to the input size, photometric colour jitter, applied
consistently to the SAM frames and their mask tubes; the temporal
dimension is repeated or sliced to T_train. Every draw comes from the
`RandomState` passed in, in the JAX package's order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def color_jitter(img: np.ndarray, rng: np.random.RandomState,
                 brightness: float = 0.5, contrast: float = 0.5,
                 saturation: float = 0.5, hue: float = 0.1) -> np.ndarray:
    """Photometric distortion on float images in [0, 1]-ish space (applied
    pre-normalization)."""
    out = img.astype(np.float32)
    out = out * rng.uniform(1 - brightness, 1 + brightness)
    mean = out.mean(axis=(-3, -2), keepdims=True)
    out = (out - mean) * rng.uniform(1 - contrast, 1 + contrast) + mean
    gray = out.mean(axis=-1, keepdims=True)
    out = (out - gray) * rng.uniform(1 - saturation, 1 + saturation) + gray
    # cheap hue-ish channel roll mix
    if hue > 0:
        shift = rng.uniform(-hue, hue)
        out = (1 - abs(shift)) * out + abs(shift) * np.roll(out, 1, axis=-1)
    return out


def joint_resize_crop(frames: np.ndarray, masks: Optional[np.ndarray],
                      rng: np.random.RandomState,
                      scale_range: Tuple[float, float] = (1.0, 1.2)):
    """frames: [T, H, W, C]; masks: [N, T, H, W] or None. Random up-scale
    then random crop back to (H, W), identical transform for both."""
    T, H, W, C = frames.shape
    s = rng.uniform(*scale_range)
    nh, nw = int(H * s), int(W * s)
    ys = (np.arange(nh) * H / nh).astype(int).clip(0, H - 1)
    xs = (np.arange(nw) * W / nw).astype(int).clip(0, W - 1)
    up_f = frames[:, ys[:, None], xs[None, :]]
    i = rng.randint(0, nh - H + 1)
    j = rng.randint(0, nw - W + 1)
    out_f = up_f[:, i:i + H, j:j + W]
    out_m = None
    if masks is not None:
        up_m = masks[:, :, ys[:, None], xs[None, :]]
        out_m = up_m[:, :, i:i + H, j:j + W]
    return out_f, out_m


def adjust_temporal(frames: np.ndarray, masks: Optional[np.ndarray],
                    t_train: int):
    """Repeat/slice the temporal dim to t_train (reference
    __adjust_temporal_dimension)."""
    T = frames.shape[0]
    if T == t_train:
        return frames, masks
    if T > t_train:
        idx = np.linspace(0, T - 1, t_train).astype(int)
    else:
        idx = np.concatenate([np.arange(T),
                              np.full(t_train - T, T - 1)]).astype(int)
    return frames[idx], (masks[:, idx] if masks is not None else None)


def apply_sam_augmentations(frames: np.ndarray,
                            masks: Optional[np.ndarray],
                            t_train: int,
                            rng: Optional[np.random.RandomState] = None):
    """Full reference pipeline: temporal adjust -> joint resize-crop ->
    color jitter on frames only."""
    rng = rng or np.random.RandomState()
    frames, masks = adjust_temporal(frames, masks, t_train)
    frames, masks = joint_resize_crop(frames, masks, rng)
    frames = color_jitter(frames, rng)
    return frames, masks
