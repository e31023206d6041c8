"""Output postprocessing: caption cleaning, phrase extraction, mask cleanup
(the port's copy of videoglamm_tpu/evals/postprocess.py).

Behavioral contracts:
- `<p>...</p>` phrase extraction + caption cleaning (reference
  eval_gcg_infer.py:94-107 clean_caption);
- small-blob removal (reference remove_small_blobs, eval_gcg_infer.py:20-29,
  which uses skimage.morphology.remove_small_objects; here scipy.ndimage
  connected components with the same min-size semantics);
- seg2bmap boundary map (reference eval_referdavis_metrics.py:263-319);
- masks_to_original_size: the low-res mask logits resized to the frame's
  size on the logits' own device (`ops/resize.resize_bilinear`), then
  thresholded; only the boolean masks cross to the host.
"""
from __future__ import annotations

import re
from typing import List

import numpy as np
from scipy import ndimage


def extract_phrases(caption: str) -> List[str]:
    """All `<p>...</p>` spans, stripped (reference eval_gcg_infer.py:94-99)."""
    return [m.strip() for m in re.findall(r"<p>(.*?)</p>", caption,
                                          flags=re.DOTALL)]


def clean_caption(caption: str) -> str:
    """Strip <p> tags, [SEG] markers and chat artifacts (reference
    eval_gcg_infer.py:100-107)."""
    out = caption.replace("<p>", "").replace("</p>", "")
    out = out.replace("[SEG]", "")
    out = re.sub(r"<\|.*?\|>", "", out)
    out = re.sub(r"\s+", " ", out).strip()
    return out


def remove_small_blobs(binary_mask: np.ndarray, min_size: int = 0
                       ) -> np.ndarray:
    """Drop connected components smaller than min_size pixels
    (4-connectivity on 2D, per-frame on 3D), matching
    skimage.morphology.remove_small_objects semantics."""
    if min_size <= 0:
        return binary_mask
    m = binary_mask.astype(bool)
    if m.ndim == 3:
        return np.stack([remove_small_blobs(f, min_size) for f in m])
    labels, n = ndimage.label(m)
    if n == 0:
        return m
    sizes = ndimage.sum_labels(m, labels, index=np.arange(1, n + 1))
    keep = np.zeros(n + 1, bool)
    keep[1:] = sizes >= min_size
    return keep[labels]


def seg2bmap(seg: np.ndarray) -> np.ndarray:
    """1-pixel-wide boundary map (reference _seg2bmap,
    eval_referdavis_metrics.py:263-319, same-size path)."""
    seg = seg.astype(bool)
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]
    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = False
    return b


def masks_to_original_size(low_res_logits, orig_hw,
                           threshold: float = 0.0) -> np.ndarray:
    """[..., h, w] logits -> [..., H, W] boolean numpy at the original
    resolution (reference postprocess_masks: bilinear to orig size then
    threshold). A tensor is resized in f32 where it lies (on the card for
    the served logits); a numpy array on the CPU."""
    import torch
    from ..ops.resize import resize_bilinear
    x = torch.as_tensor(low_res_logits).float()
    lead = x.shape[:-2]
    y = resize_bilinear(x.reshape((-1,) + x.shape[-2:] + (1,)),
                        tuple(orig_hw))
    keep = (y[..., 0] > threshold).reshape(lead + tuple(orig_hw))
    return keep.cpu().numpy()
