"""Fixed-shape batch assembly (the port's counterpart of
videoglamm_tpu/data/collate.py).

Each batch ROW is one conversation carrying `video_idx` into the batch of
videos; token rows are right-padded to `max_text_len`; ground-truth masks
are padded to [max_seg, T_sam, h, w] with MASK_IGNORE_INDEX.

The values are the JAX package's. The containers differ: the batch is a
dict of CPU torch tensors, contiguous and pinnable, in the keys and layout
that `VideoGLaMM.forward` reads. Pixel streams and masks are float32 (the
copy onto the card casts the pixels to the compute dtype); the integer
fields (`input_ids`, `labels`, `text_lens`, `video_idx`) are int64, the
port's index dtype, where JAX's are int32.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..constants import (IGNORE_INDEX, MASK_IGNORE_INDEX,
                         MAX_NUM_SEG_TOKENS_PER_SAMPLE)

PIXEL_KEYS = ("frames", "context_images", "frames_sam")


def build_batch(samples: Sequence[dict], *, max_text_len: int,
                max_seg: int = MAX_NUM_SEG_TOKENS_PER_SAMPLE,
                mask_hw: Optional[tuple] = None) -> Dict[str, torch.Tensor]:
    """samples: each a dict with
        frames:         [T, 224, 224, 3]
        context_images: [T, 336, 336, 3]
        frames_sam:     [T_sam, S, S, 3]
        conversations:  list of (input_ids [L], labels [L]) int sequences
        masks:          per-conversation list of [n_seg_i, T_sam, h, w]
                        arrays (or a single array for 1-conversation
                        samples, or None)
    Returns the model batch (the keyword arguments of the training
    forward)."""
    frames, ctx, sam = [], [], []
    rows_ids, rows_lab, rows_len, rows_vidx, rows_masks = [], [], [], [], []

    for vi, s in enumerate(samples):
        frames.append(s["frames"])
        ctx.append(s["context_images"])
        sam.append(s["frames_sam"])
        t_sam = s["frames_sam"].shape[0]
        hw = mask_hw or (s["frames_sam"].shape[1] // 4,
                         s["frames_sam"].shape[2] // 4)

        sample_masks = s.get("masks")
        if sample_masks is not None and not isinstance(sample_masks,
                                                       (list, tuple)):
            sample_masks = [sample_masks]
        for ci, (ids, lab) in enumerate(s["conversations"]):
            ids = np.asarray(ids, np.int64)[:max_text_len]
            lab = np.asarray(lab, np.int64)[:max_text_len]
            row_ids = np.zeros(max_text_len, np.int64)
            row_lab = np.full(max_text_len, IGNORE_INDEX, np.int64)
            row_ids[:len(ids)] = ids
            row_lab[:len(lab)] = lab
            rows_ids.append(row_ids)
            rows_lab.append(row_lab)
            rows_len.append(len(ids))
            rows_vidx.append(vi)

            gm = np.full((max_seg, t_sam) + tuple(hw), MASK_IGNORE_INDEX,
                         np.float32)
            m = None
            if sample_masks is not None and ci < len(sample_masks):
                m = sample_masks[ci]
            if m is not None and len(m):
                m = np.asarray(m, np.float32)[:max_seg]
                gm[:m.shape[0]] = m
            rows_masks.append(gm)

    out = {
        "frames": np.stack(frames).astype(np.float32),
        "context_images": np.stack(ctx).astype(np.float32),
        "frames_sam": np.stack(sam).astype(np.float32),
        "input_ids": np.stack(rows_ids),
        "labels": np.stack(rows_lab),
        "text_lens": np.asarray(rows_len, np.int64),
        "video_idx": np.asarray(rows_vidx, np.int64),
        "gt_masks": np.stack(rows_masks),
    }
    return {k: torch.from_numpy(v) for k, v in out.items()}
