"""Dataset base: model-ready sample building and the weighted mixture (the
port's own copy of videoglamm_tpu/data/datasets/base.py).

Datasets yield a raw record (frames, conversation sources, mask tubes);
`SampleBuilder` turns it into the fixed-shape model sample (preprocessed
pixels, tokenized and masked conversations), and `HybridDataset` samples
datasets by weight. Its `RandomState(seed)` draws come in the JAX
package's order, so the same seed gives the same records.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ...config import VideoGLaMMConfig
from ...constants import MASK_IGNORE_INDEX
from ..conversation import ConvGenerator
from ..preprocess import (preprocess_clip, preprocess_internvideo,
                          preprocess_sam2, sample_frame_indices)


class SampleBuilder:
    """raw record -> model sample dict (collate.build_batch input)."""

    def __init__(self, cfg: VideoGLaMMConfig, tokenizer,
                 conv_gen: Optional[ConvGenerator] = None,
                 max_text_len: int = 512,
                 num_frames_for_sam: int = 4,
                 mask_hw: Optional[tuple] = None):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.conv_gen = conv_gen or ConvGenerator("phi3")
        self.max_text_len = max_text_len
        self.num_frames_for_sam = num_frames_for_sam
        self.mask_hw = mask_hw or (cfg.sam2.low_res_size * 4,
                                   cfg.sam2.low_res_size * 4)

    def __call__(self, record: Dict) -> Dict:
        """record:
          frames: [T_raw] RGB arrays
          sources: list of conversations, each
                   [{'from': 'human'|'gpt', 'value': str}, ...]
          masks:   per-conversation list of [n_seg_i, T_raw, H, W] binary
                   arrays (aligned with sources; None entries allowed), or a
                   single array assigned to the first conversation, or None
          sam_frame_idx: optional explicit SAM frame indices
        """
        cfg = self.cfg
        frames = record["frames"]
        T = cfg.num_frames
        idx = sample_frame_indices(len(frames), T)
        enc = preprocess_internvideo([frames[i] for i in idx],
                                     cfg.internvideo.image_size)
        ctx = preprocess_clip([frames[i] for i in idx], cfg.clip.image_size)

        sam_idx = record.get("sam_frame_idx")
        if sam_idx is None:
            sam_idx = sample_frame_indices(len(frames),
                                           self.num_frames_for_sam)
        sam = preprocess_sam2([frames[i] for i in sam_idx],
                              cfg.sam2.image_size)

        masks = record.get("masks")
        n_src = len(record["sources"])
        if masks is None:
            per_conv = [None] * n_src
        elif isinstance(masks, (list, tuple)):
            assert len(masks) == n_src, (len(masks), n_src)
            per_conv = list(masks)
        else:
            per_conv = [masks] + [None] * (n_src - 1)

        conversations = []
        conv_masks = []
        for src, m in zip(record["sources"], per_conv):
            prompt = self.conv_gen.apply(src)[0]
            ids, labels, n = self.conv_gen.tokenize_and_mask(
                prompt, self.tokenizer, self.max_text_len)
            conversations.append((ids[:n], labels[:n]))
            if m is not None and len(m):
                m = np.asarray(m, np.float32)[:, sam_idx]
                m = _resize_masks(m, self.mask_hw)
            else:
                m = None
            conv_masks.append(m)

        return dict(frames=enc, context_images=ctx, frames_sam=sam,
                    conversations=conversations, masks=conv_masks)


def _resize_masks(m: np.ndarray, hw) -> np.ndarray:
    """Nearest-neighbor mask resize preserving binary/ignore values."""
    n, t, H, W = m.shape
    ys = (np.arange(hw[0]) * H / hw[0]).astype(np.int64).clip(0, H - 1)
    xs = (np.arange(hw[1]) * W / hw[1]).astype(np.int64).clip(0, W - 1)
    return m[:, :, ys[:, None], xs[None, :]]


@dataclasses.dataclass
class DatasetSpec:
    name: str
    dataset: object        # indexable, yields raw records
    weight: float = 1.0


class HybridDataset:
    """Weighted random mixture over registered datasets (reference
    utils/dataset.py:114-426 sample_rate machinery)."""

    def __init__(self, specs: Sequence[DatasetSpec], builder: SampleBuilder,
                 samples_per_epoch: int = 10000, seed: int = 0):
        assert specs, "no datasets registered"
        self.specs = list(specs)
        self.builder = builder
        self.samples_per_epoch = samples_per_epoch
        w = np.asarray([s.weight for s in specs], np.float64)
        self.probs = w / w.sum()
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return self.samples_per_epoch

    def __getitem__(self, idx) -> Dict:
        k = self.rng.choice(len(self.specs), p=self.probs)
        ds = self.specs[k].dataset
        record = ds[self.rng.randint(len(ds))]
        return self.builder(record)

    def batches(self, batch_size: int, max_text_len: int):
        """Infinite generator of collated fixed-shape batches."""
        from ..collate import build_batch
        i = 0
        while True:
            samples = [self[i + j] for j in range(batch_size)]
            i += batch_size
            yield build_batch(samples, max_text_len=max_text_len,
                              mask_hw=self.builder.mask_hw)
