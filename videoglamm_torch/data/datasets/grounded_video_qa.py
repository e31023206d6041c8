"""Grounded video QA dataset (GVQA); the port's own copy of
videoglamm_tpu/data/datasets/grounded_video_qa.py.

Behavioral contract from the reference GroundedVideoQABaseDataset
(utils/grounded_video_qa.py:13-103): QA pairs
whose answers carry indexed `[SEG:k]` tokens; each index maps to an object
mask on a specific frame (HQ-SAM-generated offline). The indexed tokens are
normalized to plain `[SEG]` in caption order and the masks ride along as
single-frame tubes anchored to their frame id.

Annotation JSON: [{"video_id", "frames_dir", "question", "answer",
  "seg_token_to_obj": {"[SEG:0]": {"frame_id": int, "rle": RLE}}}]
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict

import numpy as np

from ...constants import DEFAULT_VIDEO_TOKEN
from ..rle import rle_decode

SEG_IDX = re.compile(r"\[SEG:(\d+)\]")


def normalize_seg_answer(answer: str):
    """`... [SEG:2] ... [SEG:0] ...` -> plain [SEG]s + ordered index list."""
    order = [int(m) for m in SEG_IDX.findall(answer)]
    return SEG_IDX.sub("[SEG]", answer), order


class GroundedVideoQADataset:
    def __init__(self, annotation_json: str, max_seg: int = 4,
                 seed: int = 0):
        self.anns = json.load(open(annotation_json))
        self.max_seg = max_seg
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.anns)

    def __getitem__(self, idx) -> Dict:
        from ..video_reader import load_frame_dir
        ann = self.anns[idx]
        frames = load_frame_dir(ann["frames_dir"])
        hw = frames[0].shape[:2]
        T = len(frames)

        answer, order = normalize_seg_answer(ann["answer"])
        tubes = []
        for k in order[:self.max_seg]:
            info = ann["seg_token_to_obj"].get(f"[SEG:{k}]")
            tube = np.zeros((T,) + hw, np.float32)
            if info is not None:
                f = min(int(info["frame_id"]), T - 1)
                tube[f] = rle_decode(info["rle"]).astype(np.float32)
                # frames without annotation for this object are ignored in
                # the loss, not treated as empty
                miss = np.ones(T, bool)
                miss[f] = False
                tube[miss] = -1.0
            tubes.append(tube)

        q = DEFAULT_VIDEO_TOKEN + "\n" + ann["question"]
        sources = [[{"from": "human", "value": q},
                    {"from": "gpt", "value": answer}]]
        masks = [np.stack(tubes)] if tubes else None
        return dict(frames=frames, sources=sources, masks=masks)
