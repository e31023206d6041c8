"""Grounded video captioning (GCG) dataset (the port's own copy of
videoglamm_tpu/data/datasets/video_gcg.py).

- instruction JSON: {"videos": [{file_names, width, height, length,
  dense_cap: {caption, token_pos, mask_id, v_id2o_id}}],
  "annotations": [{id, segmentations: [RLE|None per frame]}]};
- caption words at `token_pos` become `<p> word </p> [SEG]`;
- each [SEG]'s mask tube is the union over its mask_ids, RLE-decoded per
  frame;
- train-time frame selection: one random present frame per object, padded
  with random frames to max_num_frames.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..rle import rle_decode
from .templates import GCG_QUESTIONS


def build_gcg_caption(caption: str, token_pos: List[int]):
    words = caption.split(" ")
    out = []
    for i, w in enumerate(words):
        if i in token_pos:
            out.append(f"<p> {w} </p> [SEG]")
        else:
            out.append(w)
    return " ".join(out)


class GCGVideoDataset:
    """Yields raw records for SampleBuilder."""

    def __init__(self, annotation_json: str, frames_root: str,
                 image_set: str = "train", max_num_frames: int = 5,
                 max_seg: int = 4, seed: int = 0):
        data = json.load(open(annotation_json))
        self.videos = data["videos"]
        self.annotations = data["annotations"]
        self.ann_by_id = {a["id"]: a for a in self.annotations}
        self.frames_root = frames_root
        self.is_train = image_set == "train"
        self.max_num_frames = max_num_frames
        self.max_seg = max_seg
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.videos)

    def _object_masks(self, video) -> Dict[int, np.ndarray]:
        """[SEG]-ordered object index -> (mask tube [T,H,W], presence [T])."""
        w, h, l = video["width"], video["height"], video["length"]
        cap = video["dense_cap"]
        word_to_masks: Dict[int, List[int]] = {}
        for wi, mid in zip(cap["token_pos"], cap["mask_id"]):
            word_to_masks.setdefault(wi, []).append(mid)

        objs = {}
        for oi, wi in enumerate(sorted(word_to_masks)):
            tube = np.zeros((l, h, w), bool)
            present = np.zeros(l, bool)
            for mid in word_to_masks[wi]:
                segs = self.ann_by_id[mid]["segmentations"]
                for t in range(l):
                    if t < len(segs) and segs[t] is not None:
                        tube[t] |= rle_decode(segs[t])
                        present[t] = True
            objs[oi] = (tube, present)
        return objs

    def __getitem__(self, idx) -> Dict:
        from PIL import Image
        video = self.videos[idx]
        cap = video["dense_cap"]
        l = video["length"]
        answer = build_gcg_caption(cap["caption"], cap["token_pos"])
        objs = self._object_masks(video)
        n_obj = min(len(objs), self.max_seg)

        if self.is_train:
            # cover each object with one present frame, pad randomly
            chosen = set()
            for oi in range(n_obj):
                present = np.flatnonzero(objs[oi][1])
                if len(present):
                    chosen.add(int(self.rng.choice(present)))
            it = 0
            while len(chosen) < min(self.max_num_frames, l) and it < l:
                chosen.add(int(self.rng.randint(l)))
                it += 1
            sel = sorted(chosen)
        else:
            sel = list(range(l))

        frames = []
        for t in sel:
            path = os.path.join(self.frames_root, video["file_names"][t])
            frames.append(np.asarray(Image.open(path).convert("RGB")))

        masks = np.stack([objs[oi][0][sel] for oi in range(n_obj)]) \
            if n_obj else None

        question = GCG_QUESTIONS[0]
        sources = [[{"from": "human", "value": question},
                    {"from": "gpt", "value": answer}]]
        return dict(frames=frames, sources=sources, masks=[masks],
                    sam_frame_idx=np.arange(len(sel)))
