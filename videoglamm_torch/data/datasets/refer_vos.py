"""Referring video object segmentation dataset, MeViS / Ref-YTVOS layout
(the port's own copy of videoglamm_tpu/data/datasets/refer_vos.py): the
expressions JSON maps each (video, expression) to object ids whose
per-frame masks come from RLE annotations (mask_dict.json) or per-object
PNG directories; one conversation per expression from the declarative
question templates, up to `max_expressions_per_sample` a record.

Expected layout (MeViS format):
  <root>/meta_expressions.json
     {"videos": {vid: {"expressions": {eid: {"exp", "obj_id"|"anno_id"}},
                       "frames": [...]}}}
  <root>/mask_dict.json      {anno_id: [RLE|None per frame]}   (optional)
  <root>/JPEGImages/<vid>/*.jpg
  <root>/Annotations/<vid>/<obj_id>/*.png                      (without mask_dict.json)
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from ..rle import rle_decode
from .templates import ANSWER_LIST, VIDEO_QUESTION_LIST


class ReferVOSDataset:
    def __init__(self, root: str, image_set: str = "train",
                 max_expressions_per_sample: int = 3, seed: int = 0):
        self.root = root
        meta = json.load(open(os.path.join(root, "meta_expressions.json")))
        self.videos = meta["videos"]
        self.vids = sorted(self.videos)
        mask_dict_path = os.path.join(root, "mask_dict.json")
        self.mask_dict = json.load(open(mask_dict_path)) \
            if os.path.exists(mask_dict_path) else None
        self.max_expr = max_expressions_per_sample
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.vids)

    def _expr_mask(self, vid: str, einfo: Dict, n_frames: int, hw):
        if self.mask_dict is not None and "anno_id" in einfo:
            ids = einfo["anno_id"]
            ids = ids if isinstance(ids, list) else [ids]
            tube = np.zeros((n_frames,) + hw, bool)
            for aid in ids:
                rles = self.mask_dict[str(aid)]
                for t in range(min(n_frames, len(rles))):
                    if rles[t] is not None:
                        tube[t] |= rle_decode(rles[t])
            return tube
        # PNG fallback
        from PIL import Image
        obj = str(einfo.get("obj_id", einfo.get("anno_id")))
        d = os.path.join(self.root, "Annotations", vid, obj)
        files = sorted(os.listdir(d))[:n_frames]
        tube = np.stack([np.asarray(Image.open(os.path.join(d, f))) > 127
                         for f in files])
        return tube

    def __getitem__(self, idx) -> Dict:
        from PIL import Image
        vid = self.vids[idx]
        vinfo = self.videos[vid]
        fdir = os.path.join(self.root, "JPEGImages", vid)
        files = sorted(os.listdir(fdir))
        frames = [np.asarray(Image.open(os.path.join(fdir, f)).convert("RGB"))
                  for f in files]
        hw = frames[0].shape[:2]

        eids = sorted(vinfo["expressions"])
        if len(eids) > self.max_expr:
            eids = list(self.rng.choice(eids, self.max_expr, replace=False))

        sources, tubes = [], []
        for eid in eids:
            einfo = vinfo["expressions"][eid]
            q = self.rng.choice(VIDEO_QUESTION_LIST).format(
                phrase=einfo["exp"].lower())
            a = self.rng.choice(ANSWER_LIST)
            sources.append([{"from": "human", "value": q},
                            {"from": "gpt", "value": a}])
            tubes.append(self._expr_mask(vid, einfo, len(frames), hw))

        # one expression per conversation: conversation i's [SEG] grounds
        # tube i
        return dict(frames=frames, sources=sources,
                    masks=[t[None] for t in tubes])
