"""Referring image segmentation (RefCOCO / RefCOCO+ / RefCOCOg / RefCLEF);
the port's own copy of videoglamm_tpu/data/datasets/refer_seg.py.

Behavioral contract from the reference ReferSegDataset + REFER API
(utils/refer_seg_dataset.py:13-278, utils/refer.py:43): a few referring expressions per image become
segment-question conversations; masks decode from COCO RLE or polygon
annotations.

The loader consumes either
- the native REFER/G_REFER databases (refs(<splitBy>).p + instances.json)
  via `ReferSegDataset.from_refer` / `videoglamm_torch.data.refer_api`, or
- a consolidated JSON (producible with `refer_api.export_consolidated`):
  [{"image": relpath, "height", "width",
    "refs": [{"sentences": [str, ...],
              "segmentation": RLE | [[polygon], ...]          # single, or
              "segmentations": [seg, ...]}]}]                 # union
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..rle import rle_decode
from .templates import ANSWER_LIST, IMAGE_QUESTION_LIST


def decode_segmentation(seg, h: int, w: int) -> np.ndarray:
    """COCO-style segmentation (RLE dict or polygon list) -> bool mask."""
    if isinstance(seg, dict):
        return rle_decode(seg)
    from PIL import Image, ImageDraw
    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in seg:
        pts = [(float(poly[i]), float(poly[i + 1]))
               for i in range(0, len(poly), 2)]
        if len(pts) >= 3:
            draw.polygon(pts, fill=1, outline=1)
    return np.asarray(img, bool)


def _ref_mask(ref, h: int, w: int) -> np.ndarray:
    """Decode one consolidated ref: union of 'segmentations' when present
    (gRefCOCO multi-ann / no-target), else single 'segmentation'."""
    if "segmentations" in ref:
        out = np.zeros((h, w), bool)
        for seg in ref["segmentations"]:
            out |= decode_segmentation(seg, h, w)
        return out
    return decode_segmentation(ref["segmentation"], h, w)


class ReferSegDataset:
    def __init__(self, annotation_json=None, image_root: str = "",
                 num_refs_per_sample: int = 3, seed: int = 0,
                 records: Optional[List[Dict]] = None):
        if records is None:
            records = json.load(open(annotation_json))
        self.anns = records
        self.image_root = image_root
        self.n_per_sample = num_refs_per_sample
        self.rng = np.random.RandomState(seed)

    @classmethod
    def from_refer(cls, data_root: str, dataset: str = "refcoco",
                   split_by: Optional[str] = None, split: str = "train",
                   **kw) -> "ReferSegDataset":
        """Build directly from the native REFER/G_REFER database
        (refs(<splitBy>).p + instances.json under data_root/<dataset>)."""
        from ..refer_api import export_consolidated, open_refer
        api = open_refer(data_root, dataset, split_by)
        return cls(records=export_consolidated(api, split=split),
                   image_root=data_root, **kw)

    def __len__(self):
        return len(self.anns)

    def __getitem__(self, idx) -> Dict:
        from PIL import Image
        ann = self.anns[idx]
        img = np.asarray(Image.open(os.path.join(
            self.image_root, ann["image"])).convert("RGB"))
        h, w = ann.get("height", img.shape[0]), ann.get("width",
                                                        img.shape[1])
        refs = ann["refs"]
        if len(refs) > self.n_per_sample:
            pick = self.rng.choice(len(refs), self.n_per_sample,
                                   replace=False)
            refs = [refs[i] for i in pick]

        sources, masks = [], []
        for ref in refs:
            sent = str(self.rng.choice(ref["sentences"]))
            q = self.rng.choice(IMAGE_QUESTION_LIST).format(
                class_name=sent.lower())
            a = self.rng.choice(ANSWER_LIST)
            sources.append([{"from": "human", "value": q},
                            {"from": "gpt", "value": a}])
            m = _ref_mask(ref, h, w)
            masks.append(m.astype(np.float32)[None, None])
        return dict(frames=[img], sources=sources, masks=masks)
