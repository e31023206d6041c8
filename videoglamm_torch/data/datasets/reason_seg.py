"""ReasonSeg dataset: reasoning-driven image segmentation (the port's own
copy of videoglamm_tpu/data/datasets/reason_seg.py). LabelMe-style JSON
polygons sorted by area (largest first), 'ignore' labels rasterized as 255
(MASK_IGNORE_INDEX in the record), 'flag' labels dropped; sentence prompts
ask directly, short phrases use the segment-question templates.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Tuple

import numpy as np

from ...constants import DEFAULT_IMAGE_TOKEN
from .templates import ANSWER_LIST, IMAGE_QUESTION_LIST

LONG_QUESTION_LIST = [
    DEFAULT_IMAGE_TOKEN + "\n" + "{sent} Please respond with segmentation "
                                 "mask.",
    DEFAULT_IMAGE_TOKEN + "\n" + "{sent} Please output segmentation mask.",
]


def _fill_polygon(mask: np.ndarray, points, value: int):
    from PIL import Image, ImageDraw
    img = Image.fromarray(mask)
    draw = ImageDraw.Draw(img)
    pts = [(float(x), float(y)) for x, y in points]
    draw.polygon(pts, fill=value, outline=value)
    mask[:] = np.asarray(img)


def get_mask_from_json(json_path: str, img: np.ndarray
                       ) -> Tuple[np.ndarray, str, bool]:
    """Rasterize LabelMe polygons exactly like the reference
    (data_processing.py:9-60): sort by area desc, paint target=1 /
    ignore=255."""
    try:
        anno = json.load(open(json_path))
    except UnicodeDecodeError:
        anno = json.load(open(json_path, encoding="cp1252"))
    h, w = img.shape[:2]
    shapes = [s for s in anno["shapes"]
              if s["label"].lower() != "flag"]
    areas = []
    for s in shapes:
        tmp = np.zeros((h, w), np.uint8)
        _fill_polygon(tmp, s["points"], 1)
        areas.append(int(tmp.sum()))
    order = np.argsort(areas)[::-1]
    mask = np.zeros((h, w), np.uint8)
    for i in order:
        s = shapes[i]
        value = 255 if "ignore" in s["label"].lower() else 1
        _fill_polygon(mask, s["points"], value)
    return mask, anno["text"], anno["is_sentence"]


class ReasonSegDataset:
    def __init__(self, root: str, split: str = "train", seed: int = 0):
        self.images = sorted(glob.glob(os.path.join(root, split, "*.jpg")))
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx) -> Dict:
        from PIL import Image
        img_path = self.images[idx]
        img = np.asarray(Image.open(img_path).convert("RGB"))
        mask, text, is_sentence = get_mask_from_json(
            os.path.splitext(img_path)[0] + ".json", img)
        if is_sentence:
            q = self.rng.choice(LONG_QUESTION_LIST).format(sent=text)
        else:
            q = self.rng.choice(IMAGE_QUESTION_LIST).format(
                class_name=text.lower())
        a = self.rng.choice(ANSWER_LIST)
        # ignore regions -> MASK_IGNORE_INDEX at loss time: map 255 -> -1
        m = mask.astype(np.float32)
        m[mask == 255] = -1.0
        return dict(frames=[img],
                    sources=[[{"from": "human", "value": q},
                              {"from": "gpt", "value": a}]],
                    masks=[m[None, None]])   # [1 obj, 1 frame, H, W]
