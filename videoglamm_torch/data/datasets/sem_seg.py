"""Semantic segmentation datasets (the port's own copy of
videoglamm_tpu/data/datasets/sem_seg.py).

Behavioral contract from the reference SemSegDataset
(utils/sem_seg_dataset.py:121-330), which mixes
five families:
- per-pixel class-label PNGs: ade20k (:33-60, labels shifted by 1),
  cocostuff (:63-79, '-' classes ignored), mapillary (:14-30, classes from
  config_v2.0.json "labels"[].readable) -> `SemSegDataset`;
- COCO-style part annotations: paco_lvis (:82-103) and pascal_part
  (:106-118), category names "obj:part" phrased as "obj part" or
  "the part of the obj" (:226-231) -> `CocoPartSegDataset`.
A few classes/annotations present in the image are sampled, each becoming
one segment-question conversation with a binary mask.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .templates import ANSWER_LIST, IMAGE_QUESTION_LIST


class SemSegDataset:
    def __init__(self, image_root: str, label_root: str,
                 class_names: List[str], num_classes_per_sample: int = 3,
                 label_offset: int = 0, ignore_label: int = 255,
                 ignored_values: Sequence[int] = (), seed: int = 0):
        """class_names[i] names label value i + label_offset (ADE20K uses
        offset 1: label 0 = unlabeled). `ignored_values` drops extra label
        ids (reference maps COCO-Stuff '-' classes to ignore, :247-250)."""
        self.images = sorted(glob.glob(os.path.join(image_root, "*.jpg")))
        self.label_root = label_root
        self.class_names = class_names
        self.n_per_sample = num_classes_per_sample
        self.label_offset = label_offset
        self.ignore_label = ignore_label
        self.ignored_values = set(int(v) for v in ignored_values)
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx) -> Dict:
        from PIL import Image
        img_path = self.images[idx]
        img = np.asarray(Image.open(img_path).convert("RGB"))
        stem = os.path.splitext(os.path.basename(img_path))[0]
        label = np.asarray(Image.open(
            os.path.join(self.label_root, stem + ".png")))

        present = [int(v) for v in np.unique(label)
                   if int(v) != self.ignore_label
                   and int(v) not in self.ignored_values
                   and 0 <= int(v) - self.label_offset < len(self.class_names)]
        if not present:
            present = [self.label_offset]
        chosen = self.rng.choice(
            present, min(self.n_per_sample, len(present)), replace=False)

        sources, masks = [], []
        for v in chosen:
            name = self.class_names[v - self.label_offset]
            q = self.rng.choice(IMAGE_QUESTION_LIST).format(
                class_name=name.lower())
            a = self.rng.choice(ANSWER_LIST)
            sources.append([{"from": "human", "value": q},
                            {"from": "gpt", "value": a}])
            masks.append((label == v).astype(np.float32)[None, None])
        return dict(frames=[img], sources=sources, masks=masks)


def load_ade20k_classes(path: Optional[str] = None) -> List[str]:
    """Load the ADE20K class list (the reference vendors ade20k_classes.json;
    point this at the same file)."""
    if path is None:
        raise ValueError("provide the ade20k_classes.json path")
    return json.load(open(path))


def load_mapillary_classes(config_json: str) -> List[str]:
    """config_v2.0.json "labels"[].readable, lowercased (reference
    sem_seg_dataset.py:16-18)."""
    return [x["readable"].lower()
            for x in json.load(open(config_json))["labels"]]


def load_cocostuff_classes(txt_path: str):
    """cocostuff_classes.txt ('id: name' per line, first line skipped) ->
    (class_names, ignored_values) where names containing '-' (stuff merged
    classes) are ignored (reference sem_seg_dataset.py:63-79, 247-250)."""
    names = []
    with open(txt_path) as f:
        for line in f.readlines()[1:]:
            names.append(line.strip().split(": ")[-1])
    ignored = [i for i, c in enumerate(names) if "-" in c]
    return names, ignored


def part_phrase(obj: str, part: str, rng) -> str:
    """'obj part' or 'the part of the obj', p=0.5 each (reference
    sem_seg_dataset.py:226-231)."""
    if rng.rand() < 0.5:
        return f"{obj} {part}"
    return f"the {part} of the {obj}"


def _strip_paren(name: str) -> str:
    return name.split("_(")[0]


class CocoPartSegDataset:
    """PACO-LVIS / Pascal-Part style COCO-json part segmentation.

    Consumes the reference's annotation files directly
    (paco_lvis_v1_train.json / pascal_part train.json): COCO {images,
    annotations, categories} where category names are "object:part" (or a
    plain object name for whole-object LVIS categories). Masks decode from
    polygon or RLE segmentations (reference sem_seg_dataset.py:82-118,
    190-234, 298-307 annToMask).
    """

    def __init__(self, annotation_json: str, image_root: str,
                 num_anns_per_sample: int = 3, seed: int = 0):
        data = json.load(open(annotation_json))
        self.imgs = {im["id"]: im for im in data["images"]}
        self.cat_names = {}
        for cat in data["categories"]:
            parts = cat["name"].strip().split(":")
            if len(parts) == 1:
                self.cat_names[cat["id"]] = _strip_paren(parts[0])
            else:
                self.cat_names[cat["id"]] = (_strip_paren(parts[0]),
                                             _strip_paren(parts[1]))
        self.anns_by_img: Dict[int, List[dict]] = {}
        for ann in data["annotations"]:
            self.anns_by_img.setdefault(ann["image_id"], []).append(ann)
        # keep only images that have annotations (reference re-samples on
        # empty, :215-216)
        self.img_ids = [i for i in sorted(self.anns_by_img) if i in self.imgs]
        self.image_root = image_root
        self.n_per_sample = num_anns_per_sample
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.img_ids)

    def __getitem__(self, idx) -> Dict:
        from PIL import Image

        from .refer_seg import decode_segmentation
        img_id = self.img_ids[idx]
        info = self.imgs[img_id]
        img = np.asarray(Image.open(os.path.join(
            self.image_root, info["file_name"])).convert("RGB"))
        h = info.get("height", img.shape[0])
        w = info.get("width", img.shape[1])

        anns = self.anns_by_img[img_id]
        if len(anns) > self.n_per_sample:
            pick = self.rng.choice(len(anns), self.n_per_sample,
                                   replace=False)
            anns = [anns[i] for i in pick]

        sources, masks = [], []
        for ann in anns:
            name = self.cat_names[ann["category_id"]]
            if isinstance(name, tuple):
                name = part_phrase(name[0], name[1], self.rng)
            q = self.rng.choice(IMAGE_QUESTION_LIST).format(
                class_name=name.lower())
            a = self.rng.choice(ANSWER_LIST)
            sources.append([{"from": "human", "value": q},
                            {"from": "gpt", "value": a}])
            m = decode_segmentation(ann["segmentation"], h, w)
            masks.append(m.astype(np.float32)[None, None])
        return dict(frames=[img], sources=sources, masks=masks)
