"""Native REFER / G_REFER database loaders (RefCOCO family); the port's
own copy of videoglamm_tpu/data/refer_api.py.

Behavioral contract from the reference REFER API (utils/refer.py:43-323)
and G_REFER (utils/grefer.py:36-345):

- `refs(<splitBy>).p` is a pickled list of ref dicts {ref_id, ann_id,
  image_id, category_id, split, sentences:[{sent, sent_id, tokens}]};
  G_REFER uses `grefs(<splitBy>).p` (or `.json`) where `ann_id` may be a
  list and `[-1]` / `None` marks a no-target expression.
- `instances.json` is COCO-style {images, annotations, categories}.
- Masks decode from COCO polygon/RLE segmentations; multiple annotations
  for one gRefCOCO ref are unioned (grefer.py:318-345 getMaskByRef merge).
- Image files live under images/mscoco/images/train2014 for the COCO
  variants and images/saiapr_tc-12 for RefCLEF (refer.py:51-54).

This module replaces pycocotools with the in-repo RLE codec and PIL
polygon rasterization, and adds `export_consolidated` which produces the
consolidated-JSON records `ReferSegDataset` consumes directly.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

COCO_IMAGE_SUBDIR = os.path.join("images", "mscoco", "images", "train2014")
REFCLEF_IMAGE_SUBDIR = os.path.join("images", "saiapr_tc-12")


def default_split_by(dataset: str) -> str:
    """Reference convention (refer_seg_dataset.py:58-61): umd for refcocog,
    unc otherwise."""
    return "umd" if dataset == "refcocog" else "unc"


def decode_coco_segmentation(seg, h: int, w: int) -> np.ndarray:
    """COCO segmentation (RLE dict, uncompressed-counts dict, or polygon
    list) -> bool mask [h, w]."""
    from .rle import rle_decode
    if isinstance(seg, dict):
        return rle_decode(seg).astype(bool)
    from PIL import Image, ImageDraw
    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in seg:
        pts = [(float(poly[i]), float(poly[i + 1]))
               for i in range(0, len(poly), 2)]
        if len(pts) >= 3:
            draw.polygon(pts, fill=1, outline=1)
    return np.asarray(img, bool)


class ReferAPI:
    """refcoco / refcoco+ / refcocog / refclef (refer.py:43)."""

    ref_file_prefix = "refs"

    def __init__(self, data_root: str, dataset: str = "refcoco",
                 split_by: Optional[str] = None):
        split_by = split_by or default_split_by(dataset)
        self.data_root = data_root
        self.dataset = dataset
        self.split_by = split_by
        ddir = os.path.join(data_root, dataset)
        self.refs = self._load_refs(ddir)
        inst = json.load(open(os.path.join(ddir, "instances.json")))
        self.imgs = {im["id"]: im for im in inst["images"]}
        self.anns = {a["id"]: a for a in inst["annotations"]}
        self.cats = {c["id"]: c["name"] for c in inst["categories"]}
        self.refs_by_id = {r["ref_id"]: r for r in self.refs}
        self.img_to_refs: Dict[int, List[dict]] = {}
        for r in self.refs:
            self.img_to_refs.setdefault(r["image_id"], []).append(r)

    def _load_refs(self, ddir: str) -> List[dict]:
        path = os.path.join(ddir, f"{self.ref_file_prefix}({self.split_by}).p")
        if os.path.exists(path):
            with open(path, "rb") as f:
                return pickle.load(f, fix_imports=True)
        jpath = path[:-2] + ".json"
        if os.path.exists(jpath):
            return json.load(open(jpath))
        raise FileNotFoundError(f"{path} (or .json)")

    # -- queries (refer.py:144-244) --------------------------------------
    def get_ref_ids(self, split: str = "") -> List[int]:
        refs = self.refs
        if split:
            if split in ("testA", "testB", "testC"):
                refs = [r for r in refs if split[-1] in r["split"]]
            elif split == "test":
                refs = [r for r in refs if "test" in r["split"]]
            else:
                refs = [r for r in refs if r["split"] == split]
        return [r["ref_id"] for r in refs]

    def get_img_ids(self, ref_ids: Sequence[int]) -> List[int]:
        return sorted({self.refs_by_id[i]["image_id"] for i in ref_ids})

    def load_ref(self, ref_id: int) -> dict:
        return self.refs_by_id[ref_id]

    def ref_anns(self, ref) -> List[dict]:
        return [self.anns[ref["ann_id"]]]

    def image_path(self, image_id: int) -> str:
        sub = (REFCLEF_IMAGE_SUBDIR if self.dataset == "refclef"
               else COCO_IMAGE_SUBDIR)
        return os.path.join(sub, self.imgs[image_id]["file_name"])

    def get_mask(self, ref) -> np.ndarray:
        """Union bool mask [H, W] of the ref's annotation(s)
        (refer.py:308-323 getMask)."""
        img = self.imgs[ref["image_id"]]
        h, w = img["height"], img["width"]
        out = np.zeros((h, w), bool)
        for ann in self.ref_anns(ref):
            seg = ann.get("segmentation")
            if seg:
                out |= decode_coco_segmentation(seg, h, w)
        return out

    def get_ref_box(self, ref_id: int) -> List[float]:
        anns = self.ref_anns(self.refs_by_id[ref_id])
        return anns[0]["bbox"] if anns else [0.0, 0.0, 0.0, 0.0]


class GReferAPI(ReferAPI):
    """grefcoco (grefer.py:36): ann_id may be a list; [-1]/None = no target."""

    ref_file_prefix = "grefs"

    def ref_anns(self, ref) -> List[dict]:
        ann_id = ref["ann_id"]
        ids = ann_id if isinstance(ann_id, list) else [ann_id]
        return [self.anns[i] for i in ids
                if i is not None and i != -1 and i in self.anns]

    def is_no_target(self, ref) -> bool:
        return len(self.ref_anns(ref)) == 0


def open_refer(data_root: str, dataset: str,
               split_by: Optional[str] = None) -> ReferAPI:
    cls = GReferAPI if dataset == "grefcoco" else ReferAPI
    return cls(data_root, dataset, split_by)


def export_consolidated(api: ReferAPI, split: str = "train",
                        out_json: Optional[str] = None) -> List[dict]:
    """REFER/G_REFER database -> the consolidated per-image records
    `ReferSegDataset` consumes: one record per image, each ref carrying its
    sentences and raw segmentation(s) (decoded lazily at sample time)."""
    ref_ids = api.get_ref_ids(split=split)
    idset = set(ref_ids)
    records = []
    for image_id in api.get_img_ids(ref_ids):
        img = api.imgs[image_id]
        refs_out = []
        for ref in api.img_to_refs[image_id]:
            if ref["ref_id"] not in idset:
                continue
            anns = api.ref_anns(ref)
            refs_out.append({
                "sentences": [s["sent"] for s in ref["sentences"]],
                "segmentations": [a["segmentation"] for a in anns
                                  if a.get("segmentation")],
            })
        if not refs_out:
            continue
        records.append({
            "image": api.image_path(image_id),
            "height": img["height"], "width": img["width"],
            "refs": refs_out,
        })
    if out_json:
        with open(out_json, "w") as f:
            json.dump(records, f)
    return records
