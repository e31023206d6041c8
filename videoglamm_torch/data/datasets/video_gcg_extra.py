"""Extra video-GCG training datasets: ANet-Entities and VidSTG/HCSTVG (the
port's own copy of videoglamm_tpu/data/datasets/video_gcg_extra.py).

Behavioral contracts:
- ANetEntitiesGCGDataset mirrors the reference ANetEntitiesGCG(Base)Dataset
  (utils/video_gcg_anet.py:13-195): dataset dir
  holds anns/<vid>____<seg>.json ({refined_caption with [SEG:n] tokens,
  seg_token_to_obj: {"[SEG:n]": {frame_id, bbox}}}),
  video_frames/<vid>/<seg>/NN.jpg, and masks/<vid>____<seg>/NN/mask.png
  (HQ-SAM masks, 0/255). [SEG:n] -> [SEG]; one SAM frame (the first seg
  token's frame, :121-123,156-157); every object's mask.png becomes a
  1-frame GT tube against that frame (:173-178).
- VidSTGHCSTVGGCGDataset mirrors VidSTG_HCSTVG_GCG(Base)Dataset
  (utils/vidstg_hcstvg_gcg.py:58-267): <set>_captions/<vid>.json carries a
  caption with "[phrase](obj_id)" spans -> "<p> phrase </p> [SEG]"
  (:47-54); frames in <set>/<vid>/frames/, per-object per-frame masks in
  <set>/<vid>/masks/<obj:03d>/<frame>; SAM frames are a linspace subsample
  with the matching mask-tube slices (:217-224).
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, List

import numpy as np

from .templates import GCG_QUESTIONS

_SEG_N = re.compile(r"\[SEG:(\d+)\]")
_PHRASE_OBJ = re.compile(r"\[([^\]]+)\]\(([^)]+)\)")


def _gcg_sources(answer: str, rng) -> List[List[Dict]]:
    q = GCG_QUESTIONS[int(rng.randint(len(GCG_QUESTIONS)))]
    return [[{"from": "human", "value": q},
             {"from": "gpt", "value": answer}]]


class ANetEntitiesGCGDataset:
    """Yields raw records for SampleBuilder (single-SAM-frame GCG)."""

    def __init__(self, dataset_dir: str, seed: int = 0):
        self.dataset_dir = dataset_dir
        self.ann_dir = os.path.join(dataset_dir, "anns")
        self.mask_dir = os.path.join(dataset_dir, "masks")
        self.frames_dir = os.path.join(dataset_dir, "video_frames")
        self.ann_files = sorted(
            f for f in os.listdir(self.ann_dir) if f.endswith(".json"))
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.ann_files)

    def __getitem__(self, idx) -> Dict:
        from PIL import Image
        ann_file = self.ann_files[idx]
        key = ann_file[:-len(".json")]
        vid, seg = key.split("____")
        obj = json.load(open(os.path.join(self.ann_dir, ann_file)))
        caption = obj["refined_caption"]

        fdir = os.path.join(self.frames_dir, vid, seg)
        files = sorted(f for f in os.listdir(fdir) if f.endswith(".jpg"))
        frames = [np.asarray(Image.open(os.path.join(fdir, f)).convert("RGB"))
                  for f in files]

        # [SEG:n] tokens in caption order; the SAM frame is the first
        # token's frame (reference keeps num_frames_for_sam=1).
        seg_ids = _SEG_N.findall(caption)
        sam_t = 0
        masks = []
        for k, seg_id in enumerate(seg_ids):
            tok = f"[SEG:{seg_id}]"
            frame_id = int(obj["seg_token_to_obj"][tok]["frame_id"])
            if k == 0:
                sam_t = frame_id
            mpath = os.path.join(self.mask_dir, key, str(seg_id).zfill(2),
                                 "mask.png")
            m = np.asarray(Image.open(mpath).convert("L"), np.uint8)
            masks.append((m > 127).astype(np.float32))

        answer = _SEG_N.sub("[SEG]", caption)
        tube = (np.stack(masks)[:, None] if masks else None)  # [n, 1, H, W]
        # place each object's GT at the single selected SAM frame
        full = None
        if tube is not None:
            full = np.zeros((tube.shape[0], len(frames)) + tube.shape[2:],
                            np.float32)
            full[:, sam_t] = tube[:, 0]
        return dict(frames=frames, sources=_gcg_sources(answer, self.rng),
                    masks=[full], sam_frame_idx=np.asarray([sam_t]))


def caption_to_gcg(caption: str):
    """"[phrase](obj_ids)" spans -> (tagged caption, [first obj_id per
    span], [phrases]) (reference vidstg_hcstvg_gcg.py:30-54)."""
    obj_ids, phrases = [], []
    for phrase, ids in _PHRASE_OBJ.findall(caption):
        obj_ids.append(ids.split(", ")[0])
        phrases.append(phrase)
    tagged = _PHRASE_OBJ.sub(r"<p> \1 </p> [SEG]", caption)
    return tagged, obj_ids, phrases


class VidSTGHCSTVGGCGDataset:
    """Yields raw records for SampleBuilder (mask tubes over all frames)."""

    def __init__(self, base_video_dataset_dir: str, image_set: str = "train",
                 source_dataset: str = "vidstg", seed: int = 0):
        assert source_dataset in ("vidstg", "hcstvg"), source_dataset
        root = os.path.join(base_video_dataset_dir, f"{source_dataset}_gcg")
        self.captions_dir = os.path.join(root, f"{image_set}_captions")
        self.videos_dir = os.path.join(root, image_set)
        self.json_files = sorted(
            f for f in os.listdir(self.captions_dir) if f.endswith(".json"))
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.json_files)

    def __getitem__(self, idx) -> Dict:
        from PIL import Image
        json_file = self.json_files[idx]
        video_id = json_file[:-len(".json")]
        caption = json.load(open(os.path.join(
            self.captions_dir, json_file)))["caption"]
        tagged, obj_ids, _ = caption_to_gcg(caption)

        vdir = os.path.join(self.videos_dir, video_id)
        files = sorted(os.listdir(os.path.join(vdir, "frames")))
        frames = [np.asarray(Image.open(os.path.join(
            vdir, "frames", f)).convert("RGB")) for f in files]

        tubes = []
        for obj_id in obj_ids:
            mdir = os.path.join(vdir, "masks", str(obj_id).zfill(3))
            ms = [np.asarray(Image.open(os.path.join(mdir, f)).convert("L"),
                             np.uint8) for f in files]
            tubes.append((np.stack(ms) > 127).astype(np.float32))
        masks = np.stack(tubes) if tubes else None  # [n, T, H, W]

        return dict(frames=frames, sources=_gcg_sources(tagged, self.rng),
                    masks=[masks])


class ConcatDataset:
    """Sequential concatenation of record datasets (reference uses
    torch.utils.data.ConcatDataset inside ValGCGDataset,
    utils/dataset.py:456-488)."""

    def __init__(self, datasets):
        self.datasets = [d for d in datasets if len(d)]
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx):
        k = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        return self.datasets[k][idx - int(self._offsets[k])]


def build_val_gcg(base_video_dir: str,
                  val_datasets: str = "video_gcg||mevis_gcg||vidstg_gcg"
                  ) -> ConcatDataset:
    """GCG validation union (reference ValGCGDataset,
    utils/dataset.py:456-488): the '||'-joined splits concatenate into one
    eval set. Layouts under base_video_dir:
      video_gcg:  video_gcg/test.json + video_gcg/frames/
      mevis_gcg:  mevis/valid_u/ (meta_expressions.json + JPEGImages +
                  mask_dict.json), expression-stitched GCG
      vidstg_gcg: vidstg_gcg/val{,_captions}/ per-video dirs
    Missing component dirs are skipped with a notice."""
    from .grounding_extra import GCGFromExpressions
    from .refer_vos import ReferVOSDataset
    from .video_gcg import GCGVideoDataset

    parts = []
    for name in val_datasets.split("||"):
        try:
            if name == "video_gcg":
                parts.append(GCGVideoDataset(
                    os.path.join(base_video_dir, "video_gcg", "test.json"),
                    os.path.join(base_video_dir, "video_gcg", "frames"),
                    image_set="test"))
            elif name == "mevis_gcg":
                parts.append(GCGFromExpressions(ReferVOSDataset(
                    os.path.join(base_video_dir, "mevis", "valid_u"),
                    image_set="valid_u")))
            elif name == "vidstg_gcg":
                parts.append(VidSTGHCSTVGGCGDataset(
                    base_video_dir, image_set="val",
                    source_dataset="vidstg"))
            else:
                raise ValueError(f"unknown val GCG dataset: {name}")
        except (FileNotFoundError, NotADirectoryError) as e:
            print(f"[val_gcg] skipping {name}: {e}")
    return ConcatDataset(parts)
