"""Temporal grounding, spatio-temporal grounding (VidSTG/HCSTVG) and the
GCG dataset variants built from referring expressions / image grounding
(the port's own copy of videoglamm_tpu/data/datasets/grounding_extra.py).

Behavioral contracts:
- TemporalGroundingDataset (reference utils/temporal_grounding_datasets.py:
  49-390): Charades-STA `video t_start t_end##query` txt and
  ActivityNet-Captions / QVHighlights JSON annotations produce
  "temporally locate {phrase}" questions answered textually with
  "frames:(f_start,f_end)" after fps sampling + subsampling rescale;
- VidSTGDataset (utils/vidstg_dataset.py:41-340): declarative/interrogative
  questions over subject tubes; masks come from precomputed per-frame mask
  annotations (the reference generates them offline from boxes with HQ-SAM);
- GCGFromExpressions (utils/ytvos_gcg.py:155-213, mevis_gcg.py:231-302):
  referring expressions stitched into one grounded caption
  "There is <p> exp1 </p> [SEG], <p> exp2 </p> [SEG] ..." with per-expression
  mask tubes;
- GranDfDataset (utils/grandf_dataset.py:23-223): image GCG — caption with
  word spans grounded to RLE masks.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional

import numpy as np

from ...constants import DEFAULT_IMAGE_TOKEN, DEFAULT_VIDEO_TOKEN
from ..rle import rle_decode
from .templates import ANSWER_LIST

TEMPORAL_QUESTIONS = [
    DEFAULT_VIDEO_TOKEN + "\n" + "Can you temporally locate {phrase} in "
                                 "this video?",
    DEFAULT_VIDEO_TOKEN + "\n" + "Please temporally locate {phrase} in "
                                 "this video.",
    DEFAULT_VIDEO_TOKEN + "\n" + "Perform temporal segmentation of {phrase}",
    DEFAULT_VIDEO_TOKEN + "\n" + "Can you indentify the range of frames "
                                 "containing {phrase}?",
]

TEMPORAL_ANSWERS = [
    "It is in frames:({t_start},{t_end}).",
    "Sure, frames:({t_start},{t_end}).",
    "Sure, it is within frames:({t_start},{t_end}).",
    "Sure, the localization result is in frames:({t_start},{t_end}).",
    "Frames:({t_start},{t_end}).",
]

STVG_QUESTIONS = [
    DEFAULT_VIDEO_TOKEN + "\n" + "Can you segment {phrase} in this video?",
    DEFAULT_VIDEO_TOKEN + "\n" + "Please locate and segment the subject "
                                 "of: {phrase}",
]


def parse_charades_sta(path: str) -> List[Dict]:
    """`vid t_start t_end##query` lines (reference :58-75)."""
    out = []
    for line in open(path).read().split("\n"):
        if not line:
            continue
        head, query = line.split("##")
        vid, t0, t1 = head.split(" ")
        out.append({"video_id": vid, "t_start": float(t0),
                    "t_end": float(t1), "query": query})
    return out


def rescale_span(f_start, f_end, n_raw, n_out):
    """Frame-span rescaling after subsampling (reference :94-101)."""
    if n_raw <= n_out:
        return int(f_start), int(f_end)
    s = n_out / n_raw
    return int(f_start * s), int(f_end * s)


class TemporalGroundingDataset:
    """Charades-STA / ActivityNet-Captions-style temporal grounding over
    frame directories (video decode happens through data.video_reader when a
    file path is given)."""

    def __init__(self, annotations: List[Dict], media_root: str,
                 video_framerate: float = 1.0, max_num_frames: int = 16,
                 seed: int = 0):
        """annotations: [{"video_id", "t_start", "t_end", "query"}];
        media at <media_root>/<video_id> (frame dir or video file)."""
        self.annotations = annotations
        self.media_root = media_root
        self.fps = video_framerate
        self.max_num_frames = max_num_frames
        self.rng = np.random.RandomState(seed)

    @classmethod
    def from_charades_sta(cls, txt_path: str, media_root: str, **kw):
        return cls(parse_charades_sta(txt_path), media_root, **kw)

    @classmethod
    def from_activitynet_captions(cls, json_path: str, media_root: str,
                                  **kw):
        """{vid: {"timestamps": [[s, e], ...], "sentences": [...]}}."""
        anns = []
        for vid, item in json.load(open(json_path)).items():
            for (s, e), sent in zip(item["timestamps"], item["sentences"]):
                anns.append({"video_id": vid, "t_start": float(s),
                             "t_end": float(e), "query": sent.strip()})
        return cls(anns, media_root, **kw)

    def __len__(self):
        return len(self.annotations)

    def __getitem__(self, idx) -> Dict:
        from ..video_reader import load_frame_dir, load_video_frames
        ann = self.annotations[idx]
        path = os.path.join(self.media_root, ann["video_id"])
        if os.path.isdir(path):
            frames = load_frame_dir(path)
        else:
            for ext in (".mp4", ".avi", ".mkv", ""):
                if os.path.exists(path + ext):
                    frames = load_video_frames(path + ext, num_frames=256)
                    break
        f_start = math.floor(ann["t_start"] * self.fps)
        f_end = math.ceil(ann["t_end"] * self.fps)
        n_raw = len(frames)
        if n_raw > self.max_num_frames:
            keep = np.linspace(0, n_raw - 1,
                               self.max_num_frames).astype(int)
            frames = [frames[i] for i in keep]
            f_start, f_end = rescale_span(f_start, f_end, n_raw,
                                          self.max_num_frames)
        q = self.rng.choice(TEMPORAL_QUESTIONS).format(
            phrase=ann["query"].lower())
        a = self.rng.choice(TEMPORAL_ANSWERS).format(t_start=f_start,
                                                     t_end=f_end)
        return dict(frames=frames,
                    sources=[[{"from": "human", "value": q},
                              {"from": "gpt", "value": a}]],
                    masks=None)


class VidSTGDataset:
    """Spatio-temporal grounding with per-question subject mask tubes.

    Annotation JSON: [{"vid", "frames_dir", "question", "qtype",
    "mask_rles": [RLE|None per frame]}] (the reference derives mask_rles
    offline from GT boxes with HQ-SAM, gcg_data_gen/)."""

    def __init__(self, annotation_json: str, seed: int = 0):
        self.anns = json.load(open(annotation_json))
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.anns)

    def __getitem__(self, idx) -> Dict:
        from ..video_reader import load_frame_dir
        ann = self.anns[idx]
        frames = load_frame_dir(ann["frames_dir"])
        hw = frames[0].shape[:2]
        tube = np.zeros((len(frames),) + hw, bool)
        for t, r in enumerate(ann["mask_rles"][:len(frames)]):
            if r is not None:
                tube[t] = rle_decode(r)
        q = self.rng.choice(STVG_QUESTIONS).format(
            phrase=ann["question"].lower())
        a = self.rng.choice(ANSWER_LIST)
        return dict(frames=frames,
                    sources=[[{"from": "human", "value": q},
                              {"from": "gpt", "value": a}]],
                    masks=[tube[None]])


GCG_VIDEO_QUESTION = (
    DEFAULT_VIDEO_TOKEN + "\n" + "Could you please give me a detailed "
    "description of the video? Please respond with interleaved segmentation "
    "masks for the corresponding parts of the answer.")
GCG_IMAGE_QUESTION = (
    DEFAULT_IMAGE_TOKEN + "\n" + "Could you please give me a detailed "
    "description of the image? Please respond with interleaved segmentation "
    "masks for the corresponding parts of the answer.")


class GCGFromExpressions:
    """GCG variant over referring-expression datasets (reference
    ytvos_gcg.py:155-213 / mevis_gcg.py:231-302): the grounded caption is
    stitched from the video's expressions, each grounded by its tube."""

    def __init__(self, refer_vos_dataset, max_seg: int = 4):
        self.base = refer_vos_dataset
        self.max_seg = max_seg

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx) -> Dict:
        from ..video_reader import load_frame_dir
        base = self.base
        vid = base.vids[idx]
        vinfo = base.videos[vid]
        fdir = os.path.join(base.root, "JPEGImages", vid)
        from PIL import Image
        files = sorted(os.listdir(fdir))
        frames = [np.asarray(Image.open(os.path.join(fdir, f)).convert(
            "RGB")) for f in files]
        hw = frames[0].shape[:2]

        parts, tubes = [], []
        for eid in sorted(vinfo["expressions"])[:self.max_seg]:
            einfo = vinfo["expressions"][eid]
            parts.append(f"<p> {einfo['exp']} </p> [SEG]")
            tubes.append(base._expr_mask(vid, einfo, len(frames), hw))
        caption = "There is " + ", ".join(parts) + " in the video."
        return dict(frames=frames,
                    sources=[[{"from": "human", "value": GCG_VIDEO_QUESTION},
                              {"from": "gpt", "value": caption}]],
                    masks=[np.stack(tubes)])


class GranDfDataset:
    """Image GCG (reference grandf_dataset.py:23-223): caption with word
    spans grounded to RLE masks.

    Annotation JSON: [{"image", "caption",
    "groundings": {phrase: [RLE, ...]}}]."""

    def __init__(self, annotation_json: str, image_root: str,
                 max_seg: int = 4):
        self.anns = json.load(open(annotation_json))
        self.image_root = image_root
        self.max_seg = max_seg

    def __len__(self):
        return len(self.anns)

    def __getitem__(self, idx) -> Dict:
        from PIL import Image
        ann = self.anns[idx]
        img = np.asarray(Image.open(os.path.join(
            self.image_root, ann["image"])).convert("RGB"))
        caption = ann["caption"]
        masks = []
        # ground phrases in caption order, tagging first occurrences
        items = sorted(
            ann["groundings"].items(),
            key=lambda kv: caption.lower().find(kv[0].lower()))
        for phrase, rles in items[:self.max_seg]:
            pos = caption.lower().find(phrase.lower())
            if pos < 0:
                continue
            orig = caption[pos:pos + len(phrase)]
            caption = (caption[:pos] + f"<p> {orig} </p> [SEG]"
                       + caption[pos + len(phrase):])
            m = np.zeros(img.shape[:2], bool)
            for r in rles:
                m |= rle_decode(r)
            masks.append(m)
        return dict(frames=[img],
                    sources=[[{"from": "human", "value": GCG_IMAGE_QUESTION},
                              {"from": "gpt", "value": caption}]],
                    masks=[np.stack(masks)[:, None] if masks else None])
