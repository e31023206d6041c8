"""Visual instruction / VQA datasets (the port's own copy of
videoglamm_tpu/data/datasets/vqa.py; image: LLaVA-Instruct-150k format,
video: Video-Instruct-100k / VideoChatGPT format). Conversations pass
through unchanged (no [SEG], no masks); they regularize the LLM during
grounded fine-tuning.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from ...constants import DEFAULT_IMAGE_TOKEN, DEFAULT_VIDEO_TOKEN


class VQADataset:
    def __init__(self, annotation_json: str, media_root: str,
                 media: str = "image"):
        self.data = json.load(open(annotation_json))
        self.media_root = media_root
        self.media = media

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx) -> Dict:
        from PIL import Image
        item = self.data[idx]
        if self.media == "image":
            img = np.asarray(Image.open(os.path.join(
                self.media_root, item["image"])).convert("RGB"))
            frames = [img]
        else:
            from ..video_reader import load_video_frames
            frames = load_video_frames(
                os.path.join(self.media_root,
                             item.get("video", item.get("image"))),
                num_frames=16)

        src = []
        for turn in item["conversations"]:
            role = "human" if turn["from"] in ("human", "user") else "gpt"
            src.append({"from": role, "value": turn["value"]})
        # guarantee a media token on the first user turn
        tok = DEFAULT_IMAGE_TOKEN if self.media == "image" \
            else DEFAULT_VIDEO_TOKEN
        if src and tok not in src[0]["value"] \
                and DEFAULT_IMAGE_TOKEN not in src[0]["value"]:
            src[0]["value"] = tok + "\n" + src[0]["value"]
        return dict(frames=frames, sources=[src], masks=None)
