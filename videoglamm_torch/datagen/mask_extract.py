"""GCG datagen: SAM mask extraction from boxes + annotation merging (the
port's own copy of videoglamm_tpu/datagen/mask_extract.py, on the port's
SAM-2).

Mirrors the reference gcg_data_gen mask tooling with the in-repo SAM-2
stack instead of external HQ-SAM checkpoints:
- anet_entities_gcg/3_anet_entities_gcg_extract_masks.py: per [SEG:n]
  token, prompt SAM with the noun phrase's bbox on its frame and save
  masks/<vid>____<seg>/<nn>/mask.png;
- vidstg_gcg/dev_vidstg_gcg_mask_gen.py + hcstvg_gcg/dev_hcstvg_2_mask_gen.py:
  per object, prompt SAM with its per-frame GT box on every frame and save
  <set>/<vid>/masks/<obj:03d>/<frame>.png;
- burst_ytvis_gcg/merge_b_y.py: merge several {videos, annotations}
  instruction files into one GCGVideoDataset-consumable JSON (id
  re-offsetting + skip lists).

All outputs load directly through ANetEntitiesGCGDataset /
VidSTGHCSTVGGCGDataset / GCGVideoDataset.
"""
from __future__ import annotations

import copy
import json
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


# ----------------------------------------------------------- SAM driver --

class Sam2BoxSegmenter:
    """Box-prompted single-image segmentation with the port's SAM-2 (the
    image-mode path: backbone + no_mem embed + box prompt encoder + mask
    decoder, reference sam2_image_predictor semantics). `sam_model` is a
    built `SAM2Base` (`inference.pipeline.build_sam2`), which holds its
    weights and runs where it lies: on the card unless built for the CPU.
    The frame goes through the host preprocessor `preprocess_sam2`, as in
    the JAX segmenter."""

    def __init__(self, sam_model):
        from ..models.sam2.sam2_base import model_device
        self.model = sam_model
        self.size = sam_model.cfg.image_size
        self.device = model_device(sam_model)

    @torch.no_grad()
    def segment(self, image, boxes):
        """image [1, S, S, 3] SAM-normalised; boxes [N, 4] xyxy in model
        pixels -> low-res mask logits [N, 4E, 4E]."""
        m = self.model
        feats, _ = m.forward_image(image)
        embed = feats[2] + m.no_mem_embed.reshape(1, 1, 1, -1).to(feats[2].dtype)
        n = boxes.shape[0]

        def tile(f):
            return f.expand((n,) + tuple(f.shape[1:]))
        sparse, dense = m.sam_prompt_encoder(boxes=boxes)
        dec = m.sam_mask_decoder(
            tile(embed), m.sam_prompt_encoder.get_dense_pe(), sparse, dense,
            multimask_output=False,
            high_res_features=(tile(feats[0]), tile(feats[1])))
        return dec.masks[:, 0]

    def __call__(self, frame: np.ndarray, boxes_xyxy) -> np.ndarray:
        """frame: [H, W, 3] uint8; boxes_xyxy: [N, 4] in original pixels ->
        [N, H, W] bool masks."""
        from ..data.preprocess import preprocess_sam2
        from ..evals.postprocess import masks_to_original_size
        h, w = frame.shape[:2]
        img = torch.from_numpy(preprocess_sam2([frame], self.size)).to(
            self.device)
        boxes = np.asarray(boxes_xyxy, np.float32).reshape(-1, 4)
        scale = np.asarray([self.size / w, self.size / h] * 2, np.float32)
        low = self.segment(img, torch.from_numpy(boxes * scale).to(self.device))
        return masks_to_original_size(low, (h, w))


# ---------------------------------------------------- extraction drivers --

_SEG_N = re.compile(r"\[SEG:(\d+)\]")


def extract_anet_gcg_masks(segmenter, dataset_dir: str,
                           overwrite: bool = False) -> int:
    """dataset_dir holds anns/<vid>____<seg>.json (refined_caption +
    seg_token_to_obj with frame_id/bbox) and video_frames/<vid>/<seg>/;
    writes masks/<vid>____<seg>/<nn>/mask.png. Returns #masks written."""
    from PIL import Image
    ann_dir = os.path.join(dataset_dir, "anns")
    written = 0
    for ann_file in sorted(os.listdir(ann_dir)):
        if not ann_file.endswith(".json"):
            continue
        key = ann_file[:-len(".json")]
        vid, seg = key.split("____")
        obj = json.load(open(os.path.join(ann_dir, ann_file)))
        fdir = os.path.join(dataset_dir, "video_frames", vid, seg)
        files = sorted(f for f in os.listdir(fdir) if f.endswith(".jpg"))
        for seg_id in set(_SEG_N.findall(obj["refined_caption"])):
            out = os.path.join(dataset_dir, "masks", key,
                               str(seg_id).zfill(2), "mask.png")
            if os.path.exists(out) and not overwrite:
                continue
            info = obj["seg_token_to_obj"][f"[SEG:{seg_id}]"]
            fid = int(info["frame_id"])
            frame = np.asarray(Image.open(os.path.join(
                fdir, files[min(fid, len(files) - 1)])).convert("RGB"))
            mask = segmenter(frame, [info["bbox"]])[0]
            os.makedirs(os.path.dirname(out), exist_ok=True)
            Image.fromarray(mask.astype(np.uint8) * 255).save(out)
            written += 1
    return written


def extract_vidstg_gcg_masks(segmenter, root: str, image_set: str = "train",
                             source_dataset: str = "vidstg",
                             overwrite: bool = False) -> int:
    """<root>/<source>_gcg/<set>/<vid>/{frames/, boxes.json} ->
    masks/<obj:03d>/<frame>.png per object per frame.

    boxes.json: {obj_id: {frame_name: [x1, y1, x2, y2] | null}}; null/absent
    frames get an empty mask (the object is not visible)."""
    from PIL import Image
    vdir_root = os.path.join(root, f"{source_dataset}_gcg", image_set)
    written = 0
    for vid in sorted(os.listdir(vdir_root)):
        vdir = os.path.join(vdir_root, vid)
        boxes_path = os.path.join(vdir, "boxes.json")
        if not os.path.exists(boxes_path):
            continue
        boxes = json.load(open(boxes_path))
        frames = sorted(os.listdir(os.path.join(vdir, "frames")))
        for obj_id, per_frame in boxes.items():
            mdir = os.path.join(vdir, "masks", str(obj_id).zfill(3))
            os.makedirs(mdir, exist_ok=True)
            for fname in frames:
                out = os.path.join(mdir, fname)
                if os.path.exists(out) and not overwrite:
                    continue
                frame = np.asarray(Image.open(os.path.join(
                    vdir, "frames", fname)).convert("RGB"))
                box = per_frame.get(fname)
                if box is None:
                    mask = np.zeros(frame.shape[:2], bool)
                else:
                    mask = segmenter(frame, [box])[0]
                Image.fromarray(mask.astype(np.uint8) * 255).save(out)
                written += 1
    return written


# ------------------------------------------------------------- merging ---

def merge_gcg_annotations(paths: Sequence[str],
                          skip_videos: Optional[Dict[str, List]] = None,
                          out_json: Optional[str] = None) -> dict:
    """Merge several GCG instruction files ({videos, annotations} with
    dense_cap.mask_id referencing annotations[].id) into one, re-offsetting
    annotation ids so references stay valid (reference merge_b_y.py does
    this with hardcoded offsets + per-split skip lists; `skip_videos` maps
    path -> list of video indices to drop)."""
    skip_videos = skip_videos or {}
    merged = {"videos": [], "annotations": []}
    offset = 0
    for path in paths:
        data = json.load(open(path))
        skip = set(skip_videos.get(path, ()))
        ids_here = {a["id"] for a in data["annotations"]}
        for ann in data["annotations"]:
            ann = dict(ann)
            ann["id"] = ann["id"] + offset
            merged["annotations"].append(ann)
        for i, video in enumerate(data["videos"]):
            if i in skip:
                continue
            video = copy.deepcopy(video)
            cap = video.get("dense_cap", {})
            if "mask_id" in cap:
                cap["mask_id"] = [m + offset for m in cap["mask_id"]]
            if "v_id2o_id" in cap:
                cap["v_id2o_id"] = {k: v + offset if isinstance(v, int)
                                    else v for k, v in
                                    cap["v_id2o_id"].items()}
            merged["videos"].append(video)
        offset += (max(ids_here) + 1) if ids_here else 0
    if out_json:
        with open(out_json, "w") as f:
            json.dump(merged, f)
    return merged
