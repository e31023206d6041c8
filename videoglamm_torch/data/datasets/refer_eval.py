"""A2D-Sentences and JHMDB-Sentences loaders and their train-source adapter
(the port's own copy of videoglamm_tpu/data/datasets/refer_eval.py).

- `A2DSentencesDataset`: the annotation JSON is a list of (text_query,
  video_id, frame_idx, instance_id) rows; frames come from
  Release/clips320H/<video_id>.mp4 (or a <video_id>/ frame directory); the
  mask of the annotated frame lives in
  text_annotations/a2d_annotation_with_instances/<video_id>/<frame:05d>.h5
  ('instance' ids and 'reMask' [N,W,H], stored transposed). A window of
  num_frames is centred on the annotated frame.
- `JHMDBSentencesDataset`: sample rows (video_id, chosen_frame_path,
  video_masks_path, video_total_frames, text_query); frames <frame:05d>.png
  are 1-indexed; the whole video's 'part_mask' is a scipy .mat [H,W,T].

Both yield eval records:
  {frames: [T,H,W,3] uint8 list, caption, image_id,
   gt_mask: [H,W] bool (annotated frame), valid_index: int (position of
   the annotated frame in `frames`), frame_indices: [T]}

`ReferSentencesTrainDataset` adapts either loader into a train source of
the hybrid mixture (the CLI's `--a2d_root` and `--jhmdb_root`).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np


def _center_window(frame_id: int, num_frames: int, lo: int,
                   hi: int) -> List[int]:
    """num_frames indices centered on frame_id, edge-padded to [lo, hi]
    (reference a2d.py:112-117 / jhmdb.py:68-75)."""
    start = frame_id - num_frames // 2
    end = frame_id + (num_frames + 1) // 2
    return sorted(min(max(i, lo), hi) for i in range(start, end))


class A2DSentencesDataset:
    def __init__(self, dataset_path: str, ann_file: str,
                 num_frames: int = 5):
        self.dataset_path = dataset_path
        self.mask_dir = os.path.join(
            dataset_path, "text_annotations", "a2d_annotation_with_instances")
        self.videos_dir = os.path.join(dataset_path, "Release", "clips320H")
        self.rows: List[Tuple] = [tuple(a) for a in json.load(open(ann_file))]
        self.num_frames = num_frames

    def __len__(self):
        return len(self.rows)

    def _load_video(self, video_id: str) -> List[np.ndarray]:
        mp4 = os.path.join(self.videos_dir, f"{video_id}.mp4")
        if os.path.exists(mp4):
            from ..video_reader import VideoReader
            vr = VideoReader(mp4)
            frames = vr.get_batch(range(len(vr)))
            vr.close()
            return list(frames)
        from ..video_reader import load_frame_dir
        return load_frame_dir(os.path.join(self.videos_dir, video_id))

    def __getitem__(self, idx) -> Dict:
        import h5py
        text_query, video_id, frame_idx, instance_id = self.rows[idx]
        caption = " ".join(str(text_query).lower().split())
        video = self._load_video(video_id)
        frame_id = int(frame_idx) - 1  # a2d is 1-indexed (:76-77)

        sel = _center_window(frame_id, self.num_frames, 0, len(video) - 1)
        valid_index = sel.index(frame_id)

        h5_path = os.path.join(self.mask_dir, video_id,
                               f"{int(frame_idx):05d}.h5")
        with h5py.File(h5_path, "r") as f:
            instances = [int(i) for i in np.asarray(f["instance"]).ravel()]
            inst_pos = instances.index(int(instance_id))
            remask = np.asarray(f["reMask"])
        if remask.ndim == 2:
            remask = remask[None]
        # stored [N, W, H]; transpose to [N, H, W] (:135-138)
        masks = np.transpose(remask, (0, 2, 1)).astype(bool)
        gt = masks[inst_pos]

        return dict(frames=[video[i] for i in sel], caption=caption,
                    image_id=f"v_{video_id}_f_{frame_idx}_i_{instance_id}",
                    gt_mask=gt, valid_index=valid_index,
                    frame_indices=np.asarray(sel))


class ReferSentencesTrainDataset:
    """Train-source adapter over A2D/JHMDB-Sentences records.

    One declarative-question conversation per text query (reference
    refer_vos_dataset.py:44-57,140-152); only the annotated frame carries
    supervision, so every SAM frame slot is pinned to it — the reference's
    num_frames_for_sam=1 uniform sampling silently pairs the annotated
    frame's mask with window frame 0 (refer_vos_dataset.py:170-177), a
    mask/frame mismatch this redesign corrects rather than replicates.
    """

    def __init__(self, base, num_frames_for_sam: int = 4, seed: int = 0):
        self.base = base
        self.num_frames_for_sam = num_frames_for_sam
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx) -> Dict:
        from .templates import ANSWER_LIST, VIDEO_QUESTION_LIST
        rec = self.base[idx]
        frames = rec["frames"]
        gt = np.asarray(rec["gt_mask"], np.float32)
        tube = np.zeros((1, len(frames)) + gt.shape, np.float32)
        tube[0, rec["valid_index"]] = gt
        q = self.rng.choice(VIDEO_QUESTION_LIST).format(
            phrase=rec["caption"].lower())
        a = self.rng.choice(ANSWER_LIST)
        return dict(
            frames=frames,
            sources=[[{"from": "human", "value": q},
                      {"from": "gpt", "value": a}]],
            masks=[tube],
            sam_frame_idx=[rec["valid_index"]] * self.num_frames_for_sam)


class JHMDBSentencesDataset:
    def __init__(self, dataset_path: str, ann_file: str,
                 num_frames: int = 5):
        self.dataset_path = dataset_path
        self.rows: List[Tuple] = [tuple(a) for a in json.load(open(ann_file))]
        self.num_frames = num_frames

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx) -> Dict:
        import scipy.io
        from PIL import Image
        (video_id, chosen_frame_path, video_masks_path,
         video_total_frames, text_query) = self.rows[idx]
        caption = " ".join(str(text_query).lower().split())

        # frames are 1-indexed (:66-69)
        chosen = int(os.path.splitext(
            os.path.basename(chosen_frame_path))[0])
        sel = _center_window(chosen, self.num_frames, 1,
                             int(video_total_frames))
        valid_index = sel.index(chosen)

        fdir = os.path.dirname(chosen_frame_path).lstrip("./")
        frames = []
        for i in sel:
            path = os.path.join(self.dataset_path, fdir, f"{i:05d}.png")
            frames.append(np.asarray(Image.open(path).convert("RGB")))

        mat = scipy.io.loadmat(
            os.path.join(self.dataset_path, str(video_masks_path)))
        all_masks = mat["part_mask"].transpose(2, 0, 1)  # [T, H, W] (:88)
        gt = all_masks[chosen - 1].astype(bool)

        return dict(frames=frames, caption=caption,
                    image_id=f"v_{video_id}_f_{chosen}",
                    gt_mask=gt, valid_index=valid_index,
                    frame_indices=np.asarray(sel))
