"""ActivityNet-Entities official-format ingestion (the port's copy of
videoglamm_tpu/data/anet_entities.py; no function differs).

Behavioral contract from the reference inference script's parsing
(eval_anet_entities_infer.py:86-146) and the GCG datagen reader
(gcg_data_gen/anet_entities_gcg/1_dev_anet_entities_for_gcg.py:85-160):
- `anet_entities_cleaned_class_thresh50_trainval.json`: {"annotations":
  {vid: {"segments": {seg_id: {"timestamps": [s_sec, e_sec],
  "tokens": [...], "process_clss": [[...]], "process_idx": [[...]],
  "process_bnd_box": [[x1,y1,x2,y2]], "frame_ind": [...],
  "crowds": [...]}}}}}
- `split_ids_anet_entities.json`: {"training"|"validation"|...: [vid, ...]}
- videos live at <videos_root>/<vid>.{mp4,mkv,webm}; frames for a segment
  are fps-scaled: start=int(s_sec*fps), end=min(total-1, int(e_sec*fps)),
  linspace(num_frames) (eval_anet_entities_infer.py:57-81).

`convert_official_annotations` flattens that into the per-entry list the
eval CLI consumes (one entry per grounded box, phrase = the caption tokens
the box grounds).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

VIDEO_EXTENSIONS = (".mp4", ".mkv", ".webm")


def find_video(videos_root: str, vid: str) -> Optional[str]:
    """Resolve <vid> against the reference's search order: every subdir
    tried with every extension (eval_anet_entities_infer.py:122-137)."""
    roots = [videos_root]
    for sub in ("train", "validation", "val"):
        roots.append(os.path.join(videos_root, sub))
    for root in roots:
        for ext in VIDEO_EXTENSIONS:
            p = os.path.join(root, vid + ext)
            if os.path.exists(p):
                return p
    return None


def convert_official_annotations(reference_file: str, split_file: str,
                                 videos_root: Optional[str] = None,
                                 split: str = "validation",
                                 skip_missing_videos: bool = False
                                 ) -> List[Dict]:
    """Official annotation + split files -> simplified entry list.

    Each entry:
      {"vid", "seg", "video": path|None, "timestamps": [s_sec, e_sec],
       "phrase": str, "gt_box": [x1,y1,x2,y2], "gt_frame": int,
       "caption": str}
    One entry per grounded box; `phrase` joins the caption tokens at the
    box's process_idx (falling back to its class name).
    """
    split_ids = set(json.load(open(split_file))[split])
    anns = json.load(open(reference_file))["annotations"]
    entries: List[Dict] = []
    for vid in sorted(anns):
        if vid not in split_ids:
            continue
        video = find_video(videos_root, vid) if videos_root else None
        if videos_root and video is None and skip_missing_videos:
            continue
        for seg in sorted(anns[vid]["segments"],
                          key=lambda s: int(s) if s.isdigit() else s):
            ann = anns[vid]["segments"][seg]
            tokens = ann.get("tokens", [])
            caption = " ".join(tokens)
            boxes = ann.get("process_bnd_box", [])
            pidx = ann.get("process_idx", [])
            clss = ann.get("process_clss", [])
            find = ann.get("frame_ind", [])
            for i, box in enumerate(boxes):
                if i < len(pidx) and pidx[i]:
                    phrase = " ".join(tokens[p] for p in pidx[i]
                                      if 0 <= p < len(tokens))
                elif i < len(clss):
                    cls = clss[i]
                    phrase = " ".join(cls) if isinstance(cls, list) else \
                        str(cls)
                else:
                    continue
                entries.append({
                    "vid": vid, "seg": seg, "video": video,
                    "timestamps": [float(t) for t in ann["timestamps"]],
                    "phrase": phrase,
                    "gt_box": [float(v) for v in box],
                    "gt_frame": int(find[i]) if i < len(find) else 0,
                    "caption": caption,
                })
    return entries


def segment_frame_indices(total_frames: int, fps: float, timestamps,
                          num_frames: int):
    """fps-scaled segment window (reference load_frames,
    eval_anet_entities_infer.py:57-81)."""
    import numpy as np
    s_t, e_t = timestamps
    start = max(0, int(s_t * fps))
    end = min(total_frames - 1, int(e_t * fps))
    end = max(end, start)
    return np.linspace(start, end, num_frames).astype(int)
