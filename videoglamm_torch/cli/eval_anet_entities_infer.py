"""ActivityNet-Entities grounding inference (long-video): the port of
videoglamm_tpu/cli/eval_anet_entities_infer.py (reference entry point
eval_anet_entities_infer.py).

Per (video, noun-phrase annotation) the model grounds the phrase; long
clips are handled by segment-window frame sampling around each annotated
timestamp; outputs per-phrase mask PNGs + boxes JSON. The model runs on
the card unless `--device cpu` asks for the CPU.

Two input modes:
- --annotations JSON: [{"vid", "frames_dir", "phrase", "segment":
  [s_frac, e_frac]}] (pre-extracted frame dirs), or entries with
  {"video": path, "timestamps": [s_sec, e_sec]} (raw videos, fps-scaled
  windows like the reference's load_frames).
- --official_reference + --official_split (+ --videos_root): the official
  anet_entities_cleaned_class_thresh50_trainval.json / split-ids files,
  converted in-process by data/anet_entities.py (reference parsing at
  eval_anet_entities_infer.py:86-146).

An entry whose frames or fields cannot be read is printed as `[skip]` and
the loop goes on; an exception from the model call, or from moving its
inputs to the device, is not caught. The summary line counts the skips.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..config import VideoGLaMMConfig
from ..constants import NUM_FRAMES
from ..data.conversation import ConvGenerator
from ..evals.metrics import masks_to_boxes
from ..inference.generate import terminators_for
from ..inference.pipeline import build_inference
from .common import (add_model_args, load_model, load_tokenizer, masks_of,
                     placement, prepare_vision_inputs, serving_options,
                     tokenize_prompt)


def window_indices(n_frames: int, segment, num: int) -> np.ndarray:
    """Sample frames inside the annotated segment window (reference
    long-clip sampling, eval_anet_entities_infer.py)."""
    s = int(segment[0] * (n_frames - 1))
    e = max(int(segment[1] * (n_frames - 1)), s + 1)
    return np.linspace(s, e, num).astype(int)


def read_entry(ann):
    """(frame indices, sampled frames) of one annotation entry."""
    from ..data.video_reader import load_frame_dir
    if ann.get("video"):
        from ..data.anet_entities import segment_frame_indices
        from ..data.video_reader import VideoReader
        vr = VideoReader(ann["video"])
        idx = segment_frame_indices(len(vr), vr.fps or 25.0,
                                    ann["timestamps"], NUM_FRAMES)
        sampled = list(vr.get_batch([int(k) for k in idx]))
        vr.close()
        return idx, sampled
    frames = load_frame_dir(ann["frames_dir"])
    idx = window_indices(len(frames), ann.get("segment", [0.0, 1.0]),
                         NUM_FRAMES)
    return idx, [frames[k] for k in idx]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_model_args(p)
    p.add_argument("--annotations", default=None)
    p.add_argument("--official_reference", default=None,
                   help="anet_entities_cleaned_class_thresh50_trainval.json")
    p.add_argument("--official_split", default=None,
                   help="split_ids_anet_entities.json")
    p.add_argument("--split", default="validation")
    p.add_argument("--videos_root", default=None,
                   help="activitynet videos root (searched with the "
                        "reference's subdir/extension order)")
    p.add_argument("--save_dir", required=True)
    args = p.parse_args(argv)
    assert args.annotations or (args.official_reference
                                and args.official_split), \
        "pass --annotations or the official-format file pair"

    from PIL import Image

    opts = serving_options(args)
    tokenizer = load_tokenizer(args.tokenizer or args.checkpoint)
    cfg = VideoGLaMMConfig.flagship()
    pipe = build_inference(cfg, load_model(args, cfg),
                           eos_id=terminators_for(cfg.llm_type, tokenizer),
                           **opts)
    conv_gen = ConvGenerator(cfg.llm_type)
    to, dtype = placement(pipe)

    if args.annotations:
        anns = json.load(open(args.annotations))
    else:
        from ..data.anet_entities import convert_official_annotations
        anns = convert_official_annotations(
            args.official_reference, args.official_split,
            videos_root=args.videos_root, split=args.split,
            skip_missing_videos=True)
        print(f"[convert] {len(anns)} grounded phrases from the official "
              f"{args.split} split")
    os.makedirs(args.save_dir, exist_ok=True)
    results = []
    skipped = 0
    for i, ann in enumerate(anns):
        try:        # faults of the data: the entry, its video or frames
            idx, sampled = read_entry(ann)
            prompt = conv_gen.apply_for_chat(
                f"Please segment {ann['phrase']} in this video.",
                media="video")
            input_ids, lens = tokenize_prompt(prompt, tokenizer,
                                              args.max_new_tokens)
        except Exception as e:
            print(f"[skip] {i}: {e}")
            skipped += 1
            continue
        f, c, s, orig_hw = prepare_vision_inputs(sampled, pipe.model.cfg,
                                                 to=to, dtype=dtype)
        res = pipe(f, c, s, input_ids.to(to), lens.to(to),
                   use_video_branch=args.use_sam2_video_branch)
        masks = masks_of(res, orig_hw)
        tube = masks[0] if len(masks) else np.zeros(
            (len(sampled),) + tuple(orig_hw), bool)

        out_dir = os.path.join(args.save_dir, f"{i:06d}")
        os.makedirs(out_dir, exist_ok=True)
        boxes = {}
        for t, fi in enumerate(idx):
            Image.fromarray((tube[t] * 255).astype(np.uint8)).save(
                os.path.join(out_dir, f"{int(fi):05d}.png"))
            if tube[t].any():
                boxes[int(fi)] = masks_to_boxes(tube[t][None])[0].tolist()
        results.append({
            "index": i, "phrase": ann["phrase"], "boxes": boxes,
            **{k: ann[k] for k in ("vid", "seg", "gt_box", "gt_frame")
               if k in ann}})
        print(f"[ok] {i}")
    json.dump(results, open(os.path.join(args.save_dir, "results.json"),
                            "w"))
    summary = {"phrases": len(results), "skipped": skipped}
    print(f"[done] {json.dumps(summary)}")
    return summary


if __name__ == "__main__":
    main()
