"""Spatio-temporal video grounding evaluation (VidSTG / HCSTVG): the port of
videoglamm_tpu/cli/eval_grounding.py (reference entry point
eval_grounding.py, :20-72 metric defs, :280-360 accumulation).

Per question: the model segments the referred subject; predicted masks
become boxes (masks_to_boxes); metrics are tIoU (temporal) and vIoU /
vIoU@{0.3,0.5} plus gt_vIoU (spatial IoU over the GT span only), averaged
per question type. The model runs on the card unless `--device cpu` asks
for the CPU.

A question whose frames or fields cannot be read is printed as `[skip]`
and the loop goes on; an exception from the model call, or from moving its
inputs to the device, is not caught. The returned summary carries the
number of skips under "skipped".

Input: an annotations JSON
  [{"vid": ..., "qtype": "declarative"|"interrogative", "question": str,
    "frames_dir": path, "gt_sted": [t0, t1),
    "gt_boxes": {frame_idx: [x0, y0, x1, y1]}}, ...]
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict

import numpy as np

from ..config import VideoGLaMMConfig
from ..constants import NUM_FRAMES
from ..data.conversation import ConvGenerator
from ..evals.metrics import masks_to_boxes, np_box_iou, temporal_iou
from ..inference.generate import terminators_for
from ..inference.pipeline import build_inference
from .common import (add_model_args, load_model, load_tokenizer, masks_of,
                     placement, prepare_vision_inputs, serving_options,
                     tokenize_prompt)

IOU_THRESHOLDS = (0.3, 0.5)


def eval_question(pred_boxes, pred_sted, gt_boxes, gt_sted, frame_ids):
    out = {}
    tiou, union_f, inter_f = temporal_iou(gt_sted, pred_sted, frame_ids)
    out["tiou"] = tiou
    viou = 0.0
    for f in inter_f:
        if f in pred_boxes and f in gt_boxes:
            viou += float(np_box_iou(np.asarray(pred_boxes[f])[None],
                                     np.asarray(gt_boxes[f])[None])[0, 0])
    viou = viou / max(len(union_f), 1)
    out["viou"] = viou
    for th in IOU_THRESHOLDS:
        out[f"viou@{th}"] = float(viou >= th)
    # gt_vIoU: spatial IoU over GT-span frames only
    gt_frames = [f for f in frame_ids if gt_sted[0] <= f < gt_sted[1]]
    gv = 0.0
    for f in gt_frames:
        if f in pred_boxes and f in gt_boxes:
            gv += float(np_box_iou(np.asarray(pred_boxes[f])[None],
                                   np.asarray(gt_boxes[f])[None])[0, 0])
    gv = gv / max(len(gt_frames), 1)
    out["gt_viou"] = gv
    for th in IOU_THRESHOLDS:
        out[f"gt_viou@{th}"] = float(gv >= th)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_model_args(p)
    p.add_argument("--annotations", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from ..data.preprocess import sample_frame_indices
    from ..data.video_reader import load_frame_dir

    opts = serving_options(args)
    tokenizer = load_tokenizer(args.tokenizer or args.checkpoint)
    cfg = VideoGLaMMConfig.flagship()
    pipe = build_inference(cfg, load_model(args, cfg),
                           eos_id=terminators_for(cfg.llm_type, tokenizer),
                           **opts)
    conv_gen = ConvGenerator(cfg.llm_type)
    to, dtype = placement(pipe)

    anns = json.load(open(args.annotations))
    results = {}
    skipped = 0
    for i, ann in enumerate(anns):
        try:        # faults of the data: the question, its frames, its GT
            frames = load_frame_dir(ann["frames_dir"])
            idx = sample_frame_indices(len(frames), NUM_FRAMES)
            sampled = [frames[k] for k in idx]
            prompt = conv_gen.apply_for_chat(
                f"Please segment the subject of: {ann['question']}",
                media="video")
            input_ids, lens = tokenize_prompt(prompt, tokenizer,
                                              args.max_new_tokens)
            gt_boxes = {int(k): v for k, v in ann["gt_boxes"].items()}
            gt_sted = tuple(ann["gt_sted"])
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

        pred_boxes, present = {}, []
        for t, fi in enumerate(idx):
            if tube[t].any():
                pred_boxes[int(fi)] = masks_to_boxes(
                    tube[t][None])[0].tolist()
                present.append(int(fi))
        pred_sted = ((min(present), max(present) + 1)
                     if present else (0, 0))
        m = eval_question(pred_boxes, pred_sted, gt_boxes, gt_sted,
                          [int(k) for k in idx])
        m["qtype"] = ann.get("qtype", "all")
        results[str(i)] = m

    # summarize per qtype (reference summarize_metrics, :22-53)
    agg = defaultdict(lambda: defaultdict(float))
    counts = defaultdict(int)
    for r in results.values():
        q = r["qtype"]
        counts[q] += 1
        for k, v in r.items():
            if k != "qtype":
                agg[q][k] += v
    summary = {q: {k: v / counts[q] for k, v in m.items()}
               for q, m in agg.items()}
    print(json.dumps(summary, indent=2))
    print(f"[done] {json.dumps({'questions': len(results), 'skipped': skipped})}")
    if args.out:
        json.dump({"summary": summary, "per_question": results},
                  open(args.out, "w"), indent=2)
    return dict(summary, skipped=skipped)


if __name__ == "__main__":
    main()
