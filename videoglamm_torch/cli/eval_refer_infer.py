"""Referring video segmentation inference (MeViS / Ref-YouTubeVOS /
Ref-DAVIS-17 / A2D-Sentences / JHMDB-Sentences): the port of
videoglamm_tpu/cli/eval_refer_infer.py (reference entry points
eval_mevis.py:35-209 and eval_referdavis_infer.py).

For each (video, referring expression): prompt the model to segment the
expression, save per-frame PNG masks in the benchmark layout (MeViS/YTVOS:
zip for the server; DAVIS: consumed by eval_referdavis_metrics). The model
runs on the card unless `--device cpu` asks for the CPU. The pixel decoder
sees every frame of a video up to `--max_sam_frames` (64 by default),
while the LLM prefix sees NUM_FRAMES sampled ones; a video's three streams
are made once and serve all its expressions.

Expected meta JSON (MeViS-style, --dataset mevis):
  <data_root>/meta_expressions.json:
    {"videos": {vid: {"expressions": {eid: {"exp": str}},
                      "frames": [frame_name, ...]}}}
  frames at <data_root>/JPEGImages/<vid>/<frame>.jpg

--dataset a2d / jhmdb instead consumes the sentence datasets
(data/datasets/refer_eval.py) and scores each record's single annotated
frame directly: per-record IoU plus the standard A2D-Sentences summary
(overall IoU, mean IoU, precision@{0.5..0.9}) written to
<save_dir>/results.json.

An expression, or a sentence record, whose prompt or record cannot be
built is printed as `[skip]` and the loop goes on; an exception from the
model call, or from moving its inputs to the device, is not caught. A
MeViS video whose frames cannot be read stops the run, as in the JAX CLI.
The summary line counts the skips.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..config import VideoGLaMMConfig
from ..constants import NUM_FRAMES
from ..data.conversation import ConvGenerator
from ..evals.postprocess import masks_to_original_size
from ..inference.generate import terminators_for
from ..inference.pipeline import build_inference
from .common import (add_model_args, load_model, load_tokenizer, placement,
                     prepare_vision_inputs, serving_options, tokenize_prompt)

REFER_PROMPT = "Please segment the {exp} in this video."


def _eval_sentences(args, pipe, tokenizer, conv_gen):
    """A2D/JHMDB-Sentences: score the annotated frame of every record."""
    from ..data.datasets import A2DSentencesDataset, JHMDBSentencesDataset
    from ..data.preprocess import sample_frame_indices

    if args.dataset == "a2d":
        ann = args.ann_file or os.path.join(
            args.data_root, "a2d_sentences_single_frame_test_annotations.json")
        ds = A2DSentencesDataset(args.data_root, ann,
                                 num_frames=args.num_frames)
    else:
        ann = args.ann_file or os.path.join(
            args.data_root, "jhmdb_sentences_samples_metadata.json")
        ds = JHMDBSentencesDataset(args.data_root, ann,
                                   num_frames=args.num_frames)

    to, dtype = placement(pipe)
    os.makedirs(args.save_dir, exist_ok=True)
    records = []
    skipped = 0
    inter_sum = union_sum = 0.0
    for i in range(len(ds)):
        try:        # faults of the data: the record, its frames, its mask
            rec = ds[i]
            prompt = conv_gen.apply_for_chat(
                REFER_PROMPT.format(exp=rec["caption"]), media="video")
            input_ids, lens = tokenize_prompt(prompt, tokenizer,
                                              args.max_new_tokens)
            idx = sample_frame_indices(len(rec["frames"]), NUM_FRAMES)
            gt = np.asarray(rec["gt_mask"], bool)
        except Exception as e:
            print(f"[skip] record {i}: {e}")
            skipped += 1
            continue
        f, c, s, _ = prepare_vision_inputs(
            [rec["frames"][j] for j in idx], pipe.model.cfg,
            sam_frames=rec["frames"], to=to, dtype=dtype)
        res = pipe(f, c, s, input_ids.to(to), lens.to(to),
                   use_video_branch=args.use_sam2_video_branch)
        masks = masks_to_original_size(res.pred_masks[0], gt.shape)
        valid = res.seg_valid[0].cpu().numpy()
        if valid.any():
            pred = masks[valid][0][rec["valid_index"]]
        else:
            pred = np.zeros_like(gt)
        inter = float((pred & gt).sum())
        union = float((pred | gt).sum())
        iou = inter / union if union else 0.0
        inter_sum += inter
        union_sum += union
        records.append({"image_id": rec["image_id"], "iou": iou})
        print(f"[ok] {rec['image_id']} iou={iou:.3f}")

    ious = np.asarray([r["iou"] for r in records], np.float64)
    summary = {
        "dataset": args.dataset,
        "n": len(records),
        "overall_iou": inter_sum / union_sum if union_sum else 0.0,
        "mean_iou": float(ious.mean()) if len(ious) else 0.0,
        **{f"precision@{t}": float((ious > t).mean()) if len(ious) else 0.0
           for t in (0.5, 0.6, 0.7, 0.8, 0.9)},
    }
    with open(os.path.join(args.save_dir, "results.json"), "w") as fp:
        json.dump({"summary": summary, "records": records}, fp, indent=2)
    print(json.dumps(summary))
    print(f"[done] {json.dumps({'records': len(records), 'skipped': skipped})}")
    return dict(summary, skipped=skipped)


def video_streams(args, pipe, fdir, to, dtype):
    """A MeViS-layout video's three streams, made once: NUM_FRAMES sampled
    frames for the LLM prefix, every frame up to --max_sam_frames for the
    pixel decoder -> ((frames, context, frames_sam, orig_hw), sam_idx)."""
    from ..data.preprocess import sample_frame_indices
    from ..data.video_reader import load_frame_dir
    all_frames = load_frame_dir(fdir)
    idx = sample_frame_indices(len(all_frames), NUM_FRAMES)
    frames = [all_frames[i] for i in idx]
    # pixel-decoder frames: the whole video (capped), not the samples
    if len(all_frames) > args.max_sam_frames:
        sam_idx = sample_frame_indices(len(all_frames), args.max_sam_frames)
    else:
        sam_idx = list(range(len(all_frames)))
    sam_frames = [all_frames[i] for i in sam_idx]
    return prepare_vision_inputs(frames, pipe.model.cfg, sam_frames=sam_frames,
                                 to=to, dtype=dtype), sam_idx


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_model_args(p)
    p.add_argument("--data_root", required=True)
    p.add_argument("--save_dir", required=True)
    p.add_argument("--meta", default="meta_expressions.json")
    p.add_argument("--dataset", default="mevis",
                   choices=["mevis", "a2d", "jhmdb"],
                   help="mevis = meta_expressions layout (also YTVOS/DAVIS); "
                        "a2d/jhmdb = sentence datasets, scored in place")
    p.add_argument("--ann_file", default=None,
                   help="a2d/jhmdb annotation JSON override")
    p.add_argument("--num_frames", type=int, default=5,
                   help="a2d/jhmdb window size centered on the annotated "
                        "frame (reference a2d.py:112-117)")
    p.add_argument("--max_sam_frames", type=int, default=64,
                   help="masks are produced for ALL video frames up to this "
                        "cap (the LLM prefix still sees NUM_FRAMES samples)")
    args = p.parse_args(argv)

    from PIL import Image

    opts = serving_options(args)
    tokenizer = load_tokenizer(args.tokenizer or args.checkpoint)
    cfg = VideoGLaMMConfig.flagship()
    pipe = build_inference(cfg, load_model(args, cfg),
                           eos_id=terminators_for(cfg.llm_type, tokenizer),
                           **opts)
    conv_gen = ConvGenerator(cfg.llm_type)

    if args.dataset in ("a2d", "jhmdb"):
        return _eval_sentences(args, pipe, tokenizer, conv_gen)

    to, dtype = placement(pipe)
    done = resumed = skipped = 0
    meta = json.load(open(os.path.join(args.data_root, args.meta)))["videos"]
    for vid, vinfo in sorted(meta.items()):
        fdir = os.path.join(args.data_root, "JPEGImages", vid)
        frame_names = vinfo.get("frames") or sorted(
            os.path.splitext(f)[0] for f in os.listdir(fdir))
        streams = None
        for eid, einfo in sorted(vinfo["expressions"].items()):
            out_dir = os.path.join(args.save_dir, vid, eid)
            if os.path.isdir(out_dir) and len(os.listdir(out_dir)):
                resumed += 1
                continue
            try:    # faults of the data: the expression's record
                prompt = conv_gen.apply_for_chat(
                    REFER_PROMPT.format(exp=einfo["exp"]), media="video")
                input_ids, lens = tokenize_prompt(prompt, tokenizer,
                                                  args.max_new_tokens)
            except Exception as e:
                print(f"[skip] {vid}/{eid}: {e}")
                skipped += 1
                continue
            if streams is None:     # once a video, for all its expressions
                streams, sam_idx = video_streams(args, pipe, fdir, to, dtype)
            f, c, s, orig_hw = streams
            res = pipe(f, c, s, input_ids.to(to), lens.to(to),
                       use_video_branch=args.use_sam2_video_branch)
            masks = masks_to_original_size(res.pred_masks[0], orig_hw)
            valid = res.seg_valid[0].cpu().numpy()
            # first [SEG] answers the referring expression
            tube = masks[valid][0] if valid.any() else np.zeros(
                (len(sam_idx),) + tuple(orig_hw), bool)
            os.makedirs(out_dir, exist_ok=True)
            # one PNG per listed frame (official MeViS/YTVOS/DAVIS
            # protocol): frames beyond the compute cap reuse the nearest
            # computed mask
            sam_arr = np.asarray(sam_idx)
            for fi, name in enumerate(frame_names):
                t = int(np.abs(sam_arr - fi).argmin())
                Image.fromarray((tube[t] * 255).astype(np.uint8)).save(
                    os.path.join(out_dir, f"{name}.png"))
            print(f"[ok] {vid}/{eid}")
            done += 1
    summary = {"expressions": done, "resumed": resumed, "skipped": skipped}
    print(f"[done] {json.dumps(summary)}")
    return summary


if __name__ == "__main__":
    main()
