"""GCG (Grounded Conversation Generation) inference over a validation set
(the port of videoglamm_tpu/cli/eval_gcg_infer.py; reference entry point
eval_gcg_infer.py:55-227).

For every video: fixed GCG question -> caption with <p>...</p> + [SEG] ->
per-object mask tubes; saves `res.json` + pred mask PNGs per video in the
reference layout (consumed by eval_gcg_metrics). Resumable: a video whose
`res.json` exists is passed over. The model runs on the card unless
`--device cpu` asks for the CPU.

A video whose frames or gt.json cannot be read is printed as `[skip]` and
the loop goes on; an exception from the model call, or from moving its
inputs to the device, is not caught. The summary line counts the skips.

Dataset layout expected (one dir per video):
  <data_root>/<video_id>/frames/*.jpg     video frames
  <data_root>/<video_id>/gt.json          {"caption": ..., "phrases": [...]}
  <data_root>/<video_id>/gt_masks/<obj>/<frame>.png   binary GT masks
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..config import VideoGLaMMConfig
from ..constants import NUM_FRAMES
from ..data.conversation import ConvGenerator
from ..evals.postprocess import (clean_caption, extract_phrases,
                                 remove_small_blobs)
from ..inference.generate import terminators_for
from ..inference.pipeline import build_inference
from .common import (add_model_args, decode_generation, load_model,
                     load_tokenizer, masks_of, placement,
                     prepare_vision_inputs, serving_options, tokenize_prompt)

GCG_PROMPT = ("Could you please give me a detailed description of the "
              "video? Please respond with interleaved segmentation masks "
              "for the corresponding parts of the answer.")


def list_videos(data_root):
    return sorted(d for d in os.listdir(data_root)
                  if os.path.isdir(os.path.join(data_root, d)))


def run_video(pipe, conv_gen, tokenizer, frames, max_new, use_video_branch):
    to, dtype = placement(pipe)
    prompt = conv_gen.apply_for_chat(GCG_PROMPT, media="video")
    input_ids, lens = tokenize_prompt(prompt, tokenizer, max_new)
    f, c, s, orig_hw = prepare_vision_inputs(frames, pipe.model.cfg, to=to,
                                             dtype=dtype)
    res = pipe(f, c, s, input_ids.to(to), lens.to(to),
               use_video_branch=use_video_branch)
    text = decode_generation(res.tokens[0], tokenizer)
    return text, masks_of(res, orig_hw)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_model_args(p)
    p.add_argument("--data_root", required=True)
    p.add_argument("--save_dir", required=True)
    p.add_argument("--min_blob", type=int, default=20)
    args = p.parse_args(argv)

    from PIL import Image
    from ..data.preprocess import sample_frame_indices
    from ..data.video_reader import load_frame_dir

    opts = serving_options(args)
    tokenizer = load_tokenizer(args.tokenizer or args.checkpoint)
    cfg = VideoGLaMMConfig.flagship()
    pipe = build_inference(cfg, load_model(args, cfg),
                           eos_id=terminators_for(cfg.llm_type, tokenizer),
                           **opts)
    conv_gen = ConvGenerator(cfg.llm_type)

    done = resumed = skipped = 0
    for vid in list_videos(args.data_root):
        out_dir = os.path.join(args.save_dir, vid)
        if os.path.exists(os.path.join(out_dir, "res.json")):
            resumed += 1
            continue   # resumable (reference eval_gcg_infer.py:119-123)
        try:            # faults of the data (reference :224-227)
            vdir = os.path.join(args.data_root, vid)
            frames = load_frame_dir(os.path.join(vdir, "frames"))
            idx = sample_frame_indices(len(frames), NUM_FRAMES)
            frames = [frames[i] for i in idx]
            gt_path = os.path.join(vdir, "gt.json")
            gt = json.load(open(gt_path)) if os.path.exists(gt_path) else {}
        except Exception as e:
            print(f"[skip] {vid}: {e}")
            skipped += 1
            continue

        text, masks = run_video(pipe, conv_gen, tokenizer, frames,
                                args.max_new_tokens,
                                args.use_sam2_video_branch)
        masks = np.stack([remove_small_blobs(m, args.min_blob)
                          for m in masks]) if len(masks) else masks

        os.makedirs(out_dir, exist_ok=True)
        res = {
            "gt_text": gt.get("caption", ""),
            "gt_phrases": gt.get("phrases", []),
            "pred_text": text,
            "pred_text_cleaned": clean_caption(text),
            "pred_phrases": extract_phrases(text),
        }
        json.dump(res, open(os.path.join(out_dir, "res.json"), "w"))
        for obj, tube in enumerate(masks):
            odir = os.path.join(out_dir, "pred_masks", str(obj))
            os.makedirs(odir, exist_ok=True)
            for t, m in enumerate(tube):
                Image.fromarray((m * 255).astype(np.uint8)).save(
                    os.path.join(odir, f"{t:05d}.png"))
        print(f"[ok] {vid}: {len(masks)} objects")
        done += 1
    summary = {"videos": done, "resumed": resumed, "skipped": skipped}
    print(f"[done] {json.dumps(summary)}")
    return summary


if __name__ == "__main__":
    main()
