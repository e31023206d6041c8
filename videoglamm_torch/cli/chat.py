"""Interactive grounded video/image chat (the port of
videoglamm_tpu/cli/chat.py; reference entry point chat.py:26-597).

Loads a video (native FFmpeg decoder or frame directory) or an image, runs
the grounded-inference pipeline on the card (`--device cpu` for the CPU),
prints the caption, and writes per-[SEG] mask overlays.

Usage:
  python -m videoglamm_torch.cli.chat --checkpoint CKPT --tokenizer TOK \\
      --media path/to/video.mp4 --prompt "Segment the dog." \\
      --out_dir ./chat_out [--use_sam2_video_branch]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..config import VideoGLaMMConfig
from ..constants import NUM_FRAMES
from ..data.conversation import ConvGenerator
from ..evals.postprocess import clean_caption, extract_phrases
from ..inference.generate import terminators_for
from ..inference.pipeline import build_inference
from .common import (add_model_args, decode_generation, load_model,
                     load_tokenizer, masks_of, placement,
                     prepare_vision_inputs, serving_options, tokenize_prompt)

PALETTE = [(255, 80, 80), (80, 200, 120), (90, 140, 255), (250, 200, 60)]


def overlay_masks(frame: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """frame [H,W,3] uint8; masks [n_obj, H, W] bool -> overlay image."""
    out = frame.astype(np.float32)
    for i, m in enumerate(masks):
        color = np.asarray(PALETTE[i % len(PALETTE)], np.float32)
        out[m] = 0.5 * out[m] + 0.5 * color
    return out.astype(np.uint8)


def run_once(pipe, conv_gen, tokenizer, frames, prompt_text, media,
             use_video_branch, max_text_len=512):
    """One turn -> (text, masks [n_valid, T, H, W] bool, InferenceResult)."""
    to, dtype = placement(pipe)
    prompt = conv_gen.apply_for_chat(prompt_text, media=media)
    input_ids, lens = tokenize_prompt(prompt, tokenizer, max_text_len)
    f, c, s, orig_hw = prepare_vision_inputs(frames, pipe.model.cfg, to=to,
                                             dtype=dtype)
    res = pipe(f, c, s, input_ids.to(to), lens.to(to),
               use_video_branch=use_video_branch)
    text = decode_generation(res.tokens[0], tokenizer)
    return text, masks_of(res, orig_hw), res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_model_args(p)
    p.add_argument("--media", required=True,
                   help="video file, frame directory, or image")
    p.add_argument("--prompt", default=None,
                   help="one-shot prompt (omit for interactive loop)")
    p.add_argument("--out_dir", default="./chat_out")
    args = p.parse_args(argv)

    from PIL import Image
    from ..data.video_reader import load_video_frames

    opts = serving_options(args)
    tokenizer = load_tokenizer(args.tokenizer or args.checkpoint)
    cfg = VideoGLaMMConfig.flagship()
    pipe = build_inference(cfg, load_model(args, cfg),
                           eos_id=terminators_for(cfg.llm_type, tokenizer),
                           **opts)
    conv_gen = ConvGenerator(cfg.llm_type)

    is_image = args.media.lower().endswith((".jpg", ".jpeg", ".png", ".bmp"))
    if is_image:
        img = np.asarray(Image.open(args.media).convert("RGB"))
        frames = [img] * NUM_FRAMES
        media = "image"
    else:
        frames = load_video_frames(args.media, NUM_FRAMES)
        media = "video"

    os.makedirs(args.out_dir, exist_ok=True)
    turns = []

    def serve(prompt_text, turn):
        text, masks, _ = run_once(pipe, conv_gen, tokenizer, frames,
                                  prompt_text, media,
                                  args.use_sam2_video_branch,
                                  max_text_len=args.max_new_tokens)
        print(f"\n{clean_caption(text)}")
        phrases = extract_phrases(text)
        if phrases:
            print("grounded phrases:", phrases)
        for t in range(min(len(frames), masks.shape[1])):
            ov = overlay_masks(frames[t], masks[:, t])
            Image.fromarray(ov).save(
                os.path.join(args.out_dir, f"turn{turn}_frame{t:03d}.png"))
        print(f"overlays -> {args.out_dir}")
        turns.append({"text": text, "objects": int(masks.shape[0])})

    if args.prompt is not None:
        serve(args.prompt, 0)
        return turns
    turn = 0
    while True:
        try:
            prompt_text = input("\nUSER: ").strip()
        except EOFError:
            break
        if not prompt_text or prompt_text in {"exit", "quit"}:
            break
        serve(prompt_text, turn)
        turn += 1
    return turns


if __name__ == "__main__":
    main()
