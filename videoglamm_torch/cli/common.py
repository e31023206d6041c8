"""Shared CLI plumbing of the port (videoglamm_tpu/cli/common.py): the model
flags, tokenizer and weight loading, the serving placement, vision inputs,
prompt tokenization, generation decoding and the masks at the frames' size.

`load_model` returns the port's state dict; the entry point builds the
model it needs from it (`build_training`, `build_inference`). A serving
CLI takes `opts = serving_options(args)` first, then builds through
`build_inference(cfg, load_model(args, cfg), eos_id=terminators_for(...),
**opts)`: on the card unless `--device cpu` asks for the CPU.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import VideoGLaMMConfig
from ..constants import SEG_TOKEN
from ..evals.postprocess import masks_to_original_size  # noqa: F401


def add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--checkpoint", required=True,
                   help="a directory written by io.checkpoint.save_params, "
                        "or a reference HF-export directory")
    p.add_argument("--tokenizer", default=None,
                   help="HF tokenizer dir (defaults to --checkpoint)")
    p.add_argument("--internvideo_ckpt", default=None,
                   help="InternVideo2 torch checkpoint (HF-export loads only)")
    p.add_argument("--clip_ckpt", default=None,
                   help="CLIP vision torch checkpoint (HF-export loads only)")
    p.add_argument("--precision", default="bf16", choices=["bf16", "f32"])
    p.add_argument("--max_new_tokens", type=int, default=512)
    p.add_argument("--draft_k", type=int, default=0,
                   help="n-gram speculative decoding depth (>=2 enables; "
                        "greedy outputs are identical)")
    p.add_argument("--use_sam2_video_branch", action="store_true")
    p.add_argument("--quant", default="none", choices=["none", "int8", "int4"],
                   help="weight-only quantized LLM serving")
    p.add_argument("--kv_cache", default="bf16", choices=["bf16", "int8"],
                   help="KV-cache storage")
    p.add_argument("--device", default="cuda",
                   help="the card by default; 'cpu' runs the plain twins")
    return p


def load_tokenizer(path: str):
    """The HF tokenizer at `path`, with [SEG] added when it lacks one.
    `transformers` is imported here and, for `--bert`, in
    `cli/eval_gcg_metrics.make_bert_sim`."""
    from transformers import AutoTokenizer
    tok = AutoTokenizer.from_pretrained(path, use_fast=False)
    if SEG_TOKEN not in tok.get_vocab():
        tok.add_tokens(SEG_TOKEN)
    return tok


def load_model(args, cfg: Optional[VideoGLaMMConfig] = None
               ) -> Dict[str, torch.Tensor]:
    """The port's float state dict for `VideoGLaMM(cfg)` from
    `args.checkpoint`: a directory written by `io.checkpoint.save_params`
    (its `params.pt`), or a reference HF-export directory
    (`pytorch_model*.bin` shards, with `args.internvideo_ckpt` and
    `args.clip_ckpt` for the towers) mapped by `io.reference`. Tensors stay
    on the CPU."""
    from ..io import checkpoint, reference
    cfg = cfg or VideoGLaMMConfig.flagship()
    ckpt = args.checkpoint
    if os.path.exists(os.path.join(ckpt, "params.pt")):
        return dict(checkpoint.load_params(ckpt))
    hf, iv, clip = reference.read_reference_dir(ckpt, args.internvideo_ckpt,
                                                args.clip_ckpt)
    return reference.from_reference_layout(hf, cfg, iv, clip)


def serving_options(args) -> dict:
    """The keyword arguments of `build_inference` that the model flags
    name: `--device`, `--precision` (the compute dtype), `--quant`,
    `--kv_cache`, `--max_new_tokens` and `--draft_k`. The stop tokens
    (`eos_id`) come from the LLM and the tokenizer: `terminators_for`.
    `--precision f32` serves the model in full f32 with every `--quant`
    and `--kv_cache`. `--device cuda` where no card is present raises here,
    so call it before loading anything."""
    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    check_card(device)
    return dict(device=device, dtype=dtype, quant=args.quant,
                kv_cache=args.kv_cache, max_new_tokens=args.max_new_tokens,
                draft_k=args.draft_k)


def check_card(device) -> None:
    """Raise RuntimeError for a CUDA device when no card is present: there
    is no silent CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device is present; "
                           "pass --device cpu to run on the CPU")


def placement(pipe):
    """(device, compute dtype) of a `GroundedInference`'s model."""
    w = pipe.model.llm.model.embed_tokens.weight
    return w.device, w.dtype


def prepare_vision_inputs(frames: List[np.ndarray], cfg: VideoGLaMMConfig,
                          num_sam_frames: Optional[int] = None,
                          sam_frames: Optional[List[np.ndarray]] = None,
                          device: bool = True, *, to="cpu",
                          dtype=torch.float32):
    """Raw RGB frames -> (frames, context_images, frames_sam, orig_hw)
    batched [1, ...] model inputs on `to` in `dtype` (reference
    preprocess_vision, chat.py:402-470). `sam_frames` decouples the
    pixel-decoder frames from the encoder frames (eval propagates masks
    over ALL frames while the LLM prefix sees NUM_FRAMES sampled ones).

    device=True (default) and frames all uint8 of one shape: one upload of
    the encoder frames and one of the SAM frames (none when they are the
    same list), resized and normalised on `to` (ops/preprocess.py).
    Otherwise the host PIL preprocessors of data/preprocess.py run and
    their f32 arrays are uploaded (within ~1/255/std of the device path)."""
    from ..data.preprocess import (preprocess_clip, preprocess_internvideo,
                                   preprocess_sam2, sample_frame_indices)

    orig_hw = np.asarray(frames[0]).shape[:2]
    if sam_frames is None:
        sam_frames = frames
        if num_sam_frames is not None and num_sam_frames != len(frames):
            idx = sample_frame_indices(len(frames), num_sam_frames)
            sam_frames = [frames[i] for i in idx]

    uniform = all(np.asarray(f).shape == (orig_hw + (3,))
                  and np.asarray(f).dtype == np.uint8 for f in frames)
    if device and uniform:
        from ..ops.preprocess import (preprocess_clip_stream,
                                      preprocess_iv_stream,
                                      preprocess_sam_stream)

        def upload(fs):
            return torch.from_numpy(np.stack([np.asarray(f) for f in fs])).to(to)
        x = upload(frames)
        enc = preprocess_iv_stream(x, cfg.internvideo.image_size, dtype)
        ctx = preprocess_clip_stream(x, cfg.clip.image_size, dtype)
        xs = x if sam_frames is frames else upload(sam_frames)
        sam = preprocess_sam_stream(xs, cfg.sam2.image_size, dtype)
        return enc[None], ctx[None], sam[None], tuple(orig_hw)

    enc = preprocess_internvideo(frames, cfg.internvideo.image_size)
    ctx = preprocess_clip(frames, cfg.clip.image_size)
    sam = preprocess_sam2(sam_frames, cfg.sam2.image_size)
    return tuple(torch.from_numpy(a)[None].to(to, dtype)
                 for a in (enc, ctx, sam)) + (tuple(orig_hw),)


def tokenize_prompt(prompt: str, tokenizer, max_len: int = 512):
    """Prompt -> (ids [1, max_len] int64, zero-padded and cut at max_len;
    lengths [1]) on the host. The CLIs pass `--max_new_tokens` as max_len,
    as the JAX CLIs do."""
    from ..data.conversation import tokenizer_image_token
    ids = tokenizer_image_token(prompt, tokenizer)[:max_len]
    out = torch.zeros((1, max_len), dtype=torch.int64)
    out[0, :len(ids)] = torch.tensor(ids, dtype=torch.int64)
    return out, torch.tensor([len(ids)], dtype=torch.int64)


def decode_generation(tokens, tokenizer) -> str:
    ids = [int(t) for t in torch.as_tensor(tokens).reshape(-1).tolist()
           if t > 0]
    text = tokenizer.decode(ids, skip_special_tokens=False)
    return text.replace("\n", "").replace("  ", " ").strip()


def masks_of(res, orig_hw) -> np.ndarray:
    """The valid [SEG] slots' masks of the first row of an
    `InferenceResult` at the frames' size: [n_valid, T_sam, H, W] bool."""
    masks = masks_to_original_size(res.pred_masks[0], orig_hw)
    return masks[res.seg_valid[0].cpu().numpy()]
