"""Shared CLI plumbing of the port (videoglamm_tpu/cli/common.py): the model
flags, tokenizer loading and weight loading.

`load_model` returns the port's float state dict; the entry point builds
the model it needs from it (`build_training`, `build_inference`). The
serving helpers of the JAX module (vision inputs, prompt tokenization,
generation decoding) come with the eval CLIs.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import torch

from ..config import VideoGLaMMConfig
from ..constants import SEG_TOKEN


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
    return p


def load_tokenizer(path: str):
    """The HF tokenizer at `path`, with [SEG] added when it lacks one.
    `transformers` is imported here and nowhere else in the port."""
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
