"""Convert reference PyTorch checkpoints into one port checkpoint directory
(the port of videoglamm_tpu/cli/convert_checkpoint.py).

Covers the reference's checkpoint composition (train_ds_with_videogptplus.py
:146-210, chat.py:280-325):
  HF export dir (merged model)  --hf_export DIR   (pytorch_model*.bin)
  (optional) PEFT LoRA adapter  --lora_adapter FILE --lora_r R
  InternVideo2 tower ckpt       --internvideo_ckpt FILE
  CLIP vision tower ckpt        --clip_ckpt FILE, or a dir of
                                pytorch_model*.bin shards
  -> --out DIR (io/checkpoint.save_params: DIR/params.pt)

`io/reference.from_reference_layout` maps the sources onto the port's
state dict; `--int8_llm` quantises the LLM through `quantize_llm` (the
Phi-3 LLM alone, loaded on the CPU in f32). The output is read by
`cli/common.load_model` (`--checkpoint DIR`); with `--int8_llm` serve it
with `--quant int8`. Files are read with `torch.load(weights_only=True)`.

Usage:
  python -m videoglamm_torch.cli.convert_checkpoint --hf_export EXP \\
      --internvideo_ckpt iv2.pt --clip_ckpt clip.bin --out ./params
"""
from __future__ import annotations

import argparse
import os


def _clip_file(path: str) -> dict:
    """A CLIP vision checkpoint file, or the merged shards of a directory."""
    import torch
    if not os.path.isdir(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    shards = sorted(f for f in os.listdir(path)
                    if f.startswith("pytorch_model") and f.endswith(".bin"))
    if not shards:
        raise FileNotFoundError(f"no pytorch_model*.bin in {path}")
    sd = {}
    for f in shards:
        sd.update(torch.load(os.path.join(path, f), map_location="cpu",
                             weights_only=True))
    return sd


def quantize_llm_state(sd: dict, cfg) -> dict:
    """The port's float state dict -> the same with the Phi-3 LLM in its
    weight-only int8 form (`quantize_llm` from the f32 values)."""
    from ..models.phi3 import Phi3ForCausalLM, quantize_llm
    llm = Phi3ForCausalLM(cfg.llm, extra_vocab=1)
    llm.load_state_dict({k[len("llm."):]: v for k, v in sd.items()
                         if k.startswith("llm.")})
    quantize_llm(llm, "int8")
    out = {k: v for k, v in sd.items() if not k.startswith("llm.")}
    out.update({"llm." + k: v for k, v in llm.state_dict().items()})
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--hf_export", required=True,
                   help="reference VideoGLaMM HF-export dir")
    p.add_argument("--lora_adapter", default=None,
                   help="optional un-merged PEFT adapter state dict")
    p.add_argument("--lora_r", type=int, default=8)
    p.add_argument("--lora_alpha", type=int, default=16)
    p.add_argument("--internvideo_ckpt", default=None)
    p.add_argument("--clip_ckpt", default=None)
    p.add_argument("--int8_llm", action="store_true",
                   help="write the weight-only int8 serving form of the LLM")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import torch
    from ..config import VideoGLaMMConfig
    from ..io.checkpoint import save_params
    from ..io.reference import (from_reference_layout, merge_lora_state_dict,
                                read_reference_dir)

    cfg = VideoGLaMMConfig.flagship()
    hf, iv, _ = read_reference_dir(args.hf_export, args.internvideo_ckpt)
    print(f"loaded {len(hf)} tensors from {args.hf_export}")

    if args.lora_adapter:
        lora_sd = torch.load(args.lora_adapter, map_location="cpu",
                             weights_only=True)
        hf = merge_lora_state_dict(hf, lora_sd, r=args.lora_r,
                                   alpha=args.lora_alpha)
        print(f"merged LoRA adapter ({len(lora_sd)} tensors)")

    clip = _clip_file(args.clip_ckpt) if args.clip_ckpt else None
    sd = from_reference_layout(hf, cfg, iv, clip)
    if args.int8_llm:
        sd = quantize_llm_state(sd, cfg)
    save_params(args.out, sd)
    print(f"saved {len(sd)} tensors -> {args.out}")
    return sd


if __name__ == "__main__":
    main()
