"""Reference-layout checkpoints: the port's counterpart of the composed load
of videoglamm_tpu/io/import_torch.py (`compose_videoglamm_params`,
:500-513) and of `cli/common.load_model` (videoglamm_tpu/cli/common.py:55-100).

The reference ships its weights in three sources:
- the VideoGLaMM HF export (`pytorch_model*.bin` shards): the LLM as
  `model.embed_tokens`, `model.layers.*`, `model.norm`, `lm_head` (Phi-3,
  or Llama-3.1 with `cfg.llm_type == "llama3_1"`), the projectors as
  `model.mm_projector.*` / `model.image_mm_projector.*`, the [SEG] head as
  `model.text_hidden_fcs.0.*` and SAM-2 as `model.visual_model.*`;
- the InternVideo2 checkpoint, keys under `vision_encoder.` or bare;
- the HF CLIP vision checkpoint, keys under `vision_model.`.

The port's parameter names are those keys under its own submodule
prefixes, so the mapping is by prefix; no tensor is transposed or copied.
Only the layers that run are kept, as the JAX importers keep them: the
InternVideo2 blocks 0..depth-2 and the CLIP layers up to the select layer
(a real checkpoint has more), and nothing the port has no parameter for
(CLIP's post_layernorm, InternVideo2's projection heads). So
`to_reference_layout` cannot restore what was dropped. A Phi-3 or Llama
export without the [SEG] row gets it appended as the mean of the
existing rows, as `import_phi3` / `import_llama` do; a Llama export
without `lm_head` takes the embedding (tied weights).
"""
from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple

import torch

# (reference prefix in the HF export, port prefix)
HF_PREFIXES = (("model.embed_tokens.", "llm.model.embed_tokens."),
               ("model.layers.", "llm.model.layers."),
               ("model.norm.", "llm.model.norm."),
               ("lm_head.", "llm.lm_head."),
               ("model.mm_projector.", "mm_projector."),
               ("model.image_mm_projector.", "image_mm_projector."),
               ("model.text_hidden_fcs.0.", "text_hidden_fcs.0."),
               ("model.visual_model.", "visual_model."))
INTERNVIDEO_PREFIX = "vision_encoder."
CLIP_PREFIX = "vision_model."
_TOWERS = (("vision_tower.", INTERNVIDEO_PREFIX),
           ("image_vision_tower.", CLIP_PREFIX))


def _port_shapes(cfg) -> Dict[str, torch.Size]:
    """Name -> shape of every parameter and buffer of a float VideoGLaMM
    of `cfg`, from a model on the meta device (no memory)."""
    from ..models.videoglamm import VideoGLaMM
    with torch.device("meta"):
        model = VideoGLaMM(cfg)
    return {k: v.shape for k, v in model.state_dict().items()}


def _strip(sd: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):] if k.startswith(prefix) else k: v
            for k, v in sd.items()}


def _with_seg_row(emb, head, rows: int):
    """Append mean rows to an embedding and an lm_head [V, H] that lack
    the [SEG] row (import_torch.py:50-58)."""
    n = rows - emb.shape[0]
    if n <= 0:
        return emb, head
    return (torch.cat([emb, emb.mean(0, keepdim=True).expand(n, -1)]),
            torch.cat([head, head.mean(0, keepdim=True).expand(n, -1)]))


def from_reference_layout(hf_sd: Mapping, cfg,
                          internvideo_state_dict: Optional[Mapping] = None,
                          clip_state_dict: Optional[Mapping] = None
                          ) -> Dict[str, torch.Tensor]:
    """The reference's three checkpoint sources -> the port's float
    `state_dict` for `VideoGLaMM(cfg)` (load it with `load_weights`, or
    pass it to `build_inference`). Keys the port has no parameter for are
    dropped (module docstring); a tower source left out leaves its keys
    out. The tensors are the sources' own."""
    shapes = _port_shapes(cfg)
    out = {}
    for k, v in hf_sd.items():
        for ref, port in HF_PREFIXES:
            if k.startswith(ref):
                out[port + k[len(ref):]] = v
                break
    emb_key, head_key = "llm.model.embed_tokens.weight", "llm.lm_head.weight"
    if cfg.llm_type == "llama3_1" and head_key not in out and emb_key in out:
        out[head_key] = out[emb_key]
    if emb_key in out and head_key in out:
        out[emb_key], out[head_key] = _with_seg_row(
            out[emb_key], out[head_key], shapes[emb_key][0])
    for (port, ref), src in zip(_TOWERS, (internvideo_state_dict, clip_state_dict)):
        if src is not None:
            out.update({port + k: v for k, v in _strip(src, ref).items()})
    return {k: v for k, v in out.items() if k in shapes}


def to_reference_layout(state_dict: Mapping, cfg
                        ) -> Tuple[Dict[str, torch.Tensor],
                                   Dict[str, torch.Tensor],
                                   Dict[str, torch.Tensor]]:
    """The port's float `state_dict` -> (the HF export, the InternVideo2
    checkpoint under `vision_encoder.`, the CLIP vision checkpoint under
    `vision_model.`): the three dicts `compose_videoglamm_params` takes.
    A state dict with a quantised LLM raises: the reference layout is
    float, and `quantize_llm` runs after loading."""
    if "llm.lm_head.scale" in state_dict:
        raise ValueError("to_reference_layout: the LLM is quantised; the "
                         "reference layout holds float weights")
    hf, towers = {}, ({}, {})
    for k, v in state_dict.items():
        for (port, ref), dst in zip(_TOWERS, towers):
            if k.startswith(port):
                dst[ref + k[len(port):]] = v
                break
        else:
            for ref, port in HF_PREFIXES:
                if k.startswith(port):
                    hf[ref + k[len(port):]] = v
                    break
            else:
                raise ValueError(f"to_reference_layout: no reference key for {k}")
    return hf, towers[0], towers[1]


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def read_reference_dir(path: str, internvideo_ckpt: Optional[str] = None,
                       clip_ckpt: Optional[str] = None):
    """The three reference sources as they lie on disk -> (hf, iv, clip)
    state dicts: the `pytorch_model*.bin` shards of the HF-export
    directory `path` (read in sorted order) and, optionally, the
    InternVideo2 checkpoint (its `model` or `module` entry, or the file's
    dict itself) and the CLIP vision checkpoint (None where not given).
    Files are read with `torch.load(weights_only=True)`: tensors and plain
    containers, never arbitrary objects."""
    shards = sorted(f for f in os.listdir(path)
                    if f.startswith("pytorch_model") and f.endswith(".bin"))
    if not shards:
        raise FileNotFoundError(f"no pytorch_model*.bin in {path}")
    hf = {}
    for f in shards:
        hf.update(_load(os.path.join(path, f)))
    iv = None
    if internvideo_ckpt:
        raw = _load(internvideo_ckpt)
        iv = raw.get("model", raw.get("module", raw))
    clip = _load(clip_ckpt) if clip_ckpt else None
    return hf, iv, clip


def load_reference_dir(path: str, cfg, internvideo_ckpt: Optional[str] = None,
                       clip_ckpt: Optional[str] = None, quant: str = "none",
                       **build_kw):
    """A reference HF-export directory and, optionally, the tower
    checkpoints (`read_reference_dir`) -> a `GroundedInference` built by
    `build_inference`, which quantises the LLM when `quant` asks ("int8",
    "int4"). build_kw: the further arguments of `build_inference`
    (device, dtype, kv_cache, ...)."""
    from ..inference.pipeline import build_inference
    hf, iv, clip = read_reference_dir(path, internvideo_ckpt, clip_ckpt)
    return build_inference(cfg, from_reference_layout(hf, cfg, iv, clip),
                           quant=quant, **build_kw)


def merge_lora_state_dict(state_dict: Mapping, lora_state_dict: Mapping,
                          r: int, alpha: int = 16) -> dict:
    """Merge a PEFT LoRA adapter into base torch weights BEFORE import
    (the reference's third checkpoint format: base + non_lora_trainables.bin
    + PEFT adapter merged via merge_and_unload,
    train_ds_with_videogptplus.py:146-210,319-343).

    PEFT keys look like `base_model.model.<path>.lora_A.weight` /
    `...lora_B.weight`; the merged delta is B @ A * (alpha / r)."""
    sd = dict(state_dict)
    scale = alpha / r
    for k, a in lora_state_dict.items():
        if "lora_A" not in k:
            continue
        b_key = k.replace("lora_A", "lora_B")
        base_key = (k.replace("base_model.model.", "")
                     .replace(".lora_A.weight", ".weight")
                     .replace(".lora_A.default.weight", ".weight"))
        if base_key not in sd:
            continue
        b = lora_state_dict[b_key]
        delta = (b.float() @ a.float()) * scale
        sd[base_key] = sd[base_key].float() + delta
    return sd
