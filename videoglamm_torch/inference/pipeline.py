"""End-to-end grounded inference (PyTorch port of
videoglamm_tpu/inference/pipeline.py): raw uint8 frames -> the three
preprocessed streams -> encode video -> generate text with [SEG] tokens ->
project the [SEG] hidden states -> masks. Framewise: encode every SAM frame,
then one batched mask decode over every ([SEG], frame) pair. With
`use_video_branch=True`: the SAM-2 memory tracker, every [SEG] an object
prompted on frame 0 and propagated through the frames.

`build_inference` is the port's model construction (counterpart of
`load_model`, videoglamm_tpu/cli/common.py:53): it builds on the card
unless the caller asks for the CPU, quantises the LLM when asked and
chooses the KV-cache storage."""
from __future__ import annotations

import time
from typing import Callable, Mapping, NamedTuple, Optional

import torch

from ..models.phi3 import quantize_llm
from ..models.videoglamm import SegExtraction, VideoGLaMM
from ..ops.preprocess import (preprocess_clip_stream, preprocess_iv_stream,
                              preprocess_sam_stream, sample_frame_indices)
from .generate import GenerateResult, generate_with_prefix, terminators_for


class InferenceResult(NamedTuple):
    tokens: torch.Tensor       # [B, max_new]
    lengths: torch.Tensor      # [B]
    seg_valid: torch.Tensor    # [B, max_seg]
    pred_masks: torch.Tensor   # [B, max_seg, T_sam, 4E, 4E] low-res logits


def extract_seg_from_generation(model, gen: GenerateResult) -> SegExtraction:
    """First max_seg [SEG] tokens of the generated stream -> prompt
    embeddings (pipeline.py:36-53)."""
    cfg = model.cfg
    tokens = gen.tokens
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)[None, :]
    is_seg = tokens == cfg.seg_token_idx
    key = torch.where(is_seg, pos, S + pos)
    idx = key.argsort(dim=1)[:, :cfg.max_seg_tokens]
    valid = torch.gather(is_seg, 1, idx)
    h = torch.gather(gen.hidden, 1,
                     idx[..., None].expand(-1, -1, gen.hidden.shape[-1]))
    emb = model.text_hidden_fcs[0](h.float())
    emb = torch.where(valid[..., None], emb, 0.0)
    return SegExtraction(embeds=emb, valid=valid, positions=idx)


def prepare_vision_inputs(raw_frames, cfg, *, num_sam_frames=None,
                          dtype=torch.float32):
    """Raw RGB frames -> (frames, context_images, frames_sam), the device
    branch of `prepare_vision_inputs` (videoglamm_tpu/cli/common.py:127-134)
    batched as bench.py:126-133 does. raw_frames: [B, T, H, W, 3] uint8 (or
    float 0-255) on the serving device. The InternVideo2 and CLIP streams
    come from all T frames; the SAM stream from `num_sam_frames` frames
    sampled uniformly, or from all."""
    frames = preprocess_iv_stream(raw_frames, cfg.internvideo.image_size, dtype)
    context = preprocess_clip_stream(raw_frames, cfg.clip.image_size, dtype)
    sam_frames = raw_frames
    T = raw_frames.shape[1]
    if num_sam_frames is not None and num_sam_frames != T:
        idx = torch.from_numpy(sample_frame_indices(T, num_sam_frames))
        sam_frames = raw_frames[:, idx.to(raw_frames.device)]
    frames_sam = preprocess_sam_stream(sam_frames, cfg.sam2.image_size, dtype)
    return frames, context, frames_sam


class GroundedInference:
    """Grounded video chat / GCG pipeline; masks framewise or, with
    `use_video_branch=True`, from the SAM-2 memory tracker. The LLM's
    serving mode (bf16, int8 or int4 weights; bf16 or int8 KV cache) is the
    model's (`build_inference`). Generation is greedy, or sampled with
    `temperature` > 0; `draft_k` >= 2 turns on n-gram speculative decoding
    for greedy generation (the same tokens from fewer passes over the
    weights, `generate.generate_speculative`). eos_id=None takes the stop
    tokens of the configured LLM (pipeline.py:60-82)."""

    def __init__(self, model, *, max_new_tokens: int = 128, eos_id=None,
                 temperature: float = 0.0, draft_k: int = 0):
        if eos_id is None:
            eos_id = terminators_for(model.cfg.llm_type)
        self.model = model
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.temperature = temperature
        self.draft_k = draft_k

    @torch.no_grad()
    def __call__(self, frames, context_images, frames_sam, input_ids,
                 text_lens, timings: Optional[dict] = None,
                 use_video_branch: bool = False,
                 generator: Optional[torch.Generator] = None
                 ) -> InferenceResult:
        """frames [B,T,224,224,3]; context [B,T,336,336,3]; frames_sam
        [B,T_sam,S,S,3]; input_ids [B,S_text]. With a `timings` dict, each
        stage is synchronised and its wall seconds recorded there.
        generator: the source of the sampling noise when temperature > 0.
        use_video_branch=True runs the SAM-2 memory tracker (stage `track`)
        in place of the independent per-frame decoding (stages `sam_encode`
        and `mask_decode`); the rows of a batch are tracked one after the
        other, where the JAX pipeline maps its tracker over them
        (pipeline.py:94-97)."""
        m = self.model
        clock = _StageClock(timings, frames.device)
        visual = m.encode_visual_prefix(frames, context_images)
        clock("visual")
        gen = generate_with_prefix(m, visual, input_ids, text_lens,
                                   max_new_tokens=self.max_new_tokens,
                                   eos_id=self.eos_id,
                                   temperature=self.temperature,
                                   generator=generator, draft_k=self.draft_k)
        clock("generate")
        seg = extract_seg_from_generation(m, gen)
        if use_video_branch:
            masks = torch.stack([m.track_masks(f, e)
                                 for f, e in zip(frames_sam, seg.embeds)])
            masks = torch.where(seg.valid[:, :, None, None, None], masks, -1e4)
            clock("track")
        else:
            sam_feats, _ = m.encode_sam_features(frames_sam)
            clock("sam_encode")
            vidx = torch.arange(frames_sam.shape[0], device=frames_sam.device)
            masks = m.decode_masks(sam_feats, seg, vidx)
            masks = torch.where(seg.valid[:, :, None, None, None], masks, -1e4)
            clock("mask_decode")
        return InferenceResult(tokens=gen.tokens, lengths=gen.lengths,
                               seg_valid=seg.valid, pred_masks=masks)


    @torch.no_grad()
    def serve_raw(self, raw_frames, input_ids, text_lens, *,
                  num_sam_frames: Optional[int] = None,
                  timings: Optional[dict] = None,
                  use_video_branch: bool = False,
                  generator: Optional[torch.Generator] = None
                  ) -> InferenceResult:
        """One request from raw decoded frames: raw_frames [B,T,H,W,3] uint8
        on the model's device -> the three streams in the model's compute
        dtype (`preprocess` stage) -> `__call__`. num_sam_frames=None sends
        every frame to SAM, as the tracker is driven."""
        m = self.model
        clock = _StageClock(timings, raw_frames.device)
        dtype = m.llm.model.embed_tokens.weight.dtype
        streams = prepare_vision_inputs(raw_frames, m.cfg,
                                        num_sam_frames=num_sam_frames,
                                        dtype=dtype)
        clock("preprocess")
        return self(*streams, input_ids, text_lens, timings=timings,
                    use_video_branch=use_video_branch, generator=generator)


def build_inference(cfg, state_dict: Optional[Mapping] = None, *,
                    device="cuda", dtype=torch.bfloat16, quant: str = "none",
                    kv_cache: str = "bf16", max_new_tokens: int = 128,
                    eos_id=None, temperature: float = 0.0, draft_k: int = 0,
                    init: Optional[Callable] = None) -> GroundedInference:
    """Build a VideoGLaMM on `device` and wrap it for serving.

    device: the card by default; a CUDA device with no card present raises
    (there is no silent CPU). Pass "cpu" to run the plain twins.
    state_dict: the port's weights (`io/from_jax.py` makes them); float, or
    already in the quantised form that `quant` names. Without one, `init`
    (a callable that fills the float model in place, e.g. seeded random
    weights) or torch's default initialisation stands in.
    quant: "none", "int8" or "int4" weights for the LLM; float weights are
    quantised here from their f32 values, before the cast to `dtype`.
    kv_cache: "bf16" (the compute dtype) or "int8".
    eos_id, temperature, draft_k: the generation options of
    `GroundedInference`.
    With `cfg.llm_type == "llama3_1"` the LLM is the Llama-3.1 base, which
    has no quantised projections: any `quant` but "none" raises."""
    if quant not in ("none", "int8", "int4"):
        raise ValueError(f"quant {quant!r}: expected none, int8 or int4")
    if kv_cache not in ("bf16", "int8"):
        raise ValueError(f"kv_cache {kv_cache!r}: expected bf16 or int8")
    if cfg.llm_type != "phi3" and quant != "none":
        raise ValueError(f"quant {quant!r}: the {cfg.llm_type} base has no "
                         "quantised projections; only Phi-3 serves int8 / int4 "
                         "weights")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"build_inference: device {device!r} asked for, but no CUDA "
            "device is present; pass device='cpu' to run on the CPU")
    head = state_dict.get("llm.lm_head.weight") if state_dict else None
    prequant = head is not None and head.dtype == torch.int8
    if prequant and quant == "none":
        raise ValueError("state_dict holds a quantised LLM; name its mode "
                         "with quant='int8' or 'int4'")
    with torch.device(dev):
        model = VideoGLaMM(cfg, quant_llm_int8=prequant and quant == "int8",
                           quant_llm_int4=prequant and quant == "int4",
                           quant_kv_int8=kv_cache == "int8")
    model.to(dev)     # tensors made from numpy ignore the device context
    if state_dict is not None:
        model.load_weights(state_dict)
    elif init is not None:
        init(model)
    if quant != "none" and not prequant:
        quantize_llm(model.llm, quant)
    if dtype != torch.float32:
        model.to_compute_dtype(dtype)
    return GroundedInference(model.eval(), max_new_tokens=max_new_tokens,
                             eos_id=eos_id, temperature=temperature,
                             draft_k=draft_k)


class _StageClock:
    def __init__(self, timings, device):
        self.timings, self.device = timings, device
        self.t0 = self._now()

    def _now(self):
        if self.timings is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def __call__(self, stage: str):
        if self.timings is None:
            return
        t = self._now()
        self.timings[stage] = t - self.t0
        self.t0 = t
