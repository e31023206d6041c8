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
chooses the KV-cache storage. `build_sam2` builds SAM-2 alone under the
same rules, for the image predictor, the automatic mask generator and the
interactive video predictor (`models/sam2/`); `build_sam1` builds SAM-1
(ViT-H, with or without the ITM tracker) for its predictor, its generator
(`models/sam1_predictor.py`) and `SAM1.track_frames`. A reference-layout
checkpoint directory loads through `io/reference.load_reference_dir`,
which ends in `build_inference`.

Over a mesh (`parallel.shard_params(model, mesh)` on the served model):
the LLM's layers are tensor-parallel over `model` (each rank's cache holds
its heads) and the other split weights are gathered at use; over `data`
each rank serves its rows of the request, and the tokens, lengths, [SEG]
slots and masks are all-gathered, so every rank returns the whole
result."""
from __future__ import annotations

from typing import Callable, Mapping, NamedTuple, Optional

import torch

from ..config import SAM1Config, SAM2Config
from ..models.common import cast_compute, full_precision, set_exact_f32
from ..models.phi3 import quantize_llm
from ..models.sam1 import SAM1
from ..models.sam2.sam2_base import SAM2Base
from ..models.videoglamm import SegExtraction, VideoGLaMM
from ..parallel import collectives
from ..parallel.mesh import DATA_AXIS
from ..ops.preprocess import (preprocess_clip_stream, preprocess_iv_stream,
                              preprocess_sam_stream, sample_frame_indices)
from ..timing import StageClock
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
        # an f32 model (`set_exact_f32`) keeps f32 exact: no TF32 in its
        # convolutions and products while it serves (`full_precision`)
        self.f32 = getattr(model, "exact_f32", False)

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
        (pipeline.py:94-97). An f32 model runs with TF32 off
        (`full_precision`)."""
        data = _data_axis(self.model, input_ids.shape[0])
        if data is not None:       # this rank's rows, then everyone's
            n = input_ids.shape[0] // data.size
            frames, context_images, frames_sam, input_ids, text_lens = (
                t[data.index * n:(data.index + 1) * n] for t in
                (frames, context_images, frames_sam, input_ids, text_lens))
        with full_precision(self.f32):
            res = self._run(frames, context_images, frames_sam, input_ids,
                            text_lens, timings, use_video_branch, generator)
        if data is None:
            return res
        return InferenceResult(*(_gather_rows(t, data) for t in res))

    def _run(self, frames, context_images, frames_sam, input_ids, text_lens,
             timings, use_video_branch, generator) -> InferenceResult:
        m = self.model
        clock = StageClock(timings, frames.device)
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
        clock = StageClock(timings, raw_frames.device)
        dtype = m.llm.model.embed_tokens.weight.dtype
        with full_precision(self.f32):
            streams = prepare_vision_inputs(raw_frames, m.cfg,
                                            num_sam_frames=num_sam_frames,
                                            dtype=dtype)
        clock("preprocess")
        return self(*streams, input_ids, text_lens, timings=timings,
                    use_video_branch=use_video_branch, generator=generator)


def _data_axis(model, rows: int):
    """The data axis a request's rows are split over: None on one rank,
    and where the rows do not divide (every rank then serves them all)."""
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        return None
    data = mesh.axis(DATA_AXIS)
    return data if data.size > 1 and rows % data.size == 0 else None


def _gather_rows(t, data):
    every = collectives.all_gather(t.to(torch.uint8) if t.dtype == torch.bool
                                   else t, data)
    every = every.reshape(-1, *t.shape[1:])
    return every.bool() if t.dtype == torch.bool else every


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
    dtype: the compute dtype, torch.bfloat16 or torch.float32. An f32
    model takes the full-precision f32 routes of its kernels on the card
    (`models.common.set_exact_f32`: K1, K2, K6, K7 and K8; K5 and K4 take
    f32 activations and queries with every `quant` and `kv_cache`) and
    serves with TF32 off (`full_precision`).
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
    dev = _device(device, "build_inference")
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
    set_exact_f32(model, dtype == torch.float32)
    return GroundedInference(model.eval(), max_new_tokens=max_new_tokens,
                             eos_id=eos_id, temperature=temperature,
                             draft_k=draft_k)


def _device(device, what: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}: device {device!r} asked for, but no CUDA device is "
            "present; pass device='cpu' to run on the CPU")
    return dev


def build_sam2(cfg: Optional[SAM2Config] = None,
               state_dict: Optional[Mapping] = None, *, device="cuda",
               dtype=torch.bfloat16,
               init: Optional[Callable] = None) -> SAM2Base:
    """Build SAM-2 (`SAM2Config()`, Hiera-L at 1024, by default) on
    `device` for the predictors of `models/sam2/`: image_predictor,
    amg and interactive each take the built model.

    device: the card by default; a CUDA device with no card present
    raises. Pass "cpu" to run the plain twins.
    state_dict: the port's SAM2Base weights (`io/from_jax.sam2_state_dict`
    makes them), loaded strictly. Without one, `init` (a callable that
    fills the f32 model in place) or torch's default initialisation
    stands in.
    dtype: the image encoder's compute dtype (and the skip projections
    conv_s0 / conv_s1); the prompt encoder, the mask decoder, the memory
    modules and parameters stay f32, as the tracking path keeps them. With
    dtype=torch.float32 the model's attention takes K1's full-precision
    route (`set_exact_f32`)."""
    dev = _device(device, "build_sam2")
    with torch.device(dev):
        model = SAM2Base(cfg if cfg is not None else SAM2Config())
    model.to(dev)     # tensors made from numpy ignore the device context
    if state_dict is not None:
        model.load_state_dict(state_dict)
    elif init is not None:
        init(model)
    if dtype != torch.float32:
        cast_compute(model.image_encoder, dtype)
        model.sam_mask_decoder.conv_s0.to(dtype)
        model.sam_mask_decoder.conv_s1.to(dtype)
    set_exact_f32(model, dtype == torch.float32)
    return model.eval()


def build_sam1(cfg: Optional[SAM1Config] = None,
               state_dict: Optional[Mapping] = None, *, device="cuda",
               dtype=torch.bfloat16,
               init: Optional[Callable] = None) -> SAM1:
    """Build SAM-1 (`SAM1Config()`, ViT-H at 1024, by default; set
    `with_itm` for the track-token module) on `device` for
    `models/sam1_predictor.py` and `SAM1.track_frames`.

    device: the card by default; a CUDA device with no card present
    raises. Pass "cpu" to run the plain twins.
    state_dict: SAM-1 weights under the reference keys
    (`io/from_jax.sam1_state_dict` makes them from a JAX tree), loaded
    strictly. Without one, `init` (a callable that fills the f32 model in
    place) or torch's default initialisation stands in.
    dtype: the image encoder's compute dtype; the prompt encoder and the
    mask decoder stay f32, as in the JAX model."""
    dev = _device(device, "build_sam1")
    with torch.device(dev):
        model = SAM1(cfg if cfg is not None else SAM1Config())
    model.to(dev)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    elif init is not None:
        init(model)
    if dtype != torch.float32:
        cast_compute(model.image_encoder, dtype)
    return model.eval()
