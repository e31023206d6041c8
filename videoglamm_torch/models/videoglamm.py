"""VideoGLaMM composite for framewise GCG inference (PyTorch port of the
inference methods of videoglamm_tpu/models/videoglamm.py:
`encode_visual_prefix`, `encode_sam_features`, `decode_masks`).

Submodule names: `vision_tower` (InternVideo2), `image_vision_tower`
(CLIP), `mm_projector`, `image_mm_projector`, `llm` (HF Phi-3 names
inside), `text_hidden_fcs` and `visual_model` (SAM-2), so a reference
export maps onto the port by key prefix (`model.layers.*` ->
`llm.model.layers.*`, `model.visual_model.*` -> `visual_model.*`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..config import VideoGLaMMConfig
from .clip_vit import CLIPVisionTower
from .common import cast_compute
from .internvideo2 import InternVideo2Tower
from .phi3 import Phi3ForCausalLM
from .projectors import TextHiddenFCs, build_vision_projector, build_visual_prefix
from .sam2.sam2_base import SAM2Base


class SegExtraction(NamedTuple):
    embeds: torch.Tensor     # [R, max_seg, out_dim] (invalid slots zeroed)
    valid: torch.Tensor      # [R, max_seg] bool
    positions: torch.Tensor  # [R, max_seg]


class VideoGLaMM(nn.Module):
    """`quant_llm_int8` / `quant_llm_int4` build the LLM in weight-only
    quantised serving form; `quant_kv_int8` makes generation use the int8
    KV cache (read by inference/generate.py) (videoglamm.py:110-132)."""

    def __init__(self, cfg: VideoGLaMMConfig, *, quant_llm_int8: bool = False,
                 quant_llm_int4: bool = False, quant_kv_int8: bool = False):
        super().__init__()
        if cfg.llm_type != "phi3":
            raise NotImplementedError(
                f"llm_type {cfg.llm_type!r}: only phi3 is ported so far")
        self.cfg = cfg
        hidden = cfg.llm.hidden_size
        self.vision_tower = InternVideo2Tower(cfg.internvideo)
        self.image_vision_tower = CLIPVisionTower(cfg.clip)
        self.mm_projector = build_vision_projector(
            cfg.mm_projector_type, cfg.internvideo.embed_dim, hidden)
        self.image_mm_projector = build_vision_projector(
            cfg.mm_projector_type, cfg.clip.hidden_size, hidden)
        self.quant_kv_int8 = quant_kv_int8
        self.llm = Phi3ForCausalLM(cfg.llm, extra_vocab=1,
                                   quant_int8=quant_llm_int8,
                                   quant_int4=quant_llm_int4)
        self.text_hidden_fcs = nn.ModuleList([TextHiddenFCs(hidden, cfg.out_dim)])
        self.visual_model = SAM2Base(cfg.sam2)

    def to_compute_dtype(self, dtype):
        """Store the compute weights in `dtype` (bf16 serving). The SAM
        prompt encoder, mask decoder and text_hidden_fcs stay f32, as in the
        JAX model, except the skip projections conv_s0/s1, which run in the
        image-encoder dtype."""
        for m in (self.vision_tower, self.image_vision_tower, self.mm_projector,
                  self.image_mm_projector, self.llm,
                  self.visual_model.image_encoder):
            cast_compute(m, dtype)
        dec = self.visual_model.sam_mask_decoder
        dec.conv_s0.to(dtype)
        dec.conv_s1.to(dtype)
        return self

    def encode_visual_prefix(self, frames, context_images):
        """frames [Bv, T, 224, 224, 3]; context [Bv, T, 336, 336, 3] ->
        [Bv, V, H] visual prefix."""
        cfg = self.cfg
        Bv, T = frames.shape[:2]
        ck = cfg.chunk_size
        assert T % ck == 0, (T, ck)
        L = cfg.internvideo.tokens_per_frame
        vid = self.vision_tower(frames.reshape(Bv * (T // ck), ck,
                                               *frames.shape[2:]))
        vid = vid.reshape(Bv, T, L, vid.shape[-1])
        ctx = self.image_vision_tower(
            context_images.reshape(Bv * T, *context_images.shape[2:]))
        ctx = ctx.reshape(Bv, T, ctx.shape[1], ctx.shape[2])
        return build_visual_prefix(self.mm_projector(vid),
                                   self.image_mm_projector(ctx), chunk_size=ck,
                                   video_pool=cfg.video_pool,
                                   context_pool=cfg.context_pool)

    def encode_sam_features(self, frames_sam):
        """frames_sam [Bv, T_sam, S, S, 3] -> (feats with a leading
        [Bv, T_sam], pos). All frames run as one batch."""
        Bv, T = frames_sam.shape[:2]
        feats, pos = self.visual_model.forward_image(
            frames_sam.reshape(Bv * T, *frames_sam.shape[2:]))
        return [f.reshape(Bv, T, *f.shape[1:]) for f in feats], pos

    def decode_masks(self, sam_feats, seg: SegExtraction, video_idx):
        """One batched decode over R*max_seg*T_sam prompts -> low-res mask
        logits [R, max_seg, T_sam, 4E, 4E]."""
        ms = self.cfg.max_seg_tokens
        R = seg.embeds.shape[0]
        T = sam_feats[0].shape[1]
        C = seg.embeds.shape[-1]
        sparse = seg.embeds[:, :, None, None, :].expand(R, ms, T, 1, C)
        sparse = sparse.reshape(R * ms * T, 1, C)

        def expand(f):
            f = f[video_idx]
            f = f[:, None].expand(R, ms, *f.shape[1:])
            return f.reshape(R * ms * T, *f.shape[3:])

        s0, s1, embed = (expand(f) for f in sam_feats)
        sam = self.visual_model
        sparse_pe, dense_pe = sam.sam_prompt_encoder(sparse)
        dec = sam.sam_mask_decoder(embed, sam.sam_prompt_encoder.get_dense_pe(),
                                   sparse_pe, dense_pe, multimask_output=False,
                                   high_res_features=(s0, s1))
        m = dec.masks[:, 0]
        return m.reshape(R, ms, T, m.shape[-2], m.shape[-1])
