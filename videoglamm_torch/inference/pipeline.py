"""End-to-end grounded inference, framewise (PyTorch port of
videoglamm_tpu/inference/pipeline.py): encode video -> generate text with
[SEG] tokens -> project the [SEG] hidden states -> encode every SAM frame
-> one batched mask decode over every ([SEG], frame) pair."""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from ..models.videoglamm import SegExtraction
from .generate import PHI3_TERMINATORS, GenerateResult, generate_with_prefix


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


class GroundedInference:
    """Grounded video chat / GCG pipeline: framewise (the SAM-2 memory
    tracker of `use_video_branch` is not ported yet) and greedy."""

    def __init__(self, model, *, max_new_tokens: int = 128,
                 eos_id=PHI3_TERMINATORS):
        self.model = model
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id

    @torch.no_grad()
    def __call__(self, frames, context_images, frames_sam, input_ids,
                 text_lens, timings: Optional[dict] = None) -> InferenceResult:
        """frames [B,T,224,224,3]; context [B,T,336,336,3]; frames_sam
        [B,T_sam,S,S,3]; input_ids [B,S_text]. With a `timings` dict, each
        stage is synchronised and its wall seconds recorded there."""
        m = self.model
        clock = _StageClock(timings, frames.device)
        visual = m.encode_visual_prefix(frames, context_images)
        clock("visual")
        gen = generate_with_prefix(m, visual, input_ids, text_lens,
                                   max_new_tokens=self.max_new_tokens,
                                   eos_id=self.eos_id)
        clock("generate")
        seg = extract_seg_from_generation(m, gen)
        sam_feats, _ = m.encode_sam_features(frames_sam)
        clock("sam_encode")
        vidx = torch.arange(frames_sam.shape[0], device=frames_sam.device)
        masks = m.decode_masks(sam_feats, seg, vidx)
        masks = torch.where(seg.valid[:, :, None, None, None], masks, -1e4)
        clock("mask_decode")
        return InferenceResult(tokens=gen.tokens, lengths=gen.lengths,
                               seg_valid=seg.valid, pred_masks=masks)


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
