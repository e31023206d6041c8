"""Interactive SAM-2 video predictor: point, box, mask and text prompts on
any frame, forward and reverse propagation (PyTorch port of
videoglamm_tpu/models/sam2/interactive.py).

- A prompt on a frame not yet tracked is an initial conditioning frame
  (no-memory features, as SAM on an image); a prompt on a tracked frame is
  a refinement (memory-conditioned features, the clicks and the frame's
  previous logits clamped to +-32), stored as a non-cond memory.
- A prompted frame's memory is encoded from its low-res mask resized back
  up and binarised (the consolidation of the reference); objects not
  prompted there get NO_OBJ_SCORE masks and the empty-mask pointer.
- Per tracked frame the memory holds up to `max_cond_frames_in_attn`
  temporally closest cond frames (always the closest before and the
  closest at-or-after), the strided non-cond window, the pointers of the
  selected past cond frames and of the last max_obj_ptrs-1 frames; an
  unselected cond frame inside either window is attended as non-cond.

The session state is an `InteractiveBank`: K cond slots and a
full-retention per-frame bank (slot == frame index). Its tensors live on
the model's device and are written in place; the frame indices the slots
hold live on the host as numpy arrays, so every selection is decided on
the host and becomes the attention's kv_mask without a device
synchronisation. The JAX `propagate` scans all T frames and keeps a
frame's result where it runs; here the loop visits the frames in
processing order and computes only those that run (the host knows the
window, the pinned frames and the cond frames): the same outputs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...ops.resize import resize_bilinear
from .sam2_base import NO_OBJ_SCORE, SAM2Base, SamHeadsOutput, model_device
from .video_predictor import wanted_mem_frames


class InteractiveBank(NamedTuple):
    cond_mem: torch.Tensor     # [B, K, E2, mem_dim]
    cond_ptr: torch.Tensor     # [B, K, C]
    cond_frame: np.ndarray     # [K] int32 frame index (-1 empty), host
    mem_ring: torch.Tensor     # [B, T, E2, mem_dim]   slot == frame index
    mem_frame: np.ndarray      # [T] int32 (t where slot t holds frame t), host
    ptr_ring: torch.Tensor     # [B, T, C]
    ptr_frame: np.ndarray      # [T], host
    spatial_pos: torch.Tensor  # [E2, mem_dim]


class PropagateResult(NamedTuple):
    low_res_masks: torch.Tensor         # [B, T, 4E, 4E] the whole timeline
    object_score_logits: torch.Tensor   # [B, T]


def init_interactive_bank(sam: SAM2Base, B: int, T: int,
                          max_cond_frames: int = 8) -> InteractiveBank:
    """Empty session state; K = max_cond_frames bounds how many distinct
    frames can carry prompts."""
    cfg = sam.cfg
    E2 = (cfg.image_size // cfg.backbone_stride) ** 2
    C, md, K = cfg.d_model, cfg.mem_dim, max_cond_frames
    dev = model_device(sam)
    return InteractiveBank(
        cond_mem=torch.zeros(B, K, E2, md, device=dev),
        cond_ptr=torch.zeros(B, K, C, device=dev),
        cond_frame=np.full((K,), -1, np.int32),
        mem_ring=torch.zeros(B, T, E2, md, device=dev),
        mem_frame=np.full((T,), -1, np.int32),
        ptr_ring=torch.zeros(B, T, C, device=dev),
        ptr_frame=np.full((T,), -1, np.int32),
        spatial_pos=torch.zeros(E2, md, device=dev))


def select_cond_frames(cond_frame: np.ndarray, t: int, cap: int) -> np.ndarray:
    """select_closest_cond_frames over the K slots (interactive.py:90-111):
    always the closest cond frame before t and the closest at-or-after t,
    then the others by |frame - t| (ties: the smaller frame) up to `cap`.
    Returns selected [K] bool; cap -1 selects every valid slot."""
    f = np.asarray(cond_frame, np.int64)
    valid = f >= 0
    if cap == -1 or cap >= f.shape[0]:
        return valid
    big = 2 ** 30
    before = valid & (f < t)
    after = valid & (f >= t)
    best_before = np.max(np.where(before, f, -big))
    best_after = np.min(np.where(after, f, big))
    forced = (before & (f == best_before)) | (after & (f == best_after))
    key = np.where(valid & ~forced, np.abs(f - t) * 65536 + f, big)
    rank = np.argsort(np.argsort(key, kind="stable"), kind="stable")
    num_remain = max(cap - int(forced.sum()), 0)
    return forced | (valid & ~forced & (rank < num_remain))


def assemble_memory_interactive(sam: SAM2Base, bank: InteractiveBank, t: int,
                                num_frames: int, reverse: bool = False):
    """(memory, pos, kv_mask, n_obj_ptr_tokens) of frame t with several
    cond frames (interactive.py:114-204). Layout: K cond blocks, then
    num_maskmem-1 non-cond blocks, then (K + max_obj_ptrs-1) pointer
    groups; a block counts where it holds the wanted frame."""
    cfg = sam.cfg
    B, K, E2, md = bank.cond_mem.shape
    T = bank.mem_ring.shape[1]
    C = bank.cond_ptr.shape[-1]
    split = C // md
    M = cfg.num_maskmem - 1
    P = max(cfg.max_obj_ptrs_in_encoder - 1, 1)
    dev = bank.cond_mem.device
    tpos = sam.maskmem_tpos_enc[:, 0, 0, :].float()         # [num_maskmem, md]
    sp = bank.spatial_pos
    f = bank.cond_frame

    selected = select_cond_frames(f, t, cfg.max_cond_frames_in_attn)
    unselected = (f >= 0) & ~selected

    # non-cond blocks: the wanted frames from the per-frame bank, or an
    # unselected cond frame inside the window (attended as non-cond)
    want, rels = wanted_mem_frames(cfg, t, reverse)
    in_range = (want >= 0) & (want < T)
    slots = np.clip(want, 0, T - 1)
    cmatch = (f[None, :] == want[:, None]) & unselected[None, :]   # [M, K]
    has_cmatch = cmatch.any(axis=1) & in_range
    cidx = np.argmax(cmatch, axis=1)
    noncond_valid = (in_range & (bank.mem_frame[slots] == want)) | has_cmatch
    blocks = [bank.cond_mem[:, k] for k in range(K)] + [
        bank.cond_mem[:, cidx[m]] if has_cmatch[m] else bank.mem_ring[:, slots[m]]
        for m in range(M)]
    memory = torch.stack(blocks, dim=1).reshape(B, (K + M) * E2, md)
    cond_pos = sp + tpos[cfg.num_maskmem - 1]
    ring_pos = sp[None] + tpos[(rels - 1).tolist()][:, None, :]    # [M, E2, md]
    mem_pos = torch.cat([cond_pos.expand(K, E2, md), ring_pos]).reshape(
        1, (K + M) * E2, md).expand(B, -1, -1)
    spatial_valid = np.concatenate([selected, noncond_valid])

    # object pointers: the selected past cond frames, then the last
    # max_obj_ptrs-1 frames, with the unselected-cond fallback
    max_ptrs = min(num_frames, cfg.max_obj_ptrs_in_encoder)
    cond_ptr_valid = selected & ((f >= t) if reverse else (f <= t))
    diffs = np.arange(1, P + 1)
    want_p = (t + diffs if reverse else t - diffs).astype(np.int32)
    in_range_p = (want_p >= 0) & (want_p < T)
    slots_p = np.clip(want_p, 0, T - 1)
    pmatch = (f[None, :] == want_p[:, None]) & unselected[None, :]
    has_pmatch = pmatch.any(axis=1) & in_range_p
    pidx = np.argmax(pmatch, axis=1)
    noncond_ptr_valid = ((in_range_p & (bank.ptr_frame[slots_p] == want_p))
                         | has_pmatch) & (diffs <= max_ptrs - 1)
    ptrs = [bank.cond_ptr[:, k] for k in range(K)] + [
        bank.cond_ptr[:, pidx[p]] if has_pmatch[p] else bank.ptr_ring[:, slots_p[p]]
        for p in range(P)]
    ptr_tokens = torch.stack(ptrs, dim=1).reshape(B, (K + P) * split, md)
    ptr_valid = np.concatenate([cond_ptr_valid, noncond_ptr_valid])

    memory = torch.cat([memory, ptr_tokens], dim=1)
    mem_pos = torch.cat([mem_pos, torch.zeros_like(ptr_tokens)], dim=1)
    valid = np.concatenate([np.repeat(spatial_valid, E2),
                            np.repeat(ptr_valid, split)])
    kv_mask = torch.from_numpy(valid).to(dev)[None].expand(B, -1)
    return memory, mem_pos, kv_mask, (K + P) * split


def apply_non_overlapping_constraints(pred_masks):
    """Keep only the highest-scoring object at each location across the
    leading object axis; the others' scores are clamped to <= -10
    (sam2_base.py:815-833). One object comes back unchanged."""
    B = pred_masks.shape[0]
    if B == 1:
        return pred_masks
    winner = pred_masks.argmax(dim=0, keepdim=True)
    keep = winner == torch.arange(B, device=pred_masks.device).reshape(
        (B,) + (1,) * (pred_masks.ndim - 1))
    return torch.where(keep, pred_masks, pred_masks.clamp(max=-10.0))


def clear_non_cond_mem_around(cfg, bank: InteractiveBank, t: int) -> None:
    """Drop the non-cond memories and pointers within
    +-(memory_temporal_stride_for_eval * num_maskmem) frames of t, t
    included (interactive.py:221-236); cond slots stay. In place: the
    ring's contents stay, their frame indices go."""
    w = cfg.memory_temporal_stride_for_eval * cfg.num_maskmem
    lo, hi = max(t - w, 0), t + w + 1
    bank.mem_frame[lo:hi] = -1
    bank.ptr_frame[lo:hi] = -1


def _use_multimask(cfg, is_init: bool, num_pts: int) -> bool:
    return (cfg.multimask_output_in_sam
            and (is_init or cfg.multimask_output_for_tracking)
            and cfg.multimask_min_pt_num <= num_pts <= cfg.multimask_max_pt_num)


def empty_mask_ptr(sam: SAM2Base, feats_t) -> torch.Tensor:
    """The object pointer of an empty mask on this frame: what objects
    without a prompt on a prompted frame get."""
    B, S = feats_t[-1].shape[0], sam.cfg.image_size
    heads = sam.use_mask_as_output(
        feats_t[-1], (feats_t[0], feats_t[1]),
        torch.zeros(B, S, S, 1, device=feats_t[-1].device))
    return heads.obj_ptr


def _merge_placeholder(sam: SAM2Base, heads: SamHeadsOutput, feats_t,
                       active) -> SamHeadsOutput:
    """Objects not prompted on this frame (active [B] bool False) get
    NO_OBJ_SCORE masks and the empty-mask pointer."""
    if active is None:
        return heads
    a = torch.as_tensor(active, dtype=torch.bool, device=heads.obj_ptr.device)
    am = a[:, None, None, None]
    return heads._replace(
        low_res_masks=torch.where(am, heads.low_res_masks, NO_OBJ_SCORE),
        high_res_masks=torch.where(am, heads.high_res_masks, NO_OBJ_SCORE),
        obj_ptr=torch.where(a[:, None], heads.obj_ptr,
                            empty_mask_ptr(sam, feats_t)))


def _write_prompt_output(sam: SAM2Base, bank: InteractiveBank, t: int,
                         feats_t, heads: SamHeadsOutput,
                         cond_slot: Optional[int]) -> None:
    """Encode the prompted frame's memory from its low-res mask resized
    back up (binarised when the build flag says so) into a cond slot (a
    fresh prompt) or the frame's own non-cond slot (a refinement)."""
    S = sam.cfg.image_size
    high = resize_bilinear(heads.low_res_masks.permute(0, 2, 3, 1), (S, S))
    mem, mem_pos = sam.encode_new_memory(
        feats_t[-1], high, heads.object_score_logits,
        binarize=sam.cfg.binarize_mask_from_pts_for_mem_enc)
    bank.spatial_pos.copy_(mem_pos)
    if cond_slot is not None:
        bank.cond_mem[:, cond_slot] = mem
        bank.cond_ptr[:, cond_slot] = heads.obj_ptr
        bank.cond_frame[cond_slot] = t
    else:
        bank.mem_ring[:, t] = mem
        bank.ptr_ring[:, t] = heads.obj_ptr
        bank.mem_frame[t] = t
        bank.ptr_frame[t] = t


def _prompt_features(sam: SAM2Base, feats_t, pos_top, bank, t: int,
                     num_frames: int, is_init: bool, reverse: bool):
    """No-memory features of an initial conditioning frame, else the
    memory-conditioned features of a refinement."""
    if is_init:
        return feats_t[-1] + sam.no_mem_embed.reshape(1, 1, 1, -1).to(
            feats_t[-1].dtype)
    memory, mem_pos, kv_mask, n_ptr = assemble_memory_interactive(
        sam, bank, t, num_frames, reverse)
    return sam.condition_features(
        feats_t[-1], pos_top.expand(feats_t[-1].shape), memory, mem_pos,
        n_ptr, kv_mask)


def add_point_prompt(sam: SAM2Base, feats_t, pos_top, bank: InteractiveBank,
                     t: int, coords, labels, num_frames: int,
                     cond_slot: Optional[int] = None, prev_mask_logits=None,
                     reverse: bool = False, active=None
                     ) -> Tuple[SamHeadsOutput, InteractiveBank]:
    """Clicks on frame t (interactive.py:309-345). cond_slot set: a fresh
    conditioning frame; None: a refinement on a tracked frame.
    coords [B, N, 2] pixel xy, labels [B, N] (1 pos / 0 neg / -1 pad);
    prev_mask_logits [B, 4E, 4E, 1] are fed back clamped to +-32; active
    [B] bool or None (objects not prompted get the placeholder)."""
    is_init = cond_slot is not None
    feat = _prompt_features(sam, feats_t, pos_top, bank, t, num_frames,
                            is_init, reverse)
    mask_in = None if prev_mask_logits is None else \
        prev_mask_logits.clamp(-32.0, 32.0)
    heads = sam.forward_sam_heads(
        feat, high_res_features=(feats_t[0], feats_t[1]),
        multimask_output=_use_multimask(sam.cfg, is_init, labels.shape[1]),
        point_inputs=(coords, labels), mask_inputs=mask_in)
    heads = _merge_placeholder(sam, heads, feats_t, active)
    _write_prompt_output(sam, bank, t, feats_t, heads, cond_slot)
    return heads, bank


def add_box_prompt(sam: SAM2Base, feats_t, pos_top, bank, t: int, boxes,
                   num_frames: int, cond_slot: Optional[int] = None,
                   reverse: bool = False, active=None):
    """A box [B, 4] xyxy as its two corner points labelled 2 and 3."""
    B = boxes.shape[0]
    labels = torch.tensor([[2, 3]], dtype=torch.int32,
                          device=boxes.device).expand(B, 2)
    return add_point_prompt(sam, feats_t, pos_top, bank, t,
                            boxes.reshape(B, 2, 2), labels, num_frames,
                            cond_slot=cond_slot, reverse=reverse,
                            active=active)


def add_mask_prompt(sam: SAM2Base, feats_t, bank: InteractiveBank, t: int,
                    masks, cond_slot: Optional[int] = None, active=None
                    ) -> Tuple[SamHeadsOutput, InteractiveBank]:
    """A binary mask [B, S, S, 1] on frame t is the output itself
    (use_mask_input_as_output_without_sam): no memory, no decode of its
    own (interactive.py:361-372)."""
    heads = sam.use_mask_as_output(feats_t[-1], (feats_t[0], feats_t[1]),
                                   masks)
    heads = _merge_placeholder(sam, heads, feats_t, active)
    _write_prompt_output(sam, bank, t, feats_t, heads, cond_slot)
    return heads, bank


def add_text_prompt(sam: SAM2Base, feats_t, pos_top, bank: InteractiveBank,
                    t: int, text_embeds, num_frames: int,
                    cond_slot: Optional[int] = None, reverse: bool = False,
                    active=None) -> Tuple[SamHeadsOutput, InteractiveBank]:
    """[SEG] embeddings [B, N, C] as the prompt of frame t."""
    is_init = cond_slot is not None
    feat = _prompt_features(sam, feats_t, pos_top, bank, t, num_frames,
                            is_init, reverse)
    heads = sam.forward_sam_heads(
        feat, text_inputs=text_embeds,
        high_res_features=(feats_t[0], feats_t[1]),
        multimask_output=_use_multimask(sam.cfg, is_init, 0))
    heads = _merge_placeholder(sam, heads, feats_t, active)
    _write_prompt_output(sam, bank, t, feats_t, heads, cond_slot)
    return heads, bank


def propagate_step(sam: SAM2Base, feats_t, pos_top, bank: InteractiveBank,
                   t: int, num_frames: int, reverse: bool = False
                   ) -> SamHeadsOutput:
    """Track frame t from the bank and write its memory and pointer into
    slot t, in place (the body of interactive.py:442-483 for a frame that
    runs)."""
    memory, mem_pos, kv_mask, n_ptr = assemble_memory_interactive(
        sam, bank, t, num_frames, reverse)
    cond_feat = sam.condition_features(
        feats_t[-1], pos_top.expand(feats_t[-1].shape), memory, mem_pos,
        n_ptr, kv_mask)
    heads = sam.forward_sam_heads(
        cond_feat, high_res_features=(feats_t[0], feats_t[1]),
        multimask_output=sam.cfg.multimask_output_for_tracking)
    mem, _ = sam.encode_new_memory(
        feats_t[-1], heads.high_res_masks.permute(0, 2, 3, 1),
        heads.object_score_logits)
    bank.mem_ring[:, t] = mem
    bank.ptr_ring[:, t] = heads.obj_ptr
    bank.mem_frame[t] = t
    bank.ptr_frame[t] = t
    return heads


def propagation_frames(T: int, start: int, end: int, reverse: bool,
                       cond_frame, pinned) -> list:
    """The frames a propagation computes, in processing order: inside
    [start, end] (or [end, start] backwards), neither a cond frame nor
    pinned."""
    order = range(T - 1, -1, -1) if reverse else range(T)
    conds = set(int(c) for c in cond_frame if c >= 0)
    lo, hi = (end, start) if reverse else (start, end)
    return [t for t in order
            if lo <= t <= hi and t not in conds and not pinned[t]]


def propagate(sam: SAM2Base, feats, pos, bank: InteractiveBank, start: int,
              num_frames: int, reverse: bool = False, end: Optional[int] = None,
              pinned=None, init_masks=None, init_scores=None,
              clear_non_cond: bool = False
              ) -> Tuple[PropagateResult, InteractiveBank]:
    """Propagate from `start` to `end` (the video's edge by default),
    forward or backward (interactive.py:403-489). feats: 3 levels
    [T, h, w, c] shared by the objects; pinned [T] bool: frames whose
    outputs came from prompts, skipped like the cond frames; init_masks
    [B, T, 4E, 4E] / init_scores [B, T]: the timeline so far, returned
    unchanged where no frame runs. With clear_non_cond, visiting an active
    cond frame first drops the non-cond memories around it."""
    cfg = sam.cfg
    T = feats[0].shape[0]
    B = bank.cond_mem.shape[0]
    dev = bank.cond_mem.device
    if end is None:
        end = 0 if reverse else T - 1
    if pinned is None:
        pinned = np.zeros((T,), bool)
    E4 = 4 * (cfg.image_size // cfg.backbone_stride)
    masks = (torch.full((B, T, E4, E4), NO_OBJ_SCORE, device=dev)
             if init_masks is None else init_masks.clone())
    scores = (torch.zeros(B, T, device=dev) if init_scores is None
              else init_scores.clone())
    lo, hi = (end, start) if reverse else (start, end)
    runs = set(propagation_frames(T, start, end, reverse, bank.cond_frame,
                                  pinned))
    conds = set(int(c) for c in bank.cond_frame if c >= 0)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        if clear_non_cond and t in conds and lo <= t <= hi:
            clear_non_cond_mem_around(cfg, bank, t)
        if t not in runs:
            continue
        feats_t = [f[t][None].expand(B, *f.shape[1:]) for f in feats]
        heads = propagate_step(sam, feats_t, pos[-1], bank, t, num_frames,
                               reverse)
        masks[:, t] = heads.low_res_masks[:, 0]
        scores[:, t] = heads.object_score_logits[:, 0]
    return PropagateResult(masks, scores), bank


class SAM2InteractivePredictor:
    """A session with the user API of the reference SAM2VideoPredictor
    (add_new_points / add_new_box / add_new_mask / add_new_text /
    propagate_in_video / reset_state) over a built SAM2Base. Which frames
    are cond, tracked or pinned is host bookkeeping; the tensors live in
    the InteractiveBank on the model's device. Prompts apply to all
    `num_objects` rows; `active` prompts a subset (the others get the
    placeholder)."""

    @torch.no_grad()
    def __init__(self, model: SAM2Base, frames, num_objects: int = 1,
                 max_cond_frames: int = 8, non_overlap_masks: bool = False,
                 clear_non_cond_mem_around_input: bool = False,
                 clear_non_cond_mem_for_multi_obj: bool = False):
        """frames: [T, S, S, 3] SAM-normalised (`ops/preprocess.py`), on
        any device; every frame is encoded up front in one batch.
        non_overlap_masks: the winner-takes-all constraint in to_video_res;
        clear_non_cond_mem_around_input: drop stale non-cond memories
        around prompted frames (one object only, unless
        clear_non_cond_mem_for_multi_obj)."""
        self.model = model
        self.B = num_objects
        self.non_overlap_masks = non_overlap_masks
        self._clear_mem = clear_non_cond_mem_around_input and (
            clear_non_cond_mem_for_multi_obj or num_objects <= 1)
        self.T = int(frames.shape[0])
        self.feats, self.pos = model.forward_image(
            torch.as_tensor(frames).to(model_device(model)))
        self.reset_state(max_cond_frames)

    def reset_state(self, max_cond_frames: int = 8):
        """Drop every prompt and tracking result; keep the features."""
        self.bank = init_interactive_bank(self.model, self.B, self.T,
                                          max_cond_frames)
        E4 = 4 * (self.model.cfg.image_size // self.model.cfg.backbone_stride)
        self.masks = torch.full((self.B, self.T, E4, E4), NO_OBJ_SCORE,
                                device=model_device(self.model))
        self.cond_frames = {}          # frame -> cond slot
        self.tracked = {}              # frame -> {"reverse": bool}
        self.pinned = set()            # frames whose output a prompt gave

    def _frame_feats(self, t: int):
        return [f[t][None].expand(self.B, *f.shape[1:]) for f in self.feats]

    def _slot(self, t: int):
        """A fresh prompt's cond slot, or None for a refinement on a
        tracked frame."""
        if t in self.cond_frames:
            return self.cond_frames[t]
        if t in self.tracked:
            return None
        K = self.bank.cond_frame.shape[0]
        if len(self.cond_frames) >= K:
            raise ValueError(f"more than max_cond_frames={K} prompted "
                             "frames; raise max_cond_frames in reset_state")
        return len(self.cond_frames)

    @torch.no_grad()
    def _run_prompt(self, kind: str, t: int, prompt, active):
        slot = self._slot(t)
        feats_t = self._frame_feats(t)
        reverse = self.tracked.get(t, {}).get("reverse", False)
        if kind == "point":
            prev = (self.masks[:, t][..., None]
                    if t in self.pinned or t in self.tracked else None)
            heads, _ = add_point_prompt(
                self.model, feats_t, self.pos[-1], self.bank, t, *prompt,
                self.T, cond_slot=slot, prev_mask_logits=prev,
                reverse=reverse, active=active)
        elif kind == "text":
            heads, _ = add_text_prompt(
                self.model, feats_t, self.pos[-1], self.bank, t, prompt,
                self.T, cond_slot=slot, reverse=reverse, active=active)
        else:
            heads, _ = add_mask_prompt(self.model, feats_t, self.bank, t,
                                       prompt, cond_slot=slot, active=active)
        if self._clear_mem:
            # around every prompted frame, the frame's own refinement
            # output included
            clear_non_cond_mem_around(self.model.cfg, self.bank, t)
        self.masks[:, t] = heads.low_res_masks[:, 0]
        self.pinned.add(t)
        if slot is not None:
            self.cond_frames[t] = slot
        return heads.low_res_masks[:, 0]

    def _tensor(self, x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=model_device(self.model))

    def add_new_points(self, frame_idx: int, coords, labels, active=None):
        """coords [B, N, 2] pixel xy, labels [B, N] (1 pos / 0 neg / -1
        pad) -> [B, 4E, 4E] mask logits of the frame."""
        return self._run_prompt(
            "point", frame_idx, (self._tensor(coords, torch.float32),
                                 self._tensor(labels, torch.int32)), active)

    def add_new_box(self, frame_idx: int, boxes, active=None):
        """boxes [B, 4] xyxy pixels, as two corner points labelled 2 / 3."""
        b = self._tensor(boxes, torch.float32).reshape(self.B, 2, 2)
        labels = self._tensor(np.tile(np.array([[2, 3]], np.int32),
                                      (self.B, 1)), torch.int32)
        return self._run_prompt("point", frame_idx, (b, labels), active)

    def add_new_mask(self, frame_idx: int, masks, active=None):
        """masks [B, S, S] binary."""
        return self._run_prompt(
            "mask", frame_idx, self._tensor(masks, torch.float32)[..., None],
            active)

    def add_new_text(self, frame_idx: int, text_embeds, active=None):
        """text_embeds [B, N, C]: projected [SEG] hidden states."""
        return self._run_prompt(
            "text", frame_idx, torch.as_tensor(text_embeds).to(
                model_device(self.model)), active)

    def propagation_range(self, start_frame_idx: Optional[int] = None,
                          max_frame_num_to_track: Optional[int] = None,
                          reverse: bool = False) -> Tuple[int, int]:
        """(start, end) of a propagate_in_video call with these arguments."""
        if not self.cond_frames:
            raise RuntimeError("no prompts added; call add_new_* first")
        start = (min(self.cond_frames) if start_frame_idx is None
                 else start_frame_idx)
        if max_frame_num_to_track is None:
            end = 0 if reverse else self.T - 1
        else:
            end = (max(start - max_frame_num_to_track, 0) if reverse else
                   min(start + max_frame_num_to_track, self.T - 1))
        return start, end

    @torch.no_grad()
    def propagate_in_video(self, start_frame_idx: Optional[int] = None,
                           max_frame_num_to_track: Optional[int] = None,
                           reverse: bool = False):
        """-> [B, T, 4E, 4E] mask logits of the whole timeline (the
        reference yields frame by frame; this returns the range at once)."""
        start, end = self.propagation_range(start_frame_idx,
                                            max_frame_num_to_track, reverse)
        pinned = np.zeros((self.T,), bool)
        pinned[list(self.pinned)] = True
        res, self.bank = propagate(
            self.model, self.feats, self.pos, self.bank, start, self.T,
            reverse=reverse, end=end, pinned=pinned, init_masks=self.masks,
            clear_non_cond=self._clear_mem)
        self.masks = res.low_res_masks
        lo, hi = (end, start) if reverse else (start, end)
        for t in range(lo, hi + 1):
            self.tracked.setdefault(t, {"reverse": reverse})
        return res.low_res_masks

    @torch.no_grad()
    def to_video_res(self, orig_hw: Tuple[int, int], masks=None):
        """Mask logits [B, T, 4E, 4E] (the session's timeline by default)
        -> [B, T, H, W] at the video's resolution, with the
        non-overlapping constraint across objects when enabled."""
        m = self.masks if masks is None else masks
        B, T = m.shape[:2]
        up = resize_bilinear(m.reshape(B * T, *m.shape[2:])[..., None],
                             tuple(orig_hw))[..., 0]
        up = up.reshape(B, T, *orig_hw)
        if self.non_overlap_masks:
            up = apply_non_overlapping_constraints(up)
        return up
