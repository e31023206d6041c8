"""SAM-2 video predictor: memory-conditioned mask propagation (PyTorch
port of videoglamm_tpu/models/sam2/video_predictor.py), restricted as the
JAX module is to the path VideoGLaMM drives: one text prompt per object on
frame 0, then forward propagation. Per tracked frame t:

- memory bank = the conditioning frame's memory (temporal position index
  num_maskmem-1) + num_maskmem-1 earlier frames' memories (the previous
  frame plus every r-th frame, r = `memory_temporal_stride_for_eval`;
  frame t-k at index k-1) + object pointers of the conditioning frame and
  of the last max_obj_ptrs_in_encoder-1 frames, each C-wide pointer split
  into C/mem_dim tokens with zero position encoding;
- memory attention -> SAM heads (multimask, object-score gating) -> encode
  the new memory -> bank update.

The bank is a fixed-shape ring (memories keyed by frame % num_slots,
pointers likewise); selecting the wanted frames is a gather, and a slot
counts only if it really holds the wanted frame, which becomes the
attention's kv_mask. The JAX package runs the frames under one `lax.scan`;
here it is a Python loop with the ring tensors allocated once and written
in place. `t` is a Python int, so choosing slots costs no device
synchronisation. `reverse=True` mirrors the selection of backward
propagation (the window after the current frame).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .sam2_base import SAM2Base, SamHeadsOutput


class MemoryBank(NamedTuple):
    cond_mem: torch.Tensor     # [B, E2, mem_dim]
    cond_ptr: torch.Tensor     # [B, C]
    mem_ring: torch.Tensor     # [B, S, E2, mem_dim]   S = (num_maskmem-2)*r + 1
    mem_frame: torch.Tensor    # [B, S] frame held (-1 empty)
    ptr_ring: torch.Tensor     # [B, P, C]             P = max_obj_ptrs - 1
    ptr_frame: torch.Tensor    # [B, P] frame held (-1 empty)
    spatial_pos: torch.Tensor  # [E2, mem_dim] sine PE over the memory grid


class TrackResult(NamedTuple):
    low_res_masks: torch.Tensor         # [B, T, 4E, 4E] logits
    ious: torch.Tensor                  # [B, T]
    object_score_logits: torch.Tensor   # [B, T]


def num_mem_slots(cfg) -> int:
    """Ring size: the strided selection reaches at most (num_maskmem-2)*r + 1
    frames back, so this many slots keyed by frame % S hold every reachable
    frame without collisions."""
    r = cfg.memory_temporal_stride_for_eval
    return max((cfg.num_maskmem - 2) * r + 1, 1)


def init_bank(sam: SAM2Base, B: int, cond_mem, cond_ptr, spatial_pos):
    cfg = sam.cfg
    S = num_mem_slots(cfg)
    P = max(cfg.max_obj_ptrs_in_encoder - 1, 1)
    E2 = cond_mem.shape[1]
    dev = cond_mem.device
    return MemoryBank(
        cond_mem=cond_mem, cond_ptr=cond_ptr,
        mem_ring=torch.zeros(B, S, E2, cfg.mem_dim, device=dev),
        mem_frame=torch.full((B, S), -1, dtype=torch.int32, device=dev),
        ptr_ring=torch.zeros(B, P, cond_ptr.shape[-1], device=dev),
        ptr_frame=torch.full((B, P), -1, dtype=torch.int32, device=dev),
        spatial_pos=spatial_pos)


def wanted_mem_frames(cfg, t: int, reverse: bool = False):
    """Absolute frame indices selected for the non-conditioning memory of
    frame t, in t_rel order [1 .. num_maskmem-1] (video_predictor.py:90-108):
    t_rel 1 is the adjacent frame, t_rel >= 2 walk every r-th frame from the
    floor- (ceil- in reverse) aligned anchor. Returns (want, t_rel), numpy
    int arrays of [num_maskmem-1]."""
    r = cfg.memory_temporal_stride_for_eval
    rels = np.arange(1, cfg.num_maskmem)
    if not reverse:
        strided = ((t - 2) // r) * r - (rels - 2) * r
        adjacent = t - 1
    else:
        strided = -((-(t + 2)) // r) * r + (rels - 2) * r    # ceil align
        adjacent = t + 1
    return np.where(rels == 1, adjacent, strided).astype(np.int32), rels


def assemble_memory(sam: SAM2Base, bank: MemoryBank, t: int, num_frames: int,
                    reverse: bool = False):
    """The fixed-shape (memory, pos, kv_mask, n_obj_ptr_tokens) of frame t
    (video_predictor.py:111-177): the wanted frames are gathered from the
    rings, and a slot is valid iff it holds the wanted frame."""
    cfg = sam.cfg
    B, E2, mem_dim = bank.cond_mem.shape
    P = bank.ptr_ring.shape[1]
    C = bank.cond_ptr.shape[-1]
    split = C // mem_dim
    S = bank.mem_ring.shape[1]
    M = cfg.num_maskmem - 1
    dev = bank.cond_mem.device

    tpos = sam.maskmem_tpos_enc[:, 0, 0, :].float()          # [num_maskmem, md]
    sp = bank.spatial_pos                                    # [E2, md]
    # conditioning block: t_pos = 0 -> tpos index num_maskmem-1
    cond_pos = sp + tpos[cfg.num_maskmem - 1]

    want_np, rels = wanted_mem_frames(cfg, t, reverse)
    ok = want_np >= 0
    if reverse:
        ok &= want_np < num_frames
    want = torch.from_numpy(want_np).to(dev)
    slots = (want_np % S).tolist()
    mem_sel = bank.mem_ring[:, slots]                        # [B, M, E2, md]
    ring_valid = torch.from_numpy(ok).to(dev)[None, :] \
        & (bank.mem_frame[:, slots] == want[None, :])
    # t_rel k -> tpos index k-1
    ring_pos = sp[None, None] + tpos[(rels - 1).tolist()][None, :, None, :]

    memory = torch.cat([bank.cond_mem[:, None], mem_sel], dim=1)
    memory = memory.reshape(B, (M + 1) * E2, mem_dim)
    mem_pos = torch.cat([cond_pos.expand(B, 1, E2, mem_dim),
                         ring_pos.expand(B, M, E2, mem_dim)], dim=1)
    mem_pos = mem_pos.reshape(B, (M + 1) * E2, mem_dim)
    spatial_mask = torch.cat(
        [torch.ones(B, 1, dtype=torch.bool, device=dev), ring_valid], dim=1)
    spatial_mask = spatial_mask.repeat_interleave(E2, dim=1)

    # object pointers: the conditioning frame's and those of the last
    # max_obj_ptrs-1 tracked frames, capped by the number of frames
    max_ptrs = min(num_frames, cfg.max_obj_ptrs_in_encoder)
    diffs = np.arange(1, P + 1)
    want_p_np = (t + diffs if reverse else t - diffs).astype(np.int32)
    ok_p = (want_p_np >= 0) & (diffs <= max_ptrs - 1)
    if reverse:
        ok_p &= want_p_np < num_frames
    want_p = torch.from_numpy(want_p_np).to(dev)
    slots_p = (want_p_np % P).tolist()
    ptr_sel = bank.ptr_ring[:, slots_p]                      # [B, P, C]
    ptr_valid = torch.from_numpy(ok_p).to(dev)[None, :] \
        & (bank.ptr_frame[:, slots_p] == want_p[None, :])
    ptr_valid = torch.cat(
        [torch.ones(B, 1, dtype=torch.bool, device=dev), ptr_valid], dim=1)

    ptrs = torch.cat([bank.cond_ptr[:, None], ptr_sel], dim=1)
    ptr_tokens = ptrs.reshape(B, (P + 1) * split, mem_dim)
    ptr_mask = ptr_valid.repeat_interleave(split, dim=1)

    memory = torch.cat([memory, ptr_tokens], dim=1)
    mem_pos = torch.cat([mem_pos, torch.zeros_like(ptr_tokens)], dim=1)
    kv_mask = torch.cat([spatial_mask, ptr_mask], dim=1)
    return memory, mem_pos, kv_mask, (P + 1) * split


def track_init_frame(sam: SAM2Base, feats0, pos0, text_embeds
                     ) -> Tuple[SamHeadsOutput, MemoryBank]:
    """The conditioning step on frame 0: no-memory features + the text
    prompt + memory encoding (video_predictor.py:180-204). feats0: 3 levels
    [B, h, w, c], already through conv_s0/s1; text_embeds [B, N, C]."""
    B = feats0[-1].shape[0]
    embed = feats0[-1] + sam.no_mem_embed.reshape(1, 1, 1, -1).to(feats0[-1].dtype)
    heads = sam.forward_sam_heads(
        embed, text_inputs=text_embeds,
        high_res_features=(feats0[0], feats0[1]),
        multimask_output=sam.cfg.multimask_output_in_sam)
    # a prompted frame's mask is binarised before memory encoding
    mem, mem_pos = sam.encode_new_memory(
        feats0[-1], heads.high_res_masks.permute(0, 2, 3, 1),
        heads.object_score_logits,
        binarize=sam.cfg.binarize_mask_from_pts_for_mem_enc)
    return heads, init_bank(sam, B, mem, heads.obj_ptr, mem_pos)


def track_step(sam: SAM2Base, feats_t, pos_top, bank: MemoryBank, t: int,
               num_frames: int, reverse: bool = False
               ) -> Tuple[SamHeadsOutput, MemoryBank]:
    """One propagation step at frame t (video_predictor.py:207-238). The new
    memory is written in place into ring slot t % S (t % P for the pointer);
    the bank that comes back is the one that went in."""
    cfg = sam.cfg
    memory, mem_pos, kv_mask, n_ptr_tokens = assemble_memory(
        sam, bank, t, num_frames, reverse)
    cond_feat = sam.condition_features(
        feats_t[-1], pos_top.expand(feats_t[-1].shape), memory, mem_pos,
        n_ptr_tokens, kv_mask)
    heads = sam.forward_sam_heads(
        cond_feat, high_res_features=(feats_t[0], feats_t[1]),
        multimask_output=cfg.multimask_output_for_tracking)
    mem, _ = sam.encode_new_memory(
        feats_t[-1], heads.high_res_masks.permute(0, 2, 3, 1),
        heads.object_score_logits)
    mem_slot = t % bank.mem_ring.shape[1]
    ptr_slot = t % bank.ptr_ring.shape[1]
    bank.mem_ring[:, mem_slot] = mem
    bank.mem_frame[:, mem_slot] = t
    bank.ptr_ring[:, ptr_slot] = heads.obj_ptr
    bank.ptr_frame[:, ptr_slot] = t
    return heads, bank


def track_video(sam: SAM2Base, feats, pos, text_embeds) -> TrackResult:
    """Propagate through a whole video.

    feats: 3 levels [T, h, w, c] from `SAM2Base.forward_image` over the
    video's frames, held once and not per object: each step hands the
    trackers an `expand`ed view of the frame's features, no copy. pos: per
    level [h, w, c]; text_embeds [B, N, C], one [SEG] prompt per tracked
    object (B objects).

    Returns the low-res mask logits [B, T, 4E, 4E], the best IoU
    prediction and the object score per frame."""
    T = feats[0].shape[0]
    B = text_embeds.shape[0]

    def per_obj(t):
        return [f[t][None].expand(B, *f.shape[1:]) for f in feats]

    heads, bank = track_init_frame(sam, per_obj(0), pos[-1], text_embeds)
    frames = [heads]
    for t in range(1, T):
        heads, bank = track_step(sam, per_obj(t), pos[-1], bank, t, T)
        frames.append(heads)
    return TrackResult(
        low_res_masks=torch.stack([h.low_res_masks[:, 0] for h in frames], dim=1),
        ious=torch.stack([h.ious.max(dim=-1).values for h in frames], dim=1),
        object_score_logits=torch.stack(
            [h.object_score_logits[:, 0] for h in frames], dim=1))
