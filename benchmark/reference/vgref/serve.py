"""Grounded captioning in the reference, teacher-forced on served tokens.

`prepare_vision_inputs`, `prefill`, `decode_step` and `extract_seg` are
copies of the serving path's plain code (inference/pipeline.py,
inference/generate.py at the commit named in this package's docstring);
`follow` feeds one request's served tokens through the cached decode and
returns the logits that chose each of them, the [SEG] masks and slots."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .models import kvcache
from .models.multimodal import splice_visual_prefix
from .models.phi3 import quantize_llm
from .models.videoglamm import SegExtraction, VideoGLaMM
from .ops.preprocess import (preprocess_clip_stream, preprocess_iv_stream,
                             preprocess_sam_stream, sample_frame_indices)


def prepare_vision_inputs(raw_frames, cfg, num_sam_frames=None,
                          dtype=torch.float32):
    frames = preprocess_iv_stream(raw_frames, cfg.internvideo.image_size, dtype)
    context = preprocess_clip_stream(raw_frames, cfg.clip.image_size, dtype)
    sam_frames = raw_frames
    T = raw_frames.shape[1]
    if num_sam_frames is not None and num_sam_frames != T:
        idx = torch.from_numpy(sample_frame_indices(T, num_sam_frames))
        sam_frames = raw_frames[:, idx.to(raw_frames.device)]
    frames_sam = preprocess_sam_stream(sam_frames, cfg.sam2.image_size, dtype)
    return frames, context, frames_sam


def prefill(llm, visual_prefix, input_ids, text_lens, max_new_tokens: int,
            quant_kv: bool):
    B, S_text = input_ids.shape
    S_prefill = S_text - 1 + visual_prefix.shape[1]
    embeds = llm.embed(input_ids)
    sp = splice_visual_prefix(embeds, input_ids, visual_prefix, text_lens)
    cfg = llm.cfg
    cache = kvcache.init_cache(cfg.num_layers, B, cfg.num_kv_heads,
                               S_prefill + max_new_tokens + 1, cfg.head_dim,
                               embeds.dtype, embeds.device, quant_kv)
    hidden_pre, cache = llm.forward_hidden(sp.embeds, sp.positions,
                                           sp.attn_lens, cache)
    bidx = torch.arange(B, device=embeds.device)
    logits = llm.head(hidden_pre[bidx, sp.attn_lens - 1])
    return cache, sp, logits, hidden_pre


def decode_step(llm, cache, tok, pos):
    logits, hidden, _ = llm(llm.embed(tok[:, None]), pos[:, None], pos + 1,
                            cache)
    return logits[:, -1], hidden[:, 0]


def extract_seg(model, tokens, hidden) -> SegExtraction:
    cfg = model.cfg
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)[None, :]
    is_seg = tokens == cfg.seg_token_idx
    key = torch.where(is_seg, pos, S + pos)
    idx = key.argsort(dim=1)[:, :cfg.max_seg_tokens]
    valid = torch.gather(is_seg, 1, idx)
    h = torch.gather(hidden, 1, idx[..., None].expand(-1, -1, hidden.shape[-1]))
    emb = model.text_hidden_fcs[0](h.float())
    emb = torch.where(valid[..., None], emb, 0.0)
    return SegExtraction(embeds=emb, valid=valid, positions=idx)


def build(cfg, weights: dict, quant: str, kv_int8: bool, device):
    """The reference model in f32 on `device`, its LLM quantised as the
    configuration states ("int8"; "int4" for the control; "none")."""
    from weights import fill
    with torch.device(device):
        model = VideoGLaMM(cfg, quant_kv_int8=kv_int8)
    model.to(device)     # tensors made from numpy ignore the device context
    fill(model, weights)
    if quant != "none":
        quantize_llm(model.llm, quant)
    return model.eval()


@torch.no_grad()
def greedy_hidden(model, raw, ids, lens, steps: int, num_sam_frames: int,
                  fed: int):
    """Final-layer hidden states [B * steps, D] of a batch of requests (raw
    [B,T,H,W,3] uint8, ids [B,S] zero-padded prompts of lengths lens [B])
    decoded twice from one prefill: feeding the greedy tokens, and feeding
    the token `fed` at every step. Returns (greedy, fed)."""
    frames, context, _ = prepare_vision_inputs(raw, model.cfg, num_sam_frames)
    visual = model.encode_visual_prefix(frames, context)
    cache, sp, first, _ = prefill(model.llm, visual, ids, lens, steps,
                                  model.quant_kv_int8)
    out = []
    for forced in (False, True):
        c = {k: v.clone() for k, v in cache.items()}
        pos, logits, hs = sp.attn_lens.clone(), first, []
        for _ in range(steps):
            tok = torch.full_like(pos, fed) if forced else logits.argmax(dim=-1)
            logits, h = decode_step(model.llm, c, tok, pos)
            hs.append(h)
            pos = pos + 1
        out.append(torch.stack(hs, dim=1).reshape(-1, hs[0].shape[-1]))
        del c
    return out[0], out[1]


class Followed(NamedTuple):
    logits: torch.Tensor      # [n, V] f32: the logits that chose served token j
    seg_valid: torch.Tensor   # [max_seg] bool
    masks: torch.Tensor       # [max_seg, T_sam, h, w] f32 (-1e4 on invalid slots)
    candidates: tuple = None  # the decoder's ([max_seg, T_sam, 4, h, w], [.., 4] IoU)


@torch.no_grad()
def follow(model, raw, ids, served, num_sam_frames: int, max_new: int) -> Followed:
    """One request: raw [T,H,W,3] uint8, ids [S] prompt, served [n] tokens
    the program returned (its answer up to its length)."""
    cfg = model.cfg
    frames, context, frames_sam = prepare_vision_inputs(
        raw[None], cfg, num_sam_frames)
    visual = model.encode_visual_prefix(frames, context)
    lens = torch.tensor([ids.shape[0]], device=ids.device)
    cache, sp, logits, _ = prefill(model.llm, visual, ids[None], lens,
                                   max_new, model.quant_kv_int8)
    n = served.shape[0]
    out, hidden = [], []
    pos = sp.attn_lens.clone()
    for j in range(n):
        out.append(logits[0].float())
        logits, h = decode_step(model.llm, cache, served[j:j + 1], pos)
        hidden.append(h)
        pos = pos + 1
    del cache
    tokens = served[None]
    hid = torch.stack(hidden, dim=1) if hidden else \
        torch.zeros(1, 0, cfg.llm.hidden_size, device=ids.device)
    if n:
        seg = extract_seg(model, tokens, hid)
    else:
        seg = SegExtraction(torch.zeros(1, cfg.max_seg_tokens, cfg.out_dim,
                                        device=ids.device),
                            torch.zeros(1, cfg.max_seg_tokens, dtype=torch.bool,
                                        device=ids.device), None)
    masks = torch.full((cfg.max_seg_tokens, num_sam_frames,
                        4 * cfg.sam2.low_res_size, 4 * cfg.sam2.low_res_size),
                       -1e4, device=ids.device)
    if bool(seg.valid.any()):
        feats = []
        for t in range(frames_sam.shape[1]):     # one frame at a time
            f, _ = model.encode_sam_features(frames_sam[:, t:t + 1])
            feats.append(f)
        feats = [torch.cat([f[i] for f in feats], dim=1) for i in range(3)]
        m = model.decode_masks(feats, seg, torch.zeros(1, dtype=torch.long,
                                                       device=ids.device))
        masks = torch.where(seg.valid[0][:, None, None, None], m[0], -1e4)
        cm, ci = model.visual_model.sam_mask_decoder.candidates
        cand = (cm.reshape(*m.shape[1:3], *cm.shape[1:]),
                ci.reshape(*m.shape[1:3], ci.shape[-1]))
    else:
        cand = None
    return Followed(torch.stack(out) if out else torch.zeros(0),
                    seg.valid[0], masks, cand)
