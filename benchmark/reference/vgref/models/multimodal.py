"""Static-shape splice of the visual prefix into the token stream (PyTorch
port of videoglamm_tpu/models/multimodal.py): [text[:p], visual,
text[p+1:]] for the single IMAGE_TOKEN_INDEX placeholder at p, the same
for the labels (IGNORE_INDEX over the visual run and past each row's valid
length) and the token ids."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX


class SplicedBatch(NamedTuple):
    embeds: torch.Tensor       # [B, S_out, D]
    attn_lens: torch.Tensor    # [B] valid lengths
    positions: torch.Tensor    # [B, S_out]
    labels: torch.Tensor       # [B, S_out] (IGNORE_INDEX over visual run/pad)
    is_visual: torch.Tensor    # [B, S_out] bool
    token_ids: torch.Tensor    # [B, S_out] (visual run = IMAGE_TOKEN_INDEX)


def find_image_token_pos(input_ids):
    hit = input_ids == IMAGE_TOKEN_INDEX
    return hit.int().argmax(dim=1), hit.any(dim=1)


def splice_visual_prefix(text_embeds, input_ids, visual, text_lens,
                         labels=None):
    """text_embeds [B, S_text, D]; input_ids [B, S_text] with one
    placeholder per row; visual [B, V, D]; text_lens [B]; labels: optional
    [B, S_text] training labels (multimodal.py:41-95)."""
    B, S_text, D = text_embeds.shape
    V = visual.shape[1]
    S_out = S_text - 1 + V
    dev = text_embeds.device
    pos, has_img = find_image_token_pos(input_ids)
    j = torch.arange(S_out, device=dev)[None, :]
    p = pos[:, None]
    is_visual = (j >= p) & (j < p + V) & has_img[:, None]
    idx_text = torch.where(j < p + V, torch.clamp(j, max=S_text - 1),
                           torch.clamp(j - V + 1, max=S_text - 1))
    idx_vis = torch.clamp(j - p, 0, V - 1)
    g_text = torch.gather(text_embeds, 1, idx_text[..., None].expand(B, S_out, D))
    g_vis = torch.gather(visual.to(text_embeds.dtype), 1,
                         idx_vis[..., None].expand(B, S_out, D))
    embeds = torch.where(is_visual[..., None], g_vis, g_text)
    text_lens = text_lens.to(dev)
    attn_lens = torch.where(has_img, text_lens - 1 + V, text_lens)
    positions = torch.arange(S_out, device=dev)[None, :].expand(B, S_out)
    token_ids = torch.where(is_visual, IMAGE_TOKEN_INDEX,
                            torch.gather(input_ids, 1, idx_text))
    if labels is not None:
        out_labels = torch.where(is_visual, IGNORE_INDEX,
                                 torch.gather(labels, 1, idx_text))
    else:
        out_labels = torch.full((B, S_out), IGNORE_INDEX, dtype=torch.long,
                                device=dev)
    out_labels = torch.where(positions < attn_lens[:, None], out_labels,
                             IGNORE_INDEX)
    return SplicedBatch(embeds=embeds, attn_lens=attn_lens, positions=positions,
                        labels=out_labels, is_visual=is_visual,
                        token_ids=token_ids)
