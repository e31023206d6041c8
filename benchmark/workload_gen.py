"""The one traffic generator: every request or micro-batch of a cell made
from the traffic file's parameters and `--seed`.

Request i of a run is made from its own generator (seed, i), so the
reference can make it again alone after the window. Sizes are drawn so
that every seed gets the same set of them in another order: the prompt
lengths run through every whole number of the file's range, a fresh
shuffle for each pass."""
from __future__ import annotations

import numpy as np
import torch

from weights import sub_seed

IMAGE_TOKEN_INDEX = -200      # the prompt's placeholder for the visual prefix


def prompt_lengths(traffic: dict, seed: int, n: int) -> list:
    lo, hi = traffic["prompt_tokens"]
    rng = np.random.default_rng(sub_seed(seed, "lengths"))
    out = []
    while len(out) < n:
        out += rng.permutation(np.arange(lo, hi + 1)).tolist()
    return out[:n]


def clip_request(traffic: dict, seed: int, index: int, length: int, device):
    """(raw frames [T,H,W,3] uint8, prompt ids [length]) of request `index`."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, f"req{index}"))
    raw = torch.randint(0, 256, (traffic["frames"], traffic["height"],
                                 traffic["width"], 3),
                        dtype=torch.uint8, generator=g, device=device)
    lo, hi = traffic["prompt_ids"]
    ids = torch.randint(lo, hi, (length,), generator=g, device=device)
    ids[traffic["image_token_at"]] = IMAGE_TOKEN_INDEX
    return raw, ids


def clip_batch(traffic: dict, seed: int, first: int, lengths: list, device):
    """Requests first .. first + len(lengths) - 1 as one padded batch:
    (raw [B,T,H,W,3], ids [B, max length] zero-padded, lens [B])."""
    reqs = [clip_request(traffic, seed, first + b, n, device)
            for b, n in enumerate(lengths)]
    raw = torch.stack([r[0] for r in reqs])
    ids = torch.zeros(len(reqs), max(lengths), dtype=torch.long, device=device)
    for b, (_, r) in enumerate(reqs):
        ids[b, :len(r)] = r
    lens = torch.tensor(lengths, dtype=torch.long, device=device)
    return raw, ids, lens


IGNORE_INDEX = -100          # label positions left out of the CE loss
MASK_IGNORE = -1.0           # ground-truth mask padding


def train_micro(tr: dict, c: dict, seed: int, step: int, micro: int, device,
                dtype=torch.bfloat16) -> dict:
    """One micro-batch of optimizer step `step` in the shapes the data
    layer's collate gives: `videos` preprocessed clips (`sam_frames` of
    them for SAM), `rows` conversations of `text_tokens` ids with the image
    placeholder and one or two [SEG] tokens, labels that ignore the prompt,
    and binary ground-truth masks with ignore padding for the unused [SEG]
    slots. Every step and micro-step has rows of its own."""
    g = torch.Generator(device=device).manual_seed(
        sub_seed(seed, f"step{step}.{micro}"))
    V, R, T = tr["videos"], tr["rows"], c["num_frames"]
    S, ts, hw = tr["text_tokens"], tr["sam_frames"], tr["gt_size"]
    iv, cl = c["internvideo"]["image_size"], c["clip"]["image_size"]
    sam = c["sam2"]["image_size"]
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=device).to(dtype)
    frames, context = rnd(V, T, iv, iv, 3), rnd(V, T, cl, cl, 3)
    frames_sam = rnd(V, ts, sam, sam, 3)
    lo, hi = tr["prompt_ids"]
    ids = torch.randint(lo, hi, (R, S), generator=g, device=device)
    ids[:, tr["image_token_at"]] = IMAGE_TOKEN_INDEX
    gt = torch.full((R, c["max_seg_tokens"], ts, hw, hw), MASK_IGNORE,
                    device=device)
    for r in range(R):
        n_seg = 1 + r % 2
        for j in range(n_seg):
            ids[r, tr["seg_at"][j]] = c["seg_token_idx"]
        gt[r, :n_seg] = (torch.rand(n_seg, ts, hw, hw, generator=g,
                                    device=device) > 0.5).float()
    labels = ids.clone()
    labels[labels < 0] = IGNORE_INDEX
    labels[:, :tr["label_from"]] = IGNORE_INDEX
    return dict(frames=frames, context_images=context, frames_sam=frames_sam,
                input_ids=ids,
                text_lens=torch.tensor(tr["text_lens"][:R], device=device),
                labels=labels,
                video_idx=torch.arange(R, device=device) % V, gt_masks=gt)


def train_batch(tr: dict, c: dict, seed: int, step: int, accum: int, device,
                dtype=torch.bfloat16) -> dict:
    """Step `step`'s micro-batches stacked on a leading axis of `accum`."""
    micro = [train_micro(tr, c, seed, step, i, device, dtype)
             for i in range(accum)]
    return {k: torch.stack([m[k] for m in micro]) for k in micro[0]}
