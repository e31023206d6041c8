"""The training step in the reference, in f32: the freeze policy, gradient
accumulation and AdamW with clipping, copied from the plain code of
training/train_step.py at the commit named in this package's docstring
(`TRAINABLE_PATTERNS`, `lr_schedule`, `AdamW.update_`, `_gradients`)."""
from __future__ import annotations

import re

import torch

TRAINABLE_PATTERNS = (
    r"lm_head", r"embed_tokens", r"text_hidden_fcs",
    r"sam_mask_decoder\.(?!conv_s[01]\.)", r"lora_[ab]",
)
METRIC_KEYS = ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss",
               "mask_loss")
EPS = 1e-8


def trainable_names(model) -> list:
    rx = re.compile("|".join(TRAINABLE_PATTERNS))
    return [n for n, _ in model.named_parameters() if rx.search(n)]


def lr_at(t: dict, count: int) -> float:
    """Linear warm-up from 0 over warmup_steps, then linear decay to 0; read
    at the count before the update."""
    def linear(init, end, steps, c):
        if steps <= 0:
            return init
        return (init - end) * (1.0 - min(max(c, 0), steps) / steps) + end
    if count < t["warmup_steps"]:
        return linear(0.0, t["lr"], t["warmup_steps"], count)
    decay = max(t["total_steps"] - t["warmup_steps"], 1)
    return linear(t["lr"], 0.0, decay, count - t["warmup_steps"])


class AdamW:
    """optax.chain(clip_by_global_norm, adamw(schedule)) over `names`."""

    def __init__(self, t: dict, params: dict, names: list):
        self.t, self.names = t, list(names)
        self.count = 0
        self.mu = {n: torch.zeros_like(params[n]) for n in self.names}
        self.nu = {n: torch.zeros_like(params[n]) for n in self.names}

    @torch.no_grad()
    def update_(self, params: dict, grads: dict):
        t = self.t
        g = [grads[n] for n in self.names]
        norm = torch.linalg.vector_norm(torch.stack([x.norm() for x in g]))
        scale = t["grad_clip"] / norm if norm >= t["grad_clip"] else 1.0
        c1 = 1.0 - t["beta1"] ** (self.count + 1)
        c2 = 1.0 - t["beta2"] ** (self.count + 1)
        lr = lr_at(t, self.count)
        for n, x in zip(self.names, g):
            x = x * scale
            self.mu[n].mul_(t["beta1"]).add_(x, alpha=1.0 - t["beta1"])
            self.nu[n].mul_(t["beta2"]).addcmul_(x, x, value=1.0 - t["beta2"])
            upd = (self.mu[n] / c1) / ((self.nu[n] / c2).sqrt() + EPS)
            if t["weight_decay"]:
                upd = upd + t["weight_decay"] * params[n]
            params[n].add_(upd, alpha=-lr)
        self.count += 1


def gradients(model, names: list, micro_batches: list):
    """Forward and backward of every micro-batch: ({name: mean gradient},
    [mean of each metric])."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    sums = None
    for mb in micro_batches:
        out = model(**mb)
        out.loss.backward()
        vals = torch.stack([getattr(out, k).detach().float() for k in METRIC_KEYS])
        sums = vals if sums is None else sums + vals
    k = float(len(micro_batches))
    grads = {n: (params[n].grad / k if params[n].grad is not None
                 else torch.zeros_like(params[n])) for n in names}
    return grads, (sums / k).tolist()
