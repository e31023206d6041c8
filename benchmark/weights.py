"""Seeded weights, made on the device in a few large calls.

The leaf list (name, shape, kind) comes from the reference model built on
the meta device; the values come from one generator seeded from `--seed`:
every matrix, convolution, embedding and other learned tensor normal with
std 0.02, norm scales 1, norm biases 0, buffers (the random-Fourier matrix
of SAM's prompt encoder) standard normal. The same dict is handed to the
program and to the reference, which reads it again after the window."""
from __future__ import annotations

import numpy as np
import torch

STD = 0.02
CHUNK = 1 << 28          # elements drawn per call


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of `--seed` (weights, requests, samples)."""
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF] + [ord(c) for c in tag]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def leaf_specs(model) -> list:
    """[(name, shape, kind)] of every parameter and buffer, in name order;
    kind is "normal", "one", "zero" or "unit" (standard normal)."""
    from vgref.models.common import LayerNorm, RMSNorm
    kinds = {}
    for mname, m in model.named_modules():
        if isinstance(m, (LayerNorm, RMSNorm)):
            pre = f"{mname}." if mname else ""
            kinds[pre + "weight"] = "one"
            if getattr(m, "bias", None) is not None:
                kinds[pre + "bias"] = "zero"
    out = [(n, tuple(p.shape), kinds.get(n, "normal"))
           for n, p in model.named_parameters()]
    out += [(n, tuple(b.shape), "unit") for n, b in model.named_buffers()]
    return sorted(out)


def make_weights(specs, seed: int, device, dtype=torch.bfloat16) -> dict:
    """name -> tensor on `device` in `dtype`. The normal leaves are views
    of one buffer filled CHUNK elements a call."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    normal = [(n, s) for n, s, k in specs if k == "normal"]
    total = sum(int(np.prod(s)) for _, s in normal)
    flat = torch.empty(total, dtype=dtype, device=device)
    for i in range(0, total, CHUNK):
        flat[i:i + CHUNK].normal_(0.0, STD, generator=g)
    out, off = {}, 0
    for n, s in normal:
        k = int(np.prod(s))
        out[n] = flat[off:off + k].view(s)
        off += k
    for n, s, kind in specs:
        if kind == "one":
            out[n] = torch.ones(s, dtype=torch.float32, device=device)
        elif kind == "zero":
            out[n] = torch.zeros(s, dtype=torch.float32, device=device)
        elif kind == "unit":
            out[n] = torch.randn(s, generator=g, device=device)
    return out


SEG_HEAD = "llm.lm_head.weight"


@torch.no_grad()
def seg_row(weights: dict, c: dict, hidden, fed, seed: int):
    """The lm_head row of [SEG] that makes greedy answers of random weights
    carry [SEG] tokens.

    Random decoders keep one direction common to every position's final
    hidden state, so a drawn [SEG] row wins everywhere or nowhere, by the
    seed. The row is a * u instead, from the reference's hidden states in
    greedy decodes, `hidden` [N, D], and in the same decodes fed [SEG] at
    every step, `fed` [N, D]: u is the direction in which `hidden` varies
    most about its mean, with the direction in which feeding [SEG] moves
    the state taken out (else one [SEG] calls up the next, and an answer
    turns into [SEG] alone), its sign drawn from the seed; a is the
    smallest scale at which [SEG] is the argmax at `mode.seg_rate` of the
    positions of `hidden`. The direction of most variance keeps a, and with
    it the rounding that the [SEG] logit amplifies, small. Returns the
    row, bf16."""
    W = weights[SEG_HEAD]
    seg = c["seg_token_idx"]
    h = hidden.float()
    best = (h @ W.float().t()).index_fill_(1, torch.tensor([seg], device=h.device),
                                           float("-inf")).max(dim=1).values
    u = torch.linalg.svd(h - h.mean(dim=0), full_matrices=False).Vh[0]
    d = fed.float().mean(dim=0) - h.mean(dim=0)
    d = d / d.norm()
    u = u - (u @ d) * d
    u = u / u.norm()
    g = torch.Generator(device=h.device).manual_seed(sub_seed(seed, "seg"))
    if torch.rand(1, generator=g, device=h.device).item() < 0.5:
        u = -u
    proj = h @ u
    ratio = torch.where(proj > 0, best / proj, torch.full_like(proj, float("inf")))
    a = torch.quantile(ratio, c["mode"]["seg_rate"])
    if not torch.isfinite(a):       # fewer positive projections than the rate
        a = ratio[torch.isfinite(ratio)].max()
    return (a * u).to(W.dtype)


@torch.no_grad()
def fill(model, weights: dict):
    """Copy every parameter and buffer of `model` from `weights` by name."""
    named = list(model.named_parameters()) + list(model.named_buffers())
    missing = [n for n, _ in named if n not in weights]
    if missing:
        raise KeyError(f"no seeded weight for {missing[:4]} "
                       f"({len(missing)} leaves)")
    for n, t in named:
        t.copy_(weights[n])
    return model
