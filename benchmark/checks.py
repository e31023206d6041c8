"""The comparisons that decide `correct`.

Serving: the reference (benchmark/reference/vgref, f32, TF32 off) makes the
weights again from the seed, quantises the LLM as the configuration states,
and follows a sample of the done requests through the same prompt and the
served tokens (`vgref.serve.follow`). Compared, each against its limit in
the configuration file's `limits`:
  token_gap_sd      the widest gap by which a served token's logit lies below
                    the reference's best at that position, in standard
                    deviations of the reference's logits there;
  mask_rel_l2       the relative L2 distance of the served mask logits from
                    the reference's, over every [SEG] slot that holds one
                    (a multimask choice between candidates that the
                    configuration's precision cannot order goes either
                    way: `judged_reference`);
  seg_slot_mismatch the [SEG] slots the program marked valid where the
                    reference, reading the same tokens, does not, or the
                    reverse (exact: 0).
With `control`, the reference again with its LLM in int4 (the next
precision below the configuration's int8) is put in the program's place and
read the same way against the reference, on the same prompts and served
tokens: the gap of the token that it puts first at each position, its
masks, its [SEG] slots; it is judged by the same limits.

Training: `train` (below) holds the first steps' losses, gradients and
parameter changes to the reference's."""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
import typing

import numpy as np
import torch

import harness
import workload_gen as gen
from weights import SEG_HEAD, leaf_specs, make_weights, seg_row


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuBLAS and cuDNN while the reference runs."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm


def program_config(c: dict, cls_name: str = "VideoGLaMMConfig"):
    """The program's config dataclass from the configuration file."""
    from videoglamm_torch import config as pc
    return build_config(pc, c, cls_name)


def reference_specs(c: dict):
    import vgref.config
    from vgref.models.videoglamm import VideoGLaMM as RefModel
    cfg = build_config(vgref.config, c)
    with torch.device("meta"):
        return cfg, leaf_specs(RefModel(cfg, lora_rank=c["mode"].get("lora_r", 0)))


def seeded_weights(c: dict, tr: dict, seed: int, device, seg=None,
                   timing: dict = None):
    """The cell's weights from the seed. A serving configuration's [SEG]
    row is shaped from the reference's hidden states in a greedy decode of
    a batch of the traffic's `seg_calibration` = [requests, steps] warm-up
    requests, which the warm-up does not serve, or set to `seg`, the row an
    earlier call returned. That decode is the reference's work, not the
    program's: its seconds go to timing["seg_row_s"]. Returns (weights,
    seg row or None)."""
    from vgref import serve as ref
    cfg, specs = reference_specs(c)
    w = make_weights(specs, seed, device)
    if "seg_rate" not in c["mode"]:
        return w, None
    if seg is None:
        t0 = time.time()
        n, steps = tr["seg_calibration"]
        warm = seed_of_warm(seed)
        with exact_f32():
            model = ref.build(cfg, w, c["mode"].get("quant", "none"),
                              c["mode"].get("kv_cache") == "int8", device)
            raw, ids, lens = gen.clip_batch(tr, warm, tr["batch"],
                                            gen.prompt_lengths(tr, warm, n),
                                            device)
            hidden, fed = ref.greedy_hidden(model, raw, ids, lens, steps,
                                            tr["sam_frames"], c["seg_token_idx"])
            del model, raw
            gc.collect()
            seg = seg_row(w, c, hidden, fed, seed)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        if timing is not None:
            timing["seg_row_s"] = time.time() - t0
    w[SEG_HEAD][c["seg_token_idx"]] = seg
    return w, seg


def seed_of_warm(seed: int) -> int:
    """The seed of the warm-up requests, which the window never serves."""
    from weights import sub_seed
    return sub_seed(seed, "warm")


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def build_config(mod, d: dict, cls_name: str = "VideoGLaMMConfig"):
    """A config dataclass of module `mod` (the program's or the reference's
    config.py) from the file's dict: the fields the class has, nested
    dataclasses built alike, lists as tuples."""
    cls = getattr(mod, cls_name)
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        t = hints[f.name]
        if dataclasses.is_dataclass(t):
            kw[f.name] = build_config(mod, d[f.name], t.__name__)
        else:
            kw[f.name] = _tuples(d[f.name])
    return cls(**kw)


def sample_requests(lengths: list, n: int, seed: int, has_seg) -> list:
    """n done requests drawn from the seed, the one with the longest prompt
    (and so the longest served sequence) always among them; where none of
    them carries a [SEG] slot, the first two requests in the seed's order
    that do are added, so that the masks are compared."""
    longest = int(np.argmax(lengths))
    rest = [i for i in range(len(lengths)) if i != longest]
    order = np.random.default_rng(seed).permutation(rest).tolist()
    pick = [longest] + order[:n - 1]
    if not any(bool(has_seg[i]) for i in pick):
        pick += [i for i in order[n - 1:] if bool(has_seg[i])][:2]
    return sorted(pick)


def _gaps(logits, tokens):
    """(max - logit of the token) / std, per position; a position whose
    logits are not finite reads inf."""
    lg = logits.float()
    best = lg.max(dim=-1).values
    got = lg.gather(1, tokens[:, None].long())[:, 0]
    return torch.nan_to_num((best - got) / lg.std(dim=-1), nan=float("inf"))


def serve(c: dict, tr: dict, seed: int, seg, got: list, lengths: list,
          device, control: bool = False) -> list:
    """got: [(request index, served tokens, seg_valid, masks)] of the
    sample; seg: the [SEG] row of set-up. Returns ([(name, value, limit)]
    of the program, the same of the control or None)."""
    from vgref import serve as ref
    lim = c["limits"]
    mode = c["mode"]
    with exact_f32():
        weights, _ = seeded_weights(c, tr, seed, device, seg)
        cfg, _ = reference_specs(c)
        kinds = [mode["quant"]] + (["int4"] if control else [])
        models = {q: ref.build(cfg, weights, q, mode["kv_cache"] == "int8", device)
                  for q in kinds}
        del weights
        gc.collect()
        gap = 0.0
        mism = 0
        num = den = 0.0
        cgap = cnum = cden = 0.0
        cmism = 0
        for i, served, valid, masks in got:
            raw, ids = gen.clip_request(tr, seed, i, lengths[i], device)
            served = served.to(device)
            f = ref.follow(models[mode["quant"]], raw, ids, served,
                           tr["sam_frames"], tr["new_tokens"])
            if served.numel():
                gap = max(gap, float(_gaps(f.logits, served).max()))
            v_ref = f.seg_valid.cpu()
            mism += int((v_ref != valid).sum())
            both = (v_ref & valid)
            slots, moved = [], 0
            if bool(both.any()):
                r, moved = judged_reference(masks, f, c["sam2"])
                r = r[both]
                d = (masks[both].float() - r).flatten(1).pow(2).sum(1)
                n = r.flatten(1).pow(2).sum(1)
                num += float(d.sum())
                den += float(n.sum())
                slots = (d / n).sqrt().tolist()
            harness.log(f"request {i}: prompt {lengths[i]}, served {served.numel()}, "
                        f"[SEG] {int((served == c['seg_token_idx']).sum())}, "
                        f"mask rel L2 by slot {[round(x, 4) for x in slots]}, "
                        f"{moved} slot-frames judged against a tied candidate")
            if control and served.numel():
                g = ref.follow(models["int4"], raw, ids, served,
                               tr["sam_frames"], tr["new_tokens"])
                first = g.logits.argmax(dim=-1)
                cgap = max(cgap, float(_gaps(f.logits, first).max()))
                cmism += int((g.seg_valid != f.seg_valid).sum())
                if bool(f.seg_valid.any()):
                    gm = g.masks.float().cpu()
                    r = judged_reference(gm, f, c["sam2"])[0]
                    v = f.seg_valid.cpu()
                    cnum += float((gm - r)[v].pow(2).sum())
                    cden += float(r[v].pow(2).sum())
        rel = (num / den) ** 0.5 if den > 0 else float("inf")
        out = [("token_gap_sd", gap, lim["token_gap_sd"]),
               ("mask_rel_l2", rel, lim["mask_rel_l2"]),
               ("seg_slot_mismatch", mism, 0)]
        ctl = None
        if control:
            ctl = [("token_gap_sd", cgap, lim["token_gap_sd"]),
                   ("mask_rel_l2", (cnum / cden) ** 0.5 if cden else float("inf"),
                    lim["mask_rel_l2"]),
                   ("seg_slot_mismatch", cmism, 0)]
            harness.log(f"control (reference, LLM int4): {ctl}")
        return out, ctl


def _stability(m, delta: float):
    """SAM-2's stability score of mask logits [..., h, w]."""
    flat = m.flatten(-2)
    inner = (flat > delta).sum(-1).float()
    outer = (flat > -delta).sum(-1).float()
    return torch.where(outer > 0, inner / outer.clamp(min=1.0), 1.0)


# SAM-2 serves, for a prompt whose single mask is unstable, the multimask
# candidate of the highest predicted IoU. On seeded weights the three
# predictions all lie within 0.004 of 0.5, where bf16 (the configuration's
# compute type) has a spacing of 2**-9 and cannot order them: candidates
# within that of the best are tied, and a served mask is judged against
# the tied candidate nearest it.
IOU_TIE = 2.0 ** -9


def judged_reference(served, f, sam2: dict):
    """The reference's masks [max_seg, T, h, w] that the served masks
    [max_seg, T, h, w] are compared with: the reference's own, but where
    the single mask is unstable, the multimask candidate nearest the
    served mask among those whose predicted IoU lies within IOU_TIE of the
    highest. Returns (masks, slot-frames judged against another candidate
    than the reference's own choice)."""
    ref = f.masks.float().cpu()
    if f.candidates is None:
        return ref, 0
    cm, ci = (t.float().cpu() for t in f.candidates)
    unstable = _stability(cm[:, :, 0], sam2["dynamic_multimask_stability_delta"]) \
        < sam2["dynamic_multimask_stability_thresh"]
    multi, iou = cm[:, :, 1:], ci[:, :, 1:]
    tied = iou >= iou.max(dim=-1, keepdim=True).values - IOU_TIE
    d = (served.float()[:, :, None] - multi).pow(2).sum(dim=(-2, -1))
    k = torch.where(tied, d, float("inf")).argmin(dim=-1)
    pick = torch.gather(multi, 2, k[:, :, None, None, None].expand(
        -1, -1, 1, *multi.shape[-2:]))[:, :, 0]
    moved = unstable & (k != iou.argmax(dim=-1))
    return torch.where(unstable[..., None, None], pick, ref), int(moved.sum())


def _worst_leaf(prog: dict, ref: dict, names) -> tuple:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's."""
    med = float(np.median([ref[n] for n in names]))
    worst, leaf = 0.0, None
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med)
        if gap > worst:
            worst, leaf = gap, n
    return worst, leaf


def _fp8(t):
    """t rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude to 448), the gradient passed straight through."""
    scale = t.detach().abs().amax().clamp(min=1e-12) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach()


@contextlib.contextmanager
def fp8_products():
    """Every F.linear of the reference on fp8-rounded operands: the control
    of a bf16 configuration."""
    import torch.nn.functional as nnf
    real = nnf.linear

    def linear(x, w, b=None):
        return real(_fp8(x), _fp8(w), b)

    nnf.linear = linear
    try:
        yield
    finally:
        nnf.linear = real


_ROWS = ("input_ids", "text_lens", "labels", "video_idx", "gt_masks")


def _follow_train(c: dict, tr: dict, seed: int, steps: int, device,
                  half: bool = False):
    """The reference's first `steps` steps: (losses, the first step's
    clipped gradient norm of every trainable leaf, each leaf's change).
    half: the fault that leaves half of every micro-batch's rows out, the
    mean taken over the rest."""
    from vgref import train as rt
    from vgref.models.videoglamm import VideoGLaMM as RefModel
    from weights import fill
    mode = c["mode"]
    t = mode["train"]
    weights, _ = seeded_weights(c, tr, seed, device)
    cfg, _ = reference_specs(c)
    with torch.device(device):
        model = RefModel(cfg, remat_llm=True, lora_rank=mode["lora_r"],
                         lora_alpha=float(mode["lora_alpha"]))
    model.to(device)
    fill(model, weights)
    del weights
    names = rt.trainable_names(model)
    params = dict(model.named_parameters())
    for n, p in params.items():
        p.requires_grad_(n in names)
    start = {n: params[n].detach().clone() for n in names}
    opt = rt.AdamW(t, params, names)
    losses, g1 = [], None
    for step in range(steps):
        micro = [{k: (v.float() if v.is_floating_point() else v)
                  for k, v in gen.train_micro(tr, c, seed, step, i, device).items()}
                 for i in range(t["grad_accum_steps"])]
        if half:
            micro = [{k: (v[:v.shape[0] // 2] if k in _ROWS else v)
                      for k, v in mb.items()} for mb in micro]
        grads, metrics = rt.gradients(model, names, micro)
        losses.append(metrics[0])
        opt.update_(params, grads)
        del grads
        if step == 0:
            g1 = {n: float(opt.mu[n].norm()) / (1.0 - t["beta1"]) for n in names}
    moved = {n: float((params[n].detach() - start[n]).norm()) for n in names}
    del model, params, start, opt
    gc.collect()
    return losses, g1, moved


def _train_numbers(losses, grad, change, ref_losses, g1, moved, names):
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    gmed = float(np.median([g1[n] for n in names]))
    kept = [n for n in names if g1[n] >= 1e-3 * gmed]
    ggap, gleaf = _worst_leaf(grad, g1, names)
    cgap, cleaf = _worst_leaf(change, moved, kept)
    return loss_rel, ggap, cgap, gleaf, cleaf, len(names) - len(kept)


def train(c: dict, tr: dict, seed: int, losses: list, first_grad: dict,
          change: dict, device, control: bool = False) -> list:
    """The reference takes the same first steps in f32 from the same
    weights and micro-batches. Compared: each step's loss (relative); the
    first step's gradient of every trainable leaf as the optimizer took it
    (clipped), by its norm; each leaf's change over the steps, by its norm,
    leaving out the leaves whose reference gradient is under a thousandth
    of the median leaf's (they move by round-off alone under Adam). A
    leaf's gap is taken against the larger of its reference norm and the
    median leaf's. With `control`, the reference again with every product
    on fp8-rounded operands reads the same numbers, and so does the
    reference with half of every micro-batch's rows left out. Returns
    ([(name, value, limit)] of the program, the same of the fp8 control,
    judged by the same limits, or None)."""
    lim = c["limits"]
    with exact_f32():
        ref_losses, g1, moved = _follow_train(c, tr, seed, len(losses), device)
        names = sorted(g1)
        loss_rel, ggap, cgap, gleaf, cleaf, out = _train_numbers(
            losses, first_grad, change, ref_losses, g1, moved, names)
        harness.log(f"train check: losses {losses} against {ref_losses}; worst "
                    f"gradient leaf {gleaf}, worst change leaf {cleaf}; {out} "
                    f"leaves left out of the change")
        ctl = None
        if control:
            with fp8_products():
                cl, cg, cm = _follow_train(c, tr, seed, len(losses), device)
            r = _train_numbers(cl, cg, cm, ref_losses, g1, moved, names)
            ctl = [("loss_rel", r[0], lim["loss_rel"]),
                   ("grad_norm_gap", r[1], lim["grad_norm_gap"]),
                   ("change_norm_gap", r[2], lim["change_norm_gap"])]
            harness.log(f"control (reference, fp8 products): {ctl}; worst "
                        f"leaves {r[3]}, {r[4]}")
            hl, hg, hm = _follow_train(c, tr, seed, len(losses), device, half=True)
            r = _train_numbers(hl, hg, hm, ref_losses, g1, moved, names)
            harness.log(f"fault (reference, half of each micro-batch's rows): "
                        f"loss_rel {r[0]!r}, grad_norm_gap {r[1]!r}, "
                        f"change_norm_gap {r[2]!r}")
    return [("loss_rel", loss_rel, lim["loss_rel"]),
            ("grad_norm_gap", ggap, lim["grad_norm_gap"]),
            ("change_norm_gap", cgap, lim["change_norm_gap"])], ctl
