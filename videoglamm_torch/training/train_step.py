"""Single-card training step: freeze policy, optimizer, gradient
accumulation (PyTorch port of videoglamm_tpu/training/train_step.py:36-134
and of the model construction of videoglamm_tpu/cli/train.py:168-202).

- trainable set = LoRA(q, v) + lm_head + embed_tokens + text_hidden_fcs +
  the SAM mask decoder; everything else is frozen: `requires_grad=False`
  and no optimizer state (the `set_to_zero` of train_step.py:81-82);
- AdamW (beta 0.9 / 0.95, no weight decay), linear warm-up then linear
  decay to 0, gradient clipping by global norm, written out here to follow
  optax where it differs from torch.optim: the clip scales by
  clip / max(norm, clip) over the trainable leaves only (torch's
  `clip_grad_norm_` divides by norm + 1e-6), and the schedule is read at the
  count BEFORE the update, so with warmup_steps >= 1 the first update has
  learning rate 0;
- `grad_accum` micro-steps accumulate the MEAN gradient; the metrics are
  their mean over the micro-steps (train_step.py:124-127).

JAX arrays are immutable and its step returns a new state. Here the
parameters and the Adam moments are updated in place (one copy of the
weights on the card), and the returned state shares them.

`make_sharded_train_step` and `opt_state_partition_spec` (GSPMD over a
mesh) wait for the multi-card slice.
"""
from __future__ import annotations

import re
import time
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional

import torch

from ..config import TrainConfig, VideoGLaMMConfig
from ..models.videoglamm import VideoGLaMM

# The five patterns of train_step.py:36-39 over the port's parameter names.
# The port keeps the skip projections conv_s0/conv_s1 inside
# `visual_model.sam_mask_decoder` (the reference checkpoint's layout), the
# JAX package on SAM2Base, where its `sam_mask_decoder` pattern leaves them
# frozen; the lookahead keeps them frozen here too.
TRAINABLE_PATTERNS = (
    r"lm_head", r"embed_tokens", r"text_hidden_fcs",
    r"sam_mask_decoder\.(?!conv_s[01]\.)", r"lora_[ab]",
)

METRIC_KEYS = ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss",
               "mask_loss")


class TrainState(NamedTuple):
    step: int
    params: Dict[str, torch.Tensor]   # the model's live parameters, by name
    opt_state: Dict[str, Any]         # {"count", "mu", "nu"}, trainable only


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def trainable_mask(params, patterns=TRAINABLE_PATTERNS) -> Dict[str, bool]:
    """{parameter name: True where it trains}. params: a module or a
    mapping of named parameters."""
    rx = re.compile("|".join(patterns))
    return {name: bool(rx.search(name)) for name in _named(params)}


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """count -> learning rate: linear warm-up from 0 over `warmup_steps`,
    then linear decay to 0 over the rest (optax.join_schedules of two
    linear_schedules, train_step.py:62-69)."""
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)

    def linear(init, end, steps, count):
        if steps <= 0:
            return init
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    def schedule(count: int) -> float:
        if count < cfg.warmup_steps:
            return linear(0.0, cfg.lr, cfg.warmup_steps, count)
        return linear(cfg.lr, 0.0, decay_steps, count - cfg.warmup_steps)

    return schedule


class AdamW:
    """optax.chain(clip_by_global_norm, adamw(schedule)) over the trainable
    parameters (train_step.py:72-82). `init` makes the state, `update_`
    applies one update in place."""

    eps = 1e-8

    def __init__(self, cfg: TrainConfig, trainable):
        self.cfg = cfg
        self.trainable = tuple(trainable)
        self.schedule = lr_schedule(cfg)

    def init(self, params) -> Dict[str, Any]:
        params = _named(params)
        return {"count": 0,
                "mu": {n: torch.zeros_like(params[n]) for n in self.trainable},
                "nu": {n: torch.zeros_like(params[n]) for n in self.trainable}}

    @torch.no_grad()
    def update_(self, params, grads: Mapping[str, torch.Tensor], opt_state):
        """params, opt_state["mu"], opt_state["nu"] are updated in place;
        `grads` are consumed (clipped in place)."""
        cfg = self.cfg
        names = self.trainable
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        mu = [opt_state["mu"][n] for n in names]
        nu = [opt_state["nu"][n] for n in names]
        # clip_by_global_norm: g / norm * clip where norm >= clip
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(g)))
        clipped = norm >= cfg.grad_clip
        torch._foreach_div_(g, torch.where(clipped, norm, 1.0))
        torch._foreach_mul_(g, torch.where(clipped, cfg.grad_clip, 1.0))
        # scale_by_adam
        count = opt_state["count"]
        torch._foreach_mul_(mu, cfg.beta1)
        torch._foreach_add_(mu, g, alpha=1.0 - cfg.beta1)
        torch._foreach_mul_(nu, cfg.beta2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - cfg.beta2)
        c1 = 1.0 - cfg.beta1 ** (count + 1)
        c2 = 1.0 - cfg.beta2 ** (count + 1)
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, c1)
        torch._foreach_div_(upd, denom)
        if cfg.weight_decay:
            torch._foreach_add_(upd, p, alpha=cfg.weight_decay)
        # the schedule is read at the count before the update
        torch._foreach_add_(p, upd, alpha=-self.schedule(count))
        opt_state["count"] = count + 1


def make_optimizer(cfg: TrainConfig, params,
                   patterns=TRAINABLE_PATTERNS) -> AdamW:
    mask = trainable_mask(params, patterns)
    return AdamW(cfg, [n for n, m in mask.items() if m])


def create_train_state(params, tx: AdamW) -> TrainState:
    params = _named(params)
    return TrainState(step=0, params=params, opt_state=tx.init(params))


def make_train_step(model, tx: AdamW, grad_accum: int = 1):
    """Returns train_step(state, batch) -> (state, metrics). `batch` is the
    keyword arguments of the model's training forward; with grad_accum > 1
    every entry has a leading micro-batch axis of that length. The state's
    parameters must be the model's own (`create_train_state(model, tx)`).
    metrics: 0-d tensors (reading one synchronises). With a `timings` dict,
    the forward, backward and optimizer stages are synchronised and their
    wall seconds added up there."""
    trainable = set(tx.trainable)
    for name, p in model.named_parameters():
        p.requires_grad_(name in trainable)

    def train_step(state: TrainState, batch, timings: Optional[dict] = None):
        def clock(stage, t0):
            if timings is None:
                return t0
            if next(iter(state.params.values())).is_cuda:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            timings[stage] = timings.get(stage, 0.0) + t1 - t0
            return t1

        for p in state.params.values():
            p.grad = None
        sums = None
        t = time.perf_counter()
        for i in range(grad_accum):
            mb = batch if grad_accum == 1 else {k: v[i] for k, v in batch.items()}
            out = model(**mb)
            t = clock("forward", t)
            out.loss.backward()       # gradients add up in .grad
            t = clock("backward", t)
            vals = torch.stack([getattr(out, k).detach().float()
                                for k in METRIC_KEYS])
            sums = vals if sums is None else sums + vals
        # a trainable leaf that the loss does not reach (the mask decoder's
        # IoU and object-score heads) has a zero gradient, as in jax.grad
        grads = {n: (state.params[n].grad if state.params[n].grad is not None
                     else torch.zeros_like(state.params[n]))
                 for n in tx.trainable}
        if grad_accum > 1:
            torch._foreach_div_(list(grads.values()), float(grad_accum))
        tx.update_(state.params, grads, state.opt_state)
        for p in state.params.values():
            p.grad = None
        metrics = dict(zip(METRIC_KEYS, (sums / grad_accum).unbind(0)))
        clock("optimizer", t)
        return TrainState(state.step + 1, state.params, state.opt_state), metrics

    return train_step


class Training(NamedTuple):
    model: VideoGLaMM
    tx: AdamW
    state: TrainState
    train_step: Callable


def build_training(cfg: VideoGLaMMConfig, tcfg: TrainConfig,
                   state_dict: Optional[Mapping] = None, *, device="cuda",
                   dtype=torch.bfloat16,
                   init: Optional[Callable] = None) -> Training:
    """Build a VideoGLaMM for training on `device`: LoRA of rank
    `tcfg.lora.r` on the LLM's q and v, remat of the LLM's layers, the
    weights grafted from `state_dict`, the freeze policy, the optimizer, a
    fresh state and the step over `tcfg.grad_accum_steps` micro-steps.

    device: the card by default; a CUDA device with no card present raises
    (there is no silent CPU). Pass "cpu" to run the plain twins.
    state_dict: the port's float weights. One without LoRA entries (an
    inference checkpoint) is grafted into the freshly initialised model,
    whose LoRA B is zero; any other missing or unexpected key raises.
    Without one, `init` (a callable that fills the model in place) or
    torch's default initialisation stands in.
    dtype: the compute dtype. Frozen weights are stored in it; trainable
    ones keep f32 masters and are cast at use."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"build_training: device {device!r} asked for, but no CUDA "
            "device is present; pass device='cpu' to run on the CPU")
    with torch.device(dev):
        model = VideoGLaMM(cfg, remat_llm=True, lora_rank=tcfg.lora.r,
                           lora_alpha=float(tcfg.lora.alpha))
    model.to(dev)     # tensors made from numpy ignore the device context
    if state_dict is not None:
        res = model.load_state_dict(state_dict, strict=False)
        bad = [k for k in res.missing_keys if not re.search(r"lora_[ab]", k)]
        if bad or res.unexpected_keys:
            raise ValueError(f"build_training: state_dict does not fit: "
                             f"missing {bad}, unexpected {res.unexpected_keys}")
    elif init is not None:
        init(model)
    if dtype != torch.float32:
        model.to_compute_dtype(dtype, keep_masters=True)
    tx = make_optimizer(tcfg, model)
    state = create_train_state(model, tx)
    return Training(model, tx, state,
                    make_train_step(model, tx, tcfg.grad_accum_steps))
