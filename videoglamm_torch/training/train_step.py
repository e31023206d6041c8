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

`make_sharded_train_step` runs the same step over a (data, model) mesh of
processes (train_step.py:137-209, where GSPMD inserts the collectives):

- the parameters are sharded over `model` by `parallel.shard_params`
  (Phi-3 tensor-parallel, the other split weights gathered at use);
- each data rank takes its videos of the batch and the rows that point at
  them (`split_batch`), and divides its losses by the whole batch's token
  and mask counts, so the ranks' losses add up to the batch's loss; a
  batch whose videos do not divide over `data` runs whole on every rank,
  as JAX replicates a leaf that does not divide;
- the gradients are summed over `data` (where the batch was split), and
  LoRA's, which each model rank holds in part, over `model`; the clip
  reads the global norm;
- ZeRO-2: each data rank keeps the AdamW moments of its dim-0 slice of
  every parameter that `opt_state_partition_spec` splits over `data`,
  updates that slice and all-gathers it over `data`.

On a (1, 1) mesh the collectives are not issued and the step is
`make_train_step`'s, bit for bit.
"""
from __future__ import annotations

import re
import time
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional

import torch

from ..config import TrainConfig, VideoGLaMMConfig
from ..models.common import full_precision, set_exact_f32
from ..models.videoglamm import VideoGLaMM, ce_target_count
from ..parallel import collectives
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from ..parallel.partitioning import (Sharding, _divisible,
                                     param_partition_spec, shard_params)

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


class StateSharding(NamedTuple):
    """How a sharded step's state is laid out: the mesh, the parameters'
    splits over `model` ({name: Sharding}) and the moments' dim-0 slices
    over `data` ({name: (first row, rows)})."""
    mesh: Mesh
    model: Dict[str, Sharding]
    data: Dict[str, tuple]


class TrainState(NamedTuple):
    step: int
    params: Dict[str, torch.Tensor]   # the model's live parameters, by name
    opt_state: Dict[str, Any]         # {"count", "mu", "nu"}, trainable only
    sharding: Optional[StateSharding] = None   # a sharded step's layout


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
    def update_(self, params, grads: Mapping[str, torch.Tensor], opt_state,
                norm=None):
        """params, opt_state["mu"], opt_state["nu"] are updated in place;
        `grads` are consumed (clipped in place). norm: the gradients' global
        norm where `grads` hold only part of them (a sharded step's)."""
        cfg = self.cfg
        names = self.trainable
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        mu = [opt_state["mu"][n] for n in names]
        nu = [opt_state["nu"][n] for n in names]
        # clip_by_global_norm: g / norm * clip where norm >= clip
        if norm is None:
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
    wall seconds added up there. A model whose compute dtype is f32 steps
    with TF32 off (`full_precision`)."""
    return _step_fn(model, tx, grad_accum)


def _step_fn(model, tx: AdamW, grad_accum: int,
             sharding: Optional[StateSharding] = None, partial=()):
    """The step of `make_train_step`, and over a mesh that of
    `make_sharded_train_step` (`sharding`; `partial`: the trainable leaves
    whose gradient each model rank holds in part)."""
    trainable = set(tx.trainable)
    for name, p in model.named_parameters():
        p.requires_grad_(name in trainable)
    f32 = model.exact_f32
    names = tx.trainable
    zero = sharding.data if sharding is not None else {}

    def train_step(state: TrainState, batch, timings: Optional[dict] = None):
        with full_precision(f32):
            clock = _Clock(state, timings)
            grads, sums = _gradients(model, tx, state, batch, grad_accum, clock)
            norm = None
            if sharding is not None:
                norm = _reduce_grads(grads, sums, names, sharding, partial,
                                     split="ce_norm" in batch)
            # ZeRO-2: each data rank updates the rows its moments cover
            p = {n: (state.params[n].narrow(0, *zero[n]) if n in zero
                     else state.params[n]) for n in names}
            g = {n: (grads[n].narrow(0, *zero[n]) if n in zero else grads[n])
                 for n in names}
            tx.update_(p, g, state.opt_state, norm=norm)
            if zero:
                _all_gather_rows_(state.params, [n for n in names if n in zero],
                                  zero, sharding.mesh.axis(DATA_AXIS))
            for t in state.params.values():
                t.grad = None
            metrics = dict(zip(METRIC_KEYS, (sums / grad_accum).unbind(0)))
            clock("optimizer")
        return TrainState(state.step + 1, state.params, state.opt_state,
                          state.sharding), metrics

    return train_step


@torch.no_grad()
def _reduce_grads(grads, sums, names, sharding: StateSharding, partial,
                  split: bool):
    """Sum the gradients (and the metrics) over `data` where each rank took
    its rows, and the `partial` ones over `model`; returns the global norm:
    the squared norms of the leaves split over `model` summed over it,
    replicated leaves counted once."""
    data = sharding.mesh.axis(DATA_AXIS)
    mdl = sharding.mesh.axis(MODEL_AXIS)
    if split:
        _all_reduce_flat([grads[n] for n in names] + [sums], data)
    _all_reduce_flat([grads[n] for n in partial], mdl)
    norms = list(torch._foreach_norm([grads[n] for n in names]))
    own = [i for i, n in enumerate(names) if n in sharding.model]
    if own and mdl.size > 1:
        sq = torch.stack([norms[i] for i in own]) ** 2
        collectives.all_reduce_(sq, mdl)
        for j, i in enumerate(own):
            norms[i] = sq[j].sqrt()
    return torch.linalg.vector_norm(torch.stack(norms))


class _Clock:
    """With a `timings` dict, synchronise and add each stage's wall seconds
    there; without one, nothing."""

    def __init__(self, state: TrainState, timings: Optional[dict]):
        self.timings = timings
        self.cuda = next(iter(state.params.values())).is_cuda
        self.t = time.perf_counter()

    def __call__(self, stage: str):
        if self.timings is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        self.timings[stage] = self.timings.get(stage, 0.0) + t - self.t
        self.t = t


def _gradients(model, tx: AdamW, state: TrainState, batch, grad_accum: int,
               clock: _Clock):
    """The micro-steps' forwards and backwards: ({trainable name: mean
    gradient}, the metrics summed over the micro-steps [5])."""
    for p in state.params.values():
        p.grad = None
    sums = None
    for i in range(grad_accum):
        mb = batch if grad_accum == 1 else {k: v[i] for k, v in batch.items()}
        out = model(**mb)
        clock("forward")
        out.loss.backward()       # gradients add up in .grad
        clock("backward")
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
    return grads, sums


def opt_state_partition_spec(opt_state, params_spec: Mapping[str, tuple],
                             mesh: Mesh) -> Dict[str, Any]:
    """ZeRO-2 specs of the AdamW state (train_step.py:137-164): a moment
    keeps its parameter's `model` spec where it has one that divides,
    otherwise its dim 0 is split over `data` where that divides, else it is
    replicated; `count` is replicated. opt_state: the full (unsharded)
    state; params_spec: `param_partition_spec(model, mesh)`."""
    def spec(name, t):
        shape = tuple(t.shape)
        if not shape:
            return ()
        base = params_spec.get(name, ())
        if base and _divisible(shape, base, mesh):
            return base
        if shape[0] % mesh.shape[DATA_AXIS] == 0:
            return (DATA_AXIS,) + (None,) * (len(shape) - 1)
        return ()

    return {"count": (),
            "mu": {n: spec(n, t) for n, t in opt_state["mu"].items()},
            "nu": {n: spec(n, t) for n, t in opt_state["nu"].items()}}


# the batch entries indexed by video, and by conversation row
_VIDEO_KEYS = ("frames", "context_images", "frames_sam")
_ROW_KEYS = ("input_ids", "text_lens", "labels", "gt_masks")


def _split_micro(mb, data) -> Optional[dict]:
    """This data rank's part of one micro-batch: its videos, the rows that
    point at them (video_idx re-based), and the whole micro-batch's loss
    divisors; None where the videos do not divide or a rank would get no
    row."""
    unknown = set(mb) - set(_VIDEO_KEYS + _ROW_KEYS + ("video_idx",))
    if unknown:
        raise ValueError(f"split_batch: unknown batch entries {sorted(unknown)}")
    Bv = mb["frames"].shape[0]
    if Bv % data.size:
        return None
    per = Bv // data.size
    vid = mb["video_idx"]
    owner = vid.div(per, rounding_mode="floor")
    if any(int((owner == d).sum()) == 0 for d in range(data.size)):
        return None
    lo = data.index * per
    rows = (owner == data.index).nonzero()[:, 0]
    out = {k: mb[k][lo:lo + per] for k in _VIDEO_KEYS}
    out.update({k: mb[k][rows] for k in _ROW_KEYS})
    out["video_idx"] = vid[rows] - lo
    gt = mb["gt_masks"]
    out["ce_norm"] = ce_target_count(mb["input_ids"], mb["text_lens"],
                                     mb["labels"])
    out["mask_norm"] = gt.shape[0] * gt.shape[1] * gt.shape[2]
    return out


def split_batch(batch, mesh: Mesh, grad_accum: int = 1):
    """The global batch -> this data rank's part (`_split_micro` for every
    micro-step; with grad_accum > 1 each entry a list over the micro-steps,
    whose row counts may differ). Where one micro-step does not split,
    every rank takes the whole batch, which then carries no divisors."""
    data = mesh.axis(DATA_AXIS)
    if data.size == 1:
        return batch
    if grad_accum == 1:
        part = _split_micro(batch, data)
        return batch if part is None else part
    parts = [_split_micro({k: v[i] for k, v in batch.items()}, data)
             for i in range(grad_accum)]
    if any(p is None for p in parts):
        return batch
    return {k: [p[k] for p in parts] for k in parts[0]}


@torch.no_grad()
def _all_reduce_flat(tensors, axis):
    """Sum a list of tensors over the axis with one all-reduce a dtype."""
    if axis.size == 1 or not tensors:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        collectives.all_reduce_(flat, axis)
        torch._foreach_copy_(ts, [f.view_as(t) for f, t in
                                  zip(flat.split([t.numel() for t in ts]), ts)])


@torch.no_grad()
def _all_gather_rows_(params, names, zero, axis):
    """Every data rank updated the dim-0 slice `zero[name]` of each named
    parameter: gather the slices back into the whole, one all-gather a
    dtype."""
    if axis.size == 1 or not names:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for n in names:
        by_dtype.setdefault(params[n].dtype, []).append(n)
    for ns in by_dtype.values():
        mine = torch.cat([params[n].narrow(0, *zero[n]).reshape(-1) for n in ns])
        every = collectives.all_gather(mine, axis)          # [data, sum]
        off = 0
        for n in ns:
            k = params[n].numel() // axis.size
            params[n].view(axis.size, k).copy_(every[:, off:off + k])
            off += k


def make_sharded_train_step(model, tx: AdamW, mesh: Mesh, state: TrainState,
                            example_batch=None, grad_accum: int = 1):
    """The train step over `mesh` (train_step.py:167-209; module
    docstring). Shards `model` in place (`shard_params`) and the state's
    moments; state: `create_train_state(model, tx)` of the unsharded model.
    Returns (fn, sharded_state, batch_split): fn(state, batch) takes this
    rank's part of the batch, which batch_split(global_batch) gives;
    every rank calls fn, and the metrics are the whole batch's.
    example_batch: unused (the split is by videos, read from each batch);
    kept for the JAX signature."""
    del example_batch
    data = mesh.axis(DATA_AXIS)
    pspec = param_partition_spec(model, mesh)
    ospec = opt_state_partition_spec(state.opt_state, pspec, mesh)
    splits = shard_params(model, mesh)
    params = _named(model)
    zero = {}
    opt = {"count": state.opt_state["count"], "mu": {}, "nu": {}}
    for n in tx.trainable:
        for k in ("mu", "nu"):
            m = state.opt_state[k][n]
            if n in splits:
                m = splits[n].take(m)
            elif ospec[k][n][:1] == (DATA_AXIS,):
                rows = m.shape[0] // data.size
                zero[n] = (data.index * rows, rows)
                m = m.narrow(0, *zero[n]).clone()
            opt[k][n] = m
    # LoRA on a tensor-parallel attention: each model rank holds the part
    # of its gradient that its heads give
    partial = [n for n in tx.trainable if n not in splits and
               re.search(r"lora_[ab]", n) and
               getattr(model.get_submodule(n.rsplit(".", 2)[0]), "tp", None)
               is not None]
    sharding = StateSharding(mesh, dict(splits), zero)
    step = _step_fn(model, tx, grad_accum, sharding, partial)
    return (step, TrainState(state.step, params, opt, sharding),
            lambda b: split_batch(b, mesh, grad_accum))


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
    ones keep f32 masters and are cast at use. An f32 model takes the
    full-precision f32 routes of K1 (with the LSE), K2 and K6 on the card
    (`models.common.set_exact_f32`) and steps with TF32 off."""
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
        model.load_weights(state_dict, allow_missing=re.compile(r"lora_[ab]"))
    elif init is not None:
        init(model)
    if dtype != torch.float32:
        model.to_compute_dtype(dtype, keep_masters=True)
    set_exact_f32(model, dtype == torch.float32)
    tx = make_optimizer(tcfg, model)
    state = create_train_state(model, tx)
    return Training(model, tx, state,
                    make_train_step(model, tx, tcfg.grad_accum_steps))
