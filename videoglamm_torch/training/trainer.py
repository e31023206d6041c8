"""Training runtime: epoch loop, meters, scalar logs, checkpoint/resume and
the two segmentation validators (PyTorch port of
videoglamm_tpu/training/trainer.py:29-197; host code and numpy).

steps_per_epoch optimizer steps per epoch, AverageMeter-aggregated loss
components to TensorBoard (when installed) and a JSONL mirror, one
checkpoint per epoch with `resume` recovering the epoch from the step
counter, and the ReasonSeg / MeViS gIoU and cIoU validation loops with the
no-object gIoU = 1 convention.

The loop also records every step in `history`, with the seconds it waited
on `next(batches)`, and every checkpoint's seconds in `ckpt_seconds`, so a
caller can see whether the loader sets the pace. The logged scalars are
the JAX trainer's.

Over several processes (a sharded step) every rank runs the loop, the
checkpoint's gathers and the validation forwards, whose collectives must
line up; only the main process logs, prints and writes files.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import time
from typing import Callable, Iterator, Optional

import numpy as np

from ..evals.metrics import AverageMeter, intersection_and_union
from ..io.checkpoint import CheckpointManager
from ..parallel.distributed import is_main_process


class ScalarLogger:
    """TensorBoard scalars (torch SummaryWriter, when tensorboard is
    installed) + a JSONL mirror."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
            self.tb = SummaryWriter(log_dir)
        except Exception:
            self.tb = None

    def log(self, tag: str, value: float, step: int):
        if self.tb is not None:
            self.tb.add_scalar(tag, value, step)
        self.jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self.jsonl.flush()


class Trainer:
    def __init__(self, train_step: Callable, state, batches: Iterator,
                 *, steps_per_epoch: int = 500, epochs: int = 10,
                 log_dir: str = "./runs", ckpt_dir: str = "./ckpts",
                 log_every: int = 10, to_device: Optional[Callable] = None,
                 val_fn: Optional[Callable] = None):
        """train_step(state, batch) -> (state, metrics), as
        `make_train_step` returns it. val_fn(state, epoch, logger) runs after
        each epoch's checkpoint."""
        self.train_step = train_step
        self.state = state
        self.batches = batches
        self.steps_per_epoch = steps_per_epoch
        self.epochs = epochs
        self.main = is_main_process()
        self.logger = ScalarLogger(log_dir) if self.main else None
        self.ckpt = CheckpointManager(ckpt_dir)
        self.log_every = log_every
        self.to_device = to_device or (lambda b: b)
        self.val_fn = val_fn
        self.start_epoch = 0
        # per step: {"step", "data_s" (wait on the loader), "step_s" (wall
        # since the previous step ended), and the metrics}
        self.history = []
        self.ckpt_seconds = []

    def resume(self):
        step = self.ckpt.latest_step()
        if step is None:
            return False
        self.state = self.ckpt.restore(self.state)
        self.start_epoch = int(step) // self.steps_per_epoch
        if self.main:
            print(f"resumed from step {step}, epoch {self.start_epoch}")
        return True

    def train(self):
        global_step = self.start_epoch * self.steps_per_epoch
        for epoch in range(self.start_epoch, self.epochs):
            meters = {k: AverageMeter(k) for k in
                      ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss",
                       "mask_loss", "step_time")}
            end = time.perf_counter()
            for it in range(self.steps_per_epoch):
                batch = self.to_device(next(self.batches))
                data_s = time.perf_counter() - end
                self.state, metrics = self.train_step(self.state, batch)
                values = {k: float(metrics[k]) for k in
                          ("loss", "ce_loss", "mask_bce_loss",
                           "mask_dice_loss", "mask_loss")}
                dt = time.perf_counter() - end
                end = time.perf_counter()
                meters["step_time"].update(dt)
                for k, v in values.items():
                    meters[k].update(v)
                global_step += 1
                self.history.append(dict(step=global_step, data_s=data_s,
                                         step_s=dt, **values))
                if self.main and (it + 1) % self.log_every == 0:
                    for k, m in meters.items():
                        self.logger.log(f"train/{k}", m.avg, global_step)
                    print(f"epoch {epoch} step {it + 1}/"
                          f"{self.steps_per_epoch} "
                          f"loss {meters['loss'].avg:.4f} "
                          f"({meters['step_time'].avg:.2f}s/it)")
            t0 = time.perf_counter()
            self.ckpt.save(global_step, self.state,
                           metadata={"epoch": epoch})
            self.ckpt_seconds.append(time.perf_counter() - t0)
            if self.val_fn is not None:
                # every rank runs the forwards; the main one reports
                quiet = contextlib.nullcontext() if self.main else \
                    contextlib.redirect_stdout(io.StringIO())
                with quiet:
                    self.val_fn(self.state, epoch, self.logger)
        return self.state


def validate_reasonseg(predict_fn: Callable, val_samples,
                       logger: Optional[ScalarLogger] = None,
                       epoch: int = 0):
    """ReasonSeg gIoU/cIoU (trainer.py:110).

    predict_fn(sample) -> (pred_masks [n, H, W] bool, gt_masks [n, H, W]
    int with 255=ignore).
    """
    inter_sum = np.zeros(2)
    union_sum = np.zeros(2)
    acc_iou_sum = np.zeros(2)
    n = 0
    for sample in val_samples:
        preds, gts = predict_fn(sample)
        for p, g in zip(preds, gts):
            i, u, _ = intersection_and_union(
                p.astype(np.int64), g.astype(np.int64), K=2,
                ignore_index=255)
            inter_sum += i
            union_sum += u
            acc = i / (u + 1e-5)
            acc[u == 0] += 1.0          # no-object target counts as IoU 1
            acc_iou_sum += acc
            n += 1
    ciou = (inter_sum / (union_sum + 1e-10))[1]
    giou = (acc_iou_sum / max(n, 1))[1]
    if logger is not None:
        logger.log("val/reason_seg/giou", giou, epoch)
        logger.log("val/reason_seg/ciou", ciou, epoch)
    print(f"reason_seg: giou: {giou:.4f}, ciou: {ciou:.4f}")
    return float(giou), float(ciou)


def validate_mevis(predict_fn: Callable, val_samples,
                   logger: Optional[ScalarLogger] = None, epoch: int = 0,
                   save_masks_dir: Optional[str] = None):
    """MeViS mid-training validator (trainer.py:144).

    predict_fn(sample) -> (pred_tube [T, H, W] bool,
                           gt_tube [T, H, W] int with 255=ignore).
    Metric mode accumulates per-frame intersection/union (cIoU) and the
    per-video mean frame IoU with the no-object-counts-as-1 convention
    (gIoU), weighting each video by its frame count. With `save_masks_dir`,
    dumps benchmark PNGs (<dir>/<video>/<exp_id>/<t:05d>.png) instead and returns
    None; samples must then carry 'video' and 'exp_id' keys.
    """
    if save_masks_dir is not None:
        from PIL import Image
        for sample in val_samples:
            pred, _ = predict_fn(sample)
            out_dir = os.path.join(save_masks_dir, sample["video"],
                                   sample["exp_id"])
            os.makedirs(out_dir, exist_ok=True)
            for t in range(pred.shape[0]):
                Image.fromarray(
                    (pred[t].astype(np.uint8)) * 255).save(
                        os.path.join(out_dir, f"{t:05d}.png"))
        return None

    inter_sum = np.zeros(2)
    union_sum = np.zeros(2)
    acc_iou_sum = np.zeros(2)
    n_frames = 0
    for sample in val_samples:
        pred, gt = predict_fn(sample)
        T = pred.shape[0]
        vid_acc = np.zeros(2)
        for t in range(T):
            i, u, _ = intersection_and_union(
                pred[t].astype(np.int64), gt[t].astype(np.int64), K=2,
                ignore_index=255)
            inter_sum += i
            union_sum += u
            acc = i / (u + 1e-5)
            acc[u == 0] += 1.0          # no-object target counts as IoU 1
            vid_acc += acc
        acc_iou_sum += vid_acc          # meter.update(mean, n=T) == sum
        n_frames += T
    ciou = (inter_sum / (union_sum + 1e-10))[1]
    giou = (acc_iou_sum / max(n_frames, 1))[1]
    if logger is not None:
        logger.log("val/mevis/giou", giou, epoch)
        logger.log("val/mevis/ciou", ciou, epoch)
    print(f"mevis: giou: {giou:.4f}, ciou: {ciou:.4f}")
    return float(giou), float(ciou)
