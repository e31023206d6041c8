"""Grounded fine-tuning entry point of the port (videoglamm_tpu/cli/train.py).

Dataset files -> raw records -> `SampleBuilder` -> `HybridDataset` ->
collated micro-batches, stacked `--grad_accum` at a time -> prefetched onto
the card by a worker thread -> `build_training`'s step (the loaded
inference weights grafted into a model with LoRA on the LLM's q and v) ->
`Trainer`: a checkpoint each epoch, then the MeViS / ReasonSeg validators.

The model runs on the card unless `--device cpu` asks for the CPU;
`--precision f32` trains in full f32 there (the f32 routes of K1, K2 and
K6). The step is `make_sharded_train_step` over the (data, model) mesh of
every process (`--model_parallel` ranks on the model axis; a world that it
does not divide raises the mesh's ValueError); one process is the mesh
(1, 1), the single-card step bit for bit. Each rank builds the same global
batch from the same seed and keeps its part: the host loader runs on every
rank. `--quant` other than none raises (quantised weights do not train).
Otherwise the JAX CLI's flags mean what they mean there.

Usage:
  python -m videoglamm_torch.cli.train --checkpoint CKPT --tokenizer TOK \\
      --gcg_json .../train.json --gcg_frames .../frames \\
      [--refer_vos_root ROOT] [--reason_seg_root ROOT] \\
      --ckpt_dir ./ckpts --log_dir ./runs
  torchrun --nproc_per_node N -m videoglamm_torch.cli.train \\
      --model_parallel M ...     (N cards, M of them on the model axis)
"""
from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Iterator, List

import numpy as np
import torch

from ..config import LoRAConfig, TrainConfig, VideoGLaMMConfig
from ..constants import MASK_IGNORE_INDEX
from ..data.collate import build_batch
from ..data.datasets import (A2DSentencesDataset, DatasetSpec, GCGVideoDataset,
                             HybridDataset, JHMDBSentencesDataset,
                             ReasonSegDataset, ReferSentencesTrainDataset,
                             ReferVOSDataset, SampleBuilder, VQADataset)
from ..data.prefetch import device_copier, prefetch_to_device
from ..parallel import global_device_mesh, initialize_distributed
from ..training import build_training, make_sharded_train_step
from ..training.trainer import Trainer, validate_mevis, validate_reasonseg
from .common import add_model_args, check_card, load_model, load_tokenizer


def make_val_fn(model, builder, max_text_len: int, to_device: Callable, *,
                mevis_ds=None, reason_ds=None, n_samples: int = 32):
    """Per-epoch validator: the teacher-forced training forward on
    validation records, its pred_masks against the ground truth.
    to_device: host batch -> the model's device batch."""

    @torch.no_grad()
    def tube_predict(record):
        sample = builder(record)
        batch = build_batch([sample], max_text_len=max_text_len,
                            mask_hw=builder.mask_hw)
        out = model(**to_device(batch), return_pred_masks=True)
        pred = out.pred_masks[0, 0].float().cpu().numpy()     # [T, h, w] logits
        gt = batch["gt_masks"][0, 0].numpy()                  # [T, h, w]
        gt = np.where(gt == MASK_IGNORE_INDEX, 255, gt).astype(np.int64)
        return pred > 0, gt

    def val_fn(state, epoch, logger):
        if mevis_ds is not None:
            n = min(n_samples, len(mevis_ds))
            validate_mevis(lambda i: tube_predict(mevis_ds[i]), range(n),
                           logger, epoch)
        if reason_ds is not None:
            def reason_predict(i):
                pred, gt = tube_predict(reason_ds[i])
                return pred[:1], gt[:1]      # image dataset: frame 0
            n = min(n_samples, len(reason_ds))
            validate_reasonseg(reason_predict, range(n), logger, epoch)
    return val_fn


def stack_micro_batches(micro: List[Dict[str, torch.Tensor]]
                        ) -> Dict[str, torch.Tensor]:
    """Stack micro-batches along a new leading axis. A row is a
    conversation, so micro-batches whose samples hold different numbers of
    conversations cannot stack: that raises, as the JAX CLI's np.stack
    does; nothing is padded."""
    out = {}
    for k in micro[0]:
        shapes = [tuple(m[k].shape) for m in micro]
        if len(set(shapes)) != 1:
            raise ValueError(f"micro-batches differ in {k!r}: {shapes} (every "
                             "micro-batch must hold the same number of "
                             "conversations)")
        out[k] = torch.stack([m[k] for m in micro])
    return out


def accum_batches(hybrid, batch_size: int, max_text_len: int,
                  grad_accum: int) -> Iterator[Dict[str, torch.Tensor]]:
    """Endless optimizer-step batches: with grad_accum > 1 the micro-batches
    stacked on a leading axis, as `make_train_step` reads them."""
    gen = hybrid.batches(batch_size, max_text_len)
    while True:
        if grad_accum == 1:
            yield next(gen)
        else:
            yield stack_micro_batches([next(gen) for _ in range(grad_accum)])


def main(argv=None):
    """Train; returns the `Trainer` (its `history` and `ckpt_seconds`)."""
    p = argparse.ArgumentParser(description=__doc__)
    add_model_args(p)
    p.add_argument("--gcg_json", default=None)
    p.add_argument("--gcg_frames", default=None)
    p.add_argument("--refer_vos_root", default=None)
    p.add_argument("--a2d_root", default=None,
                   help="A2D-Sentences root (a train source)")
    p.add_argument("--a2d_ann", default=None,
                   help="A2D single-frame train annotation JSON "
                        "(defaults to <a2d_root>/a2d_sentences_single_frame"
                        "_train_annotations.json)")
    p.add_argument("--jhmdb_root", default=None,
                   help="JHMDB-Sentences root (a train source)")
    p.add_argument("--jhmdb_ann", default=None,
                   help="defaults to <jhmdb_root>/jhmdb_sentences_samples"
                        "_metadata.json")
    p.add_argument("--reason_seg_root", default=None)
    p.add_argument("--vqa_json", default=None)
    p.add_argument("--vqa_media_root", default=None)
    p.add_argument("--sample_rates", default=None,
                   help="comma weights matching registered datasets")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--grad_accum", type=int, default=10)
    p.add_argument("--steps_per_epoch", type=int, default=500)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lora_r", type=int, default=8)
    p.add_argument("--max_text_len", type=int, default=512)
    p.add_argument("--num_frames_for_sam", type=int, default=4)
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--ckpt_dir", default="./ckpts")
    p.add_argument("--log_dir", default="./runs")
    p.add_argument("--auto_resume", action="store_true")
    p.add_argument("--val_mevis_root", default=None,
                   help="MeViS-layout valid_u root: per-epoch gIoU/cIoU")
    p.add_argument("--val_reason_seg_root", default=None)
    p.add_argument("--val_samples", type=int, default=32,
                   help="videos/images per mid-training validation pass")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if args.quant != "none":
        raise NotImplementedError(
            f"--quant {args.quant}: quantised LLM weights do not train; "
            "fine-tune from float weights (--quant none)")
    initialize_distributed(device=args.device)
    mesh = global_device_mesh(args.model_parallel)
    check_card(device)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32

    cfg = VideoGLaMMConfig.flagship()
    tokenizer = load_tokenizer(args.tokenizer or args.checkpoint)

    specs = []
    if args.gcg_json:
        specs.append(DatasetSpec("video_gcg", GCGVideoDataset(
            args.gcg_json, args.gcg_frames,
            max_num_frames=args.num_frames_for_sam), 1.0))
    if args.refer_vos_root:
        specs.append(DatasetSpec(
            "refer_vos", ReferVOSDataset(args.refer_vos_root), 1.0))
    if args.a2d_root:
        ann = args.a2d_ann or os.path.join(
            args.a2d_root, "a2d_sentences_single_frame_train_annotations.json")
        specs.append(DatasetSpec("a2d", ReferSentencesTrainDataset(
            A2DSentencesDataset(args.a2d_root, ann),
            num_frames_for_sam=args.num_frames_for_sam), 1.0))
    if args.jhmdb_root:
        ann = args.jhmdb_ann or os.path.join(
            args.jhmdb_root, "jhmdb_sentences_samples_metadata.json")
        specs.append(DatasetSpec("jhmdb", ReferSentencesTrainDataset(
            JHMDBSentencesDataset(args.jhmdb_root, ann),
            num_frames_for_sam=args.num_frames_for_sam), 1.0))
    if args.reason_seg_root:
        specs.append(DatasetSpec(
            "reason_seg", ReasonSegDataset(args.reason_seg_root), 1.0))
    if args.vqa_json:
        specs.append(DatasetSpec("vqa", VQADataset(
            args.vqa_json, args.vqa_media_root), 1.0))
    if not specs:
        raise ValueError("register at least one dataset")
    if args.sample_rates:
        for s, w in zip(specs, args.sample_rates.split(",")):
            s.weight = float(w)

    builder = SampleBuilder(cfg, tokenizer, max_text_len=args.max_text_len,
                            num_frames_for_sam=args.num_frames_for_sam)
    hybrid = HybridDataset(specs, builder,
                           samples_per_epoch=args.steps_per_epoch
                           * args.batch_size * args.grad_accum)

    # the loaded inference weights, grafted into a model with LoRA (whose
    # B starts at zero), the freeze policy, AdamW and the step
    tcfg = TrainConfig(lr=args.lr, epochs=args.epochs,
                       steps_per_epoch=args.steps_per_epoch,
                       grad_accum_steps=args.grad_accum,
                       total_steps=args.epochs * args.steps_per_epoch,
                       lora=LoRAConfig(r=args.lora_r))
    tr = build_training(cfg, tcfg, load_model(args, cfg), device=device,
                        dtype=dtype)

    copy = device_copier(device, dtype)
    val_fn = None
    if args.val_mevis_root or args.val_reason_seg_root:
        val_fn = make_val_fn(
            tr.model, builder, args.max_text_len, copy,
            mevis_ds=(ReferVOSDataset(args.val_mevis_root)
                      if args.val_mevis_root else None),
            reason_ds=(ReasonSegDataset(args.val_reason_seg_root,
                                        split="val")
                       if args.val_reason_seg_root else None),
            n_samples=args.val_samples)

    step, state, batch_split = make_sharded_train_step(
        tr.model, tr.tx, mesh, tr.state, grad_accum=args.grad_accum)
    batches = prefetch_to_device(
        accum_batches(hybrid, args.batch_size, args.max_text_len,
                      args.grad_accum), copy, prefetch=2)
    trainer = Trainer(step, state, batches, to_device=batch_split,
                      steps_per_epoch=args.steps_per_epoch,
                      epochs=args.epochs, log_dir=args.log_dir,
                      ckpt_dir=args.ckpt_dir, val_fn=val_fn)
    try:
        if args.auto_resume:
            trainer.resume()
        trainer.train()
    finally:
        batches.close()
    return trainer


if __name__ == "__main__":
    main()
