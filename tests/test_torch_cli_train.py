"""The port's `train` CLI (videoglamm_torch.cli.train) against the JAX
package on the CPU, in f32 on `VideoGLaMMConfig.tiny()`.

`main` runs on the JAX tests' dataset fixtures (a GCG root, a MeViS root,
ReasonSeg train and val splits, a VQA file) through `--device cpu`, with
the config, the tokenizer and the weights patched in as module attributes
(as tests/test_cli_e2e.py does for the JAX CLIs). The weights are one JAX
parameter tree with LoRA rank 2, filled from a numpy seed, carried into the
port by `io/from_jax.py`. The tokenizer is word-level and stateless, with
`[SEG]` at the config's id, so a worker thread and the validators may use
it at once.

- The first optimizer step's loss, CE, BCE and DICE equal, at
  tests/test_torch_training.py's f32 tolerance (1e-5 relative), the JAX
  `make_train_step` (grad_accum 2, one compile) on JAX `build_batch`
  batches of the same records (the JAX `HybridDataset` with the same seed).
- The schedule's first update has learning rate 0 (warm-up), so after one
  step the weights are the loaded ones and the two validators' scalars can
  be held to the JAX `make_val_fn`'s on those weights: equal. (The JAX
  function never asks its model for `pred_masks`; the test hands it a
  model that does.)
- `--auto_resume` continues from the epoch checkpoint: the restored Adam
  moments take the next update (the same batch on the same weights gives
  the same gradient g, so mu goes from 0.1 g to 0.19 g, nu from 0.05 g^2
  to 0.0975 g^2; a fresh start would give 0.1 g and 0.05 g^2 again).
- The three flags the port cannot serve raise.
- `load_model` reads an `io/checkpoint` directory and reference shards.
"""
import json
import os
import re
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_datasets import gcg_root, mevis_root  # noqa: F401  (fixtures)
from test_torch_data import _reason_root, _vqa_root
from test_torch_models import seeded_params
from test_videoglamm import CFG, make_batch
from videoglamm_tpu import config as jconfig
from videoglamm_tpu.cli.train import make_val_fn as jmake_val_fn
from videoglamm_tpu.data import datasets as jds
from videoglamm_tpu.models import VideoGLaMM as JVideoGLaMM
from videoglamm_tpu.training import (create_train_state as jcreate_state,
                                     make_optimizer as jmake_optimizer,
                                     make_train_step as jmake_train_step)
from videoglamm_torch.cli import common as tcommon
from videoglamm_torch.cli import train as tcli
from videoglamm_torch.io import checkpoint, reference
from videoglamm_torch.io.from_jax import port_config, videoglamm_state_dict
from videoglamm_torch.models.videoglamm import VideoGLaMM
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TCFG = port_config(CFG)
LORA_RANK = 2
MAX_TEXT = 64
N_SAM = 2
TOL_LOSS = 1e-5
METRICS = ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss")


class WordTokenizer:
    """Word-level and stateless: `[SEG]` (also inside "[SEG].") is the
    config's seg id, every other word a hash into [10, 490)."""
    bos_token_id = 1

    def __init__(self, seg_id: int):
        self.seg_id = seg_id

    def __call__(self, text):
        ids = [self.bos_token_id]
        for w in re.findall(r"\[SEG\]|\S+", text):
            ids.append(self.seg_id if w == "[SEG]"
                       else 10 + zlib.crc32(w.encode()) % 480)
        return types.SimpleNamespace(input_ids=ids)


@pytest.fixture(scope="module")
def roots(gcg_root, mevis_root, tmp_path_factory):  # noqa: F811
    reason = tmp_path_factory.mktemp("reason")
    _reason_root(reason, "train")
    _reason_root(reason, "val", seed=7)
    vqa_json, vqa_media = _vqa_root(tmp_path_factory.mktemp("vqa"))
    return dict(gcg_json=str(gcg_root / "train.json"),
                gcg_frames=str(gcg_root / "frames"),
                mevis=str(mevis_root), reason=str(reason),
                vqa_json=vqa_json, vqa_media=vqa_media)


@pytest.fixture(scope="module")
def weights():
    jm = JVideoGLaMM(CFG, dtype=jnp.float32, lora_rank=LORA_RANK)
    params = seeded_params(
        lambda: jm.init(jax.random.PRNGKey(0),
                        **make_batch(np.random.RandomState(0))), 11)["params"]
    return jm, params, videoglamm_state_dict(params, CFG)


def _argv(roots, tmp, *extra):
    return ["--checkpoint", "unused", "--device", "cpu", "--precision", "f32",
            "--gcg_json", roots["gcg_json"], "--gcg_frames", roots["gcg_frames"],
            "--refer_vos_root", roots["mevis"],
            "--reason_seg_root", roots["reason"],
            "--vqa_json", roots["vqa_json"],
            "--vqa_media_root", roots["vqa_media"],
            "--batch_size", "2", "--grad_accum", "2", "--steps_per_epoch", "1",
            "--epochs", "1", "--lora_r", str(LORA_RANK),
            "--max_text_len", str(MAX_TEXT),
            "--num_frames_for_sam", str(N_SAM),
            "--val_mevis_root", roots["mevis"],
            "--val_reason_seg_root", roots["reason"], "--val_samples", "2",
            "--ckpt_dir", str(tmp / "ckpt"), "--log_dir", str(tmp / "log"),
            *extra]


def _patch(monkeypatch, sd):
    monkeypatch.setattr(tcli.VideoGLaMMConfig, "flagship",
                        staticmethod(lambda: TCFG))
    monkeypatch.setattr(tcli, "load_tokenizer",
                        lambda path: WordTokenizer(TCFG.seg_token_idx))
    monkeypatch.setattr(tcli, "load_model",
                        lambda args, cfg=None: {k: v.clone()
                                                for k, v in sd.items()})


@pytest.fixture(scope="module")
def cli_runs(roots, weights, tmp_path_factory):
    """One epoch of one step, then `--epochs 2 --auto_resume` in the same
    directories; the epoch-1 checkpoint's Adam moments read in between."""
    mp = pytest.MonkeyPatch()
    _patch(mp, weights[2])
    tmp = tmp_path_factory.mktemp("cli")
    try:
        first = tcli.main(_argv(roots, tmp))
        saved = torch.load(tmp / "ckpt" / "1" / "state.pt", weights_only=True)
        second = tcli.main(_argv(roots, tmp, "--epochs", "2", "--auto_resume"))
    finally:
        mp.undo()
    return tmp, first, saved["opt_state"], second


def _jax_hybrid(roots, builder):
    specs = [jds.DatasetSpec("video_gcg", jds.GCGVideoDataset(
                 roots["gcg_json"], roots["gcg_frames"], max_num_frames=N_SAM)),
             jds.DatasetSpec("refer_vos", jds.ReferVOSDataset(roots["mevis"])),
             jds.DatasetSpec("reason_seg", jds.ReasonSegDataset(roots["reason"])),
             jds.DatasetSpec("vqa", jds.VQADataset(roots["vqa_json"],
                                                   roots["vqa_media"]))]
    return jds.HybridDataset(specs, builder, samples_per_epoch=4)


def test_first_step_losses_match_jax(roots, weights, cli_runs):
    jm, params, _ = weights
    _, first, _, _ = cli_runs
    builder = jds.SampleBuilder(CFG, WordTokenizer(CFG.seg_token_idx),
                                max_text_len=MAX_TEXT, num_frames_for_sam=N_SAM)
    gen = _jax_hybrid(roots, builder).batches(2, MAX_TEXT)
    micro = [next(gen) for _ in range(2)]
    batch = {k: jnp.asarray(np.stack([m[k] for m in micro])) for k in micro[0]}
    # every row reached the decoder with its [SEG] inside max_text_len
    lens = np.asarray(batch["text_lens"])
    assert (lens < MAX_TEXT).all()
    assert int((np.asarray(batch["input_ids"]) == CFG.seg_token_idx).sum()) > 0
    tcfg = jconfig.TrainConfig(lr=3e-4, epochs=1, steps_per_epoch=1,
                               grad_accum_steps=2, total_steps=1,
                               lora=jconfig.LoRAConfig(r=LORA_RANK))
    tx = jmake_optimizer(tcfg, params)
    step = jax.jit(jmake_train_step(jm, tx, grad_accum=2))
    _, jmetrics = step(jcreate_state(params, tx), batch)
    got = first.history[0]
    assert got["step"] == 1 and got["step_s"] >= got["data_s"] >= 0.0
    assert got["mask_bce_loss"] > 0
    for k in METRICS:
        np.testing.assert_allclose(got[k], float(jmetrics[k]), rtol=TOL_LOSS,
                                   atol=TOL_LOSS, err_msg=k)


def test_validators_match_jax_make_val_fn(roots, weights, cli_runs):
    jm, params, _ = weights
    tmp, _, _, _ = cli_runs
    logged = {}
    with open(tmp / "log" / "scalars.jsonl") as f:
        for line in f:
            r = json.loads(line)
            if r["tag"].startswith("val/") and r["step"] == 0:
                logged[r["tag"]] = r["value"]
    want = {}
    logger = types.SimpleNamespace(
        log=lambda tag, value, step: want.__setitem__(tag, float(value)))
    builder = jds.SampleBuilder(CFG, WordTokenizer(CFG.seg_token_idx),
                                max_text_len=MAX_TEXT, num_frames_for_sam=N_SAM)
    # the JAX CLI's make_val_fn reads `pred_masks` without asking the model
    # for them (`return_pred_masks` defaults to False, and the validators
    # then fail on None); the port passes the flag itself, the JAX function
    # is handed a model that passes it
    with_masks = types.SimpleNamespace(
        apply=lambda v, **b: jm.apply(v, **b, return_pred_masks=True))
    val_fn = jmake_val_fn(with_masks, builder, MAX_TEXT,
                          mevis_ds=jds.ReferVOSDataset(roots["mevis"]),
                          reason_ds=jds.ReasonSegDataset(roots["reason"],
                                                         split="val"),
                          n_samples=2)
    val_fn(types.SimpleNamespace(params=params), 0, logger)
    assert set(want) == {"val/mevis/giou", "val/mevis/ciou",
                         "val/reason_seg/giou", "val/reason_seg/ciou"}
    assert logged == want


def test_epoch_checkpoint_and_auto_resume(cli_runs):
    tmp, first, saved, second = cli_runs
    assert first.state.step == 1 and len(first.ckpt_seconds) == 1
    assert second.start_epoch == 1 and second.state.step == 2
    assert [h["step"] for h in second.history] == [2]
    assert second.state.opt_state["count"] == 2 and saved["count"] == 1
    with open(tmp / "ckpt" / "2" / "metadata.json") as f:
        assert json.load(f) == {"epoch": 1}
    moved = 0
    for n, mu1 in saved["mu"].items():
        g = mu1 / 0.1
        if not bool(g.abs().max() > 0):
            continue
        moved += 1
        torch.testing.assert_close(second.state.opt_state["mu"][n], 1.9 * mu1,
                                   rtol=1e-5, atol=1e-7 * float(g.abs().max()))
        torch.testing.assert_close(second.state.opt_state["nu"][n],
                                   1.95 * saved["nu"][n], rtol=1e-5,
                                   atol=1e-7 * float(g.abs().max()) ** 2)
    assert moved > 10


@pytest.mark.parametrize("flags,what", [
    (("--model_parallel", "2"), "model_parallel"),
    (("--quant", "int8"), "quant"),
    (("--precision", "f32", "--device", "cuda"), "precision f32"),
])
def test_unservable_flags_raise(flags, what):
    argv = ["--checkpoint", "unused", "--gcg_json", "unused", *flags]
    if what == "precision f32":
        # f32 trains on the card (the f32 routes of K1, K2 and K6): the CLI
        # passes its refusals and stops at the missing card, before it
        # reads anything
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(argv)
        return
    if what == "model_parallel":
        # the sharded step runs over the mesh of every process: one
        # process has no model axis of 2, and the mesh says so before
        # anything is read
        with pytest.raises(ValueError, match="model=2"):
            tcli.main(argv)
        return
    with pytest.raises(NotImplementedError, match=what):
        tcli.main(argv)


def test_load_model_reads_checkpoint_and_reference_dirs(tmp_path):
    torch.manual_seed(0)
    model = VideoGLaMM(TCFG)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02)
    sd = model.state_dict()
    checkpoint.save_params(str(tmp_path / "ckpt"), sd)
    args = types.SimpleNamespace(checkpoint=str(tmp_path / "ckpt"))
    got = tcommon.load_model(args, TCFG)
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)

    hf, iv, clip = reference.to_reference_layout(sd, TCFG)
    d = tmp_path / "hf"
    d.mkdir()
    keys = sorted(hf)
    for j, part in enumerate((keys[::2], keys[1::2])):
        torch.save({k: hf[k] for k in part},
                   d / f"pytorch_model-0000{j + 1}-of-00002.bin")
    torch.save({"module": iv}, tmp_path / "iv.pt")
    torch.save(clip, tmp_path / "clip.bin")
    args = types.SimpleNamespace(checkpoint=str(d),
                                 internvideo_ckpt=str(tmp_path / "iv.pt"),
                                 clip_ckpt=str(tmp_path / "clip.bin"))
    got = tcommon.load_model(args, TCFG)
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    model.load_weights(got)
    os.remove(d / "pytorch_model-00001-of-00002.bin")
    os.remove(d / "pytorch_model-00002-of-00002.bin")
    with pytest.raises(FileNotFoundError):
        tcommon.load_model(args, TCFG)
