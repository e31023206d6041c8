"""The videoglamm_torch training path against the JAX package on the CPU.

One JAX parameter tree of `VideoGLaMMConfig.tiny()` with `lora_rank=2`,
shaped by `jax.eval_shape` and filled from a numpy seed (so LoRA's B is not
zero and A gets a gradient), is carried into the port by `io/from_jax.py`;
the batch is `make_batch` of tests/test_videoglamm.py. One module-scoped JAX
model, one jitted `value_and_grad`, one jitted train step per accumulation
depth. Everything in f32.

Tolerances, from f32 controls (the forward controls of
parity/parity_modules_cpu.json land between 1e-6 and 4e-5 on O(1) values):
- loss components: 1e-5 relative (scalars of O(1) to O(10));
- gradients: 2e-4 of each leaf's largest entry, plus 1e-6 absolute. A
  gradient sums thousands of f32 products in another order than XLA does;
  measured here the worst leaf (a LoRA B) differs by 4.1e-5 of its largest
  entry. The absolute term covers leaves whose true gradient is zero (the
  key biases of a softmax attention): both sides hold rounding there;
- parameters after three optimizer steps: 2e-3 absolute on values whose
  updates are at most 2e-3 in all (lr 1e-3, |Adam update| <= 1, first
  update at lr 0). Adam's first steps are g / (|g| + eps): where a
  gradient entry is near 0 its sign is rounding, and the update flips by
  lr. Gradients are held tightly instead, and the optimizer's arithmetic
  is held at 5e-5 on the entries whose first gradient is at least a tenth
  of its leaf's largest: there the gradients agree to 2e-3 relative, and
  Adam's normalised update (times lr <= 1e-3, two updates) to a few 1e-6.
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import seeded_params
from test_videoglamm import CFG, make_batch
from videoglamm_tpu import config as jconfig
from videoglamm_tpu.models import VideoGLaMM as JVideoGLaMM
from videoglamm_tpu.training import (create_train_state as jcreate_state,
                                     make_optimizer as jmake_optimizer,
                                     make_train_step as jmake_train_step,
                                     trainable_mask as jtrainable_mask)
from videoglamm_tpu.training import trainer as jtrainer
from videoglamm_torch import config as tconfig
from videoglamm_torch.io.checkpoint import (CheckpointManager, load_params,
                                            save_params)
from videoglamm_torch.io.from_jax import port_config, videoglamm_state_dict
from videoglamm_torch.models.videoglamm import VideoGLaMM
from videoglamm_torch.training import (build_training, make_train_step,
                                       trainable_mask)
from videoglamm_torch.training import trainer as ttrainer

LORA_RANK = 2
METRICS = ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss", "mask_loss")
TOL_LOSS = 1e-5
TOL_GRAD = 2e-4
JTCFG = jconfig.TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                            grad_accum_steps=1,
                            lora=jconfig.LoRAConfig(r=LORA_RANK))
TCFG = port_config(JTCFG)


def _torch_batch(batch):
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        out[k] = torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i"
                                  else a.copy())
    return out


@pytest.fixture(scope="module")
def setup():
    jm = JVideoGLaMM(CFG, dtype=jnp.float32, lora_rank=LORA_RANK)
    batch = make_batch(np.random.RandomState(0))
    params = seeded_params(
        lambda: jm.init(jax.random.PRNGKey(0), **batch), 11)["params"]

    def loss_fn(p, b):
        out = jm.apply({"params": p}, **b)
        return out.loss, {k: getattr(out, k) for k in METRICS}

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, jmetrics), jgrads = vg(params, batch)
    return dict(jm=jm, params=params, batch=batch, vg=vg,
                jmetrics={k: float(v) for k, v in jmetrics.items()},
                jgrads=videoglamm_state_dict(jgrads, CFG),
                sd=videoglamm_state_dict(params, CFG))


def _training(setup, grad_accum=1):
    tcfg = dataclasses.replace(TCFG, grad_accum_steps=grad_accum)
    return build_training(port_config(CFG), tcfg, setup["sd"], device="cpu",
                          dtype=torch.float32)


@pytest.fixture(scope="module")
def port_grads(setup):
    """The port's metrics and gradients on the same weights and batch."""
    tr = _training(setup)
    out = tr.model(**_torch_batch(setup["batch"]))
    out.loss.backward()
    grads = {n: p.grad for n, p in tr.model.named_parameters()}
    return tr, {k: float(getattr(out, k).detach()) for k in METRICS}, grads


@pytest.mark.parametrize("name", METRICS)
def test_loss_component_matches_jax(setup, port_grads, name):
    _, metrics, _ = port_grads
    np.testing.assert_allclose(metrics[name], setup["jmetrics"][name],
                               rtol=TOL_LOSS, atol=TOL_LOSS)


def _grad_close(got, want, what, tol=TOL_GRAD):
    want = want.numpy()
    got = np.zeros_like(want) if got is None else got.numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale + 1e-6,
                               err_msg=what)


GROUPS = {"lora": r"lora_[ab]", "lm_head": r"lm_head", "embed": r"embed_tokens",
          "text_hidden_fcs": r"text_hidden_fcs",
          "mask_decoder": r"sam_mask_decoder"}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_trainable_gradients_match_jax(setup, port_grads, group):
    """Every trainable leaf of the group against jax.grad."""
    tr, _, grads = port_grads
    names = [n for n in tr.tx.trainable if re.search(GROUPS[group], n)]
    assert names
    moved = 0
    for n in names:
        _grad_close(grads[n], setup["jgrads"][n], n)
        moved += bool(np.abs(setup["jgrads"][n].numpy()).max() > 0)
    assert moved, f"{group}: the reference gradient is zero everywhere"


def test_every_trainable_leaf_is_compared(setup, port_grads):
    tr, _, _ = port_grads
    rx = re.compile("|".join(GROUPS.values()))
    assert all(rx.search(n) for n in tr.tx.trainable)
    assert set(tr.tx.trainable) <= set(setup["jgrads"])


def test_frozen_leaves_get_no_gradient(setup, port_grads):
    tr, _, grads = port_grads
    frozen = [n for n in grads if n not in set(tr.tx.trainable)]
    assert len(frozen) > 100
    assert all(grads[n] is None for n in frozen)
    assert not any(p.requires_grad for n, p in tr.model.named_parameters()
                   if n in set(frozen))
    # and the JAX package gives them zeros (stop_gradient, frozen LLM base)
    for n in ("vision_tower.blocks.0.attn.qkv.weight",
              "image_vision_tower.encoder.layers.0.mlp.fc1.weight",
              "visual_model.image_encoder.trunk.blocks.0.attn.qkv.weight"):
        assert float(setup["jgrads"][n].abs().max()) == 0.0


def test_trainable_mask_matches_jax_leaf_for_leaf(setup):
    """The JAX mask, written as a tree of ones and zeros in the parameters'
    shapes, goes through the same name mapping as the weights."""
    jmask = jtrainable_mask(setup["params"])
    as_arrays = jax.tree_util.tree_map(
        lambda m, p: np.full(p.shape, float(m), np.float32), jmask,
        setup["params"])
    want = {n: bool(v.max() > 0)
            for n, v in videoglamm_state_dict(as_arrays, CFG).items()}
    model = VideoGLaMM(port_config(CFG), lora_rank=LORA_RANK)
    got = trainable_mask(model)
    assert set(got) <= set(want)
    assert {n: want[n] for n in got} == got
    on = [n for n, m in got.items() if m]
    for pat in ("lm_head", "embed_tokens", "text_hidden_fcs",
                "sam_mask_decoder", "lora_a", "lora_b"):
        assert any(pat in n for n in on), pat
    assert not any("vision_tower" in n or "qkv_proj" in n for n in on)


def _jax_steps(setup, grad_accum, batches, n_steps):
    tx = jmake_optimizer(JTCFG, setup["params"])
    step = jax.jit(jmake_train_step(setup["jm"], tx, grad_accum))
    state = jcreate_state(setup["params"], tx)
    metrics = []
    for _ in range(n_steps):
        state, m = step(state, batches)
        metrics.append({k: float(v) for k, v in m.items()})
    return videoglamm_state_dict(state.params, CFG), metrics


def _hold_params(tr, start, want, jgrads_first=None):
    moved = 0
    for n, p in tr.model.named_parameters():
        if n in set(tr.tx.trainable):
            got = p.detach().numpy()
            np.testing.assert_allclose(got, want[n].numpy(), rtol=0, atol=2e-3,
                                       err_msg=n)
            moved += int(not np.array_equal(got, start[n].numpy()))
            if jgrads_first is not None:
                g = np.abs(jgrads_first[n].numpy())
                clear = g > 0.1 * max(g.max(), 1e-30)
                if clear.any():
                    np.testing.assert_allclose(
                        got[clear], want[n].numpy()[clear], rtol=0, atol=5e-5,
                        err_msg=f"{n} (entries with a clear gradient)")
        else:
            assert torch.equal(p.detach(), start[n]), f"frozen {n} changed"
            assert torch.equal(want[n], start[n]), f"frozen {n} changed in JAX"
    assert moved > 0


def test_three_train_steps_match_optax(setup):
    """Three steps of the port's `make_train_step` against the JAX package's
    step (optax clip + adamw + schedule) from the same fresh state."""
    want, jmetrics = _jax_steps(setup, 1, setup["batch"], 3)
    tr = _training(setup)
    batch = _torch_batch(setup["batch"])
    state = tr.state
    for i in range(3):
        state, m = tr.train_step(state, batch)
        for k in METRICS:
            np.testing.assert_allclose(float(m[k]), jmetrics[i][k], rtol=1e-4,
                                       atol=1e-4, err_msg=f"step {i} {k}")
    assert state.step == 3 and state.opt_state["count"] == 3
    # warm-up of one step: the first update has learning rate 0
    assert jmetrics[0]["loss"] == pytest.approx(jmetrics[1]["loss"], rel=1e-6)
    assert jmetrics[2]["loss"] < jmetrics[0]["loss"]
    _hold_params(tr, setup["sd"], want, setup["jgrads"])


def test_grad_accum_matches_jax(setup):
    """grad_accum=2 over two different micro-batches: mean gradient, mean
    metrics, as the scan of train_step.py:108-127."""
    b2 = make_batch(np.random.RandomState(5))
    stacked = {k: np.stack([np.asarray(setup["batch"][k]), np.asarray(b2[k])])
               for k in b2}
    want, jmetrics = _jax_steps(setup, 2, stacked, 2)
    tr = _training(setup, grad_accum=2)
    batch = _torch_batch(stacked)
    state = tr.state
    for i in range(2):
        state, m = tr.train_step(state, batch)
        for k in METRICS:
            np.testing.assert_allclose(float(m[k]), jmetrics[i][k], rtol=1e-4,
                                       atol=1e-4, err_msg=f"step {i} {k}")
    _hold_params(tr, setup["sd"], want)


def test_remat_on_and_off_give_equal_gradients(setup, port_grads):
    tr, metrics, grads = port_grads         # remat on, as build_training sets it
    assert tr.model.llm.model.remat
    model = VideoGLaMM(port_config(CFG), remat_llm=False, lora_rank=LORA_RANK)
    model.load_state_dict(setup["sd"])
    make_train_step(model, tr.tx)           # applies the freeze policy
    out = model(**_torch_batch(setup["batch"]))
    out.loss.backward()
    assert float(out.loss.detach()) == metrics["loss"]
    for n, p in model.named_parameters():
        if grads[n] is None:
            assert p.grad is None, n
        else:
            # the recomputed forward repeats the same f32 operations
            torch.testing.assert_close(p.grad, grads[n], rtol=0, atol=1e-7,
                                       msg=n)


def test_lora_b_zero_starts_at_the_base_model(setup):
    """A state dict without LoRA entries (an inference checkpoint) is
    grafted; LoRA's B starts at zero, so the loss equals the base model's."""
    base = {k: v for k, v in setup["sd"].items() if "lora_" not in k}
    tr = build_training(port_config(CFG), TCFG, base, device="cpu",
                        dtype=torch.float32)
    for n, p in tr.model.named_parameters():
        if "lora_b" in n:
            assert float(p.detach().abs().max()) == 0.0
    plain = VideoGLaMM(port_config(CFG))
    plain.load_state_dict(base)
    batch = _torch_batch(setup["batch"])
    with torch.no_grad():
        assert float(tr.model(**batch).loss) == float(plain(**batch).loss)
    with pytest.raises(ValueError, match="does not fit"):
        build_training(port_config(CFG), TCFG,
                       {k: v for k, v in base.items() if "lm_head" not in k},
                       device="cpu", dtype=torch.float32)


def test_build_training_defaults_and_refusals(setup):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_training(port_config(CFG), TCFG)
    tr = _training(setup)
    with pytest.raises(NotImplementedError, match="freeze_towers"):
        tr.model(**_torch_batch(setup["batch"]), freeze_towers=False)
    with pytest.raises(ValueError, match="float LLM"):
        VideoGLaMM(port_config(CFG), lora_rank=2, quant_llm_int8=True)


def test_bf16_training_keeps_f32_masters(setup):
    """Compute dtype bf16 on the CPU: trainable weights stay f32 (cast at
    use), frozen linears are stored in bf16, one step runs and moves only
    the masters."""
    tr = build_training(port_config(CFG), TCFG, setup["sd"], device="cpu",
                        dtype=torch.bfloat16)
    train = set(tr.tx.trainable)
    for n, p in tr.model.named_parameters():
        if n in train:
            assert p.dtype == torch.float32, n
    assert tr.model.llm.model.layers[0].self_attn.qkv_proj.weight.dtype \
        == torch.bfloat16
    assert tr.model.vision_tower.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    batch = _torch_batch(setup["batch"])
    for k in ("frames", "context_images", "frames_sam"):
        batch[k] = batch[k].bfloat16()
    state = tr.state
    for _ in range(2):
        state, m = tr.train_step(state, batch)
    assert np.isfinite(float(m["loss"]))
    # bf16 compute against the f32 reference loss: a few bf16 ulps (2^-8)
    # through two layers and the losses
    assert float(m["loss"]) == pytest.approx(setup["jmetrics"]["loss"], rel=3e-2)
    assert all(v.dtype == torch.float32 for v in state.opt_state["mu"].values())
    assert set(state.opt_state["mu"]) == train


def test_checkpoint_round_trip_and_max_to_keep(setup, tmp_path):
    tr = _training(setup)
    batch = _torch_batch(setup["batch"])
    state = tr.state
    for _ in range(2):
        state, _ = tr.train_step(state, batch)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(state)
    ckpt.save(2, state, metadata={"epoch": 0, "note": "x"})
    saved = {n: p.detach().clone() for n, p in state.params.items()}
    saved_mu = {n: v.clone() for n, v in state.opt_state["mu"].items()}
    state3, m3 = tr.train_step(state, batch)
    assert any(not torch.equal(saved[n], state3.params[n]) for n in saved)
    back = ckpt.restore(state3)
    assert back.step == 2 and back.opt_state["count"] == 2
    assert all(torch.equal(saved[n], back.params[n]) for n in saved)
    assert all(torch.equal(saved_mu[n], back.opt_state["mu"][n]) for n in saved_mu)
    assert ckpt.restore_metadata() == {"epoch": 0, "note": "x"}
    # restored tensors are the model's own: the next step repeats exactly
    _, m3b = tr.train_step(back, batch)
    assert float(m3b["loss"]) == float(m3["loss"])
    for s in (3, 4, 5):
        ckpt.save(s, back)
    assert ckpt.latest_step() == 5
    assert sorted(os.listdir(ckpt.directory)) == ["4", "5"]
    ckpt.close()
    save_params(str(tmp_path / "export"), back.params)
    loaded = load_params(str(tmp_path / "export"))
    assert all(torch.equal(loaded[n], back.params[n]) for n in back.params)


def test_trainer_loop_with_resume(tmp_path):
    """The epoch loop on a stub step: meters, JSONL scalars, one checkpoint
    per epoch, val_fn hook, resume from the step counter."""
    from videoglamm_torch.training.train_step import TrainState

    def stub_step(state, batch):
        p = state.params["w"]
        with torch.no_grad():
            p -= 0.1 * batch
        m = {k: torch.tensor(float(state.step + 1)) for k in METRICS}
        return TrainState(state.step + 1, state.params, state.opt_state), m

    def fresh():
        return TrainState(0, {"w": torch.zeros(2)},
                          {"count": 0, "mu": {}, "nu": {}})

    def batches():
        while True:
            yield torch.ones(2)

    seen = []
    kw = dict(steps_per_epoch=3, log_dir=str(tmp_path / "runs"),
              ckpt_dir=str(tmp_path / "ckpts"), log_every=3)
    t = ttrainer.Trainer(stub_step, fresh(), batches(), epochs=2,
                         val_fn=lambda s, e, lg: seen.append((s.step, e)), **kw)
    assert not t.resume()
    out = t.train()
    assert out.step == 6 and seen == [(3, 0), (6, 1)]
    assert t.ckpt.latest_step() == 6
    assert t.ckpt.restore_metadata() == {"epoch": 1}
    lines = (tmp_path / "runs" / "scalars.jsonl").read_text().splitlines()
    assert len(lines) == 2 * 6          # 6 meters at the end of each epoch
    t2 = ttrainer.Trainer(stub_step, fresh(), batches(), epochs=3, **kw)
    assert t2.resume() and t2.start_epoch == 2
    out = t2.train()
    assert out.step == 9
    torch.testing.assert_close(out.params["w"], torch.full((2,), -0.9))


@pytest.mark.parametrize("which", ["reasonseg", "mevis"])
def test_validators_match_jax(which, tmp_path):
    rng = np.random.RandomState(3)

    def sample():
        pred = rng.rand(3, 12, 12) > 0.5
        gt = (rng.rand(3, 12, 12) > 0.5).astype(np.int64)
        gt[:, :2] = 255
        return pred, gt

    samples = [sample() for _ in range(4)]
    samples.append((np.zeros((3, 12, 12), bool), np.zeros((3, 12, 12), np.int64)))
    fn = f"validate_{which}"
    want = getattr(jtrainer, fn)(lambda s: s, samples)
    logger = ttrainer.ScalarLogger(str(tmp_path))
    got = getattr(ttrainer, fn)(lambda s: s, samples, logger=logger, epoch=1)
    assert got == want
    assert 0.0 < got[0] <= 1.0 and 0.0 < got[1] <= 1.0


def test_train_configs_match_jax():
    assert port_config(jconfig.TrainConfig()) == tconfig.TrainConfig()
    assert port_config(jconfig.LoRAConfig()) == tconfig.LoRAConfig()
    assert dataclasses.asdict(TCFG) == dataclasses.asdict(JTCFG)


def test_training_modules_import_and_run_without_jax():
    """The training path imports neither jax nor videoglamm_tpu: with both
    blocked, build a tiny model for training on the CPU and take a step."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'optax', 'orbax', 'videoglamm_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from videoglamm_torch.config import (LoRAConfig, TrainConfig,\n"
        "                                     VideoGLaMMConfig)\n"
        "from videoglamm_torch.training import build_training\n"
        "from videoglamm_torch.training import trainer\n"
        "from videoglamm_torch.io import checkpoint\n"
        "from videoglamm_torch.evals import metrics\n"
        "cfg = VideoGLaMMConfig.tiny(num_frames=4)\n"
        "tcfg = TrainConfig(warmup_steps=0, grad_accum_steps=1,\n"
        "                   lora=LoRAConfig(r=2))\n"
        "tr = build_training(cfg, tcfg, device='cpu', dtype=torch.float32)\n"
        "ids = torch.randint(1, 400, (1, 8)); ids[0, 2] = -200; ids[0, 5] = 500\n"
        "lab = ids.clone(); lab[lab < 0] = -100\n"
        "gt = (torch.rand(1, 4, 1, 32, 32) > 0.5).float()\n"
        "state, m = tr.train_step(tr.state, dict(\n"
        "    frames=torch.randn(1, 4, 28, 28, 3),\n"
        "    context_images=torch.randn(1, 4, 56, 56, 3),\n"
        "    frames_sam=torch.randn(1, 1, 128, 128, 3), input_ids=ids,\n"
        "    text_lens=torch.tensor([8]), labels=lab,\n"
        "    video_idx=torch.tensor([0]), gt_masks=gt))\n"
        "assert state.step == 1 and torch.isfinite(m['loss'])\n"
        "assert not any(k.split('.')[0] in ('jax', 'flax', 'optax', 'orbax',\n"
        "                                   'videoglamm_tpu') and v is not None\n"
        "               for k, v in sys.modules.items())\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, env=dict(os.environ, PYTHONPATH=root),
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")
