"""The port's parity harness (videoglamm_torch.cli.verify_parity) against
videoglamm_tpu.cli.verify_parity on the CPU, with no reference checkout.

A tiny port VideoGLaMM (`VideoGLaMMConfig.tiny(num_frames=4)`) is seeded
in torch and written complete in the reference layout by
`to_reference_layout` (HF export, InternVideo2 and CLIP files; every module,
SAM-2 and its tracker too), so neither harness fills anything.

- Both harnesses read it: the import-stage reports are equal (the JAX
  harness runs once, import stage only, in a module fixture). The port's
  modules stage is `ok` against HF Phi-3 and CLIP and the exported
  text_hidden_fcs; its quant stage reports int8 and int4.
- The float `clip_run`: the JAX run on the JAX tree composed from the same
  files and the port's on its composed state dict, on the batch both draw
  from `RandomState(seed)`. The port is held teacher-forced along JAX's
  generated stream: logits to TOL = 4.3e-5 (the f32 Phi-3 control of
  parity/parity_modules_cpu.json) and mask logits to TOL_MASK = 2.2e-6
  (twice the SAM-2 decoder's control, 1.1e-6), each relative to
  max(1, max |ref|), as tests/test_torch_reference_io.py holds them.
- The int8 and int4 codes and scales of the quantised LLM equal JAX's
  `quantize_videoglamm_llm` on the same weights.
- `--synthetic --scale tiny` exits 0 with every oracle that runs here `ok`
  (the reference SAM-2 and InternVideo2 oracles are absent, so those two
  modules are filled); the copy of the golden SAM-2 config equals the JAX
  test's `CFG`; `--device cuda` with the modules stage raises before it
  reads the checkpoint.
No Pallas kernel runs here: the JAX side is the float model's XLA path.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_sam2_full_golden import CFG as GOLDEN_SAM2
from test_torch_reference_io import seed_port
from videoglamm_tpu.cli import verify_parity as jvp
from videoglamm_tpu.config import VideoGLaMMConfig
from videoglamm_tpu.inference.generate import generate_with_prefix as jgenerate
from videoglamm_tpu.inference.pipeline import extract_seg_from_generation as jextract
from videoglamm_tpu.io import import_torch as jimp
from videoglamm_tpu.models import VideoGLaMM as JVideoGLaMM
from videoglamm_torch.cli import verify_parity as vp
from videoglamm_torch.inference.generate import GenerateResult
from videoglamm_torch.inference.pipeline import (build_inference,
                                                 extract_seg_from_generation)
from videoglamm_torch.io import from_jax
from videoglamm_torch.io import reference as ref_io
from videoglamm_torch.models.videoglamm import VideoGLaMM
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = VideoGLaMMConfig.tiny(num_frames=4)
TCFG = from_jax.port_config(CFG)
TOL = 4.3e-5
TOL_MASK = 2.2e-6
SEED = 0


def _close(got, ref, tol, what):
    ref = np.asarray(ref, np.float32)
    t = tol * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, atol=t,
                               rtol=0, err_msg=what)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    tm = seed_port(VideoGLaMM(TCFG).eval(), 11)
    hf, iv, clip = ref_io.to_reference_layout(tm.state_dict(), TCFG)
    torch.save(hf, d / "pytorch_model.bin")
    torch.save({"module": iv}, d / "internvideo2.pt")
    torch.save(clip, d / "clip_vision.bin")
    return {"dir": str(d), "iv": str(d / "internvideo2.pt"),
            "clip": str(d / "clip_vision.bin")}


def _argv(ckpt, out, name, stages, *extra):
    return ["--checkpoint", ckpt["dir"], "--internvideo_ckpt", ckpt["iv"],
            "--clip_ckpt", ckpt["clip"], "--out_dir", str(out),
            "--report_name", name, "--stages", stages, *extra]


@pytest.fixture(scope="module")
def jax_report(ckpt, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax")
    assert jvp.main(_argv(ckpt, out, "jax.json", "import")) == 0
    return json.load(open(out / "jax.json"))


@pytest.fixture(scope="module")
def port_run(ckpt, tmp_path_factory):
    out = tmp_path_factory.mktemp("port")
    rc = vp.main(_argv(ckpt, out, "port.json", "import,modules,quant",
                       "--device", "cpu", "--int4"))
    return rc, json.load(open(out / "port.json"))


def test_import_report_equals_jax(jax_report, port_run):
    _, rep = port_run
    assert rep["stages"]["import"] == jax_report["stages"]["import"]
    assert rep["stages"]["import"]["imported_modules"] == [
        "image_mm_projector", "image_vision_tower", "llm", "mm_projector",
        "sam", "text_hidden_fcs", "vision_tower"]
    assert rep["serving_dtype"] == jax_report["serving_dtype"] == "float32"


def test_modules_and_quant_stages_ok(port_run):
    rc, rep = port_run
    assert rc == 0 and rep["ok"]
    mods = rep["stages"]["modules"]
    for name in ("phi3_logits", "text_hidden_fcs", "clip_features"):
        assert mods[name]["ok"], (name, mods[name])
        assert mods[name]["max_abs"] <= TOL, (name, mods[name])
    # the reference SAM-2 oracle needs the reference checkout
    assert mods["sam2_mask_decoder"].get("ok") or "skipped" in mods["sam2_mask_decoder"]
    quant = rep["stages"]["quant"]
    assert quant["int8"]["ok"] and quant["int4"]["advisory"]
    for mode in ("int8", "int4"):
        assert 0.0 <= quant[mode]["token_agreement"] <= 1.0
        assert quant[mode]["seg_valid"] == rep["runs"][mode]["seg_valid"]
    assert set(rep["runs"]) == {"float", "int8", "int4"}
    assert rep["runs"]["float"]["peak_bytes"] is None       # no card here


def _sources(ckpt):
    return ref_io.read_reference_dir(ckpt["dir"], ckpt["iv"], ckpt["clip"])


def test_float_clip_run_teacher_forced_against_jax(ckpt):
    hf, iv, clip = _sources(ckpt)
    params, imp = vp.compose(hf, TCFG, iv, clip, SEED)
    assert imp["ok"] and not imp["random_init_modules"]
    tm = build_inference(TCFG, params, device="cpu", dtype=torch.float32).model
    batch, _ = vp.make_batch(TCFG, SEED, torch.float32, "cpu")
    tokens, masks, n_seg = vp.clip_run(tm, batch)
    assert tokens.shape == (1, vp.N_NEW) and np.isfinite(masks).all()
    assert masks.shape == (1, CFG.max_seg_tokens, vp.T_SAM, 32, 32)

    # the JAX harness's clip_run on the same files and the same draws
    tree = jimp.compose_videoglamm_params(hf, CFG, iv, clip)
    p = {"params": jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                          tree)}
    jm = JVideoGLaMM(CFG, dtype=jnp.float32)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jb["input_ids"] = jb["input_ids"].astype(jnp.int32)
    jb["text_lens"] = jb["text_lens"].astype(jnp.int32)
    visual = jax.jit(lambda p, a, b: jm.apply(
        p, a, b, method=lambda m, a, b: m.encode_visual_prefix(a, b)))(
            p, jb["frames"], jb["context_images"])
    gen = jgenerate(jm, p, visual, jb["input_ids"], jb["text_lens"],
                    max_new_tokens=vp.N_NEW, eos_id=-1)
    seg = jextract(jm, p, gen)
    jmasks = np.asarray(jax.jit(lambda p, a, s: jm.apply(
        p, a, s, method=lambda m, a, s: m.decode_masks(
            m.encode_sam_features(a)[0], s, jnp.zeros((1,), jnp.int32),
            training=False)))(p, jb["frames_sam"], seg))
    jtokens = np.asarray(gen.tokens)
    ids_full = np.concatenate([batch["input_ids"].numpy(), jtokens], axis=1)
    lens_full = np.array([ids_full.shape[1]], np.int32)
    jlogits = np.asarray(jax.jit(lambda p, v, i, l: jm.apply(
        p, v, i, l, method=lambda m, v, i, l: m.lm_forward(v, i, l)[0]))(
            p, visual, jnp.asarray(ids_full, jnp.int32), jnp.asarray(lens_full)))

    n = vp.N_NEW
    with torch.no_grad():
        tvis = tm.encode_visual_prefix(batch["frames"], batch["context_images"])
        _close(tvis, visual, TOL, "visual prefix")
        logits, hidden, sp = tm.lm_forward(tvis, torch.from_numpy(ids_full),
                                           torch.from_numpy(lens_full).long())
        L = int(sp.attn_lens[0])
        _close(logits[:, :L], jlogits[:, :L], TOL,
               "logits along JAX's generated stream")
        # each generated token is the argmax at the position before it
        assert (jlogits[0, L - n - 1:L - 1].argmax(-1) == jtokens[0]).all()
        tseg = extract_seg_from_generation(tm, GenerateResult(
            tokens=torch.from_numpy(jtokens.copy()).long(), hidden=hidden[:, L - n:L],
            lengths=torch.tensor([n]), prefill_hidden=None, prefill_len=None))
        assert int(tseg.valid.sum()) == int(np.asarray(seg.valid).sum())
        tfeats, _ = tm.encode_sam_features(batch["frames_sam"])
        tmasks = tm.decode_masks(tfeats, tseg, torch.zeros(1, dtype=torch.long))
        _close(tmasks, jmasks, TOL_MASK, "mask logits")
    if (tokens == jtokens).all():
        _close(masks, jmasks, TOL_MASK, "clip_run masks")
        assert n_seg == int(np.asarray(seg.valid).sum())


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantised_codes_equal_jax(ckpt, mode):
    hf, iv, clip = _sources(ckpt)
    params, _ = vp.compose(hf, TCFG, iv, clip, SEED)
    tm = build_inference(TCFG, params, device="cpu", dtype=torch.float32,
                         quant=mode).model
    got = {k: v for k, v in tm.state_dict().items() if k.startswith("llm.")}
    tree = jimp.compose_videoglamm_params(hf, CFG, iv, clip)
    qtree = jimp.quantize_videoglamm_llm(tree, mode=mode)
    want = {k: v for k, v in from_jax.videoglamm_state_dict(qtree, CFG).items()
            if k.startswith("llm.")}
    assert set(got) == set(want)
    n_codes = 0
    for k, w in want.items():
        if w.dtype == torch.int8:
            n_codes += 1
            assert torch.equal(got[k], w), k
        else:
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6,
                                       atol=0, err_msg=k)
    assert n_codes == 4 * CFG.llm.num_layers + 1


def test_synthetic_tiny_run(tmp_path):
    rc = vp.main(["--synthetic", "--scale", "tiny", "--device", "cpu",
                  "--out_dir", str(tmp_path)])
    rep = json.load(open(tmp_path / "parity_report.json"))
    assert rc == 0 and rep["ok"], rep
    imp = rep["stages"]["import"]
    assert not imp["unmatched"]
    # no reference checkout here: the SAM-2 and InternVideo2 oracles that
    # would write those modules are absent
    assert imp["random_init_modules"] == ["sam", "vision_tower"]
    mods = rep["stages"]["modules"]
    for name in ("phi3_logits", "text_hidden_fcs", "clip_features"):
        assert mods[name]["ok"], (name, mods[name])
    assert rep["stages"]["quant"]["int8"]["ok"]
    ck = tmp_path / "synthetic_ckpt"
    assert (ck / "pytorch_model.bin").exists() and (ck / "clip_vision.bin").exists()


def test_golden_sam2_config_copy_equals_jax():
    assert vp.SAM2_TINY_GOLDEN == from_jax.port_config(GOLDEN_SAM2)


def test_cuda_refuses_the_modules_stage_before_loading(tmp_path):
    absent = str(tmp_path / "no_such_checkpoint")
    with pytest.raises(NotImplementedError, match="modules and eval"):
        vp.main(["--checkpoint", absent, "--device", "cuda"])
    with pytest.raises(NotImplementedError):
        vp.main(["--checkpoint", absent, "--device", "cuda", "--stages",
                 "import,eval", "--reason_seg_root", absent, "--tokenizer",
                 absent])
    if not torch.cuda.is_available():
        # the quant stage on the card in bf16 and in f32 (the default at
        # tiny scale; its quantised runs take K5's and K4's f32 routes) is
        # refused by nothing but the missing card
        for extra in ([], ["--dtype", "f32"], ["--scale", "flagship", "--dtype",
                                               "f32", "--int4"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                vp.main(["--checkpoint", absent, "--stages", "import,quant",
                         *extra])
    assert not os.path.exists(absent)
