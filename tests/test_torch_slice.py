"""The whole videoglamm_torch GCG slice against the JAX package on the CPU.

`VideoGLaMMConfig.tiny()` weights are shaped by `jax.eval_shape` and filled
from a numpy seed, then loaded into the port through `io/from_jax.py`. The
LLM is compared teacher-forced (ROADMAP.md: greedy argmax on random
weights flips under rounding and the flip cascades): one fixed stream of
new tokens with [SEG] at two steps goes through the port's prefill and
cached decode steps, and through ONE uncached JAX forward. Then the [SEG]
embeddings and the mask logits. One JAX compile for the whole slice.

Tolerances (f32): 1e-4 on activations, logits and hidden states; 1e-3 on
mask logits, whose magnitudes reach O(10) after the two-way transformer
and the hypernetwork product (guidance from the f32 controls in
parity/parity_modules_cpu.json).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import seeded_params
from videoglamm_tpu.config import VideoGLaMMConfig
from videoglamm_tpu.constants import IMAGE_TOKEN_INDEX
from videoglamm_tpu.models import VideoGLaMM as JVideoGLaMM
from videoglamm_tpu.models.multimodal import splice_visual_prefix as jsplice
from videoglamm_tpu.models.videoglamm import SegExtraction as JSeg
from videoglamm_torch.inference.generate import (GenerateResult, decode_step,
                                                 prefill)
from videoglamm_torch.inference.pipeline import (GroundedInference,
                                                 extract_seg_from_generation)
from videoglamm_torch.io.from_jax import port_config, videoglamm_state_dict
from videoglamm_torch.models.videoglamm import VideoGLaMM
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = VideoGLaMMConfig.tiny(num_frames=4)
SEG = CFG.seg_token_idx
S_TEXT = 16
FORCED = np.array([[7, SEG, 33, 41, SEG, 9]], np.int32)
TOL = 1e-4


def _inputs():
    rng = np.random.RandomState(0)
    T = CFG.num_frames
    frames = rng.randn(1, T, 28, 28, 3).astype(np.float32)
    ctx = rng.randn(1, T, 56, 56, 3).astype(np.float32)
    sam = rng.randn(1, 2, 128, 128, 3).astype(np.float32)
    ids = rng.randint(1, 400, size=(1, S_TEXT)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    return frames, ctx, sam, ids


def _jax_slice(mdl, frames, ctx, sam, ids_full, lens_full):
    """Visual prefix, one uncached LLM forward over prompt + FORCED, the
    [SEG] extraction of pipeline.py:36-53 and the batched mask decode."""
    visual = mdl.encode_visual_prefix(frames, ctx)
    emb = mdl.llm.embed(ids_full)
    sp = jsplice(emb, ids_full, visual, lens_full)
    logits, hidden, _ = mdl.llm(sp.embeds, sp.positions, sp.attn_lens)
    n = FORCED.shape[1]
    start = sp.attn_lens[0] - n                   # first forced position
    gen_hidden = jax.lax.dynamic_slice_in_dim(hidden, start, n, axis=1)
    tokens = jnp.asarray(FORCED)
    pos = jnp.arange(n)[None]
    is_seg = tokens == SEG
    idx = jnp.argsort(jnp.where(is_seg, pos, n + pos), axis=1)[:, :CFG.max_seg_tokens]
    valid = jnp.take_along_axis(is_seg, idx, axis=1)
    h = jnp.take_along_axis(gen_hidden, idx[..., None], axis=1)
    seg_emb = jnp.where(valid[..., None], mdl.text_hidden_fcs(h), 0.0)
    feats, _ = mdl.encode_sam_features(sam)
    masks = mdl.decode_masks(feats, JSeg(seg_emb, valid, idx),
                             jnp.arange(1, dtype=jnp.int32), training=False)
    return visual, logits, gen_hidden, seg_emb, masks


@pytest.fixture(scope="module")
def slice_setup():
    frames, ctx, sam, ids = _inputs()
    ids_full = np.concatenate([ids, FORCED], axis=1)
    lens_full = np.array([ids_full.shape[1]], np.int32)
    jm = JVideoGLaMM(CFG, dtype=jnp.float32)
    args = (frames, ctx, sam, ids_full, lens_full)
    params = seeded_params(lambda: jm.init(jax.random.PRNGKey(0), *args,
                                           method=_jax_slice), 7)
    ref = jax.jit(lambda p, *a: jm.apply(p, *a, method=_jax_slice))(params, *args)
    ref = [np.asarray(r, np.float32) for r in ref]
    tm = VideoGLaMM(port_config(CFG)).eval()
    tm.load_weights(videoglamm_state_dict(params, CFG))
    inputs = [torch.from_numpy(a) for a in (frames, ctx, sam, ids)]
    return tm, inputs, ref


def _close(got, ref, tol, what):
    np.testing.assert_allclose(got.detach().float().numpy(), ref, atol=tol,
                               rtol=tol, err_msg=what)


def test_slice_teacher_forced_matches_jax(slice_setup):
    tm, (frames, ctx, sam, ids), (visual, logits, gen_hidden, seg_emb,
                                  masks) = slice_setup
    n = FORCED.shape[1]
    with torch.no_grad():
        tvis = tm.encode_visual_prefix(frames, ctx)
        _close(tvis, visual, TOL, "visual prefix")
        h_pre, cache, sp, last_logits = prefill(tm.llm, tvis, ids,
                                                torch.tensor([S_TEXT]), n)
        s_pre = int(sp.attn_lens[0])
        _close(last_logits[0], logits[0, s_pre - 1], TOL, "prefill logits")
        pos = sp.attn_lens.clone()
        hiddens = []
        for i in range(n):
            lg, h = decode_step(tm.llm, cache, torch.from_numpy(FORCED[:, i]),
                                pos + i)
            _close(h[0], gen_hidden[0, i], TOL, f"step {i} hidden")
            _close(lg[0], logits[0, s_pre + i], TOL, f"step {i} logits")
            hiddens.append(h)
        gen = GenerateResult(tokens=torch.from_numpy(FORCED).long(),
                             hidden=torch.stack(hiddens, dim=1),
                             lengths=torch.tensor([n]), prefill_hidden=h_pre,
                             prefill_len=sp.attn_lens)
        seg = extract_seg_from_generation(tm, gen)
        assert seg.valid[0].tolist() == [True, True, False, False]
        _close(seg.embeds, seg_emb, TOL, "[SEG] embeddings")
        feats, _ = tm.encode_sam_features(sam)
        tmasks = tm.decode_masks(feats, seg, torch.arange(1))
        _close(tmasks, masks, 1e-3, "mask logits")


def test_grounded_inference_contract(slice_setup):
    """Free-running greedy serving through the port's entry point."""
    tm, (frames, ctx, sam, ids), _ = slice_setup
    timings = {}
    out = GroundedInference(tm, max_new_tokens=6)(frames, ctx, sam, ids,
                                                  torch.tensor([S_TEXT]),
                                                  timings=timings)
    E4 = 4 * CFG.sam2.low_res_size
    assert out.tokens.shape == (1, 6) and out.lengths.shape == (1,)
    assert out.seg_valid.shape == (1, CFG.max_seg_tokens)
    assert out.pred_masks.shape == (1, CFG.max_seg_tokens, 2, E4, E4)
    assert torch.isfinite(out.pred_masks).all()
    invalid = ~out.seg_valid[0]
    assert (out.pred_masks[0][invalid] <= -1e3).all()
    assert set(timings) == {"visual", "generate", "sam_encode", "mask_decode"}


def test_port_imports_and_runs_without_jax(tmp_path):
    """videoglamm_torch imports neither jax nor videoglamm_tpu: with both
    blocked, import the package, the pipeline, the quantisation and
    preprocessing modules and the tracker's modules, and serve a tiny model
    on the CPU: bf16-mode from streams, int8 (weights + KV cache) from raw
    frames, and the video branch (the memory tracker) from raw frames; load
    it back from reference-layout shards through `load_reference_dir`; and
    drive a tiny SAM-1 built by `build_sam1` through its predictor, its
    generator and `track_frames`; import the training data layer and the
    train CLI, build one collated batch from a GCG fixture in tmp_path and
    take the training forward on it; import the evaluation layer and the
    serving CLIs, tokenize a prompt, make the vision inputs and resize
    masks through their helpers; run `verify_parity` (import and quant
    stages, int8 and int4) on the reference-layout files, and see
    `--synthetic` refuse with an ImportError naming `transformers`; trace a
    region with `utils.profiling`; segment boxes with the datagen
    segmenter on a tiny SAM-2; import the last data modules; build an f32
    model for training and take a forward and backward through its towers
    (`freeze_towers=False`) inside `full_precision`; serve an f32 model
    with int4 weights and the int8 cache; import `parallel` and take one
    sharded step on the one-process mesh; then import every module of the
    package (`pkgutil.walk_packages`). `transformers` is blocked too."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'videoglamm_tpu', 'transformers'):\n"
        "    sys.modules[name] = None\n"
        "import json, torch, videoglamm_torch\n"
        "from videoglamm_torch.inference.pipeline import GroundedInference\n"
        "from videoglamm_torch.models.videoglamm import VideoGLaMM\n"
        "from videoglamm_torch.io import from_jax\n"
        "from videoglamm_torch.ops import preprocess, quant, resize, rope\n"
        "from videoglamm_torch.models.sam2 import (memory, sam2_base,\n"
        "    video_predictor, prompt_encoder, transformer, hiera,\n"
        "    image_predictor, amg, interactive)\n"
        "from videoglamm_torch.ops import connected_components\n"
        "from videoglamm_torch.data import rle\n"
        "from videoglamm_torch.inference.pipeline import build_sam2\n"
        "from videoglamm_torch.inference.pipeline import build_inference\n"
        "from videoglamm_torch.config import VideoGLaMMConfig\n"
        "cfg = VideoGLaMMConfig.tiny(num_frames=4)\n"
        "m = VideoGLaMM(cfg).eval()\n"
        "ids = torch.randint(1, 400, (1, 8)); ids[0, 2] = -200\n"
        "out = GroundedInference(m, max_new_tokens=4)(\n"
        "    torch.randn(1, 4, 28, 28, 3), torch.randn(1, 4, 56, 56, 3),\n"
        "    torch.randn(1, 1, 128, 128, 3), ids, torch.tensor([8]))\n"
        "assert out.pred_masks.shape == (1, 4, 1, 32, 32)\n"
        "gi = build_inference(cfg, device='cpu', dtype=torch.float32,\n"
        "                     quant='int8', kv_cache='int8', max_new_tokens=4)\n"
        "raw = torch.randint(0, 256, (1, 4, 48, 85, 3), dtype=torch.uint8)\n"
        "out = gi.serve_raw(raw, ids, torch.tensor([8]), num_sam_frames=1)\n"
        "assert out.pred_masks.shape == (1, 4, 1, 32, 32)\n"
        "out = gi.serve_raw(raw, ids, torch.tensor([8]), use_video_branch=True)\n"
        "assert out.pred_masks.shape == (1, 4, 4, 32, 32)\n"
        "assert torch.isfinite(out.pred_masks).all()\n"
        "import numpy as np\n"
        "from videoglamm_torch.io import reference\n"
        "from videoglamm_torch.models import sam1, sam1_predictor\n"
        "from videoglamm_torch.inference.pipeline import build_sam1\n"
        "hf, iv, clip = reference.to_reference_layout(m.state_dict(), cfg)\n"
        f"d = {str(tmp_path)!r}\n"
        "torch.save(hf, d + '/pytorch_model.bin')\n"
        "torch.save({'module': iv}, d + '/iv.pt'); torch.save(clip, d + '/clip.bin')\n"
        "gi = reference.load_reference_dir(d, cfg, d + '/iv.pt', d + '/clip.bin',\n"
        "    quant='int8', device='cpu', dtype=torch.float32, max_new_tokens=4)\n"
        "out = gi.serve_raw(raw, ids, torch.tensor([8]), num_sam_frames=1)\n"
        "assert torch.isfinite(out.pred_masks).all()\n"
        "from videoglamm_torch.cli import verify_parity\n"
        "rc = verify_parity.main(['--checkpoint', d, '--internvideo_ckpt',\n"
        "    d + '/iv.pt', '--clip_ckpt', d + '/clip.bin', '--device', 'cpu',\n"
        "    '--stages', 'import,quant', '--int4', '--out_dir', d + '/vp'])\n"
        "rep = json.load(open(d + '/vp/parity_report.json'))\n"
        "assert rc == 0 and not rep['stages']['import']['random_init_modules'], rep\n"
        "try:\n"
        "    verify_parity.main(['--synthetic', '--device', 'cpu', '--out_dir', d + '/vs'])\n"
        "    raise SystemExit('--synthetic ran without transformers')\n"
        "except ImportError as e:\n"
        "    assert 'transformers' in str(e)\n"
        "from videoglamm_torch.utils import (profiling, profile_trace, annotate,\n"
        "    StepTimer, device_memory_report)\n"
        "with profile_trace(d + '/trace'):\n"
        "    with annotate('no-jax'):\n"
        "        torch.ones(8).sum()\n"
        "assert 'no-jax' in open(d + '/trace/' + profiling.TRACE_FILE).read()\n"
        "assert set(device_memory_report()[0]) == {'device', 'bytes_in_use',\n"
        "    'peak_bytes_in_use', 'bytes_limit'}\n"
        "from videoglamm_torch.datagen import (GCGAnnotationPipeline, StubLLM,\n"
        "    parse_dense_caption, mask_extract, gcg_pipeline)\n"
        "from videoglamm_torch.config import SAM2Config\n"
        "seg = mask_extract.Sam2BoxSegmenter(build_sam2(SAM2Config.tiny(),\n"
        "    device='cpu', dtype=torch.float32))\n"
        "frame = np.random.RandomState(1).randint(0, 256, (40, 48, 3), np.uint8)\n"
        "assert seg(frame, [[5, 5, 30, 25], [1, 2, 40, 38]]).shape == (2, 40, 48)\n"
        "from videoglamm_torch.data import refer_api\n"
        "from videoglamm_torch.data.datasets import (refer_seg, sem_seg,\n"
        "    grounding_extra, grounded_video_qa, video_gcg_extra,\n"
        "    ReferSegDataset, CocoPartSegDataset, ANetEntitiesGCGDataset,\n"
        "    build_val_gcg)\n"
        "from videoglamm_torch.config import SAM1Config\n"
        "import dataclasses\n"
        "s1 = build_sam1(dataclasses.replace(SAM1Config.tiny(), with_itm=True),\n"
        "                device='cpu', dtype=torch.float32)\n"
        "img = np.random.RandomState(0).randint(0, 256, (40, 50, 3), np.uint8)\n"
        "p = sam1_predictor.SAM1ImagePredictor(s1)\n"
        "p.set_image(img)\n"
        "masks, ious, low = p.predict(point_coords=np.array([[20.0, 10.0]]),\n"
        "                             point_labels=np.array([1]))\n"
        "assert masks.shape == (3, 40, 50) and low.shape == (3, 32, 32)\n"
        "recs = sam1_predictor.SAM1AutomaticMaskGenerator(s1, points_per_side=2,\n"
        "    pred_iou_thresh=0.0, stability_score_thresh=0.0).generate(img)\n"
        "assert len(recs) > 0\n"
        "tr = s1.track_frames(torch.randn(3, 128, 128, 3), torch.randn(2, 1, 32))\n"
        "assert tr.shape == (2, 3, 32, 32) and torch.isfinite(tr).all()\n"
        "import json, os, types\n"
        "from PIL import Image\n"
        "from videoglamm_torch.cli import common as cli_common, train as cli_train\n"
        "from videoglamm_torch.data import (conversation, preprocess, collate,\n"
        "    augment, prefetch, video_reader)\n"
        "from videoglamm_torch.data.datasets import (base, templates, video_gcg,\n"
        "    refer_vos, reason_seg, vqa, refer_eval)\n"
        "g = d + '/gcg'\n"
        "os.makedirs(g + '/f/v0')\n"
        "for t in range(3):\n"
        "    Image.fromarray(np.random.RandomState(t).randint(\n"
        "        0, 255, (24, 32, 3), np.uint8)).save(f'{g}/f/v0/{t}.jpg')\n"
        "m0 = np.zeros((24, 32), bool); m0[2:10, 3:12] = True\n"
        "json.dump({'videos': [{'file_names': [f'v0/{t}.jpg' for t in range(3)],\n"
        "    'width': 32, 'height': 24, 'length': 3, 'dense_cap': {\n"
        "    'caption': 'a dog runs', 'token_pos': [1], 'mask_id': [7],\n"
        "    'v_id2o_id': {}}}], 'annotations': [{'id': 7, 'segmentations':\n"
        "    [rle.rle_encode(m0), None, rle.rle_encode(m0)]}]},\n"
        "    open(g + '/train.json', 'w'))\n"
        "tok = lambda text: types.SimpleNamespace(input_ids=[1] + [\n"
        "    cfg.seg_token_idx if w == '[SEG]' else 10 + len(w) for w in text.split()])\n"
        "b = base.SampleBuilder(cfg, tok, max_text_len=64, num_frames_for_sam=2)\n"
        "ds = video_gcg.GCGVideoDataset(g + '/train.json', g + '/f', max_num_frames=2)\n"
        "batch = collate.build_batch([b(ds[0])], max_text_len=64, mask_hw=b.mask_hw)\n"
        "assert batch['input_ids'].dtype == torch.int64\n"
        "assert int((batch['input_ids'] == cfg.seg_token_idx).sum()) == 1\n"
        "out = m(**prefetch.to_device(batch, 'cpu'))\n"
        "assert torch.isfinite(out.loss) and float(out.mask_bce_loss) > 0\n"
        "from videoglamm_torch.evals import (metrics, postprocess,\n"
        "    caption_metrics, clair)\n"
        "from videoglamm_torch.data import anet_entities\n"
        "from videoglamm_torch.cli import (chat, eval_gcg_infer,\n"
        "    eval_gcg_metrics, eval_refer_infer, eval_referdavis_metrics,\n"
        "    eval_grounding, eval_anet_entities_infer, convert_checkpoint)\n"
        "ids, lens = cli_common.tokenize_prompt('a <image> b', tok, 8)\n"
        "assert ids.shape == (1, 8) and int(lens[0]) == 5\n"
        "inp = cli_common.prepare_vision_inputs(\n"
        "    [np.zeros((24, 32, 3), np.uint8)] * 4, cfg, num_sam_frames=1)\n"
        "assert inp[2].shape == (1, 1, 128, 128, 3) and inp[3] == (24, 32)\n"
        "assert postprocess.masks_to_original_size(torch.zeros(2, 8, 8), (5, 7)).shape == (2, 5, 7)\n"
        "assert sys.modules.get('transformers') is None\n"
        "if not torch.cuda.is_available():\n"
        "    try:\n"
        "        build_sam1(SAM1Config.tiny())\n"
        "        raise SystemExit('build_sam1 built on a missing card')\n"
        "    except RuntimeError:\n"
        "        pass\n"
        "from videoglamm_torch.models.common import set_exact_f32, full_precision\n"
        "from videoglamm_torch.ops import attention, fused_block, norms\n"
        "from videoglamm_torch.models import phi3, llama, internvideo2, clip_vit\n"
        "from videoglamm_torch.training import train_step, build_training\n"
        "assert attention.k1_route(torch.float32, 72, True) == 'simt_f32'\n"
        "assert attention.k1_route(torch.float32, 72) == 'wgmma_f32'\n"
        "assert attention.k8_route(torch.float32, True) == 'simt_f32'\n"
        "gi = build_inference(cfg, device='cpu', dtype=torch.float32,\n"
        "                     quant='int4', kv_cache='int8', max_new_tokens=4)\n"
        "assert gi.model.exact_f32 and gi.model.quant_kv_int8\n"
        "out = gi.serve_raw(raw, ids, torch.tensor([8]), num_sam_frames=1)\n"
        "assert torch.isfinite(out.pred_masks).all()\n"
        "from videoglamm_torch.config import TrainConfig\n"
        "trn = build_training(cfg, TrainConfig(), device='cpu', dtype=torch.float32)\n"
        "assert trn.model.exact_f32\n"
        "trn.model.requires_grad_(True)\n"
        "with full_precision(True):\n"
        "    out = trn.model(**prefetch.to_device(batch, 'cpu'), freeze_towers=False)\n"
        "out.loss.backward()\n"
        "g = trn.model.visual_model.image_encoder.trunk.blocks[0].attn.qkv.weight.grad\n"
        "assert g is not None and torch.isfinite(g).all()\n"
        "from videoglamm_torch.parallel import (mesh as pmesh, partitioning,\n"
        "    distributed, collectives, create_mesh, global_device_mesh,\n"
        "    initialize_distributed, is_main_process, shard_params)\n"
        "from videoglamm_torch.training import (make_sharded_train_step,\n"
        "    opt_state_partition_spec)\n"
        "initialize_distributed()\n"
        "assert is_main_process() and global_device_mesh().shape == {'data': 1, 'model': 1}\n"
        "trn = build_training(cfg, TrainConfig(warmup_steps=0), device='cpu',\n"
        "                     dtype=torch.float32)\n"
        "step, st, split = make_sharded_train_step(trn.model, trn.tx,\n"
        "    create_mesh(), trn.state)\n"
        "st, mt = step(st, split(prefetch.to_device(batch, 'cpu')))\n"
        "assert st.step == 1 and torch.isfinite(mt['loss'])\n"
        "import importlib, pkgutil\n"
        "mods = [i.name for i in pkgutil.walk_packages(videoglamm_torch.__path__,\n"
        "                                               'videoglamm_torch.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "assert 'videoglamm_torch.ops.tf32x3' in mods and len(mods) > 100\n"
        "assert not any(k.split('.')[0] in ('jax', 'flax', 'videoglamm_tpu')\n"
        "               and v is not None\n"
        "               for k, v in sys.modules.items())\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")
