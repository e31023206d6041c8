"""The quantised f32 serving slice at batch 3 against the JAX package on
the CPU: three raw clips and three prompts of different text lengths in one
batch, int8 or int4 weights and the int8 KV cache, teacher-forced.

As tests/test_torch_slice_quant.py's `check_slice_against_jax` does at
batch 1: the tiny composite in f32 on the JAX package's quantised tree
(`quantize_videoglamm_llm`, loaded into the port through `io/from_jax.py`),
raw frames -> the three preprocessed streams -> visual prefix -> prefill
of the zero-padded prompts (each row's own length) -> six cached decode
steps over each row's own forced token stream, [SEG] at other steps in
each row -> [SEG] embeddings -> mask logits of every row's clip, on both
sides. On the card K5 takes these three rows at once (its f32 tensor-core
route) and K4 the three cache rows; here the port runs the kernels' plain
twins, so this holds the batched pipeline (the splice of prompts of three
lengths, the per-row positions and cache lengths, the [SEG] extraction and
the mask decode over three videos) to JAX.

Tolerances are the f32 controls of tests/test_torch_slice_quant.py: 1e-4 on
logits and hidden states and 1e-3 on mask logits while the two int8 caches
hold the same codes; once a code differs (by one: a last-bit difference
before round()), under 1e-3 of them, and the outputs at 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice_quant import CFG, LOOSE, SEG, S_TEXT, T_SAM, TOL, TOL_MASK
from test_torch_slice_quant import _close, float_params  # noqa: F401
from videoglamm_tpu.constants import IMAGE_TOKEN_INDEX
from videoglamm_tpu.io.import_torch import quantize_videoglamm_llm
from videoglamm_tpu.models import VideoGLaMM as JVideoGLaMM
from videoglamm_tpu.models.multimodal import splice_visual_prefix as jsplice
from videoglamm_tpu.models.phi3 import init_kv_cache as jinit_kv_cache
from videoglamm_tpu.models.videoglamm import SegExtraction as JSeg
from videoglamm_tpu.ops import preprocess as jpre
from videoglamm_torch.inference.generate import (GenerateResult, decode_step,
                                                 prefill)
from videoglamm_torch.inference.pipeline import (build_inference,
                                                 extract_seg_from_generation,
                                                 prepare_vision_inputs)
from videoglamm_torch.io.from_jax import port_config, videoglamm_state_dict
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LENS = (S_TEXT, 11, 7)                     # the three prompts' text tokens
FORCED = np.array([[7, SEG, 33, 41, SEG, 9],
                   [12, 5, SEG, 8, 20, 3],
                   [SEG, 3, 44, SEG, 2, SEG]], np.int32)
B = len(LENS)


def _inputs():
    rng = np.random.RandomState(5)
    raw = rng.randint(0, 256, size=(B, CFG.num_frames, 48, 85, 3)).astype(np.uint8)
    ids = np.zeros((B, S_TEXT), np.int32)
    for b, n in enumerate(LENS):
        ids[b, :n] = rng.randint(1, 400, size=n)
        ids[b, 2] = IMAGE_TOKEN_INDEX
    return raw, ids


def _jax_cached_batch(mdl, raw, ids, quant_kv: bool):
    """The JAX request at batch B, teacher-forced: `_jax_cached_slice` of
    tests/test_torch_slice_quant.py with each row's text length, its own
    forced tokens and its own video in the mask decode."""
    sam_idx = np.linspace(0, CFG.num_frames - 1, T_SAM).astype(np.int32)
    frames = jpre.preprocess_iv_stream(raw, CFG.internvideo.image_size)
    ctx = jpre.preprocess_clip_stream(raw, CFG.clip.image_size)
    sam = jpre.preprocess_sam_stream(raw[:, sam_idx], CFG.sam2.image_size)
    visual = mdl.encode_visual_prefix(frames, ctx)
    lens = jnp.asarray(LENS, jnp.int32)
    sp = jsplice(mdl.llm.embed(ids), ids, visual, lens)
    n = FORCED.shape[1]
    cache = jinit_kv_cache(CFG.llm, B, sp.embeds.shape[1] + n + 1,
                           dtype=jnp.float32, quant_kv=quant_kv)
    hidden_pre, cache = mdl.llm.forward_hidden(sp.embeds, sp.positions,
                                               sp.attn_lens, cache)
    logits = [mdl.llm.head(hidden_pre[jnp.arange(B), sp.attn_lens - 1])]
    hiddens = []
    forced = jnp.asarray(FORCED)
    for i in range(n):
        pos = sp.attn_lens + i
        lg, h, cache = mdl.llm(mdl.llm.embed(forced[:, i:i + 1]), pos[:, None],
                               pos + 1, cache)
        logits.append(lg[:, -1])
        hiddens.append(h[:, 0])
    gen_hidden = jnp.stack(hiddens, axis=1)
    posn = jnp.arange(n)[None]
    is_seg = forced == SEG
    idx = jnp.argsort(jnp.where(is_seg, posn, n + posn), axis=1)[:, :CFG.max_seg_tokens]
    valid = jnp.take_along_axis(is_seg, idx, axis=1)
    h = jnp.take_along_axis(gen_hidden, idx[..., None], axis=1)
    seg_emb = jnp.where(valid[..., None], mdl.text_hidden_fcs(h), 0.0)
    feats, _ = mdl.encode_sam_features(sam)
    masks = mdl.decode_masks(feats, JSeg(seg_emb, valid, idx),
                             jnp.arange(B, dtype=jnp.int32), training=False)
    return dict(visual=visual, logits=jnp.stack(logits, axis=1),
                hidden=gen_hidden, seg_emb=seg_emb, masks=masks, cache=cache)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_f32_batch3_with_quantised_weights_and_int8_cache_matches_jax(
        quant, float_params):
    raw, ids = _inputs()
    params = {"params": quantize_videoglamm_llm(float_params["params"], mode=quant)}
    jm = JVideoGLaMM(CFG, dtype=jnp.float32, quant_llm_int8=quant == "int8",
                     quant_llm_int4=quant == "int4", quant_kv_int8=True)
    ref = jax.jit(lambda p, r, i: jm.apply(p, r, i, True,
                                           method=_jax_cached_batch))(params, raw, ids)

    tm = build_inference(port_config(CFG), videoglamm_state_dict(params, CFG),
                         device="cpu", dtype=torch.float32, quant=quant,
                         kv_cache="int8", max_new_tokens=6).model
    n = FORCED.shape[1]
    forced = torch.from_numpy(FORCED).long()
    with torch.no_grad():
        frames, ctx, sam = prepare_vision_inputs(torch.from_numpy(raw), tm.cfg,
                                                 num_sam_frames=T_SAM)
        visual = tm.encode_visual_prefix(frames, ctx)
        h_pre, cache, sp, last = prefill(tm.llm, visual, torch.from_numpy(ids).long(),
                                         torch.tensor(LENS), n, quant_kv=True)
        logits, hiddens = [last], []
        for i in range(n):
            lg, h = decode_step(tm.llm, cache, forced[:, i], sp.attn_lens + i)
            logits.append(lg)
            hiddens.append(h)
        gen = GenerateResult(tokens=forced, hidden=torch.stack(hiddens, dim=1),
                             lengths=torch.full((B,), n), prefill_hidden=h_pre,
                             prefill_len=sp.attn_lens)
        seg = extract_seg_from_generation(tm, gen)
        feats, _ = tm.encode_sam_features(sam)
        masks = tm.decode_masks(feats, seg, torch.arange(B))
    logits = torch.stack(logits, dim=1)

    assert logits.shape[:2] == (B, n + 1) and masks.shape[0] == B
    _close(visual, ref["visual"], TOL, "visual prefix")
    flips = 0
    for key in ("k", "v"):
        a = cache[key].numpy().astype(np.int32)
        b = np.asarray(ref["cache"][key]).astype(np.int32)
        assert a.shape == b.shape
        diff = np.abs(a - b)
        assert diff.max() <= 1, f"{key}: a code differs by {diff.max()}"
        assert (diff > 0).mean() < 1e-3, f"{key}: {(diff > 0).mean()}"
        flips += int((diff > 0).sum())
        _close(cache[f"{key}_scale"], ref["cache"][f"{key}_scale"], 1e-5,
               f"{key}_scale")
    tol, tol_mask = (LOOSE, LOOSE) if flips else (TOL, TOL_MASK)
    _close(logits, ref["logits"], tol, f"logits (flips {flips})")
    _close(gen.hidden, ref["hidden"], tol, f"hidden (flips {flips})")
    np.testing.assert_array_equal(seg.valid.numpy(),
                                  [[True, True, False, False],
                                   [True, False, False, False],
                                   [True, True, True, False]])
    _close(seg.embeds, ref["seg_emb"], tol, "[SEG] embeddings")
    _close(masks, ref["masks"], tol_mask, "mask logits")
