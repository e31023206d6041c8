"""The quantised serving slice of videoglamm_torch against the JAX package
on the CPU, end to end from raw uint8 frames.

One tiny composite (`VideoGLaMMConfig.tiny()`, f32, weights from a numpy
seed) is served teacher-forced in four configurations, each against the JAX
model on the SAME quantised tree (`quantize_videoglamm_llm`, loaded into the
port through `io/from_jax.py`): raw frames -> the three preprocessed streams
-> visual prefix -> prefill -> six cached decode steps over a fixed token
stream with [SEG] at two steps -> [SEG] embeddings -> mask logits. Unlike
tests/test_torch_slice.py the JAX side runs CACHED too (its own prefill and
decode steps), because the int8 cache only acts on the cached path.

Tolerances.
- Weight-only paths (int4 weights, and int8 weights wherever activations
  are not quantised) are continuous in the activations, so the f32 control
  of tests/test_torch_slice.py holds: 1e-4 on logits and hidden states, 1e-3
  on mask logits.
- Paths that quantise activations at run time (the int8 KV cache, the W8A8
  prefill) are discontinuous: a last-bit difference before round() moves
  one int8 code by 1, which moves that K/V row (or activation row) by its
  scale, amax/127, under 1% of its largest entry. The test counts the int8
  codes of the two caches that differ. With none differing the cached
  values are bit-equal and the f32 control holds again. With any differing
  it asserts that their share is below 1e-3, that no code differs by more
  than 1, and holds the outputs to 2e-2 (logits and hidden states are O(1);
  one flipped code in a row of 16 moves a logit by about amax/127 * |q_i|).
  The W8A8 activations cannot be read from outside, so that configuration
  is held to the loose bound whenever its outputs miss the tight one.
- Free-running greedy tokens are not compared (ROADMAP.md: argmax on random
  weights flips under rounding and the flip cascades).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import seeded_params
from videoglamm_tpu.config import VideoGLaMMConfig
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
from videoglamm_torch.models.common import QDense
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = VideoGLaMMConfig.tiny(num_frames=4)
SEG = CFG.seg_token_idx
S_TEXT = 16
T_SAM = 2
FORCED = np.array([[7, SEG, 33, 41, SEG, 9]], np.int32)
TOL, TOL_MASK = 1e-4, 1e-3
LOOSE = 2e-2

#          name            weights  kv_cache  W8A8 forced in the prefill
CONFIGS = {"int8_kv8": ("int8", "int8", False),
           "kv8_only": ("none", "int8", False),
           "int4": ("int4", "bf16", False),
           "int8_kv8_w8a8": ("int8", "int8", True)}


def _inputs():
    rng = np.random.RandomState(0)
    raw = rng.randint(0, 256, size=(1, CFG.num_frames, 48, 85, 3)).astype(np.uint8)
    ids = rng.randint(1, 400, size=(1, S_TEXT)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    return raw, ids


def _jax_cached_slice(mdl, raw, ids, quant_kv: bool):
    """The JAX request, teacher-forced: preprocessing, prefix, prefill with
    a (possibly int8) cache, one cached decode step per forced token, the
    [SEG] extraction of pipeline.py:36-53 and the batched mask decode."""
    sam_idx = np.linspace(0, CFG.num_frames - 1, T_SAM).astype(np.int32)
    frames = jpre.preprocess_iv_stream(raw, CFG.internvideo.image_size)
    ctx = jpre.preprocess_clip_stream(raw, CFG.clip.image_size)
    sam = jpre.preprocess_sam_stream(raw[:, sam_idx], CFG.sam2.image_size)
    visual = mdl.encode_visual_prefix(frames, ctx)
    lens = jnp.full((1,), S_TEXT, jnp.int32)
    sp = jsplice(mdl.llm.embed(ids), ids, visual, lens)
    n = FORCED.shape[1]
    cache = jinit_kv_cache(CFG.llm, 1, sp.embeds.shape[1] + n + 1,
                           dtype=jnp.float32, quant_kv=quant_kv)
    hidden_pre, cache = mdl.llm.forward_hidden(sp.embeds, sp.positions,
                                               sp.attn_lens, cache)
    logits = [mdl.llm.head(hidden_pre[jnp.arange(1), sp.attn_lens - 1])]
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
                             jnp.arange(1, dtype=jnp.int32), training=False)
    return dict(visual=visual, logits=jnp.stack(logits, axis=1),
                hidden=gen_hidden, seg_emb=seg_emb, masks=masks, cache=cache)


@pytest.fixture(scope="module")
def float_params():
    raw, ids = _inputs()
    jm = JVideoGLaMM(CFG, dtype=jnp.float32)
    return seeded_params(
        lambda: jm.init(jax.random.PRNGKey(0), raw, ids, False,
                        method=_jax_cached_slice), 7)


def _np(x):
    return x.detach().float().numpy()


def _miss(got, ref, tol):
    """Whether `got` misses `ref` at atol = rtol = tol."""
    return not np.allclose(_np(got), np.asarray(ref, np.float32), atol=tol,
                           rtol=tol)


def _close(got, ref, tol, what):
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_quantised_slice_from_raw_frames_matches_jax(name, float_params,
                                                     monkeypatch):
    check_slice_against_jax(*CONFIGS[name], float_params, monkeypatch)


def check_slice_against_jax(quant, kv_cache, w8a8, float_params, monkeypatch):
    """The port's cached slice (build_inference in f32 on the CPU, the
    weights quantised as `quant` names, the `kv_cache` cache) teacher-forced
    against the JAX model on the same quantised tree, at the tolerances of
    the module docstring."""
    quant_kv = kv_cache == "int8"
    if w8a8:     # the prefill (M > 1) quantises its activations; decode is M = 1
        monkeypatch.setenv("VGT_W8A8_MIN_M", "2")
        monkeypatch.setattr(QDense, "w8a8_min_m", 2)
    raw, ids = _inputs()
    params = float_params
    if quant != "none":
        params = {"params": quantize_videoglamm_llm(float_params["params"],
                                                    mode=quant)}
    jm = JVideoGLaMM(CFG, dtype=jnp.float32, quant_llm_int8=quant == "int8",
                     quant_llm_int4=quant == "int4", quant_kv_int8=quant_kv)
    ref = jax.jit(lambda p, r, i: jm.apply(p, r, i, quant_kv,
                                           method=_jax_cached_slice))(
        params, raw, ids)

    gi = build_inference(port_config(CFG), videoglamm_state_dict(params, CFG),
                         device="cpu", dtype=torch.float32, quant=quant,
                         kv_cache=kv_cache, max_new_tokens=6)
    tm = gi.model
    assert tm.llm.quant == quant and tm.quant_kv_int8 == quant_kv
    n = FORCED.shape[1]
    t_ids = torch.from_numpy(ids).long()
    with torch.no_grad():
        frames, ctx, sam = prepare_vision_inputs(torch.from_numpy(raw), tm.cfg,
                                                 num_sam_frames=T_SAM)
        visual = tm.encode_visual_prefix(frames, ctx)
        h_pre, cache, sp, last = prefill(tm.llm, visual, t_ids,
                                         torch.tensor([S_TEXT]), n,
                                         quant_kv=quant_kv)
        logits, hiddens = [last], []
        for i in range(n):
            lg, h = decode_step(tm.llm, cache, torch.from_numpy(FORCED[:, i]),
                                sp.attn_lens + i)
            logits.append(lg)
            hiddens.append(h)
        gen = GenerateResult(tokens=torch.from_numpy(FORCED).long(),
                             hidden=torch.stack(hiddens, dim=1),
                             lengths=torch.tensor([n]), prefill_hidden=h_pre,
                             prefill_len=sp.attn_lens)
        seg = extract_seg_from_generation(tm, gen)
        feats, _ = tm.encode_sam_features(sam)
        masks = tm.decode_masks(feats, seg, torch.arange(1))
    logits = torch.stack(logits, dim=1)

    # the preprocessing and the towers are float in every configuration
    _close(visual, ref["visual"], TOL, "visual prefix")

    flips = 0
    if quant_kv:
        assert set(cache) == {"k", "v", "k_scale", "v_scale"}
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
    else:
        _close(cache["k"], ref["cache"]["k"], TOL, "bf16-mode cache")
    if flips or (w8a8 and (_miss(logits, ref["logits"], TOL)
                           or _miss(gen.hidden, ref["hidden"], TOL))):
        tol, tol_mask = LOOSE, LOOSE
    else:
        tol, tol_mask = TOL, TOL_MASK
    _close(logits, ref["logits"], tol, f"logits (flips {flips})")
    _close(gen.hidden, ref["hidden"], tol, f"hidden (flips {flips})")
    assert seg.valid[0].tolist() == [True, True, False, False]
    _close(seg.embeds, ref["seg_emb"], tol, "[SEG] embeddings")
    _close(masks, ref["masks"], tol_mask, "mask logits")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_serve_raw_contract(name):
    """Free-running greedy serving from raw frames through `build_inference`
    and `GroundedInference.serve_raw` in every configuration."""
    quant, kv_cache, _ = CONFIGS[name]
    torch.manual_seed(0)
    gi = build_inference(port_config(CFG), device="cpu", dtype=torch.float32,
                         quant=quant, kv_cache=kv_cache, max_new_tokens=5)
    raw, ids = _inputs()
    timings = {}
    out = gi.serve_raw(torch.from_numpy(raw), torch.from_numpy(ids).long(),
                       torch.tensor([S_TEXT]), num_sam_frames=T_SAM,
                       timings=timings)
    E4 = 4 * CFG.sam2.low_res_size
    assert out.tokens.shape == (1, 5)
    assert out.pred_masks.shape == (1, CFG.max_seg_tokens, T_SAM, E4, E4)
    assert torch.isfinite(out.pred_masks).all()
    assert (out.pred_masks[0][~out.seg_valid[0]] <= -1e3).all()
    assert list(timings) == ["preprocess", "visual", "generate", "sam_encode",
                             "mask_decode"]


def test_build_inference_device_and_arguments():
    """The card is the default and its absence raises (no silent CPU);
    `init` fills the float model before it is quantised; wrong arguments
    raise."""
    cfg = port_config(CFG)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_inference(cfg)
    seen = []

    def init(model):
        seen.append(model.llm.quant)
        with torch.no_grad():
            for p in model.parameters():
                p.fill_(0.25)

    gi = build_inference(cfg, device="cpu", dtype=torch.float32, quant="int8",
                         kv_cache="int8", init=init)
    assert seen == ["none"]
    head = gi.model.llm.lm_head
    assert isinstance(head, QDense) and head.weight.dtype == torch.int8
    assert head.weight.shape == (520, 64)           # 513 rows padded to 8
    assert head.weight[:513].eq(127).all() and not head.weight[513:].any()
    assert gi.model.quant_kv_int8 and gi.model.llm.quant == "int8"
    assert next(gi.model.parameters()).device.type == "cpu"
    for bad in (dict(quant="int2"), dict(kv_cache="fp8")):
        with pytest.raises(ValueError):
            build_inference(cfg, device="cpu", **bad)
    # a quantised state_dict must come with its mode
    sd = gi.model.state_dict()
    with pytest.raises(ValueError, match="quantised"):
        build_inference(cfg, sd, device="cpu")
    again = build_inference(cfg, sd, device="cpu", dtype=torch.float32,
                            quant="int8")
    assert torch.equal(again.model.llm.lm_head.weight, head.weight)
