"""SAM-1 (ViT-H with the ITM tracker) of videoglamm_torch against the JAX
package on the CPU: the relative-position bias, windowed (padded) and
global blocks, the encoder and neck, the mask decoder with and without
the ITM head and track tokens, `track_frames`, the longest-side
preprocessing, the image predictor and the automatic mask generator.

JAX trees are shaped by `jax.eval_shape` (through a method that touches
every prompt path, so the mask-prompt convs exist) and filled from a numpy
seed, then loaded into the port strictly through
`io/from_jax.sam1_state_dict`; the port's own state dict must give the same
tree back through `import_sam1`. Configs: `SAM1Config.tiny()` (with and
without ITM), a padded one (a 6x6 grid in windows of 4), and the config of
tests/test_sam1_predictor.py for the predictor and the generator.
Everything is f32.

Tolerances. Encoder, decoder and `track_frames` outputs are held by
relative L2 at TOL_REL = 1e-5 (f32 reduction-order noise; the SAM-2
decoder's f32 control of parity/parity_modules_cpu.json is 1.1e-6 max |d|
at O(1)). Through the predictors (the resizes to the image) mask logits
are held at TOL_LOGITS = 1e-4 relative to max(1, max |ref|), IoUs,
embeddings and AMG scores at TOL = 1e-5; thresholded masks equal except
where the JAX logit lies within the logit bound of the threshold; AMG
record counts, boxes and RLEs are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import seeded_params
from videoglamm_tpu.config import SAM1Config
from videoglamm_tpu.io.import_torch import import_sam1
from videoglamm_tpu.models import sam1 as jsam1
from videoglamm_tpu.models import sam1_predictor as jpred
from videoglamm_torch import config as tconfig
from videoglamm_torch.io import from_jax
from videoglamm_torch.models import sam1 as tsam1
from videoglamm_torch.models import sam1_predictor as tpred
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL_REL = 1e-5
TOL = 1e-5
TOL_LOGITS = 1e-4
ITM = dataclasses.replace(SAM1Config.tiny(), with_itm=True)
PADDED = dataclasses.replace(SAM1Config.tiny(), image_size=96)   # 6x6 grid, windows of 4
PRED_CFG = SAM1Config(image_size=64, encoder_embed_dim=32, encoder_depth=3,
                      encoder_num_heads=2, encoder_global_attn_indexes=(1,),
                      window_size=2, prompt_embed_dim=32, with_itm=False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, ref, what, tol=TOL_REL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    rel = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-12)
    assert rel <= tol, f"{what}: relative L2 {rel:.3e} > {tol:g}"


def _close(got, ref, tol, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def _init_all(cfg):
    """A method that reaches every parameter: the encoder, every prompt
    path (so the mask-prompt convs exist) and the decoder."""
    E = cfg.image_size // 16

    def run(mdl, x):
        emb = mdl.forward_image(x)
        sparse, dense = mdl.prompt_encoder(
            points=(jnp.zeros((1, 1, 2)), jnp.zeros((1, 1), jnp.int32)),
            boxes=jnp.zeros((1, 4)), masks=jnp.zeros((1, 4 * E, 4 * E, 1)),
            text_embeds=jnp.zeros((1, 1, cfg.prompt_embed_dim)))
        return mdl.mask_decoder(emb, mdl.prompt_encoder.get_dense_pe(), sparse,
                                dense, True)
    return run


_MODELS = {}


def _models(cfg, seed=41):
    """(JAX model, its params, the port model loaded from them), cached."""
    key = (cfg, seed)
    if key not in _MODELS:
        jm = jsam1.SAM1(cfg, dtype=jnp.float32)
        x = np.zeros((1, cfg.image_size, cfg.image_size, 3), np.float32)
        params = seeded_params(lambda: jm.init(jax.random.PRNGKey(0), x,
                                               method=_init_all(cfg)), seed)
        params = {"params": params["params"]}
        tm = tsam1.SAM1(from_jax.port_config(cfg)).eval()
        tm.load_state_dict(from_jax.sam1_state_dict(params["params"]))
        _MODELS[key] = (jm, params, tm)
    return _MODELS[key]


def test_sam1_config_presets_match_jax():
    for preset in ("vit_h", "tiny"):
        assert from_jax.port_config(getattr(SAM1Config, preset)()) == \
            getattr(tconfig.SAM1Config, preset)()
    assert from_jax.port_config(ITM).with_itm


@pytest.mark.parametrize("hw", [(4, 4), (3, 5)])
def test_rel_pos_bias_matches_jax(hw):
    rng = np.random.RandomState(1)
    h, w = hw
    q = rng.randn(2, 3, h * w, 8).astype(np.float32)
    rh = rng.randn(2 * h - 1, 8).astype(np.float32)
    rw = rng.randn(2 * w - 1, 8).astype(np.float32)
    ref = jsam1._rel_pos_bias(jnp.asarray(q), jnp.asarray(rh), jnp.asarray(rw), hw)
    got = tsam1._rel_pos_bias(_t(q), _t(rh), _t(rw), hw)
    assert got.dtype == torch.float32
    _rel(got, ref, f"bias {hw}")


@pytest.mark.parametrize("window", [4, 0], ids=["window_padded", "global"])
def test_block_matches_jax(window):
    """A 6x6 grid: windows of 4 pad it to 8x8; window 0 attends globally."""
    x = np.random.RandomState(2).randn(2, 6, 6, 32).astype(np.float32)
    jb = jsam1.SAM1Block(32, 2, window_size=window, dtype=jnp.float32)
    params = seeded_params(lambda: jb.init(jax.random.PRNGKey(0), x), 3)
    ref = jax.jit(jb.apply)(params, x)
    tb = tsam1.SAM1Block(32, 2, window, grid=6).eval()
    tb.load_state_dict(from_jax.sam1_block_state_dict(params["params"]))
    with torch.no_grad():
        _rel(tb(_t(x)), ref, f"block window {window}")


@pytest.mark.parametrize("cfg", [SAM1Config.tiny(), PADDED], ids=["tiny", "padded"])
def test_encoder_matches_jax(cfg):
    jm, params, tm = _models(cfg)
    x = np.random.RandomState(4).randn(2, cfg.image_size, cfg.image_size, 3) \
        .astype(np.float32)
    ref = jax.jit(lambda p, a: jm.apply(p, a, method=lambda m, i: m.forward_image(i)))(
        params, x)
    with torch.no_grad():
        got = tm.forward_image(_t(x))
    _rel(got, ref, "encoder + neck")


def test_state_dict_through_import_sam1_is_the_jax_tree():
    """The port's names are import_sam1's keys: its own state dict imports
    to the JAX tree it was loaded from, leaf for leaf."""
    for cfg in (ITM, PRED_CFG):
        _, params, tm = _models(cfg)
        sd = tm.state_dict()
        got = import_sam1(sd, cfg)
        ref_leaves = jax.tree_util.tree_leaves_with_path(params["params"])
        got_flat = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(got_flat) == len(ref_leaves)
        for path, leaf in ref_leaves:
            np.testing.assert_array_equal(np.asarray(got_flat[path]), np.asarray(leaf),
                                          err_msg=jax.tree_util.keystr(path))
        assert set(sd) == set(from_jax.sam1_state_dict(params["params"]))


_DECODED = {}


def _jax_decodes(cfg, emb, text, tok):
    """JAX `decode` with and without track tokens, single and multimask:
    one compile a config."""
    if cfg not in _DECODED:
        jm, params, _ = _models(cfg)
        _DECODED[cfg] = jax.jit(lambda p, e, t, k: jm.apply(
            p, e, t, k, method=lambda m, e, t, k: {
                (tr, mm): m.decode(e, t, k if tr else None, mm)
                for tr in (True, False) for mm in (False, True)}))(
                    params, emb, text, tok)
    return _DECODED[cfg]


@pytest.mark.parametrize("itm", [True, False], ids=["itm", "plain"])
@pytest.mark.parametrize("track", [True, False], ids=["track_in", "no_track"])
def test_decoder_matches_jax(itm, track):
    cfg = ITM if itm else SAM1Config.tiny()
    _, _, tm = _models(cfg)
    rng = np.random.RandomState(5)
    E, C = cfg.image_size // 16, cfg.prompt_embed_dim
    emb = rng.randn(3, E, E, C).astype(np.float32)
    text = rng.randn(3, 2, C).astype(np.float32)
    tok = rng.randn(3, 4, C).astype(np.float32)
    refs = _jax_decodes(cfg, emb, text, tok)
    for multimask in (False, True):
        with torch.no_grad():
            got = tm.decode(_t(emb), _t(text), _t(tok) if track else None, multimask)
        ref = refs[(track, multimask)]
        for name in got._fields:
            _rel(getattr(got, name), getattr(ref, name), f"{name} mm={multimask}")


@pytest.mark.parametrize("T", [1, 3])
def test_track_frames_matches_jax(T):
    jm, params, tm = _models(ITM)
    rng = np.random.RandomState(6)
    frames = rng.randn(T, ITM.image_size, ITM.image_size, 3).astype(np.float32)
    text = rng.randn(2, 1, ITM.prompt_embed_dim).astype(np.float32)
    ref = jax.jit(lambda p, f, t: jm.apply(p, f, t, method=lambda m, *a: m.track_frames(*a)))(
        params, frames, text)
    with torch.no_grad():
        got = tm.track_frames(_t(frames), _t(text))
    assert tuple(got.shape) == (2, T, 4 * 8, 4 * 8)
    _rel(got, ref, f"track_frames T={T}")


@pytest.mark.parametrize("hw", [(48, 57), (70, 33), (64, 64)])
def test_preprocess_image_longest_matches_jax(hw):
    img = np.random.RandomState(7).randint(0, 256, (*hw, 3), np.uint8)
    ref, rhw = jpred.preprocess_image_longest(img, 64)
    got, ghw = tpred.preprocess_image_longest(img, 64)
    assert ghw == rhw == tpred.preprocess_shape(*hw, 64)
    _close(got, ref, TOL, f"preprocess {hw}")
    assert (got[ghw[0]:] == 0).all() and (got[:, ghw[1]:] == 0).all()


# ---------------------------------------------------------------------------
# image predictor and automatic mask generator
# ---------------------------------------------------------------------------
def _logits_close(got, ref, what):
    ref = np.asarray(ref, np.float32)
    _close(got, ref, TOL_LOGITS * max(1.0, float(np.abs(ref).max())), what)


def _masks_equal_off_threshold(got, ref_logits, what):
    ref_logits = np.asarray(ref_logits, np.float32)
    far = np.abs(ref_logits) > TOL_LOGITS * max(1.0, float(np.abs(ref_logits).max()))
    assert got.shape == ref_logits.shape, what
    np.testing.assert_array_equal(got[far], (ref_logits > 0)[far], err_msg=what)


def test_predictor_matches_jax():
    """Points (multimask), then points and a box with the low-res logits
    fed back as mask_input; the embedding in both layouts."""
    jm, params, tm = _models(PRED_CFG)
    jp, tp = jpred.SAM1ImagePredictor(jm, params), tpred.SAM1ImagePredictor(tm)
    with pytest.raises(AssertionError):
        tp.predict(point_coords=np.array([[5.0, 5.0]]), point_labels=np.array([1]))
    img = np.random.RandomState(8).randint(0, 256, (49, 61, 3), np.uint8)
    jp.set_image(img)
    tp.set_image(img)
    for cf in (False, True):
        _close(tp.get_image_embedding(cf), jp.get_image_embedding(cf), TOL, "embedding")
    cases = [dict(point_coords=np.array([[30.0, 20.0]]), point_labels=np.array([1])),
             dict(point_coords=np.array([[30.0, 20.0], [50.0, 40.0]]),
                  point_labels=np.array([1, 0]), box=np.array([8.0, 6.0, 52.0, 42.0]),
                  multimask_output=False)]
    low = None
    for i, kw in enumerate(cases):
        if i == 1:
            kw = dict(kw, mask_input=low[:1])
        jl, ji, jlow = jp.predict(return_logits=True, **kw)
        tl, ti, tlow = tp.predict(return_logits=True, **kw)
        tm_, _, _ = tp.predict(**kw)
        assert tm_.dtype == bool and tm_.shape[-2:] == (49, 61)
        _logits_close(tl, jl, f"case {i} logits")
        _masks_equal_off_threshold(tm_, jl, f"case {i} masks")
        _close(ti, ji, TOL, f"case {i} ious")
        _logits_close(tlow, jlow, f"case {i} low-res")
        low = tlow
    tp.reset_image()
    assert not tp._is_image_set
    # BGR input is the RGB image reversed
    tp.set_image(img[..., ::-1], image_format="BGR")
    jp.set_image(img)
    _close(tp.get_image_embedding(), jp.get_image_embedding(), TOL, "BGR embedding")


@pytest.mark.parametrize("case", ["plain", "crops_small_regions"])
def test_amg_records_match_jax(case):
    """Zero thresholds, so many candidates reach NMS and the RLE: the same
    records, RLE counts and boxes equal, scores at TOL. NMS at 1.0: on
    random weights the masks' boxes nearly coincide, and NMS at 0.7 would
    keep one record. `plain`: a 4x4 grid, the last batch padded;
    `crops_small_regions`: one crop layer (five crops) and
    min_mask_region_area > 0 (the cleanup inside `_generate_masks`)."""
    jm, params, tm = _models(PRED_CFG)
    kw = dict(points_per_side=4, points_per_batch=6, pred_iou_thresh=0.0,
              stability_score_thresh=0.0, output_mode="uncompressed_rle",
              box_nms_thresh=1.0, crop_nms_thresh=1.0)
    if case == "crops_small_regions":
        kw.update(crop_n_layers=1, points_per_side=2, min_mask_region_area=30)
    img = np.random.RandomState(9).randint(0, 256, (41, 57, 3), np.uint8)
    ref = jpred.SAM1AutomaticMaskGenerator(jm, params, **kw).generate(img)
    timings = {}
    got = tpred.SAM1AutomaticMaskGenerator(tm, **kw).generate(img, timings=timings)
    assert len(ref) > 3 and len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g["segmentation"] == r["segmentation"]
        assert g["area"] == r["area"] and g["bbox"] == r["bbox"]
        assert g["crop_box"] == r["crop_box"]
        np.testing.assert_allclose(g["point_coords"], r["point_coords"], rtol=1e-12)
        for k in ("predicted_iou", "stability_score"):
            np.testing.assert_allclose(g[k], r[k], atol=TOL, rtol=TOL, err_msg=k)
    stages = {"encode", "decode", "score", "filter", "rle", "nms", "records"}
    if case == "crops_small_regions":
        stages.add("small_regions")
    assert set(timings) == stages


def test_amg_refuses_m2m():
    jm, params, tm = _models(PRED_CFG)
    with pytest.raises(AssertionError):
        jpred.SAM1AutomaticMaskGenerator(jm, params, use_m2m=True)
    with pytest.raises(ValueError):
        tpred.SAM1AutomaticMaskGenerator(tm, use_m2m=True)
