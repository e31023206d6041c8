"""The SAM-2 image surfaces of videoglamm_torch against the JAX package on
the CPU: `connected_components` and the mask cleanups built on it, the RLE
codec, the prompt encoder's boxes and mask prompts, `forward_sam_heads`
with points, boxes and masks, `use_mask_as_output`, the image predictor
(`predict`, `predict_batch`) and the automatic mask generator, with and
without crops and the m2m round.

`SAM2Config.tiny()` weights are shaped by `jax.eval_shape` (the model
initialised through `SAM2Base.__call__`, which makes the mask-prompt convs
and `mask_downsample` too) and filled from a numpy seed, then loaded into
the port strictly through `io/from_jax.py`; inputs come from numpy seeds;
everything is f32.

Tolerances. Integer outputs (labels, areas, RLE counts, record counts)
are equal. Float outputs: the SAM-2 mask decoder's f32 control of
parity/parity_modules_cpu.json is 1.1e-6 max |d| at O(1) outputs, so
`forward_sam_heads` and `use_mask_as_output` are held field by field at
TOL_HEADS = 2.2e-6 (twice the control) times max(1, max |ref|). Through
the predictors (the resize to the image, the fill, the generator's
rounds) mask logits are held at TOL_LOGITS = 1e-4 relative to
max(1, max |ref|), and IoUs, scores and embeddings at TOL = 1e-5.
Thresholded masks are equal except at pixels whose JAX logit lies within
TOL_LOGITS * max(1, max |ref|) of the threshold.
"""
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import seeded_params
from videoglamm_tpu.config import SAM2Config
from videoglamm_tpu.data import rle as jrle
from videoglamm_tpu.models.sam2 import amg as jamg
from videoglamm_tpu.models.sam2.image_predictor import \
    SAM2ImagePredictor as JImagePredictor
from videoglamm_tpu.models.sam2.prompt_encoder import PromptEncoder as JPrompt
from videoglamm_tpu.models.sam2.sam2_base import SAM2Base as JSAM2Base
from videoglamm_tpu.ops import resize as jresize
from videoglamm_torch.data import rle as trle
from videoglamm_torch.io import from_jax
from videoglamm_torch.models.sam2 import amg as tamg
from videoglamm_torch.models.sam2.image_predictor import SAM2ImagePredictor
from videoglamm_torch.models.sam2.prompt_encoder import PromptEncoder
from videoglamm_torch.models.sam2.sam2_base import SAM2Base
from videoglamm_torch.ops import connected_components as tcc
from videoglamm_torch.ops import resize as tresize
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# the package's ops/__init__ re-exports the function under the module's name
jcc = importlib.import_module("videoglamm_tpu.ops.connected_components")

SCFG = SAM2Config.tiny()
S = SCFG.image_size                   # 128
E = SCFG.low_res_size                 # 8
C = SCFG.d_model                      # 32
TOL = 1e-5
TOL_HEADS = 2.2e-6
TOL_LOGITS = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def _logits_close(got, ref, what="", tol=TOL_LOGITS):
    ref = np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    _close(got, ref, tol * scale, what)


def _masks_equal_off_threshold(got, ref_logits, what="", thr=0.0):
    """Binary masks equal the thresholded JAX logits except where a logit
    lies within the logit bound of the threshold."""
    ref_logits = np.asarray(ref_logits, np.float32)
    bound = TOL_LOGITS * max(1.0, float(np.abs(ref_logits).max()))
    far = np.abs(ref_logits - thr) > bound
    got = np.asarray(got)
    assert got.shape == ref_logits.shape, what
    np.testing.assert_array_equal(got[far], (ref_logits > thr)[far], err_msg=what)


@pytest.fixture(scope="module")
def sam_setup():
    jm = JSAM2Base(SCFG, dtype=jnp.float32)
    imgs = np.zeros((1, S, S, 3), np.float32)
    params = seeded_params(lambda: jm.init(jax.random.PRNGKey(0), imgs), 31)
    params = {"params": params["params"]}
    tm = SAM2Base(from_jax.port_config(SCFG)).eval()
    tm.load_state_dict(from_jax.sam2_state_dict(params["params"]))
    return jm, params, tm


# ---------------------------------------------------------------------------
# connected components
# ---------------------------------------------------------------------------
def _cc_masks(kind):
    rng = np.random.RandomState({"noise": 0, "sparse": 1, "blobs": 2}.get(kind, 3))
    if kind == "noise":
        return rng.rand(3, 23, 31) > 0.5
    if kind == "sparse":
        return rng.rand(2, 40, 17) > 0.85
    if kind == "blobs":             # smoothed noise: large regions
        x = rng.randn(2, 36, 44)
        for _ in range(4):
            x = (x + np.roll(x, 1, 1) + np.roll(x, 1, 2)) / 3
        return x > 0
    m = np.zeros((2, 32, 32), bool)  # rings with holes, islands, a spiral
    m[0, 4:20, 4:20] = True
    m[0, 8:16, 8:16] = False
    m[0, 11:13, 11:13] = True        # an island inside the hole
    m[0, 25, 25] = m[0, 26, 26] = True    # diagonal neighbours: one component
    m[1, ::4, :] = True
    m[1, :, 0] = True
    m[1, 2, 5:9] = True
    return m


@pytest.mark.parametrize("kind", ["noise", "sparse", "blobs", "holes"])
def test_connected_components_matches_jax(kind):
    """Labels and areas equal to JAX's, not only equivalent: the same
    propagation, the same two pointer jumps a sweep."""
    m = _cc_masks(kind)
    jl, ja = jcc.connected_components(jnp.asarray(m))
    tl, ta = tcc.connected_components(torch.from_numpy(m))
    assert tl.dtype == torch.int32 and ta.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for size in (3, 12):
        np.testing.assert_array_equal(
            tcc.remove_small_objects_device(torch.from_numpy(m), size).numpy(),
            np.asarray(jcc.remove_small_objects_device(jnp.asarray(m), size)))


@pytest.mark.parametrize("hole,sprinkle,thr", [(10.0, 0.0, 0.0), (0.0, 6.0, 0.0),
                                               (25.0, 25.0, 0.5)])
def test_postprocess_mask_scores_matches_jax(hole, sprinkle, thr):
    rng = np.random.RandomState(4)
    x = rng.randn(3, 30, 26).astype(np.float32) * 4
    for _ in range(2):
        x = (x + np.roll(x, 1, 1) + np.roll(x, 1, 2)) / 3
    ref = jcc.postprocess_mask_scores(jnp.asarray(x), max_hole_area=hole,
                                      max_sprinkle_area=sprinkle,
                                      mask_threshold=thr)
    got = tcc.postprocess_mask_scores(torch.from_numpy(x), hole, sprinkle, thr)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# RLE
# ---------------------------------------------------------------------------
def test_rle_round_trips_match_jax():
    rng = np.random.RandomState(5)
    masks = [rng.rand(13, 17) > 0.5, np.zeros((6, 9), bool), np.ones((4, 5), bool),
             _cc_masks("holes")[0], rng.rand(40, 3) > 0.9]
    for m in masks:
        for compress in (True, False):
            got, ref = trle.rle_encode(m, compress), jrle.rle_encode(m, compress)
            assert got == ref
            np.testing.assert_array_equal(trle.rle_decode(got), jrle.rle_decode(ref))
            np.testing.assert_array_equal(trle.rle_decode(got), m)
    # the generator's device-side run boundaries, placed into a canvas
    crops = rng.rand(4, 9, 7) > 0.5
    crops[1] = False
    crops[2] = True
    for x0, y0 in ((0, 0), (3, 5)):
        got = tamg.rles_from_device_masks(torch.from_numpy(crops), (x0, y0), (15, 12))
        for c, rle in zip(crops, got):
            canvas = np.zeros((15, 12), bool)
            canvas[y0:y0 + 9, x0:x0 + 7] = c
            assert rle == jrle.rle_encode(canvas, compress=False)


# ---------------------------------------------------------------------------
# prompt encoder, SAM heads
# ---------------------------------------------------------------------------
def test_prompt_encoder_boxes_and_masks_match_jax():
    rng = np.random.RandomState(6)
    B = 3
    coords = (rng.rand(B, 2, 2) * S).astype(np.float32)
    labels = np.array([[1, 0]] * B, np.int32)
    boxes = np.sort(rng.rand(B, 2, 2) * S, axis=1).reshape(B, 4).astype(np.float32)
    masks = rng.randn(B, 4 * E, 4 * E, 1).astype(np.float32) * 3
    text = rng.randn(B, 1, C).astype(np.float32)
    jp = JPrompt(SCFG)
    pp = seeded_params(lambda: jp.init(jax.random.PRNGKey(0), points=(coords, labels),
                                       boxes=boxes, masks=masks), 7)
    tp = PromptEncoder(from_jax.port_config(SCFG)).eval()
    tp.load_state_dict(from_jax.prompt_encoder_state_dict(pp["params"]))
    with torch.no_grad():
        _close(tp.embed_boxes(_t(boxes)),
               jp.apply(pp, boxes, method=lambda m, b: m.embed_boxes(b)), TOL, "boxes")
        _close(tp.embed_masks(_t(masks)),
               jp.apply(pp, masks, method=lambda m, x: m.embed_masks(x)), TOL, "masks")
        cases = [dict(points=(coords, labels)), dict(boxes=boxes),
                 dict(points=(coords, labels), boxes=boxes, masks=masks),
                 dict(masks=masks), dict(text_embeds=text, masks=masks), {}]
        for kw in cases:
            jsparse, jdense = jp.apply(pp, **kw)
            tkw = {k: (tuple(_t(a) for a in v) if isinstance(v, tuple) else _t(v))
                   for k, v in kw.items()}
            tsparse, tdense = tp(**tkw)
            assert tuple(tsparse.shape) == jsparse.shape, sorted(kw)
            _close(tsparse, jsparse, TOL, f"sparse {sorted(kw)}")
            _close(tdense, jdense, TOL, f"dense {sorted(kw)}")


def _feats(seed, B=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, E, E, C).astype(np.float32),
            rng.randn(B, 4 * E, 4 * E, C // 8).astype(np.float32),
            rng.randn(B, 2 * E, 2 * E, C // 4).astype(np.float32))


@pytest.mark.parametrize("prompt", ["points", "box", "mask", "mask_resized",
                                    "points_mask"])
@pytest.mark.parametrize("multimask", [True, False])
def test_forward_sam_heads_prompts_match_jax(sam_setup, prompt, multimask):
    jm, params, tm = sam_setup
    emb, s0, s1 = _feats(8)
    rng = np.random.RandomState(9)
    B = emb.shape[0]
    kw = {}
    if prompt in ("points", "points_mask"):
        kw["point_inputs"] = ((rng.rand(B, 3, 2) * S).astype(np.float32),
                              np.array([[1, 0, -1], [1, 1, 0]], np.int32))
    if prompt == "box":
        kw["point_inputs"] = ((rng.rand(B, 2, 2) * S).astype(np.float32),
                              np.array([[2, 3]] * B, np.int32))
    if prompt in ("mask", "points_mask"):
        kw["mask_inputs"] = rng.randn(B, 4 * E, 4 * E, 1).astype(np.float32) * 5
    if prompt == "mask_resized":
        kw["mask_inputs"] = rng.randn(B, 3 * E, 3 * E, 1).astype(np.float32) * 5
    # jitted: one compile is cheaper than the first op-by-op run
    ref = jax.jit(lambda p, e, h0, h1, kw: jm.apply(
        p, e, high_res_features=(h0, h1), multimask_output=multimask, **kw,
        method=lambda m, *a, **k: m.forward_sam_heads(*a, **k)))(
            params, emb, s0, s1, kw)
    tkw = {k: (tuple(_t(a) for a in v) if isinstance(v, tuple) else _t(v))
           for k, v in kw.items()}
    with torch.no_grad():
        got = tm.forward_sam_heads(_t(emb), high_res_features=(_t(s0), _t(s1)),
                                   multimask_output=multimask, **tkw)
    for name in got._fields:
        _logits_close(getattr(got, name), getattr(ref, name), name, TOL_HEADS)


def test_use_mask_as_output_matches_jax(sam_setup):
    """The antialiased downsample, the mask-prompted decode through
    `mask_downsample`, and the object score of an empty and a full mask."""
    jm, params, tm = sam_setup
    emb, s0, s1 = _feats(10, B=3)
    m = np.zeros((3, S, S, 1), np.float32)
    m[0, 20:70, 30:90] = 1.0
    m[2] = (np.random.RandomState(11).rand(S, S, 1) > 0.7)
    ref = jax.jit(lambda p, *a: jm.apply(
        p, *a, method=lambda mdl, *x: mdl.use_mask_as_output(*x)))(
            params, emb, (s0, s1), m)
    with torch.no_grad():
        got = tm.use_mask_as_output(_t(emb), (_t(s0), _t(s1)), _t(m))
    for name in got._fields:
        _logits_close(getattr(got, name), getattr(ref, name), name, TOL_HEADS)
    assert float(got.object_score_logits[1]) == -10.0
    x = np.random.RandomState(12).randn(2, 5, 40, 24, 1).astype(np.float32)
    _close(tresize.resize_bilinear_antialias(_t(x), (10, 6)),
           jresize.resize_bilinear_antialias(jnp.asarray(x), (10, 6)), 1e-6)


def test_state_dict_carries_the_mask_prompt_convs(sam_setup):
    """The reference names of the mask-prompt convs (import_torch.py:256-260),
    loaded strictly from the JAX tree; a tree without them still loads into
    a VideoGLaMM through `load_weights`."""
    _, params, tm = sam_setup
    sd = from_jax.sam2_state_dict(params["params"])
    for k in ("sam_prompt_encoder.mask_downscaling.0.weight",
              "sam_prompt_encoder.mask_downscaling.1.bias",
              "sam_prompt_encoder.mask_downscaling.3.weight",
              "sam_prompt_encoder.mask_downscaling.4.weight",
              "sam_prompt_encoder.mask_downscaling.6.bias", "mask_downsample.weight"):
        assert k in sd and k in tm.state_dict(), k
    assert tuple(sd["sam_prompt_encoder.mask_downscaling.0.weight"].shape) == (4, 1, 2, 2)
    assert set(sd) == set(tm.state_dict())


# ---------------------------------------------------------------------------
# image predictor
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def predictors(sam_setup):
    jm, params, tm = sam_setup
    kw = dict(max_hole_area=8.0, max_sprinkle_area=8.0)
    return JImagePredictor(jm, params, **kw), SAM2ImagePredictor(tm, **kw)


def _hold_prediction(jp, tp, what, **kw):
    jl, jious, jlow = jp.predict(return_logits=True, **kw)
    tl, tious, tlow = tp.predict(return_logits=True, **kw)
    tmasks, _, _ = tp.predict(**kw)
    assert tmasks.dtype == bool, what
    _logits_close(tl, jl, f"{what} logits")
    _masks_equal_off_threshold(tmasks, jl, what)
    _close(tious, jious, TOL, f"{what} ious")
    _logits_close(tlow, jlow, f"{what} low-res")
    assert np.abs(tlow).max() <= 32.0
    return tlow, tious


def test_image_predictor_predict_matches_jax(predictors):
    """Points (multimask), a box, the returned low-res logits fed back as
    mask_input with a second click, two boxes at once; hole and sprinkle
    filling on (connected components on the predicted logits)."""
    jp, tp = predictors
    img = np.random.RandomState(13).randint(0, 256, (97, 123, 3), np.uint8)
    jp.set_image(img)
    tp.set_image(img)
    _close(tp.get_image_embedding(), jp.get_image_embedding(), TOL, "embedding")
    _close(tp.get_image_embedding(channels_first=True),
           jp.get_image_embedding(channels_first=True), TOL, "embedding NCHW")
    low, ious = _hold_prediction(jp, tp, "points", point_coords=np.array([[60.0, 40.0]]),
                                 point_labels=np.array([1]), multimask_output=True)
    best = int(np.argmax(ious))
    _hold_prediction(jp, tp, "refine", point_coords=np.array([[60.0, 40.0], [20.0, 80.0]]),
                     point_labels=np.array([1, 0]), mask_input=low[best:best + 1],
                     multimask_output=False)
    _hold_prediction(jp, tp, "box", box=np.array([10.0, 10.0, 100.0, 90.0]))
    _hold_prediction(jp, tp, "two boxes", box=np.array([[10.0, 10.0, 100.0, 90.0],
                                                         [50, 5, 120, 60]]),
                     multimask_output=False)


def test_image_predictor_predict_batch_matches_jax(predictors):
    jp, tp = predictors
    rng = np.random.RandomState(14)
    imgs = [rng.randint(0, 256, (64, 80, 3), np.uint8),
            rng.randint(0, 256, (50, 31, 3), np.uint8)]
    jp.set_image_batch(imgs)
    tp.set_image_batch(imgs)
    kw = dict(point_coords_batch=[np.array([[30.0, 20.0]]), np.array([[10.0, 40.0]])],
              point_labels_batch=[np.array([1]), np.array([1])],
              box_batch=[None, np.array([2.0, 3.0, 25.0, 44.0])])
    jl, jious, jlow = jp.predict_batch(return_logits=True, **kw)
    tl, tious, tlow = tp.predict_batch(return_logits=True, **kw)
    tm_, _, _ = tp.predict_batch(**kw)
    for i in range(2):
        _logits_close(tl[i], jl[i], f"image {i} logits")
        _masks_equal_off_threshold(tm_[i], jl[i], f"image {i} masks")
        _close(tious[i], jious[i], TOL, f"image {i} ious")
        _logits_close(tlow[i], jlow[i], f"image {i} low-res")


# ---------------------------------------------------------------------------
# automatic mask generator
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["plain", "crops_m2m"])
def test_amg_records_match_jax(sam_setup, case):
    """Zero thresholds so that many candidates reach NMS and the RLE: the
    same records, RLE counts equal, scores at TOL. `plain`: a 4x4 grid,
    the last batch padded, box NMS at 1.0 (on random weights the masks'
    boxes nearly coincide, and NMS at 0.7 would keep one of 48);
    `crops_m2m`: one crop layer (five crops), the m2m round, hole /
    sprinkle filling and both NMS at 0.7."""
    jm, params, tm = sam_setup
    kw = dict(points_per_side=4, points_per_batch=6, pred_iou_thresh=0.0,
              stability_score_thresh=0.0, output_mode="uncompressed_rle",
              box_nms_thresh=1.0)
    if case == "crops_m2m":
        kw.update(crop_n_layers=1, use_m2m=True, min_mask_region_area=6,
                  points_per_side=2, box_nms_thresh=0.7)
    img = np.random.RandomState(15).randint(0, 256, (72, 90, 3), np.uint8)
    ref = jamg.SAM2AutomaticMaskGenerator(jm, params, **kw).generate(img)
    timings = {}
    got = tamg.SAM2AutomaticMaskGenerator(tm, **kw).generate(img, timings=timings)
    assert len(ref) > 3 and len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g["segmentation"] == r["segmentation"]
        assert g["area"] == r["area"] and g["bbox"] == r["bbox"]
        assert g["crop_box"] == r["crop_box"]
        np.testing.assert_allclose(g["point_coords"], r["point_coords"], rtol=1e-12)
        for k in ("predicted_iou", "stability_score"):
            np.testing.assert_allclose(g[k], r[k], atol=TOL, rtol=TOL, err_msg=k)
    stages = {"encode", "decode", "score", "filter", "rle", "nms", "records"}
    if case == "crops_m2m":
        stages.add("connected_components")
    assert set(timings) == stages


def test_amg_output_modes_and_helpers_match_jax(sam_setup):
    """binary_mask and coco_rle records; the point grids, crop boxes, NMS,
    the crop-edge test and remove_small_regions against the JAX helpers."""
    jm, params, tm = sam_setup
    img = np.random.RandomState(16).randint(0, 256, (40, 52, 3), np.uint8)
    kw = dict(points_per_side=3, points_per_batch=9, pred_iou_thresh=0.0,
              stability_score_thresh=0.0)
    # JAX's binary_mask and coco_rle segmentations are its uncompressed
    # RLEs decoded and compressed (amg.py:280-286)
    ref = jamg.SAM2AutomaticMaskGenerator(jm, params, output_mode="uncompressed_rle",
                                          **kw).generate(img)
    for mode in ("binary_mask", "coco_rle"):
        got = tamg.SAM2AutomaticMaskGenerator(tm, output_mode=mode, **kw).generate(img)
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            mask = jrle.rle_decode(r["segmentation"])
            if mode == "binary_mask":
                np.testing.assert_array_equal(g["segmentation"], mask)
            else:
                assert g["segmentation"] == dict(r["segmentation"], counts=jrle.rle_encode(
                    mask)["counts"])
    for n, layers, scale in ((4, 0, 1), (8, 2, 2)):
        for a, b in zip(tamg.build_all_layer_point_grids(n, layers, scale),
                        jamg.build_all_layer_point_grids(n, layers, scale)):
            np.testing.assert_array_equal(a, b)
    assert tamg.generate_crop_boxes((480, 854), 2, 512 / 1500) == \
        jamg.generate_crop_boxes((480, 854), 2, 512 / 1500)
    rng = np.random.RandomState(17)
    boxes = np.sort(rng.rand(30, 2, 2) * 50, axis=1).reshape(30, 4)
    scores = np.round(rng.rand(30), 1)            # ties: the stable order
    for thr in (0.3, 0.7):
        np.testing.assert_array_equal(tamg.nms_xyxy(boxes, scores, thr),
                                      jamg.nms_xyxy(boxes, scores, thr))
    np.testing.assert_array_equal(
        tamg.is_box_near_crop_edge(boxes, [10, 10, 40, 40], [0, 0, 50, 50]),
        jamg.is_box_near_crop_edge(boxes, [10, 10, 40, 40], [0, 0, 50, 50]))
    for mode in ("holes", "islands"):
        for m in (_cc_masks("holes")[0], _cc_masks("blobs")[1], np.zeros((5, 5), bool)):
            gm, gc = tamg.remove_small_regions(m, 6, mode)
            rm, rc = jamg.remove_small_regions(m, 6, mode)
            np.testing.assert_array_equal(gm, rm)
            assert gc == rc


def test_sam2_surfaces_import_and_run_without_jax():
    """The new modules import with jax, flax and videoglamm_tpu blocked, and
    a tiny SAM-2 built through `build_sam2` on the CPU drives the image
    predictor, the generator and the interactive predictor; a CUDA build
    without a card raises."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'videoglamm_tpu'): sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "from videoglamm_torch.config import SAM2Config\n"
        "from videoglamm_torch.data import rle\n"
        "from videoglamm_torch.ops import connected_components, resize\n"
        "from videoglamm_torch.models.sam2 import (amg, image_predictor,\n"
        "    interactive, prompt_encoder, sam2_base)\n"
        "from videoglamm_torch.inference.pipeline import build_sam2\n"
        "m = build_sam2(SAM2Config.tiny(), device='cpu', dtype=torch.float32)\n"
        "img = np.random.RandomState(0).randint(0, 256, (40, 50, 3), np.uint8)\n"
        "p = image_predictor.SAM2ImagePredictor(m, max_hole_area=4.0)\n"
        "p.set_image(img)\n"
        "masks, ious, low = p.predict(point_coords=np.array([[20.0, 10.0]]),\n"
        "                             point_labels=np.array([1]))\n"
        "assert masks.shape == (3, 40, 50) and low.shape == (3, 32, 32)\n"
        "recs = amg.SAM2AutomaticMaskGenerator(m, points_per_side=2,\n"
        "    pred_iou_thresh=0.0, stability_score_thresh=0.0).generate(img)\n"
        "assert len(recs) > 0\n"
        "s = interactive.SAM2InteractivePredictor(m, torch.randn(3, 128, 128, 3),\n"
        "                                         num_objects=2)\n"
        "s.add_new_points(0, np.full((2, 1, 2), 30.0), np.ones((2, 1)))\n"
        "out = s.propagate_in_video()\n"
        "assert out.shape == (2, 3, 32, 32) and torch.isfinite(out).all()\n"
        "if not torch.cuda.is_available():\n"
        "    try:\n"
        "        build_sam2(SAM2Config.tiny())\n"
        "        raise SystemExit('build_sam2 built on a missing card')\n"
        "    except RuntimeError:\n"
        "        pass\n"
        "assert not any(k.split('.')[0] in ('jax', 'flax', 'videoglamm_tpu')\n"
        "               and v is not None for k, v in sys.modules.items())\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")
