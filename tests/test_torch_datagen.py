"""The port's GCG datagen (videoglamm_torch.datagen) against
videoglamm_tpu.datagen on the CPU: the cases of tests/test_datagen.py.

- gcg_pipeline is host code in both packages: parsed captions and the
  pipeline's records are held EQUAL, and the record loads through the
  port's GCGVideoDataset as through JAX's.
- Sam2BoxSegmenter: a tiny SAM-2 initialised in JAX through
  `SAM2Base.__call__` and filled from a numpy seed, carried to the port by
  `io/from_jax.sam2_state_dict` and built by `build_sam2` on the CPU in
  f32. Boolean masks equal JAX's except at pixels whose logit (the port's,
  resized to the frame) is within TOL_BAND = 1e-5 of 0, where the two f32
  summation orders may fall on either side.
- The two extractors (ANet-Entities, VidSTG/HCSTVG) run with each
  package's segmenter over copies of one fixture: the PNGs they write are
  equal, array for array, and the merged GCG JSON is equal.
No Pallas kernel runs here (the JAX segmenter is the XLA path on the CPU).
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_models import seeded_params
from videoglamm_tpu.config import SAM2Config
from videoglamm_tpu.data import datasets as jds
from videoglamm_tpu.data.rle import rle_encode
from videoglamm_tpu.datagen import gcg_pipeline as jgp
from videoglamm_tpu.datagen import mask_extract as jme
from videoglamm_tpu.models.sam2.sam2_base import SAM2Base as JSAM2Base
from videoglamm_torch.data import datasets as tds
from videoglamm_torch.datagen import gcg_pipeline as tgp
from videoglamm_torch.datagen import mask_extract as tme
from videoglamm_torch.inference.pipeline import build_sam2
from videoglamm_torch.io import from_jax
from videoglamm_torch.ops.resize import resize_bilinear
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL_BAND = 1e-5


@pytest.fixture(scope="module")
def segmenters():
    cfg = SAM2Config.tiny()
    jm = JSAM2Base(cfg, dtype=jnp.float32)
    imgs = jnp.zeros((1, cfg.image_size, cfg.image_size, 3))
    text = jnp.zeros((1, 1, cfg.d_model))
    params = seeded_params(lambda: jm.init(jax.random.PRNGKey(0), imgs, text), 5)
    params = {"params": params["params"]}
    tm = build_sam2(from_jax.port_config(cfg),
                    from_jax.sam2_state_dict(params["params"]),
                    device="cpu", dtype=torch.float32)
    return jme.Sam2BoxSegmenter(jm, params), tme.Sam2BoxSegmenter(tm)


def _img(rng, h=40, w=48):
    return rng.randint(0, 255, (h, w, 3), np.uint8)


def test_parse_dense_caption_and_pipeline_records_equal_jax(tmp_path):
    for cap in ("A dog {obj_0} chases the cat{obj_1} outside.",
                "{obj_3} leads, then a man {obj_12} waves.", "no tags"):
        assert jgp.parse_dense_caption(cap) == tgp.parse_dense_caption(cap)
    rng = np.random.RandomState(0)
    h, w, l = 16, 20, 2
    file_names = [f"v/{t}.jpg" for t in range(l)]
    for f in file_names:
        p = tmp_path / "frames" / f
        p.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(p)
    meta = {"file_names": file_names, "width": w, "height": h, "length": l}
    objects = [{"id": 11, "cls": "dog"}, {"id": 12, "cls": "cat"}]
    jrec = jgp.GCGAnnotationPipeline(jgp.StubLLM()).annotate_video(
        meta, objects, frames=[])
    trec = tgp.GCGAnnotationPipeline(tgp.StubLLM()).annotate_video(
        meta, objects, frames=[])
    assert jrec == trec
    dense = tgp.parse_dense_caption("A dog {obj_0} runs.")
    assert jgp.build_instruction_record(meta, dense) == \
        tgp.build_instruction_record(meta, dense)
    m = np.zeros((h, w), bool)
    m[2:8, 2:8] = True
    ann = {"videos": [trec],
           "annotations": [{"id": 11, "segmentations": [rle_encode(m)] * l},
                           {"id": 12, "segmentations": [None, rle_encode(m)]}]}
    json.dump(ann, open(tmp_path / "train.json", "w"))
    args = (str(tmp_path / "train.json"), str(tmp_path / "frames"))
    jr = jds.GCGVideoDataset(*args, image_set="val")[0]
    tr = tds.GCGVideoDataset(*args, image_set="val")[0]
    assert jr["sources"] == tr["sources"]
    assert tr["sources"][0][1]["value"].count("[SEG]") == 2
    np.testing.assert_array_equal(jr["masks"][0], tr["masks"][0])


def test_sam2_box_segmenter_equals_jax(segmenters):
    js, ts = segmenters
    rng = np.random.RandomState(0)
    frame = _img(rng)
    boxes = [[5, 5, 30, 25], [10, 10, 40, 35], [0, 0, 47, 39]]
    got, want = ts(frame, boxes), js(frame, boxes)
    assert got.shape == want.shape == (3, 40, 48) and got.dtype == bool
    from videoglamm_torch.data.preprocess import preprocess_sam2
    size = ts.size
    img = torch.from_numpy(preprocess_sam2([frame], size))
    scale = np.asarray([size / 48, size / 40] * 2, np.float32)
    low = ts.segment(img, torch.from_numpy(np.asarray(boxes, np.float32) * scale))
    logits = resize_bilinear(low[..., None], (40, 48))[..., 0].numpy()
    differ = got != want
    assert not (differ & (np.abs(logits) > TOL_BAND)).any()
    assert 0 < got.sum() < got.size           # the masks carry signal


def _anet_fixture(root):
    rng = np.random.RandomState(1)
    vid, seg = "v_x1", "0"
    fdir = root / "video_frames" / vid / seg
    os.makedirs(fdir)
    for t in range(3):
        Image.fromarray(_img(rng)).save(fdir / f"{t:02d}.jpg")
    ann = {"refined_caption": "A cat [SEG:0] naps near a dog [SEG:1].",
           "seg_token_to_obj": {
               "[SEG:0]": {"frame_id": 0, "bbox": [2, 2, 20, 18]},
               "[SEG:1]": {"frame_id": 2, "bbox": [10, 8, 44, 36]}}}
    os.makedirs(root / "anns")
    json.dump(ann, open(root / "anns" / f"{vid}____{seg}.json", "w"))


def _vidstg_fixture(root):
    rng = np.random.RandomState(2)
    vdir = root / "vidstg_gcg" / "train" / "vidQ"
    os.makedirs(vdir / "frames")
    frames = [f"{t:04d}.png" for t in range(2)]
    for f in frames:
        Image.fromarray(_img(rng)).save(vdir / "frames" / f)
    boxes = {"1": {frames[0]: [3, 3, 25, 20], frames[1]: None}}
    json.dump(boxes, open(vdir / "boxes.json", "w"))
    cdir = root / "vidstg_gcg" / "train_captions"
    os.makedirs(cdir)
    json.dump({"caption": "[the cat](1) sleeps."}, open(cdir / "vidQ.json", "w"))


def _pngs(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".png") and "masks" in d:
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = np.asarray(Image.open(p))
    return out


@pytest.mark.parametrize("kind", ["anet", "vidstg"])
def test_extractors_write_the_pngs_jax_writes(segmenters, tmp_path, kind):
    """Each package's extractor over its own copy of one fixture: the same
    count, the same PNG files with equal arrays, idempotent without
    overwrite; the port's output loads through the port's dataset."""
    js, ts = segmenters
    make = _anet_fixture if kind == "anet" else _vidstg_fixture
    make(tmp_path / "src")
    roots = {}
    for who, mod, seg in (("jax", jme, js), ("port", tme, ts)):
        root = tmp_path / who
        shutil.copytree(tmp_path / "src", root)
        extract = (mod.extract_anet_gcg_masks if kind == "anet"
                   else mod.extract_vidstg_gcg_masks)
        assert extract(seg, str(root)) == 2
        assert extract(seg, str(root)) == 0
        roots[who] = root
    jp, tp = _pngs(roots["jax"]), _pngs(roots["port"])
    assert sorted(jp) == sorted(tp) and len(tp) == 2
    for k in jp:
        np.testing.assert_array_equal(jp[k], tp[k], err_msg=k)
    if kind == "anet":
        jr = jds.ANetEntitiesGCGDataset(str(roots["jax"]))[0]
        tr = tds.ANetEntitiesGCGDataset(str(roots["port"]))[0]
        assert tr["masks"][0].shape[0] == 2
    else:
        jr = jds.VidSTGHCSTVGGCGDataset(str(roots["jax"]), "train", "vidstg")[0]
        tr = tds.VidSTGHCSTVGGCGDataset(str(roots["port"]), "train", "vidstg")[0]
        assert tr["masks"][0].shape == (1, 2, 40, 48)
        assert not tr["masks"][0][0, 1].any()     # null box -> empty mask
    assert jr["sources"] == tr["sources"]
    np.testing.assert_array_equal(jr["masks"][0], tr["masks"][0])


def test_merge_gcg_annotations_equals_jax(tmp_path):
    m = np.zeros((8, 8), bool)
    m[:4] = True

    def inst(vid_name, ann_id):
        return {
            "videos": [{"file_names": [f"{vid_name}/0.jpg"], "width": 8,
                        "height": 8, "length": 1,
                        "dense_cap": {"caption": "a cat", "token_pos": [1],
                                      "mask_id": [ann_id],
                                      "v_id2o_id": {"0": ann_id}}}],
            "annotations": [{"id": ann_id, "segmentations": [rle_encode(m)]}],
        }

    p1, p2 = tmp_path / "a.json", tmp_path / "b.json"
    json.dump(inst("va", 3), open(p1, "w"))
    json.dump(inst("vb", 3), open(p2, "w"))
    paths = [str(p1), str(p2)]
    for skip in (None, {str(p2): [0]}):
        jo, to = tmp_path / "mj.json", tmp_path / "mt.json"
        jm = jme.merge_gcg_annotations(paths, skip_videos=skip, out_json=str(jo))
        tm = tme.merge_gcg_annotations(paths, skip_videos=skip, out_json=str(to))
        assert jm == tm
        assert json.load(open(jo)) == json.load(open(to))
    assert len(tm["videos"]) == 1
