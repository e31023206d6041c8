"""The port's last data modules against videoglamm_tpu.data on the CPU:
`data/refer_api.py` and `data/datasets/{refer_seg, sem_seg,
grounding_extra, grounded_video_qa, video_gcg_extra}.py`.

Host code (Python, numpy, PIL) in both packages, so the port is held
EQUAL: every record of every index, drawn three times over (the datasets'
own RandomState draws advance between them), the samples `SampleBuilder`
makes of them, the REFER / G_REFER API's answers, the class loaders and
caption parsers, and `build_val_gcg`'s union. Fixtures are the JAX tests':
the REFER, PACO, ANet-Entities and VidSTG roots of tests/test_data_formats.py
and the MeViS root of tests/test_datasets.py as fixtures; the inline
fixtures of tests/test_datasets.py (temporal grounding, GranDf, VidSTG,
RefCOCO-style JSON, grounded video QA, semantic segmentation) and of
tests/test_data_formats.py (`test_val_gcg_union`, `test_refclef_format`)
written again here with the same seeds and contents. No Pallas kernel runs.
"""
import json
import os
import pickle
import shutil

import numpy as np
import pytest

from test_data import FakeTokenizer
from test_data_formats import (anet_root, paco_root, refer_root,  # noqa: F401
                               vidstg_root)
from test_datasets import mevis_root  # noqa: F401  (fixture)
from test_torch_data import TCFG, _same
from test_videoglamm import CFG
from videoglamm_tpu.data import refer_api as jrefer
from videoglamm_tpu.data import datasets as jds
from videoglamm_tpu.data.datasets import sem_seg as jsem
from videoglamm_tpu.data.datasets import video_gcg_extra as jvge
from videoglamm_tpu.data.rle import rle_encode
from videoglamm_torch.data import datasets as tds
from videoglamm_torch.data import refer_api as trefer
from videoglamm_torch.data.datasets import sem_seg as tsem
from videoglamm_torch.data.datasets import video_gcg_extra as tvge
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _save_img(path, arr):
    from PIL import Image
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _temporal_root(root):
    rng = np.random.RandomState(5)
    for t in range(6):
        _save_img(str(root / "media" / "vidA" / f"{t:03d}.jpg"),
                  rng.randint(0, 255, (16, 16, 3), np.uint8))
    (root / "charades.txt").write_text("vidA 1.0 3.0##a person opens the door\n")
    return str(root / "charades.txt"), str(root / "media")


def _grandf_root(root):
    rng = np.random.RandomState(6)
    _save_img(str(root / "img" / "z.jpg"),
              rng.randint(0, 255, (20, 20, 3), np.uint8))
    m = np.zeros((20, 20), bool)
    m[3:9, 3:9] = True
    anns = [{"image": "z.jpg", "caption": "A red ball on the grass",
             "groundings": {"red ball": [rle_encode(m)]}}]
    json.dump(anns, open(root / "ann.json", "w"))
    return str(root / "ann.json"), str(root / "img")


def _vidstg_ann(root):
    rng = np.random.RandomState(7)
    for t in range(2):
        _save_img(str(root / "frames" / f"{t}.jpg"),
                  rng.randint(0, 255, (14, 14, 3), np.uint8))
    m = np.zeros((14, 14), bool)
    m[2:6, 2:6] = True
    anns = [{"vid": "v", "frames_dir": str(root / "frames"),
             "question": "the man in red", "qtype": "declarative",
             "mask_rles": [rle_encode(m), None]}]
    json.dump(anns, open(root / "ann.json", "w"))
    return str(root / "ann.json")


def _refer_seg_json(root):
    rng = np.random.RandomState(8)
    _save_img(str(root / "img" / "r.jpg"),
              rng.randint(0, 255, (18, 22, 3), np.uint8))
    m = np.zeros((18, 22), bool)
    m[4:10, 6:16] = True
    anns = [{"image": "r.jpg", "height": 18, "width": 22,
             "refs": [
                 {"sentences": ["the left mug"], "segmentation": rle_encode(m)},
                 {"sentences": ["a polygon thing"],
                  "segmentation": [[2, 2, 12, 2, 12, 8, 2, 8]]},
             ]}]
    json.dump(anns, open(root / "ann.json", "w"))
    return str(root / "ann.json"), str(root / "img")


def _gvqa_ann(root):
    rng = np.random.RandomState(9)
    for t in range(3):
        _save_img(str(root / "f" / f"{t}.jpg"),
                  rng.randint(0, 255, (10, 10, 3), np.uint8))
    m = np.zeros((10, 10), bool)
    m[2:5, 2:5] = True
    anns = [{"video_id": "v", "frames_dir": str(root / "f"),
             "question": "What bites what?",
             "answer": "The dog [SEG:0] bites the ball [SEG:1].",
             "seg_token_to_obj": {
                 "[SEG:0]": {"frame_id": 1, "rle": rle_encode(m)},
                 "[SEG:1]": {"frame_id": 2, "rle": rle_encode(m)}}}]
    json.dump(anns, open(root / "ann.json", "w"))
    return str(root / "ann.json")


def _sem_seg_roots(root):
    """The label PNGs of tests/test_datasets.py (two classes, offset 1)
    and tests/test_data_formats.py (an ignored class)."""
    rng = np.random.RandomState(3)
    _save_img(str(root / "a" / "img" / "a.jpg"),
              rng.randint(0, 255, (16, 16, 3), np.uint8))
    label = np.zeros((16, 16), np.uint8)
    label[:8] = 1
    label[8:, :8] = 2
    _save_img(str(root / "a" / "lab" / "a.png"), label)
    rng = np.random.RandomState(5)
    _save_img(str(root / "b" / "img" / "s.jpg"),
              rng.randint(0, 255, (12, 14, 3), np.uint8))
    label = np.zeros((12, 14), np.uint8)
    label[:6] = 1
    label[6:] = 2
    _save_img(str(root / "b" / "lab" / "s.png"), label)
    return str(root / "a"), str(root / "b")


@pytest.fixture(scope="module")
def datasets(refer_root, paco_root, anet_root, vidstg_root,  # noqa: F811
             mevis_root, tmp_path_factory):  # noqa: F811
    """name -> make(package's datasets module): the same files read by
    either package."""
    mk = tmp_path_factory.mktemp
    charades, media = _temporal_root(mk("temporal"))
    grandf_ann, grandf_img = _grandf_root(mk("grandf"))
    stg_ann = _vidstg_ann(mk("stg"))
    refer_ann, refer_img = _refer_seg_json(mk("referjson"))
    gvqa_ann = _gvqa_ann(mk("gvqa"))
    sem_a, sem_b = _sem_seg_roots(mk("semseg"))
    refer = str(refer_root[0])
    paco = paco_root[0]
    return {
        "temporal_charades": lambda m: m.TemporalGroundingDataset.from_charades_sta(
            charades, media, max_num_frames=4),
        "gcg_from_expressions": lambda m: m.GCGFromExpressions(
            m.ReferVOSDataset(str(mevis_root))),
        "grandf": lambda m: m.GranDfDataset(grandf_ann, grandf_img),
        "vidstg": lambda m: m.VidSTGDataset(stg_ann),
        "refer_seg_json": lambda m: m.ReferSegDataset(refer_ann, refer_img),
        "refcoco": lambda m: m.ReferSegDataset.from_refer(
            refer, "refcoco", "unc", "train"),
        "grefcoco": lambda m: m.ReferSegDataset.from_refer(
            refer, "grefcoco", "unc", "train"),
        "grounded_video_qa": lambda m: m.GroundedVideoQADataset(gvqa_ann),
        "sem_seg": lambda m: m.SemSegDataset(
            os.path.join(sem_a, "img"), os.path.join(sem_a, "lab"),
            ["wall", "sky"], label_offset=1),
        "sem_seg_ignored": lambda m: m.SemSegDataset(
            os.path.join(sem_b, "img"), os.path.join(sem_b, "lab"),
            ["person", "wall-brick", "sky"], ignored_values=[1]),
        "paco": lambda m: m.CocoPartSegDataset(
            str(paco / "train.json"), str(paco / "img"),
            num_anns_per_sample=2),
        "anet_gcg": lambda m: m.ANetEntitiesGCGDataset(str(anet_root)),
        "vidstg_gcg": lambda m: m.VidSTGHCSTVGGCGDataset(
            str(vidstg_root), "train", "vidstg"),
    }


DATASETS = ("temporal_charades", "gcg_from_expressions", "grandf", "vidstg",
            "refer_seg_json", "refcoco", "grefcoco", "grounded_video_qa",
            "sem_seg", "sem_seg_ignored", "paco", "anet_gcg", "vidstg_gcg")


def test_exports_equal_jax():
    """The port's datasets package exports what the JAX one exports."""
    public = lambda m: {k for k in dir(m) if not k.startswith("_")}
    assert public(jds) - {"refer_seg", "sem_seg", "grounding_extra",
                          "grounded_video_qa", "video_gcg_extra", "base",
                          "templates", "video_gcg", "refer_vos", "reason_seg",
                          "vqa", "refer_eval"} <= public(tds)


@pytest.mark.parametrize("name", DATASETS)
def test_dataset_records_and_samples_equal_jax(datasets, name):
    """Records of every index three times over, then the samples
    `SampleBuilder` makes of fresh datasets' records."""
    jd, td = datasets[name](jds), datasets[name](tds)
    assert len(jd) == len(td) > 0
    for rep in range(3):
        for i in range(len(jd)):
            _same(jd[i], td[i], f"{name}[{i}] draw {rep}")
    jb = jds.SampleBuilder(CFG, FakeTokenizer(), max_text_len=64,
                           num_frames_for_sam=2)
    tb = tds.SampleBuilder(TCFG, FakeTokenizer(), max_text_len=64,
                           num_frames_for_sam=2)
    jd, td = datasets[name](jds), datasets[name](tds)
    for i in range(len(jd)):
        _same(jb(jd[i]), tb(td[i]), f"{name}[{i}] sample")


def test_refer_api_equals_jax(refer_root):  # noqa: F811
    """ReferAPI and GReferAPI through `open_refer`: ref ids by split, refs,
    masks (single, unioned, no-target), boxes, image paths and the
    consolidated export."""
    root = str(refer_root[0])
    for dataset in ("refcoco", "grefcoco"):
        ja, ta = jrefer.open_refer(root, dataset), trefer.open_refer(root, dataset)
        assert type(ja).__name__ == type(ta).__name__
        for split in ("train", "val", None):
            assert ja.get_ref_ids(split=split) == ta.get_ref_ids(split=split)
        for rid in ja.get_ref_ids():
            jr, tr = ja.load_ref(rid), ta.load_ref(rid)
            _same(jr, tr, f"{dataset} ref {rid}")
            _same(ja.get_mask(jr), ta.get_mask(tr), f"{dataset} mask {rid}")
            _same(ja.image_path(jr["image_id"]), ta.image_path(tr["image_id"]))
            if dataset == "grefcoco":
                assert ja.is_no_target(jr) == ta.is_no_target(tr)
            else:
                assert ja.get_ref_box(rid) == ta.get_ref_box(rid)
        for split in ("train", "val"):
            _same(jrefer.export_consolidated(ja, split=split),
                  trefer.export_consolidated(ta, split=split),
                  f"{dataset} export {split}")


def test_refclef_api_equals_jax(tmp_path):
    """RefCLEF: the nested saiapr_tc-12 layout and uncompressed RLE
    (tests/test_data_formats.py::test_refclef_format's fixture)."""
    rng = np.random.RandomState(13)
    h, w = 4, 5
    img_rel = "19/images/19000.jpg"
    _save_img(str(tmp_path / "images" / "saiapr_tc-12" / "19" / "images" /
                  "19000.jpg"), rng.randint(0, 255, (h, w, 3), np.uint8))
    seg = {"size": [h, w], "counts": [3, 2, h * w - 5]}
    instances = {
        "images": [{"id": 1, "file_name": img_rel, "height": h, "width": w}],
        "annotations": [{"id": 10, "image_id": 1, "category_id": 1,
                         "segmentation": seg, "bbox": [0, 0, 2, 4]}],
        "categories": [{"id": 1, "name": "thing"}],
    }
    refs = [{"ref_id": 0, "ann_id": 10, "image_id": 1, "category_id": 1,
             "split": "train",
             "sentences": [{"sent": "dark region", "sent_id": 0,
                            "tokens": ["dark", "region"]}]}]
    os.makedirs(tmp_path / "refclef")
    with open(tmp_path / "refclef" / "refs(unc).p", "wb") as f:
        pickle.dump(refs, f)
    json.dump(instances, open(tmp_path / "refclef" / "instances.json", "w"))
    ja = jrefer.ReferAPI(str(tmp_path), "refclef")
    ta = trefer.ReferAPI(str(tmp_path), "refclef")
    assert ja.split_by == ta.split_by
    assert ja.image_path(1) == ta.image_path(1)
    _same(ja.get_mask(ja.load_ref(0)), ta.get_mask(ta.load_ref(0)), "refclef")


def test_parsers_and_class_loaders_equal_jax(tmp_path):
    """part_phrase under one RandomState, the Mapillary and COCO-Stuff
    class loaders, `caption_to_gcg` and `normalize_seg_answer`."""
    jr, tr = np.random.RandomState(0), np.random.RandomState(0)
    for _ in range(20):
        assert jsem.part_phrase("car", "wheel", jr) == \
            tsem.part_phrase("car", "wheel", tr)
    json.dump({"labels": [{"readable": "Bird"}, {"readable": "Curb Cut"}]},
              open(tmp_path / "config_v2.0.json", "w"))
    cfg_path = str(tmp_path / "config_v2.0.json")
    assert jds.load_mapillary_classes(cfg_path) == tds.load_mapillary_classes(cfg_path)
    with open(tmp_path / "cocostuff.txt", "w") as f:
        f.write("header\n0: person\n1: wall-brick\n2: sky\n")
    stuff = str(tmp_path / "cocostuff.txt")
    assert jds.load_cocostuff_classes(stuff) == tds.load_cocostuff_classes(stuff)
    for cap in ("[the man](1) waves at [a child](2, 3) outside.",
                "no spans here", "[a](7)[b](8) and [c d](9)"):
        assert jvge.caption_to_gcg(cap) == tvge.caption_to_gcg(cap)
    for ans in ("The dog [SEG:1] bites the ball [SEG:0].", "plain", "[SEG:2]"):
        assert jds.normalize_seg_answer(ans) == tds.normalize_seg_answer(ans)


def test_build_val_gcg_equals_jax(tmp_path, vidstg_root):  # noqa: F811
    """The '||'-joined GCG val union of tests/test_data_formats.py::
    test_val_gcg_union (video_gcg test split + a VidSTG val split; MeViS
    missing and skipped): the same datasets in the same order, the same
    records."""
    base = tmp_path / "videos"
    rng = np.random.RandomState(11)
    h, w = 12, 16
    _save_img(str(base / "video_gcg" / "frames" / "v0" / "0.jpg"),
              rng.randint(0, 255, (h, w, 3), np.uint8))
    m = np.zeros((h, w), bool)
    m[:6] = True
    inst = {"videos": [{"file_names": ["v0/0.jpg"], "width": w, "height": h,
                        "length": 1,
                        "dense_cap": {"caption": "a cat naps",
                                      "token_pos": [1], "mask_id": [1],
                                      "v_id2o_id": {}}}],
            "annotations": [{"id": 1, "segmentations": [rle_encode(m)]}]}
    json.dump(inst, open(base / "video_gcg" / "test.json", "w"))
    src = vidstg_root / "vidstg_gcg"
    shutil.copytree(src / "train", base / "vidstg_gcg" / "val")
    shutil.copytree(src / "train_captions", base / "vidstg_gcg" / "val_captions")
    jd, td = jds.build_val_gcg(str(base)), tds.build_val_gcg(str(base))
    assert type(td).__name__ == "ConcatDataset"
    assert [type(d).__name__ for d in jd.datasets] == \
        [type(d).__name__ for d in td.datasets]
    assert len(jd) == len(td) == 2
    for i in range(len(jd)):
        _same(jd[i], td[i], f"val_gcg[{i}]")
