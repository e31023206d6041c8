"""The port's training data layer against videoglamm_tpu.data on the CPU.

The data layer is host code (Python, numpy, PIL) in both packages, so the
port is held EQUAL, not close: prompts, token ids and labels, the host
preprocessors (bit-equal float32), every ported dataset's records, the
samples `SampleBuilder` makes of them, the `HybridDataset` sequence for a
seed, `build_batch` for every key, the SAM augmentations under one
`RandomState`, and decoded video frames. The one stated difference is
collate's containers: the port returns CPU torch tensors, pixels and masks
float32 and the integer fields int64, where JAX returns int32 numpy arrays.

Fixtures are the JAX tests' own: `FakeTokenizer` (tests/test_data.py), the
GCG and MeViS roots of tests/test_datasets.py, and the A2D / JHMDB layouts
of tests/test_data_formats.py. No Pallas kernel runs here.
"""
import json
import os

import numpy as np
import pytest
import torch

from test_cli_e2e import _make_a2d_fixture
from test_data import FakeTokenizer
from test_datasets import gcg_root, mevis_root  # noqa: F401  (fixtures)
from test_videoglamm import CFG
from videoglamm_tpu import data as jdata
from videoglamm_tpu.data import augment as jaugment
from videoglamm_tpu.data import datasets as jds
from videoglamm_tpu.data import video_reader as jvr
from videoglamm_tpu.data.rle import rle_encode
from videoglamm_torch import data as tdata
from videoglamm_torch.cli.train import stack_micro_batches
from videoglamm_torch.data import augment as taugment
from videoglamm_torch.data import datasets as tds
from videoglamm_torch.data import prefetch as tprefetch
from videoglamm_torch.data import video_reader as tvr
from videoglamm_torch.io.from_jax import port_config
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TCFG = port_config(CFG)


def _save_img(path, arr):
    from PIL import Image
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _same(a, b, where="record"):
    """Recursive equality: numpy arrays equal in dtype and value."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (where, a.dtype, b.dtype)
        assert a.shape == b.shape, (where, a.shape, b.shape)
        assert np.array_equal(a, b), where
    else:
        assert a == b, (where, a, b)


# ----------------------------------------------------------- conversation

SOURCES = [
    [{"from": "human", "value": "<video>\nWhat is the cat doing?"},
     {"from": "gpt", "value": "It sits. [SEG]"}],
    [{"from": "human", "value": "Describe <image> this."},
     {"from": "gpt", "value": "A <p> dog </p> [SEG] on grass."},
     {"from": "human", "value": "And the ball?"},
     {"from": "gpt", "value": "It is [SEG] ."}],
    [{"from": "gpt", "value": "dropped: a leading gpt turn"},
     {"from": "human", "value": "<video>\nSegment it."},
     {"from": "gpt", "value": "Sure, [SEG]."}],
]


@pytest.mark.parametrize("base", ["phi3", "llama3_1"])
@pytest.mark.parametrize("mm_start_end", [False, True])
def test_prompts_ids_and_labels_equal_jax(base, mm_start_end):
    jgen = jdata.ConvGenerator(base, use_mm_start_end=mm_start_end)
    tgen = tdata.ConvGenerator(base, use_mm_start_end=mm_start_end)
    jtok, ttok = FakeTokenizer(), FakeTokenizer()
    for src in SOURCES:
        jp, tp = jgen.apply(src), tgen.apply(src)
        assert jp == tp
        for max_len in (128, 9):          # 9 truncates inside the prompt
            _same(jgen.tokenize_and_mask(jp[0], jtok, max_len),
                  tgen.tokenize_and_mask(tp[0], ttok, max_len))
        assert (jdata.tokenizer_image_token(jp[0], jtok)
                == tdata.tokenizer_image_token(tp[0], ttok))
    for media in ("video", "image"):
        assert (jgen.apply_for_chat("Segment the dog.", media)
                == tgen.apply_for_chat("Segment the dog.", media))
    assert jdata.conv_templates.keys() == tdata.conv_templates.keys()


# ------------------------------------------------------------- preprocess

def test_frame_indices_and_host_preprocessors_bit_equal():
    for total, num in ((100, 16), (3, 8), (0, 2), (16, 16)):
        _same(jdata.sample_frame_indices(total, num),
              tdata.sample_frame_indices(total, num))
    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 256, (37, 53, 3), np.uint8) for _ in range(2)]
    frames.append(rng.randint(0, 256, (64, 48, 3), np.uint8))
    for fn, size in (("preprocess_internvideo", 28), ("preprocess_clip", 56),
                     ("preprocess_sam2", 128), ("preprocess_sam2", 64)):
        _same(getattr(jdata, fn)(frames, size), getattr(tdata, fn)(frames, size),
              fn)
    # the default sizes once, on one frame of the main path's shape
    big = [rng.randint(0, 256, (48, 85, 3), np.uint8)]
    for fn in ("preprocess_internvideo", "preprocess_clip", "preprocess_sam2"):
        _same(getattr(jdata, fn)(big), getattr(tdata, fn)(big), fn)


# --------------------------------------------------------------- datasets

@pytest.fixture(scope="module")
def mevis4_root(tmp_path_factory):
    """A MeViS root with 4 expressions on one video (the dataset samples 3
    of them) and one on another, masks from mask_dict.json RLEs."""
    root = tmp_path_factory.mktemp("mevis4")
    rng = np.random.RandomState(5)
    h, w = 18, 26
    meta = {"videos": {}}
    mask_dict = {}
    for v, n_exp in (("a", 4), ("b", 1)):
        for t in range(3):
            _save_img(str(root / "JPEGImages" / v / f"{t:05d}.jpg"),
                      rng.randint(0, 255, (h, w, 3), np.uint8))
        exprs = {}
        for e in range(n_exp):
            aid = f"{v}{e}"
            m = rng.rand(h, w) > 0.6
            mask_dict[aid] = [rle_encode(m), None, rle_encode(~m)]
            exprs[str(e)] = {"exp": f"The Object {v} {e}", "anno_id": [aid]}
        meta["videos"][v] = {"expressions": exprs, "frames": []}
    json.dump(mask_dict, open(root / "mask_dict.json", "w"))
    json.dump(meta, open(root / "meta_expressions.json", "w"))
    return root


def _reason_root(root, split, n=2, seed=2):
    rng = np.random.RandomState(seed)
    for i in range(n):
        _save_img(str(root / split / f"x{i}.jpg"),
                  rng.randint(0, 255, (30, 40, 3), np.uint8))
        anno = {"text": f"the biggest object {i}", "is_sentence": i % 2 == 0,
                "shapes": [
                    {"label": "target", "points": [[5, 5], [30, 5], [30, 20],
                                                   [5, 20]]},
                    {"label": "target", "points": [[2, 2], [8, 2], [8, 9]]},
                    {"label": "ignore_region", "points": [[0, 25], [10, 25],
                                                          [10, 29], [0, 29]]},
                    {"label": "flag", "points": [[0, 0], [3, 0], [3, 3]]},
                ]}
        json.dump(anno, open(root / split / f"x{i}.json", "w"))
    return str(root)


def _vqa_root(root):
    rng = np.random.RandomState(4)
    for i in range(2):
        _save_img(str(root / "media" / f"p{i}.jpg"),
                  rng.randint(0, 255, (12, 14, 3), np.uint8))
    data = [{"image": "p0.jpg", "conversations": [
                {"from": "human", "value": "What is shown?"},
                {"from": "gpt", "value": "Random noise."}]},
            {"image": "p1.jpg", "conversations": [
                {"from": "user", "value": "<image>\nAnd here?"},
                {"from": "gpt", "value": "More noise."}]}]
    json.dump(data, open(root / "ann.json", "w"))
    return str(root / "ann.json"), str(root / "media")


def _jhmdb_root(root):
    """The JHMDB-Sentences layout of tests/test_data_formats.py:323."""
    import scipy.io
    rng = np.random.RandomState(9)
    h, w, T = 12, 16, 5
    rel_dir = "Rename_Images/brush_hair/clipZ"
    for t in range(1, T + 1):
        _save_img(str(root / rel_dir / f"{t:05d}.png"),
                  rng.randint(0, 255, (h, w, 3), np.uint8))
    part_mask = np.zeros((h, w, T), np.uint8)
    part_mask[2:7, 3:9, 2] = 1
    os.makedirs(root / "puppet_mask" / "brush_hair" / "clipZ")
    mat_rel = "puppet_mask/brush_hair/clipZ/puppet_mask.mat"
    scipy.io.savemat(str(root / mat_rel), {"part_mask": part_mask})
    rows = [["clipZ", f"./{rel_dir}/00003.png", mat_rel, T,
             "A  person brushing hair"]]
    json.dump(rows, open(root / "jhmdb_ann.json", "w"))
    return str(root), str(root / "jhmdb_ann.json")


@pytest.fixture(scope="module")
def datasets(gcg_root, mevis_root, mevis4_root, tmp_path_factory):  # noqa: F811
    """(name, make(package's datasets module), number of draws): the same
    files read by either package."""
    reason = _reason_root(tmp_path_factory.mktemp("reason"), "train")
    vqa_json, vqa_media = _vqa_root(tmp_path_factory.mktemp("vqa"))
    a2d_dir = tmp_path_factory.mktemp("a2d")
    a2d_ann = _make_a2d_fixture(a2d_dir)
    jh_root, jh_ann = _jhmdb_root(tmp_path_factory.mktemp("jhmdb"))
    gcg = (str(gcg_root / "train.json"), str(gcg_root / "frames"))
    return {
        "gcg_train": lambda m: m.GCGVideoDataset(*gcg, max_num_frames=2),
        "gcg_val": lambda m: m.GCGVideoDataset(*gcg, image_set="val"),
        "refer_vos": lambda m: m.ReferVOSDataset(str(mevis_root)),
        "refer_vos_sampled": lambda m: m.ReferVOSDataset(str(mevis4_root)),
        "reason_seg": lambda m: m.ReasonSegDataset(reason),
        "vqa": lambda m: m.VQADataset(vqa_json, vqa_media),
        "a2d": lambda m: m.A2DSentencesDataset(str(a2d_dir), a2d_ann,
                                               num_frames=5),
        "jhmdb": lambda m: m.JHMDBSentencesDataset(jh_root, jh_ann,
                                                   num_frames=3),
        "a2d_train": lambda m: m.ReferSentencesTrainDataset(
            m.A2DSentencesDataset(str(a2d_dir), a2d_ann, num_frames=5),
            num_frames_for_sam=3),
        "jhmdb_train": lambda m: m.ReferSentencesTrainDataset(
            m.JHMDBSentencesDataset(jh_root, jh_ann, num_frames=3),
            num_frames_for_sam=2),
    }


DATASETS = ("gcg_train", "gcg_val", "refer_vos", "refer_vos_sampled",
            "reason_seg", "vqa", "a2d", "jhmdb", "a2d_train", "jhmdb_train")
TRAIN_DATASETS = tuple(d for d in DATASETS if d not in ("a2d", "jhmdb"))


@pytest.mark.parametrize("name", DATASETS)
def test_dataset_records_equal_jax(datasets, name):
    """Records of every index, drawn three times over (the datasets' own
    RandomState draws advance between them)."""
    jd, td = datasets[name](jds), datasets[name](tds)
    assert len(jd) == len(td) > 0
    for rep in range(3):
        for i in range(len(jd)):
            _same(jd[i], td[i], f"{name}[{i}] draw {rep}")


@pytest.mark.parametrize("name", TRAIN_DATASETS)
def test_sample_builder_samples_equal_jax(datasets, name):
    jb = jds.SampleBuilder(CFG, FakeTokenizer(), max_text_len=48,
                           num_frames_for_sam=3)
    tb = tds.SampleBuilder(TCFG, FakeTokenizer(), max_text_len=48,
                           num_frames_for_sam=3)
    assert jb.mask_hw == tb.mask_hw
    jd, td = datasets[name](jds), datasets[name](tds)
    for i in range(len(jd)):
        _same(jb(jd[i]), tb(td[i]), f"{name}[{i}] sample")


def _hybrid(mod, cfg, datasets, names, seed=0):
    builder = mod.SampleBuilder(cfg, FakeTokenizer(), max_text_len=40,
                                num_frames_for_sam=2)
    specs = [mod.DatasetSpec(n, datasets[n](mod), 1.0 + i)
             for i, n in enumerate(names)]
    return mod.HybridDataset(specs, builder, samples_per_epoch=8, seed=seed)


def test_hybrid_sequence_and_batches_equal_jax(datasets):
    """The same seed draws the same datasets and records in the same
    order; the collated batches hold the JAX arrays' values in the port's
    dtypes."""
    names = ("gcg_train", "refer_vos", "reason_seg", "vqa")
    jh = _hybrid(jds, CFG, datasets, names, seed=3)
    th = _hybrid(tds, TCFG, datasets, names, seed=3)
    np.testing.assert_array_equal(jh.probs, th.probs)
    for i in range(6):
        _same(jh[i], th[i], f"hybrid sample {i}")
    jb = next(jh.batches(2, 40))
    tb = next(th.batches(2, 40))
    assert set(jb) == set(tb)
    for k, want in jb.items():
        got = tb[k]
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert got.is_contiguous(), k
        assert got.dtype == (torch.int64 if want.dtype.kind == "i"
                             else torch.float32), (k, got.dtype)
        assert want.dtype in (np.int32, np.float32), (k, want.dtype)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=k)


def test_build_batch_equals_jax_for_every_key():
    """tests/test_data.py's ragged case: rows of several conversations,
    more [SEG] masks than slots, truncation at max_text_len."""
    rng = np.random.RandomState(0)
    T, Ts = 4, 2

    def sample(n_conv, n_seg):
        return dict(
            frames=rng.randn(T, 28, 28, 3),
            context_images=rng.randn(T, 56, 56, 3),
            frames_sam=rng.randn(Ts, 128, 128, 3),
            conversations=[(list(range(5 + 7 * i)), list(range(5 + 7 * i)))
                           for i in range(n_conv)],
            masks=rng.rand(n_seg, Ts, 32, 32).round())

    samples = [sample(2, 1), sample(1, 5), dict(sample(1, 1), masks=None)]
    for kw in ({"max_text_len": 16}, {"max_text_len": 9, "mask_hw": (32, 32)},
               {"max_text_len": 12, "max_seg": 2}):
        want = jdata.build_batch(samples, **kw)
        got = tdata.build_batch(samples, **kw)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == (torch.int64 if want[k].dtype.kind == "i"
                                    else torch.float32)
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_sam_augmentations_equal_jax():
    rng = np.random.RandomState(10)
    frames = rng.rand(3, 32, 32, 3).astype(np.float32)
    masks = (rng.rand(2, 3, 32, 32) > 0.5).astype(np.float32)
    for t_train in (2, 3, 5):
        for m in (masks, None):
            want = jaugment.apply_sam_augmentations(
                frames, m, t_train, rng=np.random.RandomState(t_train))
            got = taugment.apply_sam_augmentations(
                frames, m, t_train, rng=np.random.RandomState(t_train))
            _same(list(want), list(got), f"t_train {t_train}")
    assert tdata.apply_sam_augmentations is taugment.apply_sam_augmentations


# ----------------------------------------------------------- video reader

def test_video_reader_frames_equal_jax(tmp_path, monkeypatch):
    """Both packages' loaders on one clip: the port's library is built into
    build/native/ from native/frameloader.cpp and never writes native/. The
    JAX loader builds its own copy of the same source into tmp_path here,
    so that this file never races the JAX tests' build in native/."""
    monkeypatch.setattr(jvr, "_LIB_PATH", str(tmp_path / "libvglframes.so"))
    monkeypatch.setattr(jvr, "_lib", None)
    native = os.path.dirname(jvr._SRC_PATH)
    before = {f: os.stat(os.path.join(native, f)).st_mtime_ns
              for f in os.listdir(native)}
    path = str(tmp_path / "clip.avi")
    tvr.write_test_video(path, w=64, h=48, n_frames=25, fps=5)
    jr, tr = jvr.VideoReader(path), tvr.VideoReader(path)
    assert len(jr) == len(tr) == 25 and jr.size == tr.size == (64, 48)
    assert jr.fps == tr.fps
    for idx, size in (([0, 3, 10, 24], None), ([2], (32, 24)), ([5, 6], None)):
        _same(jr.get_batch(idx, out_size=size), tr.get_batch(idx, out_size=size))
    jr.close()
    tr.close()
    _same(jvr.load_video_frames(path, num_frames=8),
          tvr.load_video_frames(path, num_frames=8))
    d = tmp_path / "frames"
    for i in range(6):
        _save_img(str(d / f"{i:05d}.jpg"), np.full((16, 16, 3), i * 30, np.uint8))
    _same(jvr.load_video_frames(str(d), num_frames=4),
          tvr.load_video_frames(str(d), num_frames=4))
    _same(jvr.load_frame_dir(str(d), [1, 4]), tvr.load_frame_dir(str(d), [1, 4]))
    lib = tvr.get_native_lib()._name
    assert os.path.dirname(lib) == str(tvr.BUILD_DIR)
    assert {f: os.stat(os.path.join(native, f)).st_mtime_ns
            for f in os.listdir(native)} == before


def test_video_reader_raises_when_the_library_does_not_build(tmp_path,
                                                             monkeypatch):
    bad = tmp_path / "frameloader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tvr, "SRC_PATH", bad)
    monkeypatch.setattr(tvr, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tvr, "_lib", None)
    with pytest.raises(RuntimeError, match="frame loader"):
        tvr.VideoReader(str(tmp_path / "clip.avi"))


# ------------------------------------------------- prefetch and the stack

def test_prefetch_passes_worker_errors_and_closes():
    def failing():
        yield {"x": torch.zeros(1)}
        raise KeyError("bad record")

    it = tdata.PrefetchIterator(failing(), prefetch=2)
    assert torch.equal(next(it)["x"], torch.zeros(1))
    with pytest.raises(KeyError, match="bad record"):
        next(it)

    def endless():
        i = 0
        while True:
            yield i
            i += 1

    staged = []
    it = tdata.prefetch_to_device(endless(), lambda b: staged.append(b) or b,
                                  prefetch=2)
    assert [next(it) for _ in range(5)] == list(range(5))
    it.close()
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)


def test_to_device_on_the_cpu_casts_the_pixel_streams_only():
    b = {"frames": torch.randn(1, 2, 4, 4, 3), "gt_masks": torch.rand(1, 2),
         "input_ids": torch.arange(4)[None]}
    out = tprefetch.device_copier("cpu", torch.bfloat16)(b)
    assert out["frames"].dtype == torch.bfloat16
    assert torch.equal(out["frames"], b["frames"].to(torch.bfloat16))
    assert out["gt_masks"] is b["gt_masks"] and out["input_ids"] is b["input_ids"]


def test_micro_batch_stack_raises_on_unequal_rows(datasets):
    """A 3-expression ReferVOS record is 3 rows, a GCG record 1: their
    micro-batches do not stack, in JAX (np.stack) or in the port."""
    rows = []
    for mod, cfg in ((jds, CFG), (tds, TCFG)):
        b = mod.SampleBuilder(cfg, FakeTokenizer(), max_text_len=40,
                              num_frames_for_sam=2)
        three = b(datasets["refer_vos_sampled"](mod)[0])
        one = b(datasets["gcg_train"](mod)[0])
        build = jdata.build_batch if mod is jds else tdata.build_batch
        rows.append([build([s], max_text_len=40, mask_hw=b.mask_hw)
                     for s in (three, one)])
    (j3, j1), (t3, t1) = rows
    assert j3["input_ids"].shape[0] == t3["input_ids"].shape[0] == 3
    with pytest.raises(ValueError):
        np.stack([j3["input_ids"], j1["input_ids"]])
    with pytest.raises(ValueError, match="input_ids"):
        stack_micro_batches([t3, t1])
    st = stack_micro_batches([t1, t1])
    assert st["input_ids"].shape == (2,) + tuple(t1["input_ids"].shape)
