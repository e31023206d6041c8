"""The port's evaluation layer (videoglamm_torch.evals and
data/anet_entities.py) against the JAX package on the CPU.

Every function takes the same numpy inputs, made from a seed (and the
hand-made cases of tests/test_evals.py), in both packages. Metrics, boxes,
phrases, cleaned masks and anet records must be EQUAL: both are the same
numpy and scipy code. Caption scores (CIDEr-D, METEOR with its synonym
stage, CLAIR through a stub judge) within 1e-12. `masks_to_original_size`
resizes in torch where JAX resizes in jnp, both in f32 with the same
matrices and another summation order: the masks must be equal except at
pixels whose JAX logit lies within 1e-5 of the threshold.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoglamm_tpu import evals as jev
from videoglamm_tpu.data import anet_entities as janet
from videoglamm_tpu.evals import caption_metrics as jcap
from videoglamm_tpu.evals import clair as jclair
from videoglamm_tpu.ops.resize import resize_bilinear as jresize_bilinear
from videoglamm_torch import evals as tev
from videoglamm_torch.data import anet_entities as tanet
from videoglamm_torch.evals import caption_metrics as tcap
from videoglamm_torch.evals import clair as tclair
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CAPTION_TOL = 1e-12
THRESH_TOL = 1e-5
SEEDS = (0, 1, 2)


def _masks(rng, n, shape, p=0.5):
    return rng.rand(n, *shape) > p


def _blobs(rng, n, T, H, W):
    """Rectangles, so that IoUs, boundaries and boxes are not all noise."""
    out = np.zeros((n, T, H, W), bool)
    for i in range(n):
        for t in range(T):
            y0, x0 = rng.randint(0, H // 2), rng.randint(0, W // 2)
            out[i, t, y0:y0 + rng.randint(2, H // 2),
                x0:x0 + rng.randint(2, W // 2)] = True
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_iou_miou_and_matching_equal(seed):
    rng = np.random.RandomState(seed)
    pred = list(_blobs(rng, 3, 4, 24, 32))
    gt = list(_blobs(rng, 2, 4, 24, 32)) + [pred[1].copy()]
    for a, b in zip(pred, gt):
        assert tev.compute_iou(a, b) == jev.compute_iou(a, b)
    assert tev.compute_miou(pred, gt) == jev.compute_miou(pred, gt)
    assert tev.compute_miou([], gt) == jev.compute_miou([], gt)
    words = ["red car", "a dog", "the road"]
    sim = lambda a, b: 1.0 if a.split()[-1] == b.split()[-1] else 0.2
    for thr in (0.0, 0.1, 0.5):
        got = tev.find_best_matches(gt, words, pred, words[::-1], sim,
                                    iou_threshold=thr)
        want = jev.find_best_matches(gt, words, pred, words[::-1], sim,
                                     iou_threshold=thr)
        assert [tuple(map(int, m)) for m in got] == \
            [tuple(map(int, m)) for m in want]


def test_hand_cases_of_the_jax_tests():
    """tests/test_evals.py's cases, held to the same expectations."""
    a = np.zeros((8, 8), bool)
    a[:4] = True
    b = np.zeros((8, 8), bool)
    b[2:6] = True
    assert tev.compute_iou(a, b) == pytest.approx(16 / 48)
    assert tev.compute_miou([a, b], [b, a]) == 1.0
    assert tev.find_best_matches([a], ["cat"], [a], ["car"],
                                 lambda x, y: 0.1) == []
    m = np.zeros((1, 10, 10))
    m[0, 2:5, 3:7] = 1
    assert list(tev.masks_to_boxes(m)[0]) == [3, 2, 6, 4]
    tiou, union, inter = tev.temporal_iou((2, 6), (4, 8), list(range(10)))
    assert tiou == pytest.approx(2 / 6) and inter == {4, 5}
    cap = "The <p> red car </p> [SEG] drives past <p>a tree</p> [SEG].<|end|>"
    assert tev.extract_phrases(cap) == ["red car", "a tree"]
    assert tev.clean_caption(cap) == "The red car drives past a tree ."


@pytest.mark.parametrize("seed", SEEDS)
def test_davis_j_f_and_statistics_equal(seed):
    rng = np.random.RandomState(seed)
    gt = _blobs(rng, 1, 6, 40, 48)[0]
    pred = np.roll(gt, rng.randint(0, 4), axis=1) | _masks(rng, 6, (40, 48), 0.98)
    pred[2] = False                        # an empty prediction
    gt[3] = False                          # an empty annotation
    np.testing.assert_array_equal(tev.davis_j(gt, pred), jev.davis_j(gt, pred))
    void = _masks(rng, 6, (40, 48), 0.9)
    np.testing.assert_array_equal(tev.davis_j(gt, pred, void),
                                  jev.davis_j(gt, pred, void))
    for t in range(6):
        for th in (0.008, 2):
            assert tev.boundary_f_measure(pred[t], gt[t], th) == \
                jev.boundary_f_measure(pred[t], gt[t], th)
        np.testing.assert_array_equal(tev.seg2bmap(gt[t]), jev.seg2bmap(gt[t]))
    vals = np.concatenate([jev.davis_j(gt, pred), [np.nan]])
    assert tev.db_statistics(vals) == jev.db_statistics(vals)


@pytest.mark.parametrize("seed", SEEDS)
def test_boxes_and_grounding_ious_equal(seed):
    rng = np.random.RandomState(seed)
    m = _blobs(rng, 5, 1, 30, 40)[:, 0]
    m[4] = False
    np.testing.assert_array_equal(tev.masks_to_boxes(m), jev.masks_to_boxes(m))
    assert tev.masks_to_boxes(m[:0]).shape == jev.masks_to_boxes(m[:0]).shape
    b1 = jev.masks_to_boxes(m[:4])
    b2 = rng.randint(0, 30, (3, 4)).astype(np.float32)
    b2[:, 2:] += b2[:, :2]
    b2[0] = b2[0, [0, 1, 0, 1]]            # a zero-area box
    np.testing.assert_array_equal(tev.np_box_iou(b1, b2), jev.np_box_iou(b1, b2))
    frames = list(range(0, 40, 3))
    gt_sted = tuple(sorted(rng.randint(0, 40, 2)))
    pred_sted = tuple(sorted(rng.randint(0, 40, 2)))
    got = tev.temporal_iou(gt_sted, pred_sted, frames)
    want = jev.temporal_iou(gt_sted, pred_sted, frames)
    assert got == want
    pred = {f: b1[i % 4].tolist() for i, f in enumerate(frames)}
    gtb = {f: b2[i % 3].tolist() for i, f in enumerate(frames) if i % 2}
    assert tev.video_iou(pred, gtb, got[1], got[2]) == \
        jev.video_iou(pred, gtb, want[1], want[2])
    assert tev.video_iou(pred, gtb, [], set()) == 0.0


@pytest.mark.parametrize("seed", SEEDS)
def test_intersection_and_union_and_meter_equal(seed):
    rng = np.random.RandomState(seed)
    pred = rng.randint(0, 2, (2, 16, 16))
    tgt = rng.randint(0, 2, (2, 16, 16))
    tgt[0, :3] = 255
    for a, b in zip(tev.intersection_and_union(pred, tgt),
                    jev.intersection_and_union(pred, tgt)):
        np.testing.assert_array_equal(a, b)
    tm, jm = tev.AverageMeter("x"), jev.AverageMeter("x")
    for v, n in zip(rng.rand(5), rng.randint(1, 4, 5)):
        tm.update(v, n)
        jm.update(v, n)
    assert (tm.sum, tm.count, tm.avg) == (jm.sum, jm.count, jm.avg)


@pytest.mark.parametrize("seed", SEEDS)
def test_postprocess_equal(seed):
    rng = np.random.RandomState(seed)
    m = _masks(rng, 3, (20, 24), 0.7)
    for size in (0, 3, 9):
        np.testing.assert_array_equal(tev.remove_small_blobs(m, size),
                                      jev.remove_small_blobs(m, size))
        np.testing.assert_array_equal(tev.remove_small_blobs(m[0], size),
                                      jev.remove_small_blobs(m[0], size))
    words = ["dog", "[SEG]", "<p>", "</p>", "a", "red  car", "<|end|>", "\n"]
    for _ in range(10):
        cap = " ".join(rng.choice(words, rng.randint(1, 12)))
        assert tev.clean_caption(cap) == jev.clean_caption(cap)
        assert tev.extract_phrases(cap) == jev.extract_phrases(cap)


@pytest.mark.parametrize("shape,hw", [((4, 2, 16, 16), (30, 44)),
                                      ((1, 3, 32, 32), (48, 85)),
                                      ((2, 16, 16), (16, 16)),
                                      ((5, 8, 12), (9, 7))])
def test_masks_to_original_size_against_jnp(shape, hw):
    rng = np.random.RandomState(sum(shape) + sum(hw))
    logits = (rng.randn(*shape) * 4).astype(np.float32)
    want = jev.postprocess.masks_to_original_size(logits, hw)
    ref = np.asarray(jresize_bilinear(
        jnp.asarray(logits).reshape((-1,) + shape[-2:] + (1,)), hw))
    ref = ref[..., 0].reshape(shape[:-2] + hw)
    for x in (logits, torch.from_numpy(logits)):
        got = tev.masks_to_original_size(x, hw)
        assert got.dtype == np.bool_ and got.shape == want.shape
        differ = got != want
        assert (np.abs(ref[differ]) < THRESH_TOL).all()
    for thr in (-1.0, 2.5):
        got = tev.masks_to_original_size(logits, hw, threshold=thr)
        want = jev.postprocess.masks_to_original_size(logits, hw, threshold=thr)
        assert (np.abs(ref[got != want] - thr) < THRESH_TOL).all()


CAPS = ["a red car drives down the road", "a dog runs across the field",
        "two people sit on a bench", "the cat sat on the mat",
        "a puppy sprints along the street", "glass towers hum loudly",
        "mat the on sat cat the", "cats mat", "a little kid leaps"]


@pytest.mark.parametrize("seed", SEEDS)
def test_caption_metrics_within_tolerance(seed):
    rng = np.random.RandomState(seed)
    n = 5
    gts = {k: list(rng.choice(CAPS, rng.randint(1, 3), replace=False))
           for k in range(n)}
    res = {k: [str(rng.choice(CAPS))] for k in range(n)}
    for fn_t, fn_j in ((tcap.cider_d, jcap.cider_d),
                       (tcap.meteor, jcap.meteor)):
        (st, pt), (sj, pj) = fn_t(gts, res), fn_j(gts, res)
        assert abs(st - sj) <= CAPTION_TOL
        np.testing.assert_allclose(pt, pj, rtol=0, atol=CAPTION_TOL)
    assert tcap.tokenize(CAPS[0] + ", OK!") == jcap.tokenize(CAPS[0] + ", OK!")


def test_meteor_synonym_stage_and_register():
    """The synonym stage and its table (tests/test_evals.py's case), and a
    group registered in both packages."""
    gts = {0: ["the canine runs"]}
    for mod in (tcap, jcap):
        s, _ = mod.meteor(gts, {0: ["the dog runs"]})
        assert abs(s - (1 - 0.5 / 27)) < 1e-9
    pair = ("quibblet", "snarfle")
    before = tcap.meteor({0: ["the quibblet runs"]}, {0: ["the snarfle runs"]})
    assert abs(before[0] - 1 / 3) < 1e-9
    tcap.register_synonyms(pair)
    jcap.register_synonyms(pair)
    got = tcap.meteor({0: ["the quibblet runs"]}, {0: ["the snarfle runs"]})
    want = jcap.meteor({0: ["the quibblet runs"]}, {0: ["the snarfle runs"]})
    assert abs(got[0] - want[0]) <= CAPTION_TOL
    assert abs(got[0] - (1 - 0.5 / 27)) < 1e-9


def test_clair_with_a_stub_judge():
    replies = ['noise {"score": 73.5, "reason": "close"} tail',
               "no json here", '{"score": "x"}', '{"score": 10}']
    prompts = {"t": [], "j": []}

    def judge(key):
        it = iter(replies)

        def call(prompt):
            prompts[key].append(prompt)
            return next(it)
        return call

    cands = [["a dog runs"], ["a cat"], ["x"], ["two people", "a bench"]]
    refs = [["a puppy sprints"], ["a kitten"], ["y"], ["people sit"]]
    got = tclair.clair_metric(cands, refs, judge("t"))
    want = jclair.clair_metric(cands, refs, judge("j"))
    assert prompts["t"] == prompts["j"]
    assert got["n_scored"] == want["n_scored"] == 2
    assert abs(got["clair"] - want["clair"]) <= CAPTION_TOL
    one = tclair.clair_score(["a"], ["b"], lambda p: replies[0])
    assert one == jclair.clair_score(["a"], ["b"], lambda p: replies[0])


def _anet_fixture(tmp_path):
    rng = np.random.RandomState(5)
    anns, split = {}, {"validation": [], "training": []}
    for v in range(4):
        vid = f"v_{v:03d}"
        segs = {}
        for s in range(3):
            tokens = [str(w) for w in rng.choice(
                ["a", "man", "rides", "the", "red", "bike", "dog"], 6)]
            nb = rng.randint(0, 4)
            segs[str(s if s != 2 else 10)] = {
                "timestamps": sorted(rng.uniform(0, 60, 2).tolist()),
                "tokens": tokens,
                "process_idx": [[int(rng.randint(0, 8))] if b % 2 else []
                                for b in range(nb)],
                "process_clss": [["bike"] if b != 1 else "dog"
                                 for b in range(nb - 1)],
                "process_bnd_box": rng.randint(0, 400, (nb, 4)).tolist(),
                "frame_ind": rng.randint(0, 50, max(nb - 1, 0)).tolist(),
                "crowds": [0] * nb}
        anns[vid] = {"segments": segs}
        split["validation" if v != 1 else "training"].append(vid)
    (tmp_path / "ref.json").write_text(json.dumps({"annotations": anns}))
    (tmp_path / "split.json").write_text(json.dumps(split))
    root = tmp_path / "videos"
    (root / "val").mkdir(parents=True)
    (root / "val" / "v_000.mkv").write_bytes(b"")
    (root / "v_002.mp4").write_bytes(b"")
    return str(tmp_path / "ref.json"), str(tmp_path / "split.json"), str(root)


@pytest.mark.parametrize("split", ["validation", "training"])
@pytest.mark.parametrize("with_videos,skip", [(False, False), (True, False),
                                              (True, True)])
def test_anet_entities_records_equal(tmp_path, split, with_videos, skip):
    ref, sp, root = _anet_fixture(tmp_path)
    kw = dict(videos_root=root if with_videos else None, split=split,
              skip_missing_videos=skip)
    got = tanet.convert_official_annotations(ref, sp, **kw)
    want = janet.convert_official_annotations(ref, sp, **kw)
    assert got == want
    assert len(got) > 0 or (split == "training" and skip)
    for vid in ("v_000", "v_002", "v_003"):
        assert tanet.find_video(root, vid) == janet.find_video(root, vid)


@pytest.mark.parametrize("total,fps,ts,num", [(300, 25.0, [1.2, 7.9], 16),
                                              (40, 30.0, [0.5, 9.0], 8),
                                              (100, 24.0, [3.0, 3.0], 4),
                                              (10, 25.0, [0.0, 0.1], 16)])
def test_anet_segment_frame_indices_equal(total, fps, ts, num):
    np.testing.assert_array_equal(
        tanet.segment_frame_indices(total, fps, ts, num),
        janet.segment_frame_indices(total, fps, ts, num))


def test_evals_exports_what_jax_exports():
    import videoglamm_tpu.evals as j
    names = {n for n in dir(j) if not n.startswith("_")} - {
        "metrics", "postprocess", "clair", "caption_metrics"}
    missing = [n for n in names if not hasattr(tev, n)]
    assert not missing
