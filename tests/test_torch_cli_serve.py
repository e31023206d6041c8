"""The port's serving CLIs (videoglamm_torch.cli: chat, the five eval
inference CLIs, the two metric CLIs, convert_checkpoint) against the JAX
CLIs on the CPU.

- Stubbed pipeline: both packages' `load_model` and `load_tokenizer` are
  patched, the JAX `GroundedInference` and the port's `build_inference`
  replaced by stubs that record every call and answer it with the same
  `InferenceResult`, made from a seed per call (tokens that decode to
  "<p> ... </p> [SEG]" captions, [SEG] slots valid or not, blob-shaped mask
  logits at the SAM frame count they were handed). On the same fixtures
  the two CLIs must see the same prompt ids, build with the same options,
  write the same files (equal PNG arrays, equal JSON) and print the same
  lines; the port adds one "[done]" line with its skip count. The vision
  inputs the stubs receive are held within tests/test_torch_preprocess.py's
  bound (1e-5): both CLIs take the device branch of `prepare_vision_inputs`
  on uniform uint8 frames. The host branch is held bit-equal on its own.
- A fault of the data (a missing frame directory, a bad annotation) is
  skipped by both; an exception from the model call propagates from the
  port's CLI where the JAX CLI prints "[skip]".
- One end-to-end pass of every port CLI on the tiny port model through the
  real `build_inference`, `--device cpu --precision f32` (int8 weights and
  cache and the video branch on chat). Its free-running tokens are not
  compared with JAX's (ROADMAP: compare teacher-forced).
- convert_checkpoint: a seeded model in the reference layout (two shards,
  a LoRA adapter, both tower files) gives, through `load_model`, the state
  dict of `from_reference_layout` after the LoRA merge; with `--int8_llm`
  the codes of `quantize_llm`, and the directory serves with --quant int8.
"""
import builtins
import json
import os
import types
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import videoglamm_tpu.inference as jinference
from test_videoglamm import CFG
from videoglamm_tpu.cli import chat as jchat
from videoglamm_tpu.cli import common as jcommon
from videoglamm_tpu.cli import eval_anet_entities_infer as janet
from videoglamm_tpu.cli import eval_gcg_infer as jgcg
from videoglamm_tpu.cli import eval_gcg_metrics as jgcg_metrics
from videoglamm_tpu.cli import eval_grounding as jground
from videoglamm_tpu.cli import eval_refer_infer as jrefer
from videoglamm_tpu.cli import eval_referdavis_metrics as jdavis
from videoglamm_tpu.inference.pipeline import InferenceResult as JResult
from videoglamm_torch.cli import chat as tchat
from videoglamm_torch.cli import common as tcommon
from videoglamm_torch.cli import convert_checkpoint as tconvert
from videoglamm_torch.cli import eval_anet_entities_infer as tanet
from videoglamm_torch.cli import eval_gcg_infer as tgcg
from videoglamm_torch.cli import eval_gcg_metrics as tgcg_metrics
from videoglamm_torch.cli import eval_grounding as tground
from videoglamm_torch.cli import eval_refer_infer as trefer
from videoglamm_torch.cli import eval_referdavis_metrics as tdavis
from videoglamm_torch.config import VideoGLaMMConfig
from videoglamm_torch.inference.pipeline import InferenceResult as TResult
from videoglamm_torch.io import reference
from videoglamm_torch.io.from_jax import port_config
from videoglamm_torch.models.phi3 import quantize_llm
from videoglamm_torch.models.videoglamm import VideoGLaMM
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TCFG = port_config(CFG)
TOL_STREAMS = 1e-5          # tests/test_torch_preprocess.py's bound
MAX_NEW = 8
H, W = 30, 44               # fixture frames
VOCAB = ["<pad>", "<s>", "</s>", "<eos>", "<p>", "</p>", "[SEG]", "the", "a",
         "red", "car", "dog", "runs", "on", "road", "\n", "."]
CAPTION = "the <p> red car </p> [SEG] runs on <p> a road </p> [SEG] ."


class WordTok:
    """Stateless word-level tokenizer: VOCAB words at their index, [SEG]
    at the config's id, other words hashed into [20, 490); decode maps ids
    back (ids past VOCAB become "w<id>")."""
    bos_token_id = 1
    eos_token_id = 3

    def __call__(self, text):
        return types.SimpleNamespace(input_ids=[self.bos_token_id] + [
            self._id(w) for w in text.split()])

    @staticmethod
    def _id(w):
        if w == "[SEG]":
            return TCFG.seg_token_idx
        if w in VOCAB:
            return VOCAB.index(w)
        return 20 + zlib.crc32(w.encode()) % 470

    def decode(self, ids, skip_special_tokens=False):
        return " ".join("[SEG]" if i == TCFG.seg_token_idx
                        else VOCAB[i] if i < len(VOCAB) else f"w{i}"
                        for i in ids)


def stub_result(call: int, t_sam: int):
    """The seeded InferenceResult of the call-th pipeline call (numpy)."""
    rng = np.random.RandomState(1000 + call)
    words = CAPTION.split() + [str(x) for x in rng.choice(VOCAB[7:], 3)]
    ids = [WordTok._id(w) for w in words][:MAX_NEW * 2]
    tokens = np.zeros((1, len(ids) + 2), np.int32)
    tokens[0, :len(ids)] = ids
    n_seg = TCFG.max_seg_tokens
    valid = np.zeros((1, n_seg), bool)
    if call % 3 != 1:                      # every third call: no [SEG]
        valid[0] = rng.rand(n_seg) > 0.4
        valid[0, call % n_seg] = True
    logits = np.full((1, n_seg, t_sam, 32, 32), -3.0, np.float32)
    for s in range(n_seg):
        for t in range(t_sam):
            y, x = rng.randint(0, 20, 2)
            logits[0, s, t, y:y + rng.randint(3, 12), x:x + rng.randint(3, 12)] = 3.0
    logits += 0.5 * rng.randn(*logits.shape).astype(np.float32)
    return (tokens, np.asarray([len(ids)], np.int32), valid, logits)


class Recorder:
    def __init__(self):
        self.calls, self.build = [], None


class JaxStub:
    """Stands in for videoglamm_tpu.inference.GroundedInference."""
    rec = None

    def __init__(self, model, params, **kw):
        self.model = model
        JaxStub.rec.build = kw

    def __call__(self, f, c, s, input_ids, lens, use_video_branch=False):
        rec = JaxStub.rec
        rec.calls.append(dict(f=np.asarray(f), c=np.asarray(c),
                              s=np.asarray(s), ids=np.asarray(input_ids),
                              lens=np.asarray(lens), vb=use_video_branch))
        return JResult(*map(jnp.asarray, stub_result(len(rec.calls) - 1,
                                                     s.shape[1])))


class TorchStub:
    """Stands in for the GroundedInference that build_inference returns."""

    def __init__(self, rec, cfg, fail=False):
        self.rec, self.fail = rec, fail
        emb = types.SimpleNamespace(weight=torch.zeros(1))
        self.model = types.SimpleNamespace(
            cfg=cfg, llm=types.SimpleNamespace(
                model=types.SimpleNamespace(embed_tokens=emb)))

    def __call__(self, f, c, s, input_ids, lens, use_video_branch=False):
        if self.fail:
            raise RuntimeError("kernel launch failed")
        self.rec.calls.append(dict(f=f.numpy(), c=c.numpy(), s=s.numpy(),
                                   ids=input_ids.numpy(), lens=lens.numpy(),
                                   vb=use_video_branch))
        r = stub_result(len(self.rec.calls) - 1, s.shape[1])
        return TResult(*(torch.from_numpy(x).long() if x.dtype == np.int32
                         else torch.from_numpy(x) for x in r))


def _save(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _frame(rng, h=H, w=W):
    return rng.randint(0, 256, (h, w, 3), np.uint8)


def _write_h5(path, instances, masks_wh):
    import h5py
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with h5py.File(path, "w") as f:
        f["instance"] = np.asarray(instances)
        f["reMask"] = masks_wh


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Every CLI's fixture, written once from seeds."""
    root = tmp_path_factory.mktemp("serve_data")
    rng = np.random.RandomState(0)
    d = {"root": root}
    # an image and a frame directory (chat)
    _save(str(root / "image.png"), _frame(rng))
    for t in range(5):
        _save(str(root / "clip" / f"{t:05d}.jpg"), _frame(rng))
    # GCG: two videos with frames, one without (a data fault)
    for vid, n in (("vidA", 3), ("vidB", 5)):
        for t in range(n):
            _save(str(root / "gcg" / vid / "frames" / f"{t:05d}.jpg"), _frame(rng))
        for o in range(2):
            for t in range(16):
                m = np.zeros((H, W), np.uint8)
                m[rng.randint(0, 15):20, rng.randint(0, 20):30] = 255
                _save(str(root / "gcg" / vid / "gt_masks" / str(o)
                          / f"{t:05d}.png"), m)
    (root / "gcg" / "vidC").mkdir()
    json.dump({"caption": "the red car runs on a road",
               "phrases": ["red car", "a road"]},
              open(root / "gcg" / "vidA" / "gt.json", "w"))
    # MeViS layout: v1 (3 frames, names from the directory, a broken
    # expression), v2 (6 frames, listed names); DAVIS ground truth for both
    for vid, n in (("v1", 3), ("v2", 6)):
        for t in range(n):
            _save(str(root / "mevis" / "JPEGImages" / vid / f"{t:05d}.jpg"),
                  _frame(rng))
            m = np.zeros((H, W), np.uint8)
            m[5:20, 10:30] = 255
            _save(str(root / "davis_gt" / vid / "0" / f"{t:05d}.png"), m)
    meta = {"videos": {
        "v1": {"expressions": {"0": {"exp": "the dog"}, "1": {"text": "x"}}},
        "v2": {"expressions": {"0": {"exp": "a red car"}},
               "frames": [f"{t:05d}" for t in range(6)]}}}
    json.dump(meta, open(root / "mevis" / "meta_expressions.json", "w"))
    # A2D-Sentences: two records and one whose instance is missing
    a2d = root / "a2d"
    for t in range(6):
        _save(str(a2d / "Release" / "clips320H" / "vidA" / f"{t:05d}.jpg"),
              _frame(rng, 14, 18))
    masks_wh = np.zeros((2, 18, 14), np.uint8)
    masks_wh[0, 2:9, 3:11] = 1
    masks_wh[1, 4:12, 3:9] = 1
    _write_h5(str(a2d / "text_annotations" / "a2d_annotation_with_instances"
                  / "vidA" / "00003.h5"), [7, 9], masks_wh)
    json.dump([["a red ball rolling", "vidA", 3, 9],
               ["the dog on the left", "vidA", 3, 7],
               ["nobody", "vidA", 3, 4]], open(a2d / "ann.json", "w"))
    # JHMDB-Sentences: one record
    import scipy.io
    jh = root / "jhmdb"
    rel = "Rename_Images/brush_hair/clipZ"
    for t in range(1, 6):
        _save(str(jh / rel / f"{t:05d}.png"), _frame(rng, 12, 16))
    part = np.zeros((12, 16, 5), np.uint8)
    part[2:7, 3:9, 2] = 1
    os.makedirs(jh / "puppet_mask" / "brush_hair" / "clipZ")
    mat = "puppet_mask/brush_hair/clipZ/puppet_mask.mat"
    scipy.io.savemat(str(jh / mat), {"part_mask": part})
    json.dump([["clipZ", f"./{rel}/00003.png", mat, 5,
                "a person brushing hair"]], open(jh / "ann.json", "w"))
    # grounding: two questions and one without frames
    json.dump([{"vid": "v", "qtype": "declarative", "question": "who walks",
                "frames_dir": str(root / "clip"), "gt_sted": [0, 3],
                "gt_boxes": {"0": [1, 1, 20, 20], "2": [3, 3, 30, 25]}},
               {"vid": "w", "qtype": "interrogative", "question": "what runs",
                "frames_dir": str(root / "gcg" / "vidB" / "frames"),
                "gt_sted": [1, 4], "gt_boxes": {"1": [0, 0, 10, 10]}},
               {"vid": "x", "qtype": "declarative", "question": "none",
                "frames_dir": str(root / "missing"), "gt_sted": [0, 1],
                "gt_boxes": {}}], open(root / "ground.json", "w"))
    # ActivityNet-Entities: two entries and one without frames
    json.dump([{"vid": "v", "frames_dir": str(root / "clip"),
                "phrase": "a person", "segment": [0.2, 0.8], "seg": "0",
                "gt_box": [1, 2, 3, 4], "gt_frame": 2},
               {"vid": "w", "frames_dir": str(root / "gcg" / "vidB" / "frames"),
                "phrase": "the red car"},
               {"vid": "x", "phrase": "nothing"}],
              open(root / "anet.json", "w"))
    return d


def _patch_jax(mp, mod):
    model = types.SimpleNamespace(cfg=CFG)
    mp.setattr(mod, "load_model", lambda args, cfg=None: (model, None))
    mp.setattr(mod, "load_tokenizer", lambda path: WordTok())
    mp.setattr(jinference, "GroundedInference", JaxStub)


def _patch_torch(mp, mod, rec, fail=False):
    mp.setattr(VideoGLaMMConfig, "flagship", staticmethod(lambda: TCFG))
    mp.setattr(mod, "load_model", lambda args, cfg=None: {})
    mp.setattr(mod, "load_tokenizer", lambda path: WordTok())

    def build(cfg, sd, **kw):
        rec.build = kw
        return TorchStub(rec, cfg, fail)
    mp.setattr(mod, "build_inference", build)


def run_both(jmod, tmod, argv_of, tmp_path, capsys, monkeypatch, before=None):
    """Run the JAX and the port CLI with `argv_of(out_dir)` (`before(mp)`
    patches more for each run); returns the two recorders, return values,
    output directories and stdout lines."""
    out = {}
    for name, mod in (("jax", jmod), ("torch", tmod)):
        rec = Recorder()
        with monkeypatch.context() as mp:
            if name == "jax":
                JaxStub.rec = rec
                _patch_jax(mp, mod)
            else:
                _patch_torch(mp, mod, rec)
            if before is not None:
                before(mp)
            capsys.readouterr()
            argv = argv_of(tmp_path / name)
            if name == "jax":       # the JAX CLIs have no --device
                i = argv.index("--device")
                argv = argv[:i] + argv[i + 2:]
            ret = mod.main(argv)
            lines = [ln.replace(str(tmp_path / name), "<out>")
                     for ln in capsys.readouterr().out.splitlines()]
        out[name] = dict(rec=rec, ret=ret, dir=tmp_path / name, lines=lines)
    return out["jax"], out["torch"]


def _tree(d):
    files = {}
    for dp, _, fs in os.walk(d):
        for f in fs:
            p = os.path.join(dp, f)
            rel = os.path.relpath(p, d)
            if f.endswith(".png"):
                files[rel] = np.asarray(Image.open(p))
            else:
                files[rel] = json.load(open(p))
    return files


def assert_same(j, t, n_calls):
    """Same pipeline calls and options, files, printed lines (the port's
    "[done]" line aside)."""
    assert len(j["rec"].calls) == len(t["rec"].calls) == n_calls
    for a, b in zip(j["rec"].calls, t["rec"].calls):
        np.testing.assert_array_equal(a["ids"], b["ids"])
        np.testing.assert_array_equal(a["lens"], b["lens"])
        assert a["vb"] == b["vb"]
        for k in ("f", "c", "s"):
            assert a[k].shape == b[k].shape, k
            np.testing.assert_allclose(b[k], a[k], atol=TOL_STREAMS, rtol=0,
                                       err_msg=k)
    jb, tb = j["rec"].build, t["rec"].build
    assert {k: tb[k] for k in jb} == jb
    assert (tb["device"], tb["dtype"]) == (torch.device("cpu"), torch.float32)
    jt, tt = _tree(j["dir"]), _tree(t["dir"])
    assert sorted(jt) == sorted(tt)
    for k in jt:
        if isinstance(jt[k], np.ndarray):
            np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
        else:
            assert tt[k] == jt[k], k
    done = [ln for ln in t["lines"] if ln.startswith("[done]")]
    assert len(done) == 1
    assert [ln for ln in t["lines"] if not ln.startswith("[done]")] == j["lines"]
    return json.loads(done[0][len("[done] "):])


MODEL = ["--checkpoint", "unused", "--device", "cpu", "--precision", "f32",
         "--max_new_tokens", str(MAX_NEW)]


def test_chat_one_shot_on_an_image(data, tmp_path, capsys, monkeypatch):
    argv = lambda out: MODEL + ["--media", str(data["root"] / "image.png"),
                                "--prompt", "Segment the red car.",
                                "--out_dir", str(out), "--quant", "int8",
                                "--kv_cache", "int8", "--use_sam2_video_branch"]
    j, t = run_both(jchat, tchat, argv, tmp_path, capsys, monkeypatch)
    assert len(t["rec"].calls) == 1 and t["rec"].calls[0]["vb"]
    assert (t["rec"].build["quant"], t["rec"].build["kv_cache"]) == ("int8", "int8")
    assert len(list((tmp_path / "torch").glob("turn0_frame*.png"))) == 16
    assert t["ret"][0]["objects"] >= 1
    # the last printed lines are the same; chat prints no "[done]"
    assert t["lines"] == j["lines"]


def test_chat_interactive_on_a_frame_dir(data, tmp_path, capsys, monkeypatch):
    def answers(mp):
        it = iter(["segment the dog", "and the road", "quit"])
        mp.setattr(builtins, "input", lambda prompt="": next(it))
    argv = lambda out: MODEL + ["--media", str(data["root"] / "clip"),
                                "--out_dir", str(out)]
    j, t = run_both(jchat, tchat, argv, tmp_path, capsys, monkeypatch,
                    before=answers)
    assert len(j["rec"].calls) == len(t["rec"].calls) == 2
    for a, b in zip(j["rec"].calls, t["rec"].calls):
        np.testing.assert_array_equal(a["ids"], b["ids"])
        np.testing.assert_allclose(b["s"], a["s"], atol=TOL_STREAMS, rtol=0)
    jt, tt = _tree(j["dir"]), _tree(t["dir"])
    assert sorted(jt) == sorted(tt) and len(jt) == 32
    for k in jt:
        np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
    assert t["lines"] == j["lines"]
    assert len(t["ret"]) == 2


def test_eval_gcg_infer_then_metrics(data, tmp_path, capsys, monkeypatch):
    argv = lambda out: MODEL + ["--data_root", str(data["root"] / "gcg"),
                                "--save_dir", str(out)]
    j, t = run_both(jgcg, tgcg, argv, tmp_path, capsys, monkeypatch)
    done = assert_same(j, t, 2)
    assert done == {"videos": 2, "resumed": 0, "skipped": 1} == t["ret"]
    assert any(ln.startswith("[skip] vidC") for ln in t["lines"])
    assert (tmp_path / "torch" / "vidA" / "pred_masks" / "0" / "00015.png").exists()
    # resumable: a second run touches nothing
    with monkeypatch.context() as mp:
        _patch_torch(mp, tgcg, Recorder())
        again = tgcg.main(argv(tmp_path / "torch"))
    assert again == {"videos": 0, "resumed": 2, "skipped": 1}
    # the metrics over those outputs, in both packages
    res = {}
    for name, mod in (("jax", jgcg_metrics), ("torch", tgcg_metrics)):
        res[name] = mod.main(["--pred_root", str(tmp_path / name),
                              "--gt_root", str(data["root"] / "gcg")])
    caps = ("meteor", "cider")
    assert {k: v for k, v in res["torch"].items() if k not in caps} == \
        {k: v for k, v in res["jax"].items() if k not in caps}
    for k in caps:
        assert abs(res["torch"][k] - res["jax"][k]) <= 1e-12
    assert res["torch"]["n_videos"] == 2 and res["torch"]["miou"] > 0
    assert "NOT the reference" in res["torch"]["recall_similarity"]


def test_eval_refer_infer_mevis_then_davis(data, tmp_path, capsys, monkeypatch):
    argv = lambda out: MODEL + ["--data_root", str(data["root"] / "mevis"),
                                "--save_dir", str(out), "--max_sam_frames", "4"]
    j, t = run_both(jrefer, trefer, argv, tmp_path, capsys, monkeypatch)
    done = assert_same(j, t, 2)
    assert done == {"expressions": 2, "resumed": 0, "skipped": 1} == t["ret"]
    assert [c["s"].shape[1] for c in t["rec"].calls] == [3, 4]   # the cap
    assert len(list((tmp_path / "torch" / "v2" / "0").glob("*.png"))) == 6
    res = {}
    for name, mod in (("jax", jdavis), ("torch", tdavis)):
        res[name] = mod.main(["--pred_root", str(tmp_path / name),
                              "--gt_root", str(data["root"] / "davis_gt"),
                              "--out", str(tmp_path / f"{name}_jf.json")])
    assert res["torch"] == res["jax"] and res["torch"]["n_sequences"] == 2
    assert json.load(open(tmp_path / "torch_jf.json")) == \
        json.load(open(tmp_path / "jax_jf.json"))


@pytest.mark.parametrize("dataset,n,skips", [("a2d", 2, 1), ("jhmdb", 1, 0)])
def test_eval_refer_infer_sentences(data, tmp_path, capsys, monkeypatch,
                                    dataset, n, skips):
    root = data["root"] / dataset
    argv = lambda out: MODEL + ["--dataset", dataset, "--data_root", str(root),
                                "--ann_file", str(root / "ann.json"),
                                "--save_dir", str(out)]
    j, t = run_both(jrefer, trefer, argv, tmp_path, capsys, monkeypatch)
    done = assert_same(j, t, n)
    assert done == {"records": n, "skipped": skips}
    summary = json.load(open(tmp_path / "jax" / "results.json"))["summary"]
    assert t["ret"] == dict(summary, skipped=done["skipped"])
    assert summary["n"] == n


def test_eval_grounding(data, tmp_path, capsys, monkeypatch):
    argv = lambda out: MODEL + ["--annotations", str(data["root"] / "ground.json"),
                                "--out", str(out / "ground.json")]
    for name in ("jax", "torch"):
        (tmp_path / name).mkdir()
    j, t = run_both(jground, tground, argv, tmp_path, capsys, monkeypatch)
    done = assert_same(j, t, 2)
    assert done == {"questions": 2, "skipped": 1}
    assert t["ret"] == dict(j["ret"], skipped=1)
    assert set(j["ret"]) == {"declarative", "interrogative"}


def test_eval_anet_entities_infer(data, tmp_path, capsys, monkeypatch):
    argv = lambda out: MODEL + ["--annotations", str(data["root"] / "anet.json"),
                                "--save_dir", str(out)]
    j, t = run_both(janet, tanet, argv, tmp_path, capsys, monkeypatch)
    done = assert_same(j, t, 2)
    assert done == t["ret"] == {"phrases": 2, "skipped": 1}
    recs = json.load(open(tmp_path / "torch" / "results.json"))
    assert [r["index"] for r in recs] == [0, 1] and recs[0]["gt_frame"] == 2


def test_eval_anet_entities_official_format(tmp_path, capsys, monkeypatch):
    """The official file pair, converted in-process; without --videos_root
    every entry has no frames, so both CLIs skip them all."""
    ref = {"annotations": {"v_a": {"segments": {"0": {
        "timestamps": [1.0, 4.0], "tokens": ["a", "man", "rides"],
        "process_idx": [[1]], "process_bnd_box": [[1, 2, 30, 40]],
        "frame_ind": [3]}}}}}
    json.dump(ref, open(tmp_path / "ref.json", "w"))
    json.dump({"validation": ["v_a"]}, open(tmp_path / "split.json", "w"))
    argv = lambda out: MODEL + ["--official_reference", str(tmp_path / "ref.json"),
                                "--official_split", str(tmp_path / "split.json"),
                                "--save_dir", str(out)]
    for name in ("jax", "torch"):
        (tmp_path / name).mkdir()
    j, t = run_both(janet, tanet, argv, tmp_path, capsys, monkeypatch)
    done = assert_same(j, t, 0)
    assert done == {"phrases": 0, "skipped": 1}
    assert j["lines"][0] == "[convert] 1 grounded phrases from the official validation split"


CASES = {
    "gcg": (tgcg, lambda d, o: ["--data_root", str(d / "gcg"), "--save_dir", o]),
    "refer": (trefer, lambda d, o: ["--data_root", str(d / "mevis"),
                                    "--save_dir", o]),
    "a2d": (trefer, lambda d, o: ["--dataset", "a2d", "--data_root",
                                  str(d / "a2d"), "--ann_file",
                                  str(d / "a2d" / "ann.json"), "--save_dir", o]),
    "grounding": (tground, lambda d, o: ["--annotations", str(d / "ground.json")]),
    "anet": (tanet, lambda d, o: ["--annotations", str(d / "anet.json"),
                                  "--save_dir", o]),
    "chat": (tchat, lambda d, o: ["--media", str(d / "image.png"), "--prompt",
                                  "hi", "--out_dir", o]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_model_fault_propagates(data, tmp_path, monkeypatch, case):
    """The per-sample skip covers the data only: an exception from the
    model call leaves the port's CLI (the JAX CLIs print "[skip]")."""
    mod, argv = CASES[case]
    _patch_torch(monkeypatch, mod, Recorder(), fail=True)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        mod.main(MODEL + argv(data["root"], str(tmp_path / "out")))


@pytest.mark.parametrize("case", sorted(CASES))
def test_f32_on_the_card_raises_at_start_up(data, tmp_path, monkeypatch, case):
    """f32 serves on the card with quantised weights (K5) and the int8
    cache (K4) too: those flags pass the option checks and the CLI stops at
    the missing card, before the tokenizer or the weights load."""
    if torch.cuda.is_available():
        pytest.skip("the no-card error needs a machine without a card")
    mod, argv = CASES[case]
    called = []
    monkeypatch.setattr(mod, "load_tokenizer", lambda p: called.append(p))
    for flags in (["--quant", "int8"], ["--quant", "int4"],
                  ["--kv_cache", "int8"],
                  ["--quant", "int8", "--kv_cache", "int8"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(["--checkpoint", "x", "--precision", "f32", "--device",
                      "cuda", *flags]
                     + argv(data["root"], str(tmp_path / "out")))
    assert not called


# ------------------------------------------------------------ helpers --

@pytest.mark.parametrize("max_len", [64, 9])
def test_tokenize_prompt_and_decode_generation_equal(max_len):
    tok = WordTok()
    prompt = jchat.ConvGenerator("phi3").apply_for_chat(jgcg.GCG_PROMPT)
    jids, jlens = jcommon.tokenize_prompt(prompt, tok, max_len)
    tids, tlens = tcommon.tokenize_prompt(prompt, tok, max_len)
    assert tids.dtype == torch.int64 and tids.shape == (1, max_len)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))
    tokens = stub_result(0, 1)[0]
    assert tcommon.decode_generation(torch.from_numpy(tokens), tok) == \
        jcommon.decode_generation(tokens, tok)


def _frames(rng, shapes):
    return [rng.randint(0, 256, s + (3,), np.uint8) for s in shapes]


@pytest.mark.parametrize("how", ["uneven", "device_false", "float_frames"])
def test_prepare_vision_inputs_host_path_bit_equal(how):
    rng = np.random.RandomState(3)
    shapes = [(30, 44)] * 5
    if how == "uneven":
        shapes[2] = (32, 40)
    frames = _frames(rng, shapes)
    if how == "float_frames":
        frames = [f.astype(np.float32) for f in frames]
    kw = dict(device=how != "device_false")
    want = jcommon.prepare_vision_inputs(frames, CFG, num_sam_frames=2, **kw)
    got = tcommon.prepare_vision_inputs(frames, TCFG, num_sam_frames=2, **kw)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("sam", ["same", "sampled", "separate"])
def test_prepare_vision_inputs_device_path_within_bound(sam):
    rng = np.random.RandomState(4)
    frames = _frames(rng, [(37, 53)] * 4)
    kw = {"same": {}, "sampled": dict(num_sam_frames=2),
          "separate": dict(sam_frames=_frames(rng, [(37, 53)] * 6))}[sam]
    want = jcommon.prepare_vision_inputs(frames, CFG, **kw)
    got = tcommon.prepare_vision_inputs(frames, TCFG, **kw)
    for g, w in zip(got[:3], want[:3]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL_STREAMS,
                                   rtol=0)
    got16 = tcommon.prepare_vision_inputs(frames, TCFG, dtype=torch.bfloat16, **kw)
    assert all(g.dtype == torch.bfloat16 for g in got16[:3])


# ------------------------------------------------- the tiny port model --

@pytest.fixture(scope="module")
def tiny_sd():
    torch.manual_seed(0)
    model = VideoGLaMM(TCFG)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02)
    return model.state_dict()


E2E = {
    "chat": (tchat, lambda d, o: ["--media", str(d / "image.png"), "--prompt",
                                  "segment the dog", "--out_dir", o, "--quant",
                                  "int8", "--kv_cache", "int8",
                                  "--use_sam2_video_branch"]),
    "gcg": CASES["gcg"],
    "refer": (trefer, lambda d, o: ["--data_root", str(d / "mevis"),
                                    "--save_dir", o, "--max_sam_frames", "4"]),
    "a2d": CASES["a2d"],
    "grounding": CASES["grounding"],
    "anet": CASES["anet"],
}


@pytest.mark.parametrize("case", sorted(E2E))
def test_end_to_end_on_the_tiny_model(data, tmp_path, monkeypatch, tiny_sd,
                                      case):
    mod, argv = E2E[case]
    monkeypatch.setattr(VideoGLaMMConfig, "flagship", staticmethod(lambda: TCFG))
    monkeypatch.setattr(mod, "load_model", lambda args, cfg=None: dict(tiny_sd))
    monkeypatch.setattr(mod, "load_tokenizer", lambda path: WordTok())
    out = str(tmp_path / "out")
    ret = mod.main(["--checkpoint", "unused", "--device", "cpu", "--precision",
                    "f32", "--max_new_tokens", "4"] + argv(data["root"], out))
    if case == "chat":
        assert len(ret) == 1 and len(os.listdir(out)) == 16
    else:
        assert ret["skipped"] == {"gcg": 1, "refer": 1, "a2d": 1,
                                  "grounding": 1, "anet": 1}[case]
    if case == "gcg":
        assert sorted(os.listdir(out)) == ["vidA", "vidB"]
        assert json.load(open(os.path.join(out, "vidA", "res.json")))[
            "gt_phrases"] == ["red car", "a road"]
    if case == "refer":
        assert len(os.listdir(os.path.join(out, "v2", "0"))) == 6
    if case in ("a2d", "grounding"):
        assert all(np.isfinite(v) for v in ret.values()
                   if isinstance(v, float))


# ------------------------------------------------ convert_checkpoint --

@pytest.fixture(scope="module")
def reference_dir(tmp_path_factory, tiny_sd):
    """The seeded tiny model in the reference layout: two HF-export
    shards, a PEFT adapter for two projections, both tower files."""
    d = tmp_path_factory.mktemp("ref")
    hf, iv, clip = reference.to_reference_layout(tiny_sd, TCFG)
    keys = sorted(hf)
    for i, part in enumerate((keys[::2], keys[1::2])):
        torch.save({k: hf[k] for k in part},
                   d / f"pytorch_model-0000{i + 1}-of-00002.bin")
    torch.save({"module": iv}, d / "iv.pt")
    torch.save(clip, d / "clip.bin")
    g = torch.Generator().manual_seed(5)
    lora = {}
    for name in ("model.layers.0.self_attn.qkv_proj",
                 "model.layers.1.mlp.down_proj"):
        w = hf[name + ".weight"]
        lora[f"base_model.model.{name}.lora_A.weight"] = torch.randn(
            2, w.shape[1], generator=g)
        lora[f"base_model.model.{name}.lora_B.weight"] = torch.randn(
            w.shape[0], 2, generator=g)
    torch.save(lora, d / "lora.bin")
    return d, hf, iv, clip, lora


@pytest.mark.parametrize("int8", [False, True])
def test_convert_checkpoint_round_trip(tmp_path, monkeypatch, reference_dir,
                                       int8):
    d, hf, iv, clip, lora = reference_dir
    monkeypatch.setattr(VideoGLaMMConfig, "flagship", staticmethod(lambda: TCFG))
    out = tmp_path / "params"
    tconvert.main(["--hf_export", str(d), "--lora_adapter", str(d / "lora.bin"),
                   "--lora_r", "2", "--lora_alpha", "4",
                   "--internvideo_ckpt", str(d / "iv.pt"),
                   "--clip_ckpt", str(d / "clip.bin"), "--out", str(out)]
                  + (["--int8_llm"] if int8 else []))
    got = tcommon.load_model(types.SimpleNamespace(checkpoint=str(out)), TCFG)
    merged = reference.merge_lora_state_dict(hf, lora, r=2, alpha=4)
    want = reference.from_reference_layout(merged, TCFG, iv, clip)
    assert not torch.equal(want["llm.model.layers.0.self_attn.qkv_proj.weight"],
                           hf["model.layers.0.self_attn.qkv_proj.weight"])
    if int8:
        model = VideoGLaMM(TCFG)
        model.load_weights(want)
        quantize_llm(model.llm, "int8")
        want = model.state_dict()
        assert got["llm.lm_head.weight"].dtype == torch.int8
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    if int8:   # the directory serves through the pre-quantised branch
        from videoglamm_torch.inference.pipeline import build_inference
        gi = build_inference(TCFG, got, device="cpu", dtype=torch.float32,
                             quant="int8", kv_cache="int8", max_new_tokens=2)
        assert gi.model.llm.quant == "int8"
        with pytest.raises(ValueError, match="quantised"):
            build_inference(TCFG, got, device="cpu", dtype=torch.float32)


def test_convert_checkpoint_reads_a_clip_directory(tmp_path, monkeypatch,
                                                   reference_dir):
    d, hf, iv, clip, _ = reference_dir
    monkeypatch.setattr(VideoGLaMMConfig, "flagship", staticmethod(lambda: TCFG))
    cdir = tmp_path / "clip"
    cdir.mkdir()
    keys = sorted(clip)
    torch.save({k: clip[k] for k in keys[:5]}, cdir / "pytorch_model-1.bin")
    torch.save({k: clip[k] for k in keys[5:]}, cdir / "pytorch_model-2.bin")
    sd = tconvert.main(["--hf_export", str(d), "--internvideo_ckpt",
                        str(d / "iv.pt"), "--clip_ckpt", str(cdir), "--out",
                        str(tmp_path / "o")])
    want = reference.from_reference_layout(hf, TCFG, iv, clip)
    assert set(sd) == set(want) and all(torch.equal(sd[k], want[k]) for k in want)
