"""The interactive SAM-2 video predictor of videoglamm_torch against the JAX
package on the CPU: `select_cond_frames` over its tie cases,
`assemble_memory_interactive` with a cap on the cond frames (the
unselected-cond fallback) forward and backward, the non-overlap
constraint, and whole sessions: point, box, mask and text prompts,
forward and reverse propagation, a refinement click on a tracked frame,
`clear_non_cond_mem_around_input`, objects left out of a prompt, and
`to_video_res` with non-overlapping masks (tests/test_interactive.py
drives the JAX sessions alike).

`SAM2Config.tiny()` weights from a numpy seed (the JAX model initialised
through `SAM2Base.__call__`), loaded strictly into the port through
`io/from_jax.py`; frames and prompts from numpy seeds; f32.

Tolerances, as tests/test_torch_tracking.py sets them from the f32
controls of parity/parity_modules_cpu.json: equality for what is selected
(cond frames, the bank's frame indices, kv_mask); 1e-5 on the assembled
memory and positions; 1e-3 on mask logits, which reach O(10) and feed back
through the memory, and on object scores.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import seeded_params
from videoglamm_tpu.config import SAM2Config
from videoglamm_tpu.models.sam2 import interactive as jint
from videoglamm_tpu.models.sam2.sam2_base import SAM2Base as JSAM2Base
from videoglamm_torch.io import from_jax
from videoglamm_torch.models.sam2 import interactive as tint
from videoglamm_torch.models.sam2.sam2_base import SAM2Base
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCFG = SAM2Config.tiny()
S = SCFG.image_size                   # 128
E = SCFG.low_res_size                 # 8
C, MD = SCFG.d_model, SCFG.mem_dim
TOL_LOGITS = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def _setup(cfg, seed):
    jm = JSAM2Base(cfg, dtype=jnp.float32)
    imgs = np.zeros((1, S, S, 3), np.float32)
    params = seeded_params(lambda: jm.init(jax.random.PRNGKey(0), imgs), seed)
    params = {"params": params["params"]}
    tm = SAM2Base(from_jax.port_config(cfg)).eval()
    tm.load_state_dict(from_jax.sam2_state_dict(params["params"]))
    return jm, params, tm


@pytest.fixture(scope="module")
def sam_setup():
    return _setup(SCFG, 41)


# ---------------------------------------------------------------------------
# selection and assembly
# ---------------------------------------------------------------------------
def test_select_cond_frames_matches_jax():
    """The selection of JAX's static select_cond_frames, slot for slot,
    over random layouts and the tie cases (t equally far from two cond
    frames; slots in any order; empty slots between)."""
    rng = random.Random(0)
    layouts = []
    for _ in range(300):
        K = rng.randint(1, 7)
        n = rng.randint(0, K)
        cf = np.full(K, -1, np.int32)
        slots = rng.sample(range(K), n)
        cf[slots] = rng.sample(range(16), n)
        layouts.append((cf, rng.randint(0, 15), rng.choice([-1, 1, 2, 3, 4, 6])))
    ties = [([2, 6, 10, 14], 8, 2), ([2, 6, 10, 14], 8, 3), ([6, 10, 2, 14], 8, 3),
            ([4, 8, -1, 0, 12], 6, 2), ([4, 8, -1, 0, 12], 6, 3),
            ([5, 3, 7, 1, 9], 5, 3), ([5, 3, 7, 1, 9], 5, 4), ([0, 2], 1, 1),
            ([-1, -1, 3], 3, 1), ([1, 3, 5, 7], 0, 2), ([1, 3, 5, 7], 9, 2)]
    layouts += [(np.asarray(cf, np.int32), t, cap) for cf, t, cap in ties]
    jselect = jax.jit(jint.select_cond_frames, static_argnums=2)
    for cf, t, cap in layouts:
        got = tint.select_cond_frames(cf, t, cap)
        ref = np.asarray(jselect(jnp.asarray(cf), t, cap))
        np.testing.assert_array_equal(got, ref, err_msg=f"{cf.tolist()} t={t} cap={cap}")


def _banks(seed, T, K, cond, held, B=2):
    """The same random bank in both packages: cond frames in slots, the
    per-frame bank holding `held`."""
    rng = np.random.RandomState(seed)
    E2 = E * E
    cond_frame = np.full(K, -1, np.int32)
    cond_frame[:len(cond)] = cond
    frame = np.full(T, -1, np.int32)
    frame[held] = held
    arrays = dict(cond_mem=rng.randn(B, K, E2, MD).astype(np.float32),
                  cond_ptr=rng.randn(B, K, C).astype(np.float32),
                  mem_ring=rng.randn(B, T, E2, MD).astype(np.float32),
                  ptr_ring=rng.randn(B, T, C).astype(np.float32),
                  spatial_pos=rng.randn(E2, MD).astype(np.float32))
    jbank = jint.InteractiveBank(cond_frame=jnp.asarray(cond_frame),
                                 mem_frame=jnp.asarray(frame),
                                 ptr_frame=jnp.asarray(frame),
                                 **{k: jnp.asarray(v) for k, v in arrays.items()})
    tbank = tint.InteractiveBank(cond_frame=cond_frame.copy(),
                                 mem_frame=frame.copy(), ptr_frame=frame.copy(),
                                 **{k: _t(v) for k, v in arrays.items()})
    return jbank, tbank


@pytest.mark.parametrize("cap", [-1, 2])
@pytest.mark.parametrize("t,reverse,cond,held", [
    (6, False, [0, 3, 9, 5], [1, 2, 4]),
    (11, False, [0, 10, 4], list(range(1, 10))),
    (4, True, [12, 7, 1, 5], [8, 9, 10, 11]),
    (2, True, [13], list(range(3, 13))),
])
def test_assemble_memory_interactive_matches_jax(sam_setup, cap, t, reverse,
                                                 cond, held):
    """Memory, positions and kv_mask equal block for block; with cap 2 the
    unselected cond frames inside the windows are attended as non-cond."""
    jm, params, tm = sam_setup
    cfg = dataclasses.replace(SCFG, max_cond_frames_in_attn=cap)
    tm.cfg = from_jax.port_config(cfg)
    try:
        T, K = 14, 5
        jbank, tbank = _banks(t + 100 * (cap + 1), T, K, cond, held)
        jm_c = JSAM2Base(cfg, dtype=jnp.float32)
        ref = jm_c.apply(params, method=lambda m: jint.assemble_memory_interactive(
            m, jbank, t, T, reverse))
        got = tint.assemble_memory_interactive(tm, tbank, t, T, reverse)
    finally:
        tm.cfg = from_jax.port_config(SCFG)
    assert got[3] == ref[3]
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    _close(got[0], ref[0], 1e-6, "memory")
    _close(got[1], ref[1], 1e-6, "pos")


def test_non_overlapping_constraints_and_clear_match_jax():
    rng = np.random.RandomState(0)
    m = rng.randn(3, 2, 8, 8).astype(np.float32) * 8
    m[1, 0, 0, 0] = m[0, 0, 0, 0]               # a tie: the first object wins
    for x in (m, m[:1]):
        np.testing.assert_array_equal(
            tint.apply_non_overlapping_constraints(_t(x)).numpy(),
            np.asarray(jint.apply_non_overlapping_constraints(jnp.asarray(x))))
    jbank, tbank = _banks(1, 30, 3, [2], list(range(30)))
    for t in (0, 9, 29):
        jb = jint.clear_non_cond_mem_around(SCFG, jbank, t)
        tint.clear_non_cond_mem_around(SCFG, tbank, t)
        np.testing.assert_array_equal(tbank.mem_frame, np.asarray(jb.mem_frame))
        np.testing.assert_array_equal(tbank.ptr_frame, np.asarray(jb.ptr_frame))
        jbank = jb


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------
def _sessions(sam_setup, T, B, seed, **kw):
    jm, params, tm = sam_setup
    frames = np.random.RandomState(seed).randn(T, S, S, 3).astype(np.float32)
    return (jint.SAM2InteractivePredictor(jm, params, frames, num_objects=B, **kw),
            tint.SAM2InteractivePredictor(tm, _t(frames), num_objects=B, **kw))


def _hold(js, ts, got, ref, what):
    _close(got, ref, TOL_LOGITS, what)
    np.testing.assert_array_equal(ts.bank.cond_frame, np.asarray(js.bank.cond_frame),
                                  err_msg=f"{what}: cond frames")
    np.testing.assert_array_equal(ts.bank.mem_frame, np.asarray(js.bank.mem_frame),
                                  err_msg=f"{what}: memory frames")
    np.testing.assert_array_equal(ts.bank.ptr_frame, np.asarray(js.bank.ptr_frame),
                                  err_msg=f"{what}: pointer frames")
    assert ts.cond_frames == js.cond_frames and ts.pinned == js.pinned, what
    assert ts.tracked == js.tracked, what
    _close(ts.bank.cond_mem, js.bank.cond_mem, TOL_LOGITS, f"{what}: cond memories")
    _close(ts.bank.cond_ptr, js.bank.cond_ptr, TOL_LOGITS, f"{what}: cond pointers")
    held = np.asarray(js.bank.mem_frame) >= 0
    _close(ts.bank.mem_ring[:, held], np.asarray(js.bank.mem_ring)[:, held],
           TOL_LOGITS, f"{what}: ring memories")


def test_session_points_box_mask_forward_reverse_matches_jax(sam_setup):
    """Points on frame 1, a box on frame 4, a mask on frame 6, forward
    propagation from frame 1, reverse from 6, then a refinement click on a
    tracked frame (memory-conditioned, stored non-cond) and a forward
    propagation from it."""
    T, B = 7, 2
    js, ts = _sessions(sam_setup, T, B, 1)
    rng = np.random.RandomState(2)
    coords = (rng.rand(B, 1, 2) * S).astype(np.float32)
    # user-drawn masks: blobs. (The prompted frame's memory binarises the
    # mask's low-res logits resized back up; a pixel-noise mask puts many of
    # them at exactly 0, where rounding decides the binarisation.)
    mask = np.zeros((B, S, S), np.float32)
    mask[0, 10:50, 21:77] = 1.0
    mask[1, 60:119, 5:47] = 1.0
    mask[1, 70:90, 15:30] = 0.0
    steps = [("points", lambda s: s.add_new_points(1, coords, np.ones((B, 1), np.int32))),
             ("box", lambda s: s.add_new_box(4, np.array([[8, 10, 90, 100],
                                                          [40, 20, 120, 60]], np.float32))),
             ("mask", lambda s: s.add_new_mask(6, mask))]
    for what, step in steps:
        _hold(js, ts, step(ts), step(js), what)
    _hold(js, ts, ts.propagate_in_video(), js.propagate_in_video(), "forward")
    _hold(js, ts, ts.propagate_in_video(start_frame_idx=6, reverse=True),
          js.propagate_in_video(start_frame_idx=6, reverse=True), "reverse")
    neg = np.zeros((B, 1), np.int32)
    _hold(js, ts, ts.add_new_points(3, coords, neg), js.add_new_points(3, coords, neg),
          "refinement")
    assert 3 not in ts.cond_frames and 3 in ts.pinned
    _hold(js, ts, ts.propagate_in_video(start_frame_idx=3, max_frame_num_to_track=2),
          js.propagate_in_video(start_frame_idx=3, max_frame_num_to_track=2),
          "forward from the refinement")
    ts.reset_state()
    assert ts.cond_frames == {} and ts.pinned == set()
    with pytest.raises(RuntimeError):
        ts.propagate_in_video()


def test_session_clear_non_cond_and_text_match_jax(sam_setup):
    """clear_non_cond_mem_around_input (one object): a refinement click
    drops the non-cond memories around it, its own included; a later
    propagation clears again on the cond frames it visits. A text prompt
    on a second cond frame."""
    T, B = 5, 1
    js, ts = _sessions(sam_setup, T, B, 4, clear_non_cond_mem_around_input=True)
    rng = np.random.RandomState(5)
    coords = (rng.rand(B, 1, 2) * S).astype(np.float32)
    _hold(js, ts, ts.add_new_points(0, coords, np.ones((B, 1), np.int32)),
          js.add_new_points(0, coords, np.ones((B, 1), np.int32)), "points")
    _hold(js, ts, ts.propagate_in_video(), js.propagate_in_video(), "forward")
    _hold(js, ts, ts.add_new_points(2, coords, np.zeros((B, 1), np.int32)),
          js.add_new_points(2, coords, np.zeros((B, 1), np.int32)), "refinement")
    assert (ts.bank.mem_frame == -1).all()
    text = rng.randn(B, 1, C).astype(np.float32)
    _hold(js, ts, ts.add_new_text(4, text), js.add_new_text(4, jnp.asarray(text)), "text")
    _hold(js, ts, ts.propagate_in_video(start_frame_idx=2),
          js.propagate_in_video(start_frame_idx=2), "forward from 2")


def test_session_active_subset_and_video_res_match_jax(sam_setup):
    """Two of three objects prompted on frame 0 (the third gets the
    placeholder and the empty-mask pointer), the third alone on frame 2,
    propagation both ways, then to_video_res with non-overlapping masks."""
    T, B = 4, 3
    js, ts = _sessions(sam_setup, T, B, 6, non_overlap_masks=True,
                       clear_non_cond_mem_around_input=True,
                       clear_non_cond_mem_for_multi_obj=True)
    rng = np.random.RandomState(7)
    coords = (rng.rand(B, 1, 2) * S).astype(np.float32)
    ones = np.ones((B, 1), np.int32)
    for t, active in ((0, np.array([True, True, False])),
                      (2, np.array([False, False, True]))):
        got = ts.add_new_points(t, coords, ones, active=active)
        ref = js.add_new_points(t, coords, ones, active=active)
        assert (got[~torch.from_numpy(active)] == -1024.0).all()
        _hold(js, ts, got, ref, f"points on {t}")
    _hold(js, ts, ts.propagate_in_video(), js.propagate_in_video(), "forward")
    _hold(js, ts, ts.propagate_in_video(start_frame_idx=3, reverse=True),
          js.propagate_in_video(start_frame_idx=3, reverse=True), "reverse")
    got, ref = ts.to_video_res((37, 53)), np.asarray(js.to_video_res((37, 53)))
    assert tuple(got.shape) == (B, T, 37, 53)
    _close(got, ref, TOL_LOGITS, "video resolution")
    assert ((got > -10.0).sum(dim=0) <= 1).all()


def test_propagation_frames_are_the_frames_jax_runs():
    """The loop visits exactly the frames the JAX scan keeps: inside the
    window, neither cond nor pinned."""
    T = 9
    cond = np.array([2, 6, -1], np.int32)
    pinned = np.zeros(T, bool)
    pinned[[4, 6]] = True
    assert tint.propagation_frames(T, 2, 8, False, cond, pinned) == [3, 5, 7, 8]
    assert tint.propagation_frames(T, 6, 0, True, cond, pinned) == [5, 3, 1, 0]
    assert tint.propagation_frames(T, 3, 5, False, cond, pinned) == [3, 5]


@pytest.mark.parametrize("cond_slot", [1, None])
def test_add_box_prompt_matches_jax(sam_setup, cond_slot):
    """A box as two corner points labelled 2 and 3 on frame 5: a fresh
    cond frame (no-memory features, written into cond slot 1) or a
    refinement (memory-conditioned on a bank holding frames 0 to 4,
    written into slot 5 of the per-frame bank)."""
    jm, params, tm = sam_setup
    T, K, B = 8, 3, 2
    jbank, tbank = _banks(9, T, K, [0], list(range(1, 5)))
    rng = np.random.RandomState(10)
    feats = [rng.randn(B, 4 * E, 4 * E, C // 8).astype(np.float32),
             rng.randn(B, 2 * E, 2 * E, C // 4).astype(np.float32),
             rng.randn(B, E, E, C).astype(np.float32)]
    pos = rng.randn(E, E, C).astype(np.float32)
    boxes = np.array([[8, 10, 90, 100], [40, 20, 120, 60]], np.float32)
    jheads, jb = jax.jit(lambda p, f, ps, bank, bx: jm.apply(
        p, method=lambda m: jint.add_box_prompt(m, f, ps, bank, 5, bx, T,
                                                cond_slot=cond_slot)))(
        params, [jnp.asarray(f) for f in feats], jnp.asarray(pos), jbank,
        jnp.asarray(boxes))
    with torch.no_grad():
        theads, tb = tint.add_box_prompt(tm, [_t(f) for f in feats], _t(pos), tbank,
                                         5, _t(boxes), T, cond_slot=cond_slot)
    _close(theads.low_res_masks, jheads.low_res_masks, TOL_LOGITS, "masks")
    _close(theads.obj_ptr, jheads.obj_ptr, TOL_LOGITS, "pointer")
    for name in ("cond_frame", "mem_frame", "ptr_frame"):
        np.testing.assert_array_equal(getattr(tb, name), np.asarray(getattr(jb, name)))
    for name in ("cond_mem", "cond_ptr", "mem_ring", "ptr_ring", "spatial_pos"):
        _close(getattr(tb, name), getattr(jb, name), TOL_LOGITS, name)
