"""The SAM-2 video-branch tracking path of videoglamm_torch against the JAX
package on the CPU: axial RoPE, `RoPEAttention`, the memory encoder, the
memory attention, `forward_sam_heads`, `encode_new_memory`, the memory
bank's selection and assembly (forward and reverse), `track_video`,
`VideoGLaMM.track_masks`, and the slice as a whole through
`GroundedInference(..., use_video_branch=True)`.

`SAM2Config.tiny()` / `VideoGLaMMConfig.tiny()` weights are shaped by
`jax.eval_shape` and filled from a numpy seed, then loaded into the port
through `io/from_jax.py`; inputs come from numpy seeds; everything is f32.
The LLM is teacher-forced as in tests/test_torch_slice.py (greedy argmax
on random weights flips under rounding).

Tolerances (f32, set from the f32 controls of
parity/parity_modules_cpu.json, 1e-6 to 4e-5): 1e-5 on single modules with
O(1) outputs; exact equality where nothing is computed (selection, masks);
1e-4 on activations after several modules; 1e-3 on mask logits, whose
magnitudes reach O(10) to O(100) after the hypernetwork product and which
the tracker feeds back through its memory.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import seeded_params
from videoglamm_tpu.config import SAM2Config, VideoGLaMMConfig
from videoglamm_tpu.constants import IMAGE_TOKEN_INDEX
from videoglamm_tpu.models import VideoGLaMM as JVideoGLaMM
from videoglamm_tpu.models.multimodal import splice_visual_prefix as jsplice
from videoglamm_tpu.models.sam2 import video_predictor as jvp
from videoglamm_tpu.models.sam2.memory import MemoryAttention as JMemAttn
from videoglamm_tpu.models.sam2.memory import MemoryEncoder as JMemEnc
from videoglamm_tpu.models.sam2.sam2_base import SAM2Base as JSAM2Base
from videoglamm_tpu.models.sam2.transformer import RoPEAttention as JRoPEAttention
from videoglamm_tpu.ops import rope as jrope
from videoglamm_torch.inference import pipeline as tpipeline
from videoglamm_torch.inference.generate import (GenerateResult, decode_step,
                                                 prefill)
from videoglamm_torch.inference.pipeline import GroundedInference, build_inference
from videoglamm_torch.io import from_jax
from videoglamm_torch.models.sam2 import video_predictor as tvp
from videoglamm_torch.models.sam2.sam2_base import SAM2Base
from videoglamm_torch.models.sam2.transformer import RoPEAttention
from videoglamm_torch.models.videoglamm import TRACKER_MODULES, VideoGLaMM
from videoglamm_torch.ops import rope as trope
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCFG = SAM2Config.tiny()
E = SCFG.low_res_size                 # 8
E2 = E * E
C, MD = SCFG.d_model, SCFG.mem_dim    # 32, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# axial RoPE and RoPEAttention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [16, 40, 7], ids=["grid", "tiled", "short"])
def test_axial_rope_matches_jax(S):
    """Interleaved pairs, f32; a sequence longer than the 4x4 table sees it
    tiled (the k-repeat over memory frames), a shorter one its head."""
    x = np.random.RandomState(0).randn(2, 3, S, 16).astype(np.float32)
    jcos, jsin = jrope.axial_rope_cos_sin(16, 4, 4, 10000.0)
    tcos, tsin = trope.axial_rope_cos_sin(16, 4, 4, 10000.0)
    _close(tcos, jcos, 0)
    _close(tsin, jsin, 0)
    _close(trope.apply_axial_rope(_t(x), tcos, tsin),
           jrope.apply_axial_rope(jnp.asarray(x), jcos, jsin), 1e-6)


@pytest.mark.parametrize("heads", [1, 2])
def test_rope_attention_matches_jax(heads):
    """Cross-attention geometry of the memory attention: keys and values
    come in at kv_in_dim, two memory frames (the table tiled), four
    trailing keys that are not rotated, and a kv_mask with holes."""
    rng = np.random.RandomState(1)
    B, d, kv, n_excl = 2, 32, 16, 4
    Sq, Sk = 16, 2 * 16 + n_excl
    q = rng.randn(B, Sq, d).astype(np.float32)
    k = rng.randn(B, Sk, kv).astype(np.float32)
    v = rng.randn(B, Sk, kv).astype(np.float32)
    mask = rng.rand(B, Sk) > 0.3
    mask[:, 0] = True
    jm = JRoPEAttention(d, heads, feat_sizes=(4, 4), rope_k_repeat=True,
                        kv_in_dim=kv)
    params = seeded_params(lambda: jm.init(jax.random.PRNGKey(0), q, k, v), 1)
    tm = RoPEAttention(d, heads, (4, 4), kv_in_dim=kv)
    sd = {}
    for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
        sd.update(from_jax._linear(params["params"][n], n))
    tm.load_state_dict(sd)
    for excl, km in ((n_excl, mask), (0, None)):
        ref = jm.apply(params, q, k, v, num_k_exclude_rope=excl,
                       kv_mask=None if km is None else jnp.asarray(km))
        got = tm(_t(q), _t(k), _t(v), num_k_exclude_rope=excl,
                 kv_mask=None if km is None else _t(km))
        _close(got, ref, 1e-5, f"exclude {excl}")


# ---------------------------------------------------------------------------
# SAM2Base and its memory modules
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def sam_setup():
    """JAX SAM2Base parameters (initialised through `__call__`, which
    touches every submodule) and the port loaded from them, strictly: the
    port's state dict is whole."""
    jm = JSAM2Base(SCFG, dtype=jnp.float32)
    imgs = np.zeros((1, SCFG.image_size, SCFG.image_size, 3), np.float32)
    params = seeded_params(lambda: jm.init(jax.random.PRNGKey(0), imgs), 2)
    tm = SAM2Base(from_jax.port_config(SCFG)).eval()
    tm.load_state_dict(from_jax.sam2_state_dict(params["params"]))
    return jm, params, tm


def test_state_dict_has_the_reference_checkpoint_names(sam_setup):
    """The tracker's leaves carry the reference checkpoint's names
    (videoglamm_tpu/io/import_torch.py:252-254,305-358 reads these)."""
    _, _, tm = sam_setup
    keys = set(tm.state_dict())
    for k in ("memory_encoder.mask_downsampler.encoder.0.weight",
              "memory_encoder.mask_downsampler.encoder.1.bias",
              "memory_encoder.mask_downsampler.encoder.9.weight",
              "memory_encoder.mask_downsampler.encoder.12.bias",
              "memory_encoder.pix_feat_proj.weight",
              "memory_encoder.fuser.layers.1.dwconv.weight",
              "memory_encoder.fuser.layers.0.weight",
              "memory_encoder.out_proj.bias",
              "memory_attention.layers.0.self_attn.q_proj.weight",
              "memory_attention.layers.0.cross_attn_image.k_proj.weight",
              "memory_attention.layers.0.linear2.bias",
              "memory_attention.norm.weight", "maskmem_tpos_enc", "no_mem_embed",
              "no_mem_pos_enc", "no_obj_ptr", "obj_ptr_proj.layers.2.weight",
              "mask_downsample.weight",
              "sam_prompt_encoder.point_embeddings.3.weight",
              "sam_prompt_encoder.not_a_point_embed.weight",
              "sam_prompt_encoder.mask_downscaling.0.weight",
              "sam_prompt_encoder.mask_downscaling.1.weight",
              "sam_prompt_encoder.mask_downscaling.3.bias",
              "sam_prompt_encoder.mask_downscaling.4.bias",
              "sam_prompt_encoder.mask_downscaling.6.weight"):
        assert k in keys, k
    assert tm.maskmem_tpos_enc.shape == (SCFG.num_maskmem, 1, 1, MD)
    assert tm.no_obj_ptr.shape == (1, C)
    assert tm.memory_attention.layers[0].cross_attn_image.k_proj.in_features == MD


def test_memory_encoder_matches_jax(sam_setup):
    _, params, tm = sam_setup
    rng = np.random.RandomState(3)
    pix = rng.randn(2, E, E, C).astype(np.float32)
    masks = (rng.rand(2, 16 * E, 16 * E, 1) * 20 - 10).astype(np.float32)
    mem, pos = JMemEnc(SCFG).apply({"params": params["params"]["memory_encoder"]},
                                   pix, masks)
    with torch.no_grad():
        tmem, tpos = tm.memory_encoder(_t(pix), _t(masks))
    assert tmem.shape == (2, E, E, MD)
    _close(tmem, mem, 1e-5, "memory")
    _close(tpos, pos, 1e-6, "pos")


def test_memory_attention_matches_jax(sam_setup):
    _, params, tm = sam_setup
    rng = np.random.RandomState(4)
    B, n_ptr = 2, 8
    M = 3 * E2 + n_ptr
    curr = rng.randn(B, E2, C).astype(np.float32)
    cpos = rng.randn(B, E2, C).astype(np.float32)
    memory = rng.randn(B, M, MD).astype(np.float32)
    mpos = rng.randn(B, M, MD).astype(np.float32)
    mask = np.ones((B, M), bool)
    mask[0, E2:2 * E2] = False          # an empty ring slot
    mask[1, -4:] = False                # an object pointer that is not held
    ref = JMemAttn(SCFG).apply({"params": params["params"]["memory_attention"]},
                               curr, cpos, memory, mpos, n_ptr,
                               jnp.asarray(mask))
    with torch.no_grad():
        got = tm.memory_attention(_t(curr), _t(cpos), _t(memory), _t(mpos),
                                  n_ptr, _t(mask))
    _close(got, ref, 1e-5)


def _heads_inputs(seed, B=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, E, E, C).astype(np.float32),
            rng.randn(B, 1, C).astype(np.float32),
            rng.randn(B, 4 * E, 4 * E, C // 8).astype(np.float32),
            rng.randn(B, 2 * E, 2 * E, C // 4).astype(np.float32))


@pytest.mark.parametrize("multimask", [True, False])
def test_forward_sam_heads_matches_jax(sam_setup, multimask):
    """The padding point, the text prompt, the multimask argmax, the
    object-score gating with NO_OBJ_SCORE, `obj_ptr_proj` and the hard
    no-object mixing, field by field."""
    jm, params, tm = sam_setup
    emb, text, s0, s1 = _heads_inputs(5)
    ref = jm.apply(params, emb, text_inputs=text, high_res_features=(s0, s1),
                   multimask_output=multimask,
                   method=lambda m, *a, **k: m.forward_sam_heads(*a, **k))
    with torch.no_grad():
        got = tm.forward_sam_heads(_t(emb), text_inputs=_t(text),
                                   high_res_features=(_t(s0), _t(s1)),
                                   multimask_output=multimask)
    n = 3 if multimask else 1
    assert got.low_res_multimasks.shape == (3, n, 4 * E, 4 * E)
    assert got.high_res_masks.shape == (3, 1, 16 * E, 16 * E)
    for name in got._fields:
        tol = 1e-3 if "masks" in name else 1e-4
        _close(getattr(got, name), getattr(ref, name), tol, name)


def test_forward_sam_heads_gates_absent_objects(sam_setup):
    """With the object-score head's last bias pushed far down every object
    is absent: masks are NO_OBJ_SCORE and the pointer is `no_obj_ptr`, as
    in the JAX module with the same weights."""
    jm, params, tm = sam_setup
    emb, text, s0, s1 = _heads_inputs(6)
    head = params["params"]["sam_mask_decoder"]["obj_score_head"]
    last = sorted(head)[-1]
    shifted = jax.tree_util.tree_map(lambda a: a, params)
    shifted["params"]["sam_mask_decoder"]["obj_score_head"][last]["bias"] = \
        head[last]["bias"] - 1e3
    ref = jm.apply(shifted, emb, text_inputs=text, high_res_features=(s0, s1),
                   multimask_output=True,
                   method=lambda m, *a, **k: m.forward_sam_heads(*a, **k))
    tm2 = SAM2Base(from_jax.port_config(SCFG)).eval()
    tm2.load_state_dict(from_jax.sam2_state_dict(shifted["params"]))
    with torch.no_grad():
        got = tm2.forward_sam_heads(_t(emb), text_inputs=_t(text),
                                    high_res_features=(_t(s0), _t(s1)),
                                    multimask_output=True)
    assert (got.low_res_masks == -1024.0).all()
    assert torch.equal(got.obj_ptr, tm2.no_obj_ptr.detach().expand(3, C))
    _close(got.obj_ptr, ref.obj_ptr, 0)
    _close(got.high_res_masks, ref.high_res_masks, 1e-3)


@pytest.mark.parametrize("binarize", [False, True])
def test_encode_new_memory_matches_jax(sam_setup, binarize):
    jm, params, tm = sam_setup
    rng = np.random.RandomState(7)
    pix = rng.randn(2, E, E, C).astype(np.float32)
    masks = (rng.randn(2, 16 * E, 16 * E, 1) * 4).astype(np.float32)
    score = rng.randn(2, 1).astype(np.float32)
    mem, pos = jm.apply(params, pix, masks, score, binarize=binarize,
                        method=lambda m, *a, **k: m.encode_new_memory(*a, **k))
    with torch.no_grad():
        tmem, tpos = tm.encode_new_memory(_t(pix), _t(masks), _t(score),
                                          binarize=binarize)
    assert tmem.shape == (2, E2, MD) and tpos.shape == (E2, MD)
    _close(tmem, mem, 1e-5, "memory")
    _close(tpos, pos, 1e-6, "pos")


def test_condition_features_matches_jax(sam_setup):
    jm, params, tm = sam_setup
    rng = np.random.RandomState(8)
    B, M = 2, 2 * E2 + 8
    feat = rng.randn(B, E, E, C).astype(np.float32)
    pos = rng.randn(B, E, E, C).astype(np.float32)
    memory = rng.randn(B, M, MD).astype(np.float32)
    mpos = rng.randn(B, M, MD).astype(np.float32)
    mask = rng.rand(B, M) > 0.2
    ref = jm.apply(params, feat, pos, memory, mpos, 8, jnp.asarray(mask),
                   jnp.ones((B,), bool),
                   method=lambda m, *a: m.condition_features(*a))
    with torch.no_grad():
        got = tm.condition_features(_t(feat), _t(pos), _t(memory), _t(mpos), 8,
                                    _t(mask))
    _close(got, ref, 1e-5)


# ---------------------------------------------------------------------------
# the memory bank
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("reverse", [False, True])
def test_wanted_mem_frames_matches_jax(stride, reverse):
    import dataclasses
    cfg = dataclasses.replace(SCFG, memory_temporal_stride_for_eval=stride)
    assert tvp.num_mem_slots(from_jax.port_config(cfg)) == jvp.num_mem_slots(cfg)
    for t in range(0, 23):
        want, rels = tvp.wanted_mem_frames(from_jax.port_config(cfg), t, reverse)
        jwant, jrels = jvp.wanted_mem_frames(cfg, t, reverse)
        np.testing.assert_array_equal(want, np.asarray(jwant), err_msg=f"t={t}")
        np.testing.assert_array_equal(rels, jrels)


def _bank_arrays(seed, cfg, B, held_mem, held_ptr):
    """Ring contents from a seed; `held_*`: the frames the rings hold, each
    keyed into slot frame % size; one slot of row 1 is made stale."""
    rng = np.random.RandomState(seed)
    S = jvp.num_mem_slots(cfg)
    P = cfg.max_obj_ptrs_in_encoder - 1
    mem_frame = np.full((B, S), -1, np.int32)
    for f in held_mem:
        mem_frame[:, f % S] = f
    ptr_frame = np.full((B, P), -1, np.int32)
    for f in held_ptr:
        ptr_frame[:, f % P] = f
    if held_mem:
        mem_frame[1, held_mem[0] % S] -= S            # a stale slot
    return dict(cond_mem=rng.randn(B, E2, MD).astype(np.float32),
                cond_ptr=rng.randn(B, C).astype(np.float32),
                mem_ring=rng.randn(B, S, E2, MD).astype(np.float32),
                mem_frame=mem_frame,
                ptr_ring=rng.randn(B, P, C).astype(np.float32),
                ptr_frame=ptr_frame,
                spatial_pos=rng.randn(E2, MD).astype(np.float32))


@pytest.mark.parametrize("t,num_frames,reverse,held_mem,held_ptr", [
    (1, 8, False, [], []),                                 # nothing tracked yet
    (9, 32, False, list(range(3, 9)), list(range(1, 9))),  # a full window
    (4, 4, False, [1, 2, 3], [1]),                         # short video caps ptrs
    (20, 40, False, list(range(14, 20)), list(range(5, 20))),
    (5, 12, True, list(range(6, 12)), list(range(6, 12))),  # backward
    (9, 12, True, [10, 11], [10, 11]),                     # near the end
])
def test_assemble_memory_matches_jax(sam_setup, t, num_frames, reverse,
                                     held_mem, held_ptr):
    """Memory, positions and mask equal tensor by tensor: the selection is
    a gather and the positions are sums of the same two f32 terms."""
    jm, params, tm = sam_setup
    arrays = _bank_arrays(t, SCFG, 2, held_mem, held_ptr)
    ref = jm.apply(params, method=lambda m: jvp.assemble_memory(
        m, jvp.MemoryBank(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        jnp.asarray(t), num_frames, reverse))
    with torch.no_grad():
        got = tvp.assemble_memory(
            tm, tvp.MemoryBank(**{k: _t(v) for k, v in arrays.items()}), t,
            num_frames, reverse)
    assert got[3] == ref[3]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]), "memory")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]), "pos")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]), "kv_mask")
    if held_mem:      # the stale slot of row 1 is masked, row 0's is not
        blocks = got[2][:, :SCFG.num_maskmem * E2].reshape(2, -1, E2)
        assert not torch.equal(blocks[0], blocks[1])


def test_track_step_writes_the_ring_in_place(sam_setup):
    _, _, tm = sam_setup
    rng = np.random.RandomState(9)
    B = 2
    feats = [_t(rng.randn(B, 4 * E, 4 * E, C // 8).astype(np.float32)),
             _t(rng.randn(B, 2 * E, 2 * E, C // 4).astype(np.float32)),
             _t(rng.randn(B, E, E, C).astype(np.float32))]
    pos = _t(rng.randn(E, E, C).astype(np.float32))
    with torch.no_grad():
        _, bank = tvp.track_init_frame(
            tm, feats, pos, _t(rng.randn(B, 1, C).astype(np.float32)))
        ring, frames = bank.mem_ring, bank.mem_frame
        assert (frames == -1).all() and not ring.any()
        heads, bank2 = tvp.track_step(tm, feats, pos, bank, 1, 4)
    assert bank2.mem_ring is ring and bank2.mem_frame is frames
    S, P = ring.shape[1], bank.ptr_ring.shape[1]
    assert frames[:, 1 % S].tolist() == [1, 1] and ring[:, 1 % S].any()
    assert (frames[:, [s for s in range(S) if s != 1 % S]] == -1).all()
    assert torch.equal(bank.ptr_ring[:, 1 % P], heads.obj_ptr)


# ---------------------------------------------------------------------------
# track_video
# ---------------------------------------------------------------------------
def test_track_video_matches_jax(sam_setup):
    """Four frames, two objects, through the image encoder, the init frame
    and three memory-conditioned steps; the frames' features are shared by
    the objects as `expand`ed views."""
    jm, params, tm = sam_setup
    rng = np.random.RandomState(10)
    T, B = 4, 2
    imgs = rng.randn(T, SCFG.image_size, SCFG.image_size, 3).astype(np.float32)
    text = rng.randn(B, 1, C).astype(np.float32)

    def fn(mdl, imgs_, text_):
        feats, pos = mdl.forward_image(imgs_)
        return jvp.track_video(mdl, feats, pos, text_)

    ref = jax.jit(lambda p, a, b: jm.apply(p, a, b, method=fn))(params, imgs, text)
    with torch.no_grad():
        feats, pos = tm.forward_image(_t(imgs))
        got = tvp.track_video(tm, feats, pos, _t(text))
    E4 = 4 * E
    assert got.low_res_masks.shape == (B, T, E4, E4)
    assert got.ious.shape == (B, T) and got.object_score_logits.shape == (B, T)
    _close(got.object_score_logits, ref.object_score_logits, 1e-4, "scores")
    _close(got.ious, ref.ious, 1e-4, "ious")
    _close(got.low_res_masks, ref.low_res_masks, 1e-3, "masks")


# ---------------------------------------------------------------------------
# the composite: track_masks and the slice as a whole
# ---------------------------------------------------------------------------
CFG = VideoGLaMMConfig.tiny(num_frames=4)
SEG = CFG.seg_token_idx
S_TEXT = 16
FORCED = np.array([[7, SEG, 33, 41, SEG, 9]], np.int32)
T_SAM = 3


def _slice_inputs():
    rng = np.random.RandomState(11)
    T = CFG.num_frames
    frames = rng.randn(1, T, 28, 28, 3).astype(np.float32)
    ctx = rng.randn(1, T, 56, 56, 3).astype(np.float32)
    sam = rng.randn(1, T_SAM, 128, 128, 3).astype(np.float32)
    ids = rng.randint(1, 400, size=(1, S_TEXT)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    seg_only = rng.randn(CFG.max_seg_tokens, CFG.out_dim).astype(np.float32)
    return frames, ctx, sam, ids, seg_only


def _jax_track_slice(mdl, frames, ctx, sam, ids_full, lens_full, seg_only):
    """The JAX pipeline with `use_video_branch=True` (pipeline.py:99-123),
    teacher-forced: one uncached LLM forward over prompt + FORCED, the
    [SEG] extraction of pipeline.py:36-53, `track_masks` on the video, the
    invalid slots set to -1e4; and `track_masks` alone on given prompts."""
    visual = mdl.encode_visual_prefix(frames, ctx)
    sp = jsplice(mdl.llm.embed(ids_full), ids_full, visual, lens_full)
    _, hidden, _ = mdl.llm(sp.embeds, sp.positions, sp.attn_lens)
    n = FORCED.shape[1]
    gen_hidden = jax.lax.dynamic_slice_in_dim(hidden, sp.attn_lens[0] - n, n,
                                              axis=1)
    tokens = jnp.asarray(FORCED)
    pos = jnp.arange(n)[None]
    is_seg = tokens == SEG
    idx = jnp.argsort(jnp.where(is_seg, pos, n + pos), axis=1)[:, :CFG.max_seg_tokens]
    valid = jnp.take_along_axis(is_seg, idx, axis=1)
    h = jnp.take_along_axis(gen_hidden, idx[..., None], axis=1)
    seg_emb = jnp.where(valid[..., None], mdl.text_hidden_fcs(h), 0.0)
    masks = mdl.track_masks(sam[0], seg_emb[0])[None]
    masks = jnp.where(valid[:, :, None, None, None], masks, -1e4)
    return seg_emb, masks, mdl.track_masks(sam[0], seg_only)


def _jax_init(mdl, frames, ctx, sam, *rest):
    """Initialisation: the whole SAM2Base first, as `VideoGLaMM.__call__`
    does when it initialises (videoglamm.py:311-317), because the tracker
    first reaches the memory attention inside its `lax.scan`, where flax
    cannot make parameters."""
    mdl.sam(sam[0, :1], text_inputs=jnp.zeros((1, 1, CFG.sam2.d_model)))
    return _jax_track_slice(mdl, frames, ctx, sam, *rest)


@pytest.fixture(scope="module")
def slice_setup():
    frames, ctx, sam, ids, seg_only = _slice_inputs()
    ids_full = np.concatenate([ids, FORCED], axis=1)
    lens_full = np.array([ids_full.shape[1]], np.int32)
    jm = JVideoGLaMM(CFG, dtype=jnp.float32)
    args = (frames, ctx, sam, ids_full, lens_full, seg_only)
    params = seeded_params(lambda: jm.init(jax.random.PRNGKey(0), *args,
                                           method=_jax_init), 12)
    ref = jax.jit(lambda p, *a: jm.apply(p, *a, method=_jax_track_slice))(
        params, *args)
    ref = [np.asarray(r, np.float32) for r in ref]
    tm = VideoGLaMM(from_jax.port_config(CFG)).eval()
    tm.load_weights(from_jax.videoglamm_state_dict(params, CFG))
    inputs = [torch.from_numpy(a) for a in (frames, ctx, sam, ids, seg_only)]
    return tm, inputs, ref


def test_track_masks_matches_jax(slice_setup):
    tm, (_, _, sam, _, seg_only), (_, _, ref) = slice_setup
    with torch.no_grad():
        got = tm.track_masks(sam[0], seg_only)
    E4 = 4 * CFG.sam2.low_res_size
    assert got.shape == (CFG.max_seg_tokens, T_SAM, E4, E4)
    _close(got, ref, 1e-3)


def test_slice_with_video_branch_matches_jax(slice_setup, monkeypatch):
    """`GroundedInference(...)(..., use_video_branch=True)` with the
    generation teacher-forced: the port's prefill and cached decode steps
    run over FORCED in place of the greedy loop, everything else is the
    entry point's own code."""
    tm, (frames, ctx, sam, ids, _), (seg_emb, masks, _) = slice_setup
    n = FORCED.shape[1]

    def forced_generate(model, visual, input_ids, text_lens, **kw):
        h_pre, cache, sp, _ = prefill(model.llm, visual, input_ids, text_lens, n)
        hiddens = [decode_step(model.llm, cache, torch.from_numpy(FORCED[:, i]),
                               sp.attn_lens + i)[1] for i in range(n)]
        return GenerateResult(tokens=torch.from_numpy(FORCED).long(),
                              hidden=torch.stack(hiddens, dim=1),
                              lengths=torch.tensor([n]), prefill_hidden=h_pre,
                              prefill_len=sp.attn_lens)

    monkeypatch.setattr(tpipeline, "generate_with_prefix", forced_generate)
    seen = {}
    real_extract = tpipeline.extract_seg_from_generation
    monkeypatch.setattr(
        tpipeline, "extract_seg_from_generation",
        lambda m, g: seen.setdefault("seg", real_extract(m, g)))
    timings = {}
    out = GroundedInference(tm, max_new_tokens=n)(
        frames, ctx, sam, ids, torch.tensor([S_TEXT]), timings=timings,
        use_video_branch=True)
    assert set(timings) == {"visual", "generate", "track"}
    assert out.seg_valid[0].tolist() == [True, True, False, False]
    _close(seen["seg"].embeds, seg_emb, 1e-4, "[SEG] embeddings")
    E4 = 4 * CFG.sam2.low_res_size
    assert out.pred_masks.shape == (1, CFG.max_seg_tokens, T_SAM, E4, E4)
    _close(out.pred_masks, masks, 1e-3, "tracked masks")
    assert (out.pred_masks[0, 2:] == -1e4).all()


def test_video_branch_batched_and_raw(slice_setup):
    """A batch of two rows is tracked row by row (the JAX pipeline maps its
    tracker over the rows): each row equals its own batch-1 call; and
    `serve_raw(..., use_video_branch=True)` with num_sam_frames=None sends
    every frame to the tracker."""
    tm, (_, _, sam, _, _), _ = slice_setup
    rng = np.random.RandomState(13)
    sam2 = torch.cat([sam, _t(rng.randn(*sam.shape).astype(np.float32))])
    emb = _t(rng.randn(2, CFG.max_seg_tokens, CFG.out_dim).astype(np.float32))
    with torch.no_grad():
        both = torch.stack([tm.track_masks(f, e) for f, e in zip(sam2, emb)])
        assert torch.equal(both[1], tm.track_masks(sam2[1], emb[1]))
    gi = GroundedInference(tm, max_new_tokens=4)
    raw = torch.from_numpy(rng.randint(0, 256, (2, CFG.num_frames, 48, 85, 3))
                           .astype(np.uint8))
    ids = torch.randint(1, 400, (2, 8))
    ids[:, 2] = IMAGE_TOKEN_INDEX
    timings = {}
    out = gi.serve_raw(raw, ids, torch.tensor([8, 8]), timings=timings,
                       use_video_branch=True)
    E4 = 4 * CFG.sam2.low_res_size
    assert out.pred_masks.shape == (2, CFG.max_seg_tokens, CFG.num_frames, E4, E4)
    assert torch.isfinite(out.pred_masks).all()
    assert set(timings) == {"preprocess", "visual", "generate", "track"}
    assert (out.pred_masks[~out.seg_valid] == -1e4).all()


# ---------------------------------------------------------------------------
# dtypes and loading
# ---------------------------------------------------------------------------
def test_compute_dtype_cast_keeps_the_tracker_f32():
    """`build_inference(dtype=bfloat16)` casts the towers, the LLM and the
    SAM image encoder; the prompt encoder, the mask decoder (but for its
    skip projections), the memory encoder, the memory attention,
    `obj_ptr_proj` and the memory parameters stay f32
    (videoglamm_tpu/models/sam2/sam2_base.py:49-75)."""
    gi = build_inference(from_jax.port_config(CFG), device="cpu",
                         dtype=torch.bfloat16)
    sam = gi.model.visual_model
    f32 = [sam.memory_encoder, sam.memory_attention, sam.obj_ptr_proj,
           sam.sam_prompt_encoder, sam.mask_downsample]
    for mod in f32:
        for n, p in list(mod.named_parameters()) + list(mod.named_buffers()):
            assert p.dtype == torch.float32, n
    for name in ("no_mem_embed", "no_mem_pos_enc", "maskmem_tpos_enc",
                 "no_obj_ptr"):
        assert getattr(sam, name).dtype == torch.float32, name
    for n, p in sam.sam_mask_decoder.named_parameters():
        want = torch.bfloat16 if n.startswith(("conv_s0", "conv_s1")) \
            else torch.float32
        assert p.dtype == want, n
    assert sam.image_encoder.trunk.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert gi.model.llm.model.embed_tokens.weight.dtype == torch.bfloat16


def test_load_weights_takes_a_tree_without_the_tracker(slice_setup):
    """A tracker submodule may be absent as a whole (a flax tree initialised
    through the framewise forward has none of its leaves); a submodule that
    is there in part, or any other missing or unexpected key, raises."""
    tm, _, _ = slice_setup
    full = tm.state_dict()
    pre = tuple(f"visual_model.{m}." for m in TRACKER_MODULES)
    partial = {k: v for k, v in full.items() if not k.startswith(pre)}
    assert len(partial) < len(full)
    fresh = VideoGLaMM(from_jax.port_config(CFG))
    fresh.load_weights(partial)
    assert torch.equal(fresh.visual_model.no_mem_embed, tm.visual_model.no_mem_embed)
    broken = dict(partial)
    some = next(k for k in full if k.startswith(pre[0]))
    broken[some] = full[some]
    with pytest.raises(ValueError):
        VideoGLaMM(from_jax.port_config(CFG)).load_weights(broken)
    with pytest.raises(ValueError):
        VideoGLaMM(from_jax.port_config(CFG)).load_weights(
            {k: v for k, v in full.items() if k != "visual_model.no_obj_ptr"})
    with pytest.raises(ValueError):
        VideoGLaMM(from_jax.port_config(CFG)).load_weights(
            dict(full, **{"visual_model.extra": torch.zeros(1)}))
