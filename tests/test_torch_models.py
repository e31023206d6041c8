"""videoglamm_torch modules against the JAX reference models on the CPU.

Each JAX module's parameter tree is shaped with `jax.eval_shape` (no init
compile) and filled from a numpy seed; the port loads the same values
through `videoglamm_torch.io.from_jax`. Inputs come from numpy too. One
jitted JAX apply per model. All in f32; tolerances are f32 controls:
1e-4 on O(1) activations after a few layers of f32 reduction-order noise
(the f32 JAX-vs-torch controls in parity/parity_modules_cpu.json land
between 1e-6 and 4e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoglamm_torch import config as tconfig
from videoglamm_tpu import config as jconfig
from videoglamm_tpu.config import (CLIPVisionConfig, HieraConfig,
                                   InternVideo2Config, Phi3Config, SAM2Config)
from videoglamm_tpu.models.clip_vit import CLIPVisionTower as JCLIP
from videoglamm_tpu.models.internvideo2 import InternVideo2Tower as JIV2
from videoglamm_tpu.models.phi3 import Phi3ForCausalLM as JPhi3
from videoglamm_tpu.models.sam2.fpn import SAM2ImageEncoder as JSAMEnc
from videoglamm_tpu.models.sam2.mask_decoder import MaskDecoder as JMaskDec
from videoglamm_tpu.models.sam2.prompt_encoder import PromptEncoder as JPrompt
from videoglamm_torch.inference.generate import decode_step
from videoglamm_torch.io import from_jax
from videoglamm_torch.models.clip_vit import CLIPVisionTower
from videoglamm_torch.models.internvideo2 import InternVideo2Tower
from videoglamm_torch.models.phi3 import Phi3ForCausalLM, init_kv_cache
from videoglamm_torch.models.sam2.fpn import SAM2ImageEncoder
from videoglamm_torch.models.sam2.mask_decoder import MaskDecoder
from videoglamm_torch.models.sam2.prompt_encoder import PromptEncoder
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-4


def seeded_params(init_fn, seed: int):
    """Shape the parameter tree without compiling, fill it from numpy."""
    shapes = jax.eval_shape(init_fn)
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = s.shape
        if name == "scale":
            v = 1 + 0.1 * rng.randn(*shape)
        elif name == "bias":
            v = 0.02 * rng.randn(*shape)
        elif name == "kernel":
            fan = np.prod(shape[:-1]) if len(shape) == 4 else shape[-2]
            v = rng.randn(*shape) / np.sqrt(fan)
        elif name.endswith("gamma"):
            v = 0.1 + 0.05 * rng.randn(*shape)
        elif name == "pe_gauss":
            v = rng.randn(*shape)
        else:
            v = 0.02 * rng.randn(*shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, ref, tol=TOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("preset", ["flagship", "tiny"])
def test_port_config_presets_match_jax(preset):
    """The port's own configs carry the JAX presets' values."""
    jcfg = getattr(jconfig.VideoGLaMMConfig, preset)()
    assert from_jax.port_config(jcfg) == getattr(tconfig.VideoGLaMMConfig, preset)()


def test_clip_matches_jax():
    cfg = CLIPVisionConfig.tiny()
    x = np.random.RandomState(0).randn(2, 56, 56, 3).astype(np.float32)
    jm = JCLIP(cfg, dtype=jnp.float32)
    params = seeded_params(lambda: jm.init(jax.random.PRNGKey(0), x), 0)
    ref = jax.jit(jm.apply)(params, x)
    tm = CLIPVisionTower(from_jax.port_config(cfg))
    tm.load_state_dict(from_jax.clip_state_dict(params["params"]))
    _close(tm(_t(x)), ref)


@pytest.mark.parametrize("embed_dim,heads", [(32, 2), (144, 2)])
def test_internvideo2_matches_jax(embed_dim, heads):
    """hd 16 takes the BSHD route; hd 72 makes JAX take its head-padded
    branch (internvideo2.py:110-128), which the port reads unpadded."""
    cfg = dataclasses.replace(InternVideo2Config.tiny(), embed_dim=embed_dim,
                              num_heads=heads, num_frames=2)
    x = np.random.RandomState(1).randn(2, 2, 28, 28, 3).astype(np.float32)
    jm = JIV2(cfg, dtype=jnp.float32)
    params = seeded_params(lambda: jm.init(jax.random.PRNGKey(0), x), 1)
    ref = jax.jit(jm.apply)(params, x)
    tm = InternVideo2Tower(from_jax.port_config(cfg))
    tm.load_state_dict(from_jax.internvideo2_state_dict(params["params"]))
    _close(tm(_t(x)), ref)


def test_phi3_prefill_and_cached_decode_match_jax():
    """Port prefill (attention on the fresh k/v, cache write-only) plus 3
    cached decode steps against ONE uncached JAX forward over the whole
    stream, with a ragged batch (rows of 12 and 9 prompt tokens)."""
    cfg = Phi3Config.tiny()
    rng = np.random.RandomState(2)
    B, S, n_dec = 2, 12, 3
    lens = np.array([12, 9])
    prompt = rng.randint(1, 500, size=(B, S))
    forced = rng.randint(1, 500, size=(B, n_dec))
    full = np.zeros((B, S + n_dec), np.int32)
    for b in range(B):
        full[b, :lens[b]] = prompt[b, :lens[b]]
        full[b, lens[b]:lens[b] + n_dec] = forced[b]
    pos = np.broadcast_to(np.arange(S + n_dec), (B, S + n_dec)).astype(np.int32)
    jm = JPhi3(cfg, extra_vocab=1, dtype=jnp.float32)
    args = (full, pos, (lens + n_dec).astype(np.int32))
    params = seeded_params(
        lambda: jm.init(jax.random.PRNGKey(0), *args, method=jm.forward_ids), 2)
    logits, hidden, _ = jax.jit(
        lambda p, *a: jm.apply(p, *a, method=jm.forward_ids))(params, *args)

    tm = Phi3ForCausalLM(from_jax.port_config(cfg), extra_vocab=1)
    tm.load_state_dict(from_jax.phi3_state_dict(params["params"]))
    with torch.no_grad():
        cache = init_kv_cache(cfg, B, S + n_dec + 1, dtype=torch.float32)
        ids = torch.from_numpy(prompt)
        tpos = torch.arange(S)[None].expand(B, S)
        h_pre, cache = tm.forward_hidden(tm.embed(ids), tpos,
                                         torch.from_numpy(lens), cache)
        for b in range(B):
            _close(h_pre[b, :lens[b]], hidden[b, :lens[b]], what="prefill")
        p = torch.from_numpy(lens)
        for i in range(n_dec):
            lg, h = decode_step(tm, cache, torch.from_numpy(forced[:, i]), p + i)
            for b in range(B):
                _close(h[b], hidden[b, lens[b] + i], what=f"decode hidden {i}")
                _close(lg[b], logits[b, lens[b] + i], what=f"decode logits {i}")


_HIERA_GLOBAL = HieraConfig(embed_dim=16, num_heads=1, stages=(1, 3, 1, 1),
                            global_att_blocks=(3,), window_spec=(4, 4, 2, 2))


@pytest.mark.parametrize("hiera", [HieraConfig.tiny(), _HIERA_GLOBAL],
                         ids=["tiny", "global_after_windows"])
def test_hiera_fpn_matches_jax(hiera):
    """Trunk + neck. The second config puts a global block right after a
    hoisted windowed stage, so it attends over the window-major order."""
    cfg = dataclasses.replace(SAM2Config.tiny(), hiera=hiera)
    x = np.random.RandomState(3).randn(2, 128, 128, 3).astype(np.float32)
    jm = JSAMEnc(cfg, dtype=jnp.float32)
    params = seeded_params(lambda: jm.init(jax.random.PRNGKey(0), x), 3)
    feats, pos = jax.jit(jm.apply)(params, x)
    tm = SAM2ImageEncoder(from_jax.port_config(cfg))
    tm.load_state_dict(from_jax.image_encoder_state_dict(params["params"]))
    tfeats, tpos = tm(_t(x))
    assert len(tfeats) == len(feats) == 3
    for i, (a, b) in enumerate(zip(tfeats, feats)):
        _close(a, b, what=f"level {i}")
    for a, b in zip(tpos, pos):
        _close(a, b, 1e-6)


def test_mask_decoder_matches_jax():
    """Text-prompted (no points) SAM-2 decode in f32, single-mask output
    with the dynamic stability fallback and the training-mode selection."""
    cfg = SAM2Config.tiny()
    C, E, B = cfg.d_model, cfg.image_size // 16, 3
    rng = np.random.RandomState(4)
    emb = rng.randn(B, E, E, C).astype(np.float32)
    s0 = rng.randn(B, 4 * E, 4 * E, C // 8).astype(np.float32)
    s1 = rng.randn(B, 2 * E, 2 * E, C // 4).astype(np.float32)
    text = rng.randn(B, 1, C).astype(np.float32)
    jp = JPrompt(cfg)
    # a mask prompt at init makes the mask-prompt convs too, which the
    # port's PromptEncoder holds
    mask = np.zeros((B, 4 * E, 4 * E, 1), np.float32)
    pp = seeded_params(lambda: jp.init(jax.random.PRNGKey(0), text_embeds=text,
                                       masks=mask), 5)
    sparse, dense = jp.apply(pp, text_embeds=text)
    image_pe = jp.apply(pp, method=lambda m: m.get_dense_pe())
    jd = JMaskDec(cfg, dtype=jnp.float32)
    args = (emb, image_pe, sparse, dense)
    dp = seeded_params(lambda: jd.init(jax.random.PRNGKey(0), *args,
                                       multimask_output=False,
                                       high_res_features=(s0, s1)), 6)
    run = jax.jit(lambda p, *a, training: jd.apply(
        p, *a, multimask_output=False, high_res_features=(s0, s1),
        training=training), static_argnames="training")

    tcfg = from_jax.port_config(cfg)
    tp = PromptEncoder(tcfg)
    tp.load_state_dict(from_jax.prompt_encoder_state_dict(pp["params"]))
    td = MaskDecoder(tcfg)
    conv_s = [{"kernel": rng.randn(C, C // r).astype(np.float32),
               "bias": rng.randn(C // r).astype(np.float32)} for r in (8, 4)]
    td.load_state_dict(from_jax.mask_decoder_state_dict(dp["params"], *conv_s))
    tsparse, tdense = tp(_t(text))
    _close(tsparse, sparse, 0)
    _close(tdense, dense, 0)
    # point prompts: every label, padding (-1) included, plus the padding
    # point that the encoder appends (prompt_encoder.py:60-71,:92-99)
    coords = rng.rand(B, 5, 2).astype(np.float32) * cfg.image_size
    labels = np.tile(np.array([[-1, 0, 1, 2, 3]], np.int32), (B, 1))
    psparse, _ = jp.apply(pp, points=(coords, labels), text_embeds=text)
    tpsparse, _ = tp(_t(text), points=(_t(coords), torch.from_numpy(labels)))
    assert tpsparse.shape == (B, 5 + 1 + 1, C)
    _close(tpsparse, psparse, 1e-5, "point prompts")
    _close(tp.get_dense_pe(), image_pe, 1e-5)
    with torch.no_grad():
        for training in (False, True):
            ref = run(dp, *args, training=training)
            got = td(_t(emb), tp.get_dense_pe(), tsparse, tdense,
                     multimask_output=False, high_res_features=(_t(s0), _t(s1)),
                     training=training)
            _close(got.masks, ref.masks, 1e-3, "masks")
            _close(got.iou_pred, ref.iou_pred, TOL, "iou")
            _close(got.object_score_logits, ref.object_score_logits, TOL, "obj")
