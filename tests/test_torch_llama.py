"""The Llama-3.1 base of videoglamm_torch against the JAX package on the CPU:
the rescaled RoPE table, one decoder layer, the stack with and without a
cache (f32 and int8 KV, GQA with 2 KV heads under 4 query heads), the
self-contained prefill, a K-row cached forward (the speculative verify
step), and the whole GCG slice with `llm_type="llama3_1"` teacher-forced.

Weights are shaped by `jax.eval_shape`, filled from a numpy seed and carried
into the port through `io/from_jax.py` (flax scans the layers: every leaf
has a leading layer axis). Everything runs in f32.

Tolerances (f32): 1e-4 on hidden states and logits, as the Phi-3 tests hold
them (tests/test_torch_models.py, from the f32 controls of
parity/parity_modules_cpu.json); 1e-3 on mask logits; 2e-3 through the int8
cache, where a stored value on a rounding tie may take the neighbouring
code in one of the two frameworks (1/127 of its row's maximum); 2e-6 on the
RoPE table (cos and sin of the same f32 angle in two libraries).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_slice as tslice
from test_torch_models import seeded_params
from videoglamm_tpu import config as jconfig
from videoglamm_tpu.models import VideoGLaMM as JVideoGLaMM
from videoglamm_tpu.models import llama as jllama
from videoglamm_torch import config as tconfig
from videoglamm_torch.inference.generate import (GenerateResult, decode_step,
                                                 prefill)
from videoglamm_torch.inference.pipeline import (build_inference,
                                                 extract_seg_from_generation)
from videoglamm_torch.io import from_jax
from videoglamm_torch.models import llama as tllama
from videoglamm_torch.models.videoglamm import VideoGLaMM
from videoglamm_torch.ops.rope import llama31_rope_cos_sin, rope_cos_sin
from videoglamm_torch.training import build_training
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LCFG = jconfig.LlamaConfig.tiny()
TOL = 1e-4
TOL_KV8 = 2e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol=TOL, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol,
                               err_msg=what)


@pytest.mark.parametrize("head_dim,theta", [(16, 500000.0), (128, 500000.0),
                                            (64, 10000.0)])
def test_llama31_rope_matches_jax(head_dim, theta):
    pos = np.array([[0, 1, 2, 17, 300, 3391, 8191], [5, 6, 7, 8, 9, 10, 4095]],
                   np.int32)
    jc, js = jllama.llama31_rope_cos_sin(jnp.asarray(pos), head_dim, theta)
    tc, ts = llama31_rope_cos_sin(_t(pos), head_dim, theta)
    assert tc.shape == (2, 7, head_dim) and tc.dtype == torch.float32
    _close(tc, jc, 2e-6)
    _close(ts, js, 2e-6)
    # the rescaling slows the long wavelengths only: the fastest frequency
    # is the unscaled table's, the slowest is 8 times slower
    uc, us = rope_cos_sin(_t(pos), head_dim, theta)
    torch.testing.assert_close(ts[..., 0], us[..., 0])
    slow = head_dim // 2 - 1
    if theta == 500000.0 and head_dim == 128:
        ratio = torch.asin(us[0, 1, slow]) / torch.asin(ts[0, 1, slow])
        assert abs(float(ratio) - 8.0) < 1e-3


def _layer_sd(lp):
    """One unscanned LlamaDecoderLayer's flax leaves -> the port layer's."""
    sd = {}
    for nm in ("input_layernorm", "post_attention_layernorm"):
        sd[f"{nm}.weight"] = _t(lp[nm]["scale"])
    for nm in ("q_proj", "k_proj", "v_proj", "o_proj"):
        sd[f"self_attn.{nm}.weight"] = _t(np.asarray(lp[nm]["kernel"]).T)
    for nm in ("gate_proj", "up_proj", "down_proj"):
        sd[f"mlp.{nm}.weight"] = _t(np.asarray(lp[nm]["kernel"]).T)
    return sd


@pytest.mark.parametrize("scaling", [True, False])
def test_llama_layer_matches_jax(scaling):
    rng = np.random.RandomState(3)
    B, S = 2, 9
    x = rng.randn(B, S, LCFG.hidden_size).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    lens = np.array([9, 6], np.int32)
    jl = jllama.LlamaDecoderLayer(LCFG, use_rope_scaling=scaling,
                                  dtype=jnp.float32)
    params = seeded_params(lambda: jl.init(jax.random.PRNGKey(0), x, pos, None,
                                           lens), 3)
    ref, _ = jl.apply(params, x, pos, None, lens)
    tl = tllama.LlamaDecoderLayer(from_jax.port_config(LCFG))
    tl.load_state_dict(_layer_sd(params["params"]))
    table = llama31_rope_cos_sin if scaling else rope_cos_sin
    rope = table(_t(pos), LCFG.head_dim, LCFG.rope_theta)
    got = tl(_t(x), _t(pos), rope, None, _t(lens), 0)
    for b in range(B):
        _close(got[b, :lens[b]], np.asarray(ref)[b, :lens[b]], what=f"row {b}")


def _llama_pair(seed: int):
    rng = np.random.RandomState(seed)
    B, S = 2, 12
    prompt = rng.randint(1, 500, size=(B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jm = jllama.LlamaForCausalLM(LCFG, extra_vocab=1, dtype=jnp.float32)
    params = seeded_params(
        lambda: jm.init(jax.random.PRNGKey(0), prompt, pos,
                        np.full((B,), S, np.int32),
                        method=lambda m, *a: m.forward_ids(*a)), seed)
    tm = tllama.LlamaForCausalLM(from_jax.port_config(LCFG), extra_vocab=1).eval()
    tm.load_state_dict(from_jax.llama_state_dict(params["params"]))
    return jm, params, tm, rng


def test_llama_stack_without_cache_matches_jax():
    jm, params, tm, rng = _llama_pair(4)
    B, S = 2, 12
    ids = rng.randint(1, 500, size=(B, S)).astype(np.int32)
    ids[0, 3] = -200                         # a placeholder id is clamped
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    lens = np.array([12, 7], np.int32)
    logits, hidden, _ = jm.apply(params, ids, pos, lens,
                                 method=lambda m, *a: m.forward_ids(*a))
    with torch.no_grad():
        tl, th, tc = tm.forward_ids(_t(ids).long(), _t(pos), _t(lens))
    assert tc is None and tl.shape == (B, S, LCFG.vocab_size + 1)
    for b in range(B):
        _close(th[b, :lens[b]], np.asarray(hidden)[b, :lens[b]], what="hidden")
        _close(tl[b, :lens[b]], np.asarray(logits)[b, :lens[b]], what="logits")
    # names are the reference checkpoint's
    keys = set(tm.state_dict())
    assert "model.layers.1.self_attn.k_proj.weight" in keys
    assert "model.layers.0.mlp.gate_proj.weight" in keys and "lm_head.weight" in keys


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_llama_prefill_and_cached_decode_match_jax(kv):
    """Port prefill (attention on the fresh k/v, cache write-only), 3 cached
    decode steps and one 3-row cached forward against the JAX module driven
    the same way, with a ragged batch; in f32 also against ONE uncached JAX
    forward over the whole stream."""
    jm, params, tm, rng = _llama_pair(5)
    quant = kv == "int8"
    tol = TOL_KV8 if quant else TOL
    B, S, n_dec, n_blk = 2, 12, 3, 3
    lens = np.array([12, 9], np.int32)
    prompt = rng.randint(1, 500, size=(B, S)).astype(np.int32)
    forced = rng.randint(1, 500, size=(B, n_dec + n_blk)).astype(np.int32)
    max_len = S + n_dec + n_blk + 1

    def drive(mdl):
        cache = jllama.init_llama_kv_cache(LCFG, B, max_len, dtype=jnp.float32,
                                           quant_kv=quant)
        pos = jnp.broadcast_to(jnp.arange(S), (B, S))
        h_pre, cache = mdl.forward_hidden(mdl.embed(prompt), pos, lens, cache)
        outs = []
        p = jnp.asarray(lens)
        for i in range(n_dec):
            lg, h, cache = mdl(mdl.embed(forced[:, i:i + 1]), (p + i)[:, None],
                               p + i + 1, cache)
            outs.append((lg[:, 0], h[:, 0]))
        blk_pos = (p + n_dec)[:, None] + jnp.arange(n_blk)[None]
        lg, h, cache = mdl(mdl.embed(forced[:, n_dec:]), blk_pos,
                           p + n_dec + n_blk, cache)
        return h_pre, outs, lg, h

    h_pre, outs, blk_lg, blk_h = jax.jit(
        lambda p_: jm.apply(p_, method=drive))(params)
    with torch.no_grad():
        cache = tllama.init_llama_kv_cache(LCFG, B, max_len, dtype=torch.float32,
                                           quant_kv=quant)
        assert ("k_scale" in cache) == quant
        assert cache["k"].shape[-1] == (LCFG.num_kv_heads * LCFG.head_dim
                                        if quant else LCFG.head_dim)
        tpos = torch.arange(S)[None].expand(B, S)
        th_pre, cache = tm.forward_hidden(tm.embed(_t(prompt).long()), tpos,
                                          _t(lens), cache)
        for b in range(B):
            _close(th_pre[b, :lens[b]], np.asarray(h_pre)[b, :lens[b]],
                   what="prefill")
        p = _t(lens).long()
        steps = []
        for i in range(n_dec):
            lg, h = decode_step(tm, cache, _t(forced[:, i]).long(), p + i)
            _close(h, outs[i][1], tol, f"decode hidden {i}")
            _close(lg, outs[i][0], tol, f"decode logits {i}")
            steps.append(h)
        blk_pos = (p + n_dec)[:, None] + torch.arange(n_blk)[None]
        lg, h, _ = tm(tm.embed(_t(forced[:, n_dec:]).long()), blk_pos,
                      p + n_dec + n_blk, cache)
        _close(h, blk_h, tol, "3-row cached forward, hidden")
        _close(lg, blk_lg, tol, "3-row cached forward, logits")
    if quant:
        return
    # the f32 cache reproduces one uncached forward over the whole stream
    full = np.zeros((B, S + n_dec + n_blk), np.int32)
    for b in range(B):
        full[b, :lens[b]] = prompt[b, :lens[b]]
        full[b, lens[b]:lens[b] + n_dec + n_blk] = forced[b]
    fpos = np.broadcast_to(np.arange(full.shape[1]), full.shape).astype(np.int32)
    _, hidden, _ = jm.apply(params, full, fpos, lens + n_dec + n_blk,
                            method=lambda m, *a: m.forward_ids(*a))
    for b in range(B):
        for i in range(n_dec):
            _close(steps[i][b], np.asarray(hidden)[b, lens[b] + i],
                   what=f"uncached, step {i}")
        _close(h[b], np.asarray(hidden)[b, lens[b] + n_dec:lens[b] + n_dec + n_blk],
               what="uncached, block")


def test_llama_remat_gives_the_same_gradient():
    _, _, tm, rng = _llama_pair(6)
    ids = _t(rng.randint(1, 500, size=(1, 8))).long()
    pos = torch.arange(8)[None]
    lens = torch.tensor([8])

    def grad(remat):
        tm.model.remat = remat
        tm.zero_grad()
        logits, _, _ = tm.forward_ids(ids, pos, lens)
        logits.square().mean().backward()
        return tm.model.layers[0].self_attn.q_proj.weight.grad.clone()

    a, b = grad(False), grad(True)
    tm.model.remat = False
    assert a.abs().max() > 0
    torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-5)


# ---------------------------------------------------------------------------
# the composite with llm_type="llama3_1"
# ---------------------------------------------------------------------------
CFG_L = dataclasses.replace(tslice.CFG, llm_type="llama3_1", llama=LCFG)


def test_port_config_carries_llama():
    tcfg = from_jax.port_config(CFG_L)
    assert tcfg == dataclasses.replace(
        tconfig.VideoGLaMMConfig.tiny(num_frames=4), llm_type="llama3_1",
        llama=tconfig.LlamaConfig.tiny())
    assert tcfg.llm_config is tcfg.llama
    assert from_jax.port_config(jconfig.LlamaConfig.llama3_1_8b()) \
        == tconfig.LlamaConfig.llama3_1_8b()
    flagship = from_jax.port_config(jconfig.VideoGLaMMConfig.flagship())
    assert flagship.llama.hidden_size == 4096 and flagship.llama.num_kv_heads == 8


@pytest.fixture(scope="module")
def llama_slice():
    frames, ctx, sam, ids = tslice._inputs()
    ids_full = np.concatenate([ids, tslice.FORCED], axis=1)
    lens_full = np.array([ids_full.shape[1]], np.int32)
    jm = JVideoGLaMM(CFG_L, dtype=jnp.float32)
    args = (frames, ctx, sam, ids_full, lens_full)
    params = seeded_params(lambda: jm.init(jax.random.PRNGKey(0), *args,
                                           method=tslice._jax_slice), 8)
    ref = jax.jit(lambda p, *a: jm.apply(p, *a, method=tslice._jax_slice))(
        params, *args)
    ref = [np.asarray(r, np.float32) for r in ref]
    tm = VideoGLaMM(from_jax.port_config(CFG_L)).eval()
    tm.load_weights(from_jax.videoglamm_state_dict(params, CFG_L))
    inputs = [torch.from_numpy(a) for a in (frames, ctx, sam, ids)]
    return tm, inputs, ref


def test_llama_slice_teacher_forced_matches_jax(llama_slice):
    tm, (frames, ctx, sam, ids), (visual, logits, gen_hidden, seg_emb,
                                  masks) = llama_slice
    assert isinstance(tm.llm, tllama.LlamaForCausalLM)
    assert tm.mm_projector[-1].out_features == LCFG.hidden_size
    n = tslice.FORCED.shape[1]
    with torch.no_grad():
        tvis = tm.encode_visual_prefix(frames, ctx)
        _close(tvis, visual, TOL, "visual prefix")
        h_pre, cache, sp, last_logits = prefill(
            tm.llm, tvis, ids, torch.tensor([tslice.S_TEXT]), n)
        s_pre = int(sp.attn_lens[0])
        _close(last_logits[0], logits[0, s_pre - 1], TOL, "prefill logits")
        hiddens = []
        for i in range(n):
            lg, h = decode_step(tm.llm, cache,
                                torch.from_numpy(tslice.FORCED[:, i]),
                                sp.attn_lens + i)
            _close(h[0], gen_hidden[0, i], TOL, f"step {i} hidden")
            _close(lg[0], logits[0, s_pre + i], TOL, f"step {i} logits")
            hiddens.append(h)
        gen = GenerateResult(tokens=torch.from_numpy(tslice.FORCED).long(),
                             hidden=torch.stack(hiddens, dim=1),
                             lengths=torch.tensor([n]), prefill_hidden=h_pre,
                             prefill_len=sp.attn_lens)
        seg = extract_seg_from_generation(tm, gen)
        assert seg.valid[0].tolist() == [True, True, False, False]
        _close(seg.embeds, seg_emb, TOL, "[SEG] embeddings")
        feats, _ = tm.encode_sam_features(sam)
        tmasks = tm.decode_masks(feats, seg, torch.arange(1))
        _close(tmasks, masks, 1e-3, "mask logits")


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_llama_refuses_quantised_weights(quant):
    cfg = from_jax.port_config(CFG_L)
    with pytest.raises(ValueError, match="no quantised projections"):
        build_inference(cfg, device="cpu", dtype=torch.float32, quant=quant)
    with pytest.raises(ValueError, match="llama3_1"):
        VideoGLaMM(cfg, **{f"quant_llm_{quant}": True})


def test_llama_refuses_training_and_unknown_types():
    cfg = from_jax.port_config(CFG_L)
    with pytest.raises(ValueError, match="no LoRA"):
        build_training(cfg, tconfig.TrainConfig(), device="cpu",
                       dtype=torch.float32)
    with pytest.raises(ValueError, match="llm_type"):
        VideoGLaMM(dataclasses.replace(cfg, llm_type="gpt2"))
