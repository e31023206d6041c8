"""Reference-layout checkpoints (`videoglamm_torch/io/reference.py`)
against the JAX package's importers on the CPU, with no reference checkout.

A tiny port VideoGLaMM is seeded in torch (not through `io/from_jax.py`),
written in the reference's three layouts by `to_reference_layout`, and
read by the JAX `compose_videoglamm_params`. The JAX forward on that tree
must give the port's outputs, and `from_jax` must invert the tree to the
port's state dict tensor for tensor. `from_reference_layout` must invert
`to_reference_layout`, drop what the port does not run, and add the [SEG]
row as `import_phi3` does; `load_reference_dir` reads shards and wrapped
tower checkpoints from `tmp_path` (and quantises as `quantize_llm` does);
`merge_lora_state_dict` equals the JAX function; the Llama layout goes
through `import_llama`. (SAM-1 through `import_sam1`:
tests/test_torch_sam1.py.)

Tolerances (f32), each relative to max(1, max |ref|). The JAX forward is
held teacher-forced over one prompt and forced tokens: the visual prefix,
logits, hidden states and [SEG] embeddings to TOL = 4.3e-5 (the f32
Phi-3 control of parity/parity_modules_cpu.json), mask logits to
TOL_MASK = 2.2e-6 (twice the SAM-2 decoder's control, 1.1e-6). Layout
conversions are exact; the appended [SEG] row, a mean taken in another
order by each package, to 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import CFG, FORCED, S_TEXT, _inputs, _jax_slice
from videoglamm_tpu import config as jconfig
from videoglamm_tpu.io import import_torch as jimp
from videoglamm_tpu.models import VideoGLaMM as JVideoGLaMM
from videoglamm_torch.inference.generate import GenerateResult
from videoglamm_torch.inference.pipeline import extract_seg_from_generation
from videoglamm_torch.io import from_jax
from videoglamm_torch.io import reference as ref_io
from videoglamm_torch.models.common import LayerNorm, RMSNorm
from videoglamm_torch.models.phi3 import quantize_llm
from videoglamm_torch.models.videoglamm import VideoGLaMM

TOL = 4.3e-5
TOL_MASK = 2.2e-6
CFG_L = dataclasses.replace(CFG, llm_type="llama3_1", llama=jconfig.LlamaConfig.tiny())


def seed_port(model, seed: int):
    """Seeded weights in torch: norm scales 1 + N(0, 0.1), biases and
    embeddings N(0, 0.02), matrices and convs N(0, 1 / fan_in), layer
    scales 0.1 + N(0, 0.05), the random-Fourier matrix N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    norms = {id(m.weight) for m in model.modules() if isinstance(m, (LayerNorm, RMSNorm))}
    with torch.no_grad():
        for name, p in model.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if id(p) in norms:
                p.copy_(1 + 0.1 * r)
            elif name.endswith("gamma") or name.endswith("fuser.layers.0.weight") \
                    or name.endswith("fuser.layers.1.weight"):
                p.copy_(0.1 + 0.05 * r)
            elif p.dim() >= 2 and "embed" not in name and "token" not in name:
                p.copy_(r / np.sqrt(np.prod(p.shape[1:])))
            else:
                p.copy_(0.02 * r)
        for b in model.buffers():
            if b.is_floating_point():
                b.copy_(torch.randn(b.shape, generator=g))
    return model


def _port(jcfg, seed=11):
    return seed_port(VideoGLaMM(from_jax.port_config(jcfg)).eval(), seed)


def _assert_same(got, want, what=""):
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want))[:8])
    for k in want:
        assert got[k].shape == want[k].shape, (what, k)
        assert torch.equal(got[k].float(), want[k].float()), (what, k)


def _close(got, ref, tol, what):
    ref = np.asarray(ref, np.float32)
    t = tol * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), ref, atol=t, rtol=0,
                               err_msg=what)


@pytest.fixture(scope="module")
def layout():
    """The seeded port model, its state dict, the three reference dicts and
    the JAX tree `compose_videoglamm_params` reads from them."""
    tm = _port(CFG)
    sd = tm.state_dict()
    hf, iv, clip = ref_io.to_reference_layout(sd, tm.cfg)
    tree = jimp.compose_videoglamm_params(hf, CFG, iv, clip)
    return tm, sd, (hf, iv, clip), tree


def test_reference_layout_drives_jax_to_port_outputs(layout):
    tm, _, _, tree = layout
    frames, ctx, sam, ids = _inputs()
    ids_full = np.concatenate([ids, FORCED], axis=1)
    lens_full = np.array([ids_full.shape[1]], np.int32)
    jm = JVideoGLaMM(CFG, dtype=jnp.float32)
    visual, logits, gen_hidden, seg_emb, masks = (
        np.asarray(r, np.float32) for r in jax.jit(
            lambda p, *a: jm.apply(p, *a, method=_jax_slice))(
                {"params": tree}, frames, ctx, sam, ids_full, lens_full))
    f, c, s, i = (torch.from_numpy(a) for a in (frames, ctx, sam, ids_full))
    n = FORCED.shape[1]
    with torch.no_grad():
        tvis = tm.encode_visual_prefix(f, c)
        _close(tvis, visual, TOL, "visual prefix")
        tlogits, hidden, sp = tm.lm_forward(tvis, i, torch.from_numpy(lens_full))
        L = int(sp.attn_lens[0])
        _close(tlogits[:, :L], logits[:, :L], TOL, "teacher-forced logits")
        h = hidden[:, L - n:L]
        _close(h, gen_hidden, TOL, "hidden states of the forced tokens")
        seg = extract_seg_from_generation(tm, GenerateResult(
            tokens=torch.from_numpy(FORCED).long(), hidden=h,
            lengths=torch.tensor([n]), prefill_hidden=None, prefill_len=None))
        _close(seg.embeds, seg_emb, TOL, "[SEG] embeddings")
        feats, _ = tm.encode_sam_features(s)
        _close(tm.decode_masks(feats, seg, torch.arange(1)), masks, TOL_MASK,
               "mask logits")
    assert S_TEXT + n == ids_full.shape[1]


def test_jax_tree_inverts_to_the_port_state_dict(layout):
    """from_jax of the tree that the reference layout imports to is the
    port's state dict, key for key and tensor for tensor."""
    _, sd, _, tree = layout
    _assert_same(from_jax.videoglamm_state_dict(tree, CFG), sd, "from_jax")


def test_from_reference_layout_inverts_to_reference_layout(layout):
    """Key for key, the same tensors; keys the port does not run (tower
    layers past the executed ones, CLIP's post_layernorm and position_ids,
    HF's rotary buffer) are dropped; a bare InternVideo2 layout (no
    `vision_encoder.` prefix) reads the same."""
    tm, sd, (hf, iv, clip), _ = layout
    back = ref_io.from_reference_layout(hf, tm.cfg, iv, clip)
    assert set(back) == set(sd) and all(back[k] is sd[k] for k in sd)
    n_iv = sum(k.endswith("norm1.weight") for k in iv)
    n_clip = sum(k.endswith("layer_norm1.weight") for k in clip)
    iv_more = {**{k[len("vision_encoder."):]: v for k, v in iv.items()},
               f"blocks.{n_iv}.norm1.weight": torch.ones(1),
               "clip_projector.weight": torch.ones(1)}
    clip_more = {**clip, f"vision_model.encoder.layers.{n_clip}.mlp.fc1.weight":
                 torch.ones(1), "vision_model.post_layernorm.weight": torch.ones(1),
                 "vision_model.embeddings.position_ids": torch.zeros(1)}
    hf_more = {**hf, "model.layers.0.self_attn.rotary_emb.inv_freq": torch.ones(1)}
    _assert_same(ref_io.from_reference_layout(hf_more, tm.cfg, iv_more, clip_more),
                 sd, "with keys the port does not run")
    no_towers = ref_io.from_reference_layout(hf, tm.cfg)
    assert set(no_towers) == {k for k in sd if not k.startswith(
        ("vision_tower.", "image_vision_tower."))}


def test_seg_row_appended_as_import_phi3_does(layout):
    """An export without the [SEG] row: the embedding and lm_head get the
    mean row, as `import_phi3(extra_vocab=1)` pads them."""
    tm, sd, (hf, iv, clip), _ = layout
    V = CFG.llm.vocab_size
    base = {**hf, "model.embed_tokens.weight": hf["model.embed_tokens.weight"][:V],
            "lm_head.weight": hf["lm_head.weight"][:V]}
    got = ref_io.from_reference_layout(base, tm.cfg, iv, clip)
    want = jimp.import_phi3(base, CFG.llm, extra_vocab=1)
    # the mean row: f32 sums in another order
    _close(got["llm.model.embed_tokens.weight"], want["embed_tokens"]["embedding"],
           1e-6, "embedding")
    _close(got["llm.lm_head.weight"], np.asarray(want["lm_head"]["kernel"]).T, 1e-6,
           "lm_head")


@pytest.mark.parametrize("quant,wrap", [("none", "model"), ("int8", "module")])
def test_load_reference_dir(layout, tmp_path, quant, wrap):
    """Two shards, an InternVideo2 checkpoint wrapped under `model` /
    `module`, a CLIP checkpoint: the model built from them has the
    original's weights (int8: the codes and scales `quantize_llm` gives
    the original) and its outputs."""
    tm, sd, (hf, iv, clip), _ = layout
    keys = sorted(hf)
    for j, part in enumerate((keys[::2], keys[1::2])):
        torch.save({k: hf[k] for k in part},
                   tmp_path / f"pytorch_model-0000{j + 1}-of-00002.bin")
    torch.save({wrap: iv, "epoch": 3}, tmp_path / "iv.pt")
    torch.save(clip, tmp_path / "clip.bin")
    gi = ref_io.load_reference_dir(str(tmp_path), tm.cfg, str(tmp_path / "iv.pt"),
                                   str(tmp_path / "clip.bin"), quant=quant,
                                   device="cpu", dtype=torch.float32,
                                   max_new_tokens=4)
    want = tm
    if quant == "int8":
        want = _port(CFG)
        quantize_llm(want.llm, "int8")
    _assert_same(gi.model.state_dict(), want.state_dict(), quant)
    frames, ctx, _, ids = _inputs()
    with torch.no_grad():
        outs = [m.lm_forward(m.encode_visual_prefix(torch.from_numpy(frames),
                                                    torch.from_numpy(ctx)),
                             torch.from_numpy(ids), torch.tensor([S_TEXT]))[0]
                for m in (gi.model, want)]
    assert torch.equal(outs[0], outs[1])


def test_load_reference_dir_without_shards_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ref_io.load_reference_dir(str(tmp_path), from_jax.port_config(CFG),
                                  device="cpu")


def test_merge_lora_matches_jax():
    g = torch.Generator().manual_seed(3)
    base = {"model.layers.0.self_attn.q_proj.weight": torch.randn(12, 10, generator=g),
            "model.layers.0.self_attn.v_proj.weight": torch.randn(12, 10, generator=g),
            "model.norm.weight": torch.randn(10, generator=g)}
    lora = {"base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight":
            torch.randn(4, 10, generator=g),
            "base_model.model.model.layers.0.self_attn.q_proj.lora_B.weight":
            torch.randn(12, 4, generator=g),
            "base_model.model.model.layers.0.self_attn.v_proj.lora_A.default.weight":
            torch.randn(4, 10, generator=g),
            "base_model.model.model.layers.0.self_attn.v_proj.lora_B.default.weight":
            torch.randn(12, 4, generator=g),
            "base_model.model.model.layers.9.mlp.lora_A.weight": torch.randn(4, 10)}
    for r, alpha in ((4, 16), (8, 32)):
        got = ref_io.merge_lora_state_dict(base, lora, r, alpha)
        want = jimp.merge_lora_state_dict(base, lora, r, alpha)
        _assert_same(got, want, f"r={r}")
    assert not torch.equal(got["model.layers.0.self_attn.q_proj.weight"],
                           base["model.layers.0.self_attn.q_proj.weight"])


def test_llama_layout_through_import_llama():
    """The Llama-3.1 base: its reference keys import through `import_llama`
    to the tree `from_jax` inverts to the port's LLM; without `lm_head` the
    embedding stands in (tied), as in `import_llama`."""
    tm = _port(CFG_L, seed=12)
    sd = tm.state_dict()
    hf, iv, clip = ref_io.to_reference_layout(sd, tm.cfg)
    tree = jimp.import_llama(hf, CFG_L.llama, extra_vocab=1)
    llm = {k[len("llm."):]: v for k, v in sd.items() if k.startswith("llm.")}
    _assert_same(from_jax.llama_state_dict(tree), llm, "import_llama")
    back = ref_io.from_reference_layout(hf, tm.cfg, iv, clip)
    assert set(back) == set(sd) and all(back[k] is sd[k] for k in sd)
    tied = {k: v for k, v in hf.items() if k != "lm_head.weight"}
    got = ref_io.from_reference_layout(tied, tm.cfg, iv, clip)
    want = jimp.import_llama(tied, CFG_L.llama, extra_vocab=1)
    _close(got["llm.lm_head.weight"], np.asarray(want["lm_head"]["kernel"]).T, 1e-6,
           "tied lm_head")
    assert torch.equal(got["llm.lm_head.weight"], sd["llm.model.embed_tokens.weight"])


def test_to_reference_layout_refuses_a_quantised_llm():
    tm = _port(CFG)
    quantize_llm(tm.llm, "int8")
    with pytest.raises(ValueError, match="quantised"):
        ref_io.to_reference_layout(tm.state_dict(), tm.cfg)
