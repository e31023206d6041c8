"""f32 as a compute dtype of the port on the card, checked on the CPU.

- The route rule: only a model whose compute dtype is f32 takes the
  full-precision routes ("simt_f32" for K1); its build functions mark it
  (`set_exact_f32`) and every attention module passes the mark to the
  attention ops as `exact`. f32 operands in a bf16 model (the SAM-2 memory
  attention) keep the staged route.
- `full_precision`: an f32 model serves and steps with TF32 off, and the
  flags come back after.
- The entry points accept `--precision f32` on the card with every
  `--quant` and `--kv_cache` (K4, K5, K7 and K8 have f32 routes too) and
  stop at the missing card here, before anything loads.
- The f32 routes' plain twins on CPU tensors: K2's f32 GELU is the erf form
  of `_erf_as`, the function the TPU kernel computes in f32.

The kernels themselves run only on the card (tests/test_torch_cuda.py and
chip_smoke.py's f32 phase).
"""
import argparse
import types

import numpy as np
import pytest
import torch

from videoglamm_tpu.ops import fused_block as jfb
from videoglamm_torch.cli import common as cli_common
from videoglamm_torch.cli import train as cli_train
from videoglamm_torch.cli import verify_parity as cli_vp
from videoglamm_torch.config import SAM2Config, VideoGLaMMConfig
from videoglamm_torch.inference import pipeline
from videoglamm_torch.inference.pipeline import (GroundedInference,
                                                 build_inference, build_sam2)
from videoglamm_torch.models import common, internvideo2, phi3
from videoglamm_torch.models.common import full_precision, set_exact_f32
from videoglamm_torch.models.sam2 import hiera, transformer
from videoglamm_torch.ops import attention as A
from videoglamm_torch.ops import fused_block as FB
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = VideoGLaMMConfig.tiny(num_frames=4)
F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("dtype,exact,route", [
    (BF16, False, "wgmma"), (BF16, True, "wgmma"),
    (F32, False, "wgmma_f32"), (F32, True, "simt_f32")])
def test_k1_route_rule(dtype, exact, route):
    assert A.k1_route(dtype, 72, exact) == route


def _marked(model):
    return {type(m).__name__: m.exact_f32 for m in model.modules()
            if hasattr(type(m), "exact_f32")}


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_build_functions_mark_an_f32_model(dtype):
    """build_inference marks every attention module of an f32 model (the
    LLM's layers, the towers, Hiera, the memory attention) and of no
    other; build_sam2 does the same for SAM-2 alone."""
    gi = build_inference(CFG, device="cpu", dtype=dtype, max_new_tokens=2)
    marks = _marked(gi.model)
    assert {"VideoGLaMM", "Phi3DecoderLayer", "MultiHeadAttention",
            "InternVideo2Block", "MultiScaleAttention", "MultiScaleBlock",
            "RoPEAttention"} <= set(marks)
    assert set(marks.values()) == {dtype == F32}
    assert gi.f32 == (dtype == F32)
    sam = build_sam2(SAM2Config.tiny(), device="cpu", dtype=dtype)
    assert set(_marked(sam).values()) == {dtype == F32}


def _spy(monkeypatch, mod, name, seen):
    fn = getattr(mod, name)

    def spy(*a, **kw):
        seen.append((f"{mod.__name__.split('.')[-1]}.{name}",
                     kw.get("exact", False)))
        return fn(*a, **kw)
    monkeypatch.setattr(mod, name, spy)


@pytest.mark.parametrize("exact", [True, False])
def test_attention_modules_pass_the_mark(monkeypatch, exact):
    """Every attention call of a request (framewise and on the video
    branch) carries the model's mark: True in an f32 model, False in a bf16
    one, whose f32 memory attention therefore keeps the staged route."""
    gi = build_inference(CFG, device="cpu", dtype=F32, max_new_tokens=4)
    set_exact_f32(gi.model, exact)
    seen = []
    for mod, names in ((common, ["attention_bshd"]),
                       (internvideo2, ["attention_bshd",
                                       "attention_packed_qkv_padded"]),
                       (phi3, ["dot_product_attention"]),
                       (hiera, ["attention_bshd", "attention_packed_qkv_padded",
                                "dot_product_attention", "fused_window_block"]),
                       (transformer, ["dot_product_attention"])):
        for name in names:
            _spy(monkeypatch, mod, name, seen)
    rng = np.random.RandomState(0)
    raw = torch.from_numpy(rng.randint(0, 256, (1, 4, 48, 64, 3), np.uint8))
    ids = torch.from_numpy(rng.randint(1, 400, (1, 8)))
    ids[0, 2] = -200
    gi.serve_raw(raw, ids, torch.tensor([8]), num_sam_frames=2)
    gi.serve_raw(raw, ids, torch.tensor([8]), use_video_branch=True)
    assert {"common.attention_bshd", "phi3.dot_product_attention",
            "hiera.fused_window_block"} <= {n for n, _ in seen}
    towers_and_llm = [e for n, e in seen
                      if n != "transformer.dot_product_attention"]
    assert set(towers_and_llm) == {exact}
    # SAM-2's transformer module: the memory attention (RoPEAttention)
    # carries the mark; the mask decoder's short attention is plain in both
    # models and passes none
    sam2 = {e for n, e in seen if n == "transformer.dot_product_attention"}
    assert sam2 == ({True, False} if exact else {False})


def test_full_precision_restores_the_flags():
    flags = lambda: (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
    before = flags()
    torch.backends.cudnn.allow_tf32 = True
    try:
        with full_precision(True):
            assert flags() == (False, False)
        assert flags()[0] is True
        with pytest.raises(KeyError):
            with full_precision(True):
                raise KeyError
        assert flags()[0] is True
        with full_precision(False):
            assert flags()[0] is True
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
            = before


@pytest.mark.parametrize("exact", [True, False])
def test_an_f32_model_serves_with_tf32_off(monkeypatch, exact):
    gi = build_inference(CFG, device="cpu", dtype=F32, max_new_tokens=4)
    set_exact_f32(gi.model, exact)
    gi = GroundedInference(gi.model, max_new_tokens=4)
    seen = []
    enc = gi.model.encode_visual_prefix

    def spy(*a):
        seen.append(torch.backends.cudnn.allow_tf32)
        return enc(*a)
    monkeypatch.setattr(gi.model, "encode_visual_prefix", spy)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        rng = np.random.RandomState(1)
        raw = torch.from_numpy(rng.randint(0, 256, (1, 4, 48, 64, 3), np.uint8))
        ids = torch.from_numpy(rng.randint(1, 400, (1, 8)))
        ids[0, 2] = -200
        gi.serve_raw(raw, ids, torch.tensor([8]), num_sam_frames=1)
        assert seen == [not exact] and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = before


def _args(**kw):
    base = dict(device="cuda", precision="f32", quant="none", kv_cache="bf16",
                max_new_tokens=4, draft_k=0)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("kw,raises,match", [
    ({}, RuntimeError, "no CUDA device"),
    ({"precision": "bf16", "quant": "int8", "kv_cache": "int8"}, RuntimeError,
     "no CUDA device"),
    ({"quant": "int8"}, RuntimeError, "no CUDA device"),
    ({"quant": "int4"}, RuntimeError, "no CUDA device"),
    ({"kv_cache": "int8"}, RuntimeError, "no CUDA device"),
])
def test_serving_options_f32_on_the_card(kw, raises, match):
    """--precision f32 --device cuda passes the option checks with every
    --quant and --kv_cache (K5 and K4 have f32 routes) and stops at the
    missing card."""
    if torch.cuda.is_available():
        pytest.skip("the no-card error needs a machine without a card")
    with pytest.raises(raises, match=match):
        cli_common.serving_options(_args(**kw))


def test_serving_options_f32_on_the_cpu_takes_everything():
    opts = cli_common.serving_options(_args(device="cpu", quant="int8",
                                            kv_cache="int8"))
    assert opts["dtype"] == F32 and opts["quant"] == "int8"


@pytest.mark.parametrize("quant,kv,match", [("int8", "bf16", "no CUDA device"),
                                            ("int4", "int8", "no CUDA device"),
                                            ("none", "int8", "no CUDA device")])
def test_build_inference_refuses_f32_with_k4_or_k5_before_building(
        monkeypatch, quant, kv, match):
    """f32 with quantised weights (K5) or the int8 cache (K4) is no longer
    refused: build_inference on CUDA passes its option checks and stops at
    the missing card before anything is built, in f32 as in bf16."""
    if torch.cuda.is_available():
        pytest.skip("the no-card error needs a machine without a card")
    monkeypatch.setattr(pipeline, "VideoGLaMM", None)     # nothing is built
    for dtype in (F32, BF16):
        with pytest.raises(RuntimeError, match=match):
            build_inference(CFG, device="cuda", dtype=dtype, quant=quant,
                            kv_cache=kv)


def test_train_and_verify_parity_take_f32_on_the_card(monkeypatch):
    """cli.train and verify_parity --dtype f32 on CUDA no longer refuse
    f32: they stop at the missing card before reading anything."""
    if torch.cuda.is_available():
        pytest.skip("the no-card error needs a machine without a card")
    monkeypatch.setattr(cli_train, "load_tokenizer", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(["--checkpoint", "unused", "--gcg_json", "unused",
                        "--precision", "f32", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_vp.main(["--checkpoint", "absent", "--device", "cuda", "--dtype",
                     "f32", "--stages", "import,quant"])
    with pytest.raises(NotImplementedError, match="HF oracles"):
        cli_vp.main(["--checkpoint", "absent", "--device", "cuda", "--dtype",
                     "f32", "--stages", "import,modules"])


def test_k8_refuses_f32_with_a_message():
    qkv = torch.zeros(2, 16, 3 * 32)
    with pytest.raises(ValueError, match="K8 takes bf16 only"):
        A.smallwin_attention_kernel(qkv, 2, 16, sm_scale=0.25)


@pytest.mark.parametrize("gelu,res", [(False, False), (True, False),
                                      (False, True), (True, True)])
def test_k2_f32_twin_is_the_tpu_function(gelu, res):
    """K2's f32 route computes `_gemm_plain` in f32: GELU in the
    Abramowitz & Stegun erf form, no rounding between the stages, as the
    JAX block's `_mm_bias_act` does in f32 (fused_block.py:83-105)."""
    import jax.numpy as jnp
    rng = np.random.RandomState(2)
    a, w = rng.randn(40, 48).astype(np.float32), rng.randn(24, 48).astype(np.float32)
    b, r = rng.randn(24).astype(np.float32), rng.randn(40, 24).astype(np.float32)
    got = FB.gemm_epilogue(torch.from_numpy(a), torch.from_numpy(w),
                           torch.from_numpy(b), gelu=gelu,
                           residual=torch.from_numpy(r) if res else None)
    y = jnp.dot(jnp.asarray(a), jnp.asarray(w).T,
                preferred_element_type=jnp.float32) + b
    if gelu:
        y = jfb._gelu(y)
    if res:
        y = r + y
    np.testing.assert_allclose(got.numpy(), np.asarray(y), rtol=1e-5,
                               atol=1e-5)


def test_fused_block_takes_exact_down_to_k1(monkeypatch):
    """`fused_window_block(..., exact=True)` hands `exact` to K1's launch
    inside the chain (the chain on CUDA tensors is stood in for here by
    recording the call)."""
    seen = []
    monkeypatch.setattr(FB, "_fused_block_kernels",
                        lambda x, p, nh, eps, exact: seen.append(exact) or x)
    x = types.SimpleNamespace(shape=(4, 16, 32), is_cuda=True,
                              requires_grad=False)
    p = {k: torch.zeros(1) for k in FB.PKEYS}
    for exact in (True, False):
        FB.fused_window_block(x, p, 2, exact=exact)
    assert seen == [True, False]
