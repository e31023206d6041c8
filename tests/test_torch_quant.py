"""The quantised ops of videoglamm_torch against the JAX package on the CPU:
the four quantisers, the int8-cache decode attention (K4's function), the
int8 and int4 dequantising products on both routing branches (K5's
functions), the int8 KV cache, and the quantised Phi-3.

Inputs come from numpy seeds and everything runs in f32. On the CPU the
port's wrappers take the plain twins of K4 and K5, which is what these
tests hold to the JAX functions; the kernels themselves are held to the
twins on the card (tests/test_torch_cuda.py, chip_smoke.py).

The JAX side runs as its own tests run it on the CPU: through the XLA
paths in this process, and through the Pallas kernels in interpret mode
(`decode_attention_quant(interpret=True)`, `_dequant4_matvec_pallas` and
`_dequant_matmul_pallas` under `pltpu.force_tpu_interpret_mode()`). The
interpret-mode runs happen in ONE child process with a time limit, fed by
an .npz of the same inputs, so that an interpret-mode deadlock can fail
these comparisons but cannot hang the suite.

Tolerances: integer codes must be equal; scales agree to 1 ulp (XLA may
turn a division by a constant into another instruction sequence); f32
products and attention agree to 2e-5 (summation order), as the JAX tests of
the same kernels state (tests/test_ops.py:84-152).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import seeded_params
from videoglamm_tpu.config import Phi3Config
from videoglamm_tpu.io.import_torch import (quantize_phi3_params,
                                            quantize_phi3_params_int4)
from videoglamm_tpu.models import kvcache as jkv
from videoglamm_tpu.models.phi3 import Phi3ForCausalLM as JPhi3
from videoglamm_tpu.ops import quant as jq
from videoglamm_tpu.ops.attention import _attention_xla
from videoglamm_torch.io import from_jax
from videoglamm_torch.models import kvcache as tkv
from videoglamm_torch.models.common import QDense, QDense4
from videoglamm_torch.models.phi3 import Phi3ForCausalLM, quantize_llm
from videoglamm_torch.ops import attention as tattn
from videoglamm_torch.ops import quant as tq
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _ulp_equal(got, ref, what=""):
    np.testing.assert_array_max_ulp(np.asarray(got, np.float32),
                                    np.asarray(ref, np.float32), maxulp=1)


def _close(got, ref, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# quantisers: codes equal, scales to 1 ulp
# ---------------------------------------------------------------------------
def _weight_case(case: str, K: int, N: int, top: float):
    """[K, N] f32. "zero": an all-zero output channel; "tie": a channel
    whose amax is `top`, so its scale is exactly 1 and x.5 entries are
    ties for round-half-even."""
    rng = np.random.RandomState({"random": 0, "zero": 1, "tie": 2}[case])
    w = rng.randn(K, N).astype(np.float32) * 0.1
    if case == "zero":
        w[:, 3] = 0.0
    if case == "tie":
        w[:, 5] = 0.0
        w[:8, 5] = [top, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
    return w


@pytest.mark.parametrize("case", ["random", "zero", "tie"])
def test_quantize_int8_matches_jax(case):
    w = _weight_case(case, 64, 24, 127.0)
    jq8, js = jq.quantize_int8(jnp.asarray(w))
    q, s = tq.quantize_int8(_t(w.T))
    assert q.shape == (24, 64) and q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy().T, np.asarray(jq8))
    _ulp_equal(s.numpy(), js)
    if case == "zero":
        assert s[3] == 1.0 and not q[3].any()
    if case == "tie":
        assert q[5, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]


@pytest.mark.parametrize("case", ["random", "zero", "tie"])
def test_quantize_rows_matches_jax(case):
    x = _weight_case(case, 48, 16, 127.0).T.copy()      # rows are tokens
    jq8, js = jq.quantize_rows(jnp.asarray(x))
    q, s = tq.quantize_rows(_t(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq8))
    _ulp_equal(s.numpy(), js)
    if case == "zero":                                    # the 1e-6 floor
        assert s[3, 0] == np.float32(1e-6) * np.float32(1.0 / 127.0)


@pytest.mark.parametrize("case", ["random", "zero", "tie"])
def test_quantize_int4_matches_jax(case):
    w = _weight_case(case, 256, 193, 7.0)
    jp, js = jq.quantize_int4(jnp.asarray(w), group=128)
    p, s = tq.quantize_int4(_t(w.T), group=128)
    assert p.shape == (193, 128) and s.shape == (193, 2)
    np.testing.assert_array_equal(p.numpy().T, np.asarray(jp))
    _ulp_equal(s.numpy().T, js)
    lo, hi = tq._unpack4(p)
    jlo, jhi = jq._unpack4(jp)
    np.testing.assert_array_equal(lo.numpy().T, np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy().T, np.asarray(jhi))
    _close(tq._dequant4_weights(p, s, 128, torch.float32).numpy().T,
           jq._dequant4_weights(jp, js, 128, jnp.float32), 0.0)


@pytest.mark.parametrize("case", ["random", "zero", "tie"])
def test_kv_quantize_matches_jax(case):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 5, 16).astype(np.float32)
    if case == "zero":
        x[0, 1, 2] = 0.0
    if case == "tie":
        x[1, 2, 4] = 0.0
        x[1, 2, 4, :6] = [127.0, 0.5, 1.5, -2.5, 3.5, -0.5]
    jq8, js = jkv._quantize(jnp.asarray(x))
    q, s = tkv._quantize(_t(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq8))
    _ulp_equal(s.numpy(), js)
    if case == "zero":
        assert s[0, 1, 2] == 1.0
    if case == "tie":
        assert q[1, 2, 4, :6].tolist() == [127, 0, 2, -2, 4, 0]


# ---------------------------------------------------------------------------
# the Pallas kernels in interpret mode, in one child process
# ---------------------------------------------------------------------------
ATTN_CASES = {"mha_ragged": (2, 4, 4, 300, 96),      # test_ops.py:93-94
              "gqa4": (1, 8, 2, 700, 64),
              "gqa2": (2, 8, 4, 160, 96)}
STACKED = (3, 2, 8, 4, 300, 96)                      # test_ops.py:130
GEMV_M = (1, 3, 64)
GK, GN = 256, 193                                    # odd N on purpose


def _attn_inputs(name):
    B, Hq, Hkv, C, hd = ATTN_CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    q = rng.randn(B, Hq, 1, hd).astype(np.float32)
    kf = rng.randn(B, Hkv, C, hd).astype(np.float32)
    vf = rng.randn(B, Hkv, C, hd).astype(np.float32)
    kv_lens = rng.randint(C // 2, C + 1, size=(B,)).astype(np.int32)
    return q, kf, vf, kv_lens


def _stacked_inputs():
    L, B, Hq, Hkv, C, hd = STACKED
    rng = np.random.RandomState(11)
    q = rng.randn(B, Hq, 1, hd).astype(np.float32)
    kf = rng.randn(L, B, Hkv, C, hd).astype(np.float32)
    vf = rng.randn(L, B, Hkv, C, hd).astype(np.float32)
    kv_lens = rng.randint(C // 2, C + 1, size=(B,)).astype(np.int32)
    return q, kf, vf, kv_lens


def _flat(q8):
    """[..., Hkv, C, hd] int8 -> token-major flat [..., C, Hkv*hd]."""
    q8 = np.asarray(q8)
    sw = np.swapaxes(q8, -3, -2)
    return np.ascontiguousarray(sw.reshape(*sw.shape[:-2], -1))


def _gemv_inputs():
    rng = np.random.RandomState(5)
    w = rng.randn(GK, GN).astype(np.float32) * 0.1
    xs = {M: rng.randn(M, GK).astype(np.float32) for M in GEMV_M}
    return w, xs


_CHILD = r"""
import sys
import numpy as np
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from videoglamm_tpu.ops.attention import decode_attention_quant
from videoglamm_tpu.ops.quant import (_dequant4_matvec_pallas,
                                      _dequant_matmul_pallas)
d = np.load(sys.argv[1])
out = {}
for key in d.files:
    if not key.endswith(".q"):
        continue
    n = key[:-2]
    layer = int(d[n + ".layer"]) if n + ".layer" in d.files else None
    y = decode_attention_quant(
        jnp.asarray(d[n + ".q"]), jnp.asarray(d[n + ".k"]),
        jnp.asarray(d[n + ".v"]), jnp.asarray(d[n + ".ks"]),
        jnp.asarray(d[n + ".vs"]), jnp.asarray(d[n + ".kv_lens"]),
        None if layer is None else jnp.int32(layer),
        sm_scale=float(d[n + ".q"].shape[-1]) ** -0.5, block_k=128,
        interpret=True)
    out[n] = np.asarray(y)
with pltpu.force_tpu_interpret_mode():
    for key in d.files:
        if key.startswith("x."):
            m = key[2:]
            x = jnp.asarray(d[key])
            out["int8." + m] = np.asarray(_dequant_matmul_pallas(
                x, jnp.asarray(d["w8"]), jnp.asarray(d["w8s"])))
            out["int4." + m] = np.asarray(_dequant4_matvec_pallas(
                x, jnp.asarray(d["w4"]), jnp.asarray(d["w4s"]), group=128))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def pallas_refs(tmp_path_factory):
    """Outputs of the JAX package's Pallas kernels (interpret mode) on the
    inputs of this file, computed in a child process with a time limit."""
    tmp = tmp_path_factory.mktemp("pallas_refs")
    feed = {}
    for name in ATTN_CASES:
        q, kf, vf, kv_lens = _attn_inputs(name)
        kq, ks = jkv._quantize(jnp.asarray(kf))
        vq, vs = jkv._quantize(jnp.asarray(vf))
        feed.update({f"{name}.q": q, f"{name}.k": _flat(kq),
                     f"{name}.v": _flat(vq), f"{name}.ks": np.asarray(ks),
                     f"{name}.vs": np.asarray(vs),
                     f"{name}.kv_lens": kv_lens})
    q, kf, vf, kv_lens = _stacked_inputs()
    kq, ks = jkv._quantize(jnp.asarray(kf))
    vq, vs = jkv._quantize(jnp.asarray(vf))
    for layer in range(STACKED[0]):
        n = f"stacked{layer}"
        feed.update({f"{n}.q": q, f"{n}.k": _flat(kq), f"{n}.v": _flat(vq),
                     f"{n}.ks": np.asarray(ks), f"{n}.vs": np.asarray(vs),
                     f"{n}.kv_lens": kv_lens, f"{n}.layer": np.int32(layer)})
    w, xs = _gemv_inputs()
    w8, w8s = jq.quantize_int8(jnp.asarray(w))
    w4, w4s = jq.quantize_int4(jnp.asarray(w), group=128)
    feed.update(w8=np.asarray(w8), w8s=np.asarray(w8s), w4=np.asarray(w4),
                w4s=np.asarray(w4s))
    feed.update({f"x.{M}": x for M, x in xs.items()})
    np.savez(tmp / "in.npz", **feed)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, JAX_PLATFORMS="cpu")
    try:
        res = subprocess.run(
            [sys.executable, "-c", _CHILD, str(tmp / "in.npz"),
             str(tmp / "out.npz")], capture_output=True, text=True, cwd=root,
            env=env, timeout=600)
    except subprocess.TimeoutExpired:
        pytest.fail("the Pallas interpret-mode child did not return in 600 s")
    assert res.returncode == 0, res.stderr[-2000:]
    return dict(np.load(tmp / "out.npz"))


# ---------------------------------------------------------------------------
# K4's function
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_decode_attention_matches_jax(name, pallas_refs):
    """MHA, GQA G = 4 and G = 2, ragged C, per-row kv_lens: the port's entry
    (the twin, on the CPU) against `_attention_xla` and against the Pallas
    kernel in interpret mode, 2e-5."""
    B, Hq, Hkv, C, hd = ATTN_CASES[name]
    q, kf, vf, kv_lens = _attn_inputs(name)
    kq, ks = jkv._quantize(jnp.asarray(kf))
    vq, vs = jkv._quantize(jnp.asarray(vf))
    rep = Hq // Hkv
    ref = _attention_xla(
        jnp.asarray(q), jnp.repeat(kq, rep, axis=1), jnp.repeat(vq, rep, axis=1),
        causal=False, sm_scale=hd ** -0.5, kv_lens=jnp.asarray(kv_lens),
        bias=None, k_scale=jnp.repeat(ks, rep, axis=1),
        v_scale=jnp.repeat(vs, rep, axis=1))
    got = tattn.dot_product_attention(
        _t(q), _t(_flat(kq)), _t(_flat(vq)), causal=True,
        kv_lens=_t(kv_lens), q_start=_t(kv_lens) - 1,
        k_scale=_t(np.asarray(ks)), v_scale=_t(np.asarray(vs)))
    assert got.shape == (B, Hq, 1, hd)
    _close(got.numpy(), ref, what="vs _attention_xla")
    _close(got.numpy(), pallas_refs[name], what="vs decode_attention_quant")


@pytest.mark.parametrize("layer", range(STACKED[0]))
def test_decode_attention_stacked_layer_select(layer, pallas_refs):
    """The stacked cache [L, B, C, Hkv*hd] with a layer index; each layer
    holds different data, so a wrong selection is a loud mismatch."""
    L, B, Hq, Hkv, C, hd = STACKED
    q, kf, vf, kv_lens = _stacked_inputs()
    kq, ks = jkv._quantize(jnp.asarray(kf))
    vq, vs = jkv._quantize(jnp.asarray(vf))
    rep = Hq // Hkv
    ref = _attention_xla(
        jnp.asarray(q), jnp.repeat(kq[layer], rep, axis=1),
        jnp.repeat(vq[layer], rep, axis=1), causal=False, sm_scale=hd ** -0.5,
        kv_lens=jnp.asarray(kv_lens), bias=None,
        k_scale=jnp.repeat(ks[layer], rep, axis=1),
        v_scale=jnp.repeat(vs[layer], rep, axis=1))
    got = tattn.dot_product_attention(
        _t(q), _t(_flat(kq)), _t(_flat(vq)), kv_lens=_t(kv_lens),
        k_scale=_t(np.asarray(ks)), v_scale=_t(np.asarray(vs)), layer=layer)
    _close(got.numpy(), ref, what="vs _attention_xla")
    _close(got.numpy(), pallas_refs[f"stacked{layer}"],
           what="vs decode_attention_quant")


# ---------------------------------------------------------------------------
# K5's functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M", GEMV_M)
def test_dequant_matmul_small_m_matches_jax(M, pallas_refs):
    """The decode branch (the twin of K5's int8 entry) against
    `_dequant_matmul_ref`, the JAX `dequant_matmul` and the Pallas kernel
    `_dequant_matmul_pallas` in interpret mode (which returns within a
    second on the CPU). The odd N = 193 pads the port's weight to 200 rows."""
    w, xs = _gemv_inputs()
    x = xs[M]
    w8, w8s = jq.quantize_int8(jnp.asarray(w))
    q, s = tq.quantize_int8(_t(w.T))
    got = tq.dequant_matmul(_t(x), tq.pad_rows8(q), s).numpy()
    assert got.shape == (M, GN)
    _close(got, jq._dequant_matmul_ref(jnp.asarray(x), w8, w8s), what="ref")
    _close(got, jq.dequant_matmul(jnp.asarray(x), w8, w8s), what="jax entry")
    _close(got, pallas_refs[f"int8.{M}"], what="pallas interpret")


@pytest.mark.parametrize("M", (3, 40))
def test_dequant_matmul_w8a8_branch_matches_jax(M):
    """The W8A8 branch forced at small M through `w8a8_min_m`: the int8
    codes of the activations are equal, so the s32 products are, and the
    results agree to 1e-5."""
    rng = np.random.RandomState(7)
    K, N = 128, 193
    x = rng.randn(2, M, K).astype(np.float32)
    w8, w8s = jq.quantize_int8(jnp.asarray(rng.randn(K, N), jnp.float32))
    wq, ws = _t(np.asarray(w8).T), _t(np.asarray(w8s))
    jcodes, jscale = jq.quantize_rows(jnp.asarray(x))
    codes, scale = tq.quantize_rows(_t(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    _ulp_equal(scale.numpy(), jscale)
    ref = jq._w8a8_matmul(jnp.asarray(x.reshape(-1, K)), w8, w8s)
    got = tq.dequant_matmul(_t(x), tq.pad_rows8(wq), ws, w8a8_min_m=2)
    assert got.shape == (2, M, N)
    _close(got.reshape(-1, N).numpy(), ref, 1e-5)
    # and the routing: below the threshold the result is the twin's, exactly
    small = tq.dequant_matmul(_t(x), wq, ws, w8a8_min_m=10 ** 6)
    twin = tq._dequant_matmul_plain(_t(x.reshape(-1, K)), wq, ws)
    assert torch.equal(small.reshape(-1, N), twin)
    assert not torch.equal(small, got)


@pytest.mark.parametrize("M", GEMV_M)
def test_dequant4_matmul_matches_jax(M, pallas_refs):
    """Both routing branches of `dequant4_matmul` (the matvec twin at
    M <= matvec_max_m, dequantise-then-matmul above) against the JAX
    function and `_dequant4_matvec_pallas` in interpret mode, N = 193."""
    w, xs = _gemv_inputs()
    x = xs[M]
    w4, w4s = jq.quantize_int4(jnp.asarray(w), group=128)
    p, s = tq.quantize_int4(_t(w.T), group=128)
    ref = jq.dequant4_matmul(jnp.asarray(x), w4, w4s, group=128)
    matvec = tq.dequant4_matmul(_t(x), p, s, 128).numpy()
    large = tq.dequant4_matmul(_t(x), p, s, 128, matvec_max_m=0).numpy()
    assert matvec.shape == (M, GN)
    _close(matvec, ref, what="matvec vs jax entry")
    _close(large, ref, what="large-M vs jax entry")
    _close(matvec, pallas_refs[f"int4.{M}"], what="vs pallas interpret")


# ---------------------------------------------------------------------------
# the int8 KV cache
# ---------------------------------------------------------------------------
def _cache_np(cache):
    return {k: np.asarray(v) for k, v in cache.items()}


@pytest.mark.parametrize("S", [5, 1], ids=["prefill", "decode"])
def test_int8_cache_write_and_fetch_match_jax(S):
    """`write` + `update_and_fetch` on the int8 token-major cache, ragged
    starts, layer 1 of 3: buffers equal (codes) resp. 1 ulp (scales); the
    S > 1 fetch is one dequantised slab, the S == 1 fetch the stacked
    buffers."""
    L, B, Hkv, C, hd = 3, 2, 2, 12, 16
    rng = np.random.RandomState(21 + S)
    k0, v0, kn, vn = (rng.randn(B, Hkv, n, hd).astype(np.float32)
                      for n in (4, 4, S, S))
    starts0 = np.zeros(B, np.int32)
    starts = np.array([4, 2], np.int32)

    jc = jkv.init_cache(L, B, Hkv, C, hd, jnp.float32, quant_kv=True)
    jc = jkv.write(jc, 1, jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(starts0))
    jc, jk, jv, jks, jvs = jkv.update_and_fetch(
        jc, 1, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(starts),
        jnp.float32)

    tc = tkv.init_cache(L, B, Hkv, C, hd, torch.float32, quant_kv=True)
    assert {k: (tuple(v.shape), v.dtype) for k, v in tc.items()} == {
        "k": ((L, B, C, Hkv * hd), torch.int8),
        "v": ((L, B, C, Hkv * hd), torch.int8),
        "k_scale": ((L, B, Hkv, C), torch.float32),
        "v_scale": ((L, B, Hkv, C), torch.float32)}
    tkv.write(tc, 1, _t(k0), _t(v0), _t(starts0))
    before = tc["k"].data_ptr()
    tc, tk, tv, tks, tvs = tkv.update_and_fetch(tc, 1, _t(kn), _t(vn),
                                                _t(starts), torch.float32)
    assert tc["k"].data_ptr() == before           # updated in place
    want = _cache_np(jc)
    for name in ("k", "v"):
        np.testing.assert_array_equal(tc[name].numpy(), want[name])
        _ulp_equal(tc[f"{name}_scale"].numpy(), want[f"{name}_scale"])
    if S == 1:
        assert tk is tc["k"] and tv is tc["v"]
        assert tks is tc["k_scale"] and tvs is tc["v_scale"]
        assert jk.shape == tk.shape and jks.shape == tks.shape
    else:
        assert tks is None and tvs is None and jks is None
        _close(tk.numpy(), jk, 1e-6)
        _close(tv.numpy(), jv, 1e-6)


# ---------------------------------------------------------------------------
# QDense / QDense4 / the quantised Phi-3
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def phi3_float():
    cfg = Phi3Config.tiny()
    rng = np.random.RandomState(31)
    ids = rng.randint(1, 400, size=(2, 9)).astype(np.int32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    lens = np.array([9, 7], np.int32)
    jm = JPhi3(cfg, extra_vocab=1, dtype=jnp.float32)
    params = seeded_params(
        lambda: jm.init(jax.random.PRNGKey(0), ids, pos, lens,
                        method=JPhi3.forward_ids), 31)
    return cfg, params["params"], (ids, pos, lens)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_phi3_matches_jax(phi3_float, mode):
    """The JAX model on a tree quantised by `quantize_phi3_params(_int4)`
    against the port loaded from that tree through `from_jax` (QDense /
    QDense4 inside), one uncached forward in f32. Weight-only quantisation
    is continuous in the activations, so the f32 control tolerance of the
    float model holds (1e-4)."""
    cfg, params, (ids, pos, lens) = phi3_float
    quantise = quantize_phi3_params if mode == "int8" else quantize_phi3_params_int4
    qparams = quantise(params)
    jm = JPhi3(cfg, extra_vocab=1, dtype=jnp.float32,
               quant_int8=mode == "int8", quant_int4=mode == "int4")
    ref_logits, ref_hidden, _ = jax.jit(
        lambda p, *a: jm.apply({"params": p}, *a, method=JPhi3.forward_ids))(
            qparams, ids, pos, lens)
    tm = Phi3ForCausalLM(from_jax.port_config(cfg), extra_vocab=1,
                         quant_int8=mode == "int8", quant_int4=mode == "int4")
    tm.load_state_dict(from_jax.phi3_state_dict(qparams))
    kind = QDense if mode == "int8" else QDense4
    assert isinstance(tm.lm_head, kind)
    assert isinstance(tm.model.layers[0].mlp.down_proj, kind)
    with torch.no_grad():
        logits, hidden, _ = tm(tm.embed(_t(ids).long()), _t(pos).long(),
                               _t(lens).long())
    _close(hidden.numpy(), ref_hidden, 1e-4, "hidden")
    _close(logits.numpy(), ref_logits, 1e-4, "logits")


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_llm_equals_the_jax_quantised_tree(phi3_float, mode):
    """The port's own `quantize_llm` on the float weights gives the buffers
    that `from_jax` makes of the JAX-quantised tree: codes equal, scales to
    1 ulp."""
    cfg, params, _ = phi3_float
    quantise = quantize_phi3_params if mode == "int8" else quantize_phi3_params_int4
    want = from_jax.phi3_state_dict(quantise(params))
    tm = Phi3ForCausalLM(from_jax.port_config(cfg), extra_vocab=1)
    tm.load_state_dict(from_jax.phi3_state_dict(params))
    got = quantize_llm(tm, mode).state_dict()
    assert set(got) == set(want)
    for name, ref in want.items():
        if ref.dtype == torch.int8:
            assert torch.equal(got[name], ref), name
        else:
            _ulp_equal(got[name].numpy(), ref.numpy())
    with pytest.raises(ValueError):
        quantize_llm(tm, mode)
