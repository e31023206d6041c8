"""f32 through every serving kernel, checked on the CPU: an f32 model with
int8 / int4 weights and the int8 KV cache, the tracker at SAM image size
512 (whose memory self-attention is K7's), the unhoisted Hiera (whose
small windows are K8's), and the summation orders of the f32 routes of K4
and K5.

On the CPU the port runs the kernels' plain twins; the f32 routes
themselves run on the card (tests/test_torch_cuda.py, chip_smoke.py's f32q
phase). Here:
- the tiny slice in f32 with quantised weights and the int8 cache against
  the JAX package's f32 run on the same quantised tree, at the f32
  controls' tolerances (tests/test_torch_slice_quant.py's helper);
- an f32 build quantises the float weights exactly as a bf16 build does
  and leaves every float leaf in f32;
- the JAX tracker at image size 512 against the port's, marked f32, with
  its memory self-attention sent through `_window_attention` (K7's entry)
  as the card's dispatcher sends it; the unhoisted Hiera, marked f32,
  against the JAX module's XLA small-window path, with every small window
  through `attention_packed_qkv_smallwin` with exact=True;
- K4's f32 walk and K5's f32 sums (the CUDA-core route's, and the
  tensor-core route's over x's three bf16 planes), emulated in f32 from the
  plans, against the JAX XLA references at 2e-6 of the output scale (the
  same f32 products summed in another order; a bf16 rounding anywhere gives
  1e-3), and K5's f32 plans;
- the plain twins compute in f32: none rounds to bf16;
- the route rule: an f32 model names the "simt_f32" routes of K7 and K8,
  a bf16 model keeps its own.
No Pallas kernel runs here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_k4_plan import ATTN_CASES, _case, _emulate, _flat
from test_torch_k5_plan import SHAPES as K5_SHAPES
from test_torch_k5_plan import _k5_f32_tc_order, _k5_int4_order, _k5_int8_order
from test_torch_models import seeded_params
from test_torch_slice_quant import CFG as SLICE_CFG
from test_torch_slice_quant import check_slice_against_jax, float_params  # noqa: F401
from test_torch_window_ops import hiera_setup, _HIERA  # noqa: F401
from videoglamm_tpu.config import SAM2Config
from videoglamm_tpu.models.sam2 import video_predictor as jvp
from videoglamm_tpu.models.sam2.hiera import Hiera as JHiera
from videoglamm_tpu.models.sam2.sam2_base import SAM2Base as JSAM2Base
from videoglamm_tpu.ops import quant as jq
from videoglamm_tpu.ops.attention import _attention_xla
from videoglamm_torch.inference.pipeline import build_inference
from videoglamm_torch.io import from_jax
from videoglamm_torch.models.common import set_exact_f32
from videoglamm_torch.models.sam2 import hiera as thiera
from videoglamm_torch.models.sam2 import transformer as ttransformer
from videoglamm_torch.models.sam2 import video_predictor as tvp
from videoglamm_torch.models.sam2.hiera import Hiera
from videoglamm_torch.models.sam2.sam2_base import SAM2Base
from videoglamm_torch.ops import attention as tattn
from videoglamm_torch.ops import quant as tq
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

F32, BF16 = torch.float32, torch.bfloat16
TOL_ORDER = 2e-6
SMS = 132                                   # an H100's SMs


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# the slice: f32 with quantised weights and the int8 cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_f32_slice_with_quantised_weights_and_int8_cache_matches_jax(
        quant, float_params, monkeypatch):
    check_slice_against_jax(quant, "int8", False, float_params, monkeypatch)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_f32_build_quantises_as_bf16_and_keeps_float_leaves_f32(quant):
    """The quantisers read the f32 weights before any cast, so an f32 and a
    bf16 build hold the same codes and scales; the f32 build casts no leaf,
    the bf16 build only the float compute weights."""
    from videoglamm_torch.models.common import QDense, QDense4
    torch.manual_seed(0)
    sd = build_inference(from_jax.port_config(SLICE_CFG), device="cpu",
                         dtype=F32).model.state_dict()
    cfg = from_jax.port_config(SLICE_CFG)
    m32, m16 = (build_inference(cfg, sd, device="cpu", dtype=dt, quant=quant,
                                kv_cache="int8").model for dt in (F32, BF16))
    kind = QDense if quant == "int8" else QDense4
    q32 = {n: m for n, m in m32.named_modules() if isinstance(m, kind)}
    q16 = dict((n, m) for n, m in m16.named_modules() if isinstance(m, kind))
    assert len(q32) == 4 * SLICE_CFG.llm.num_layers + 1 and q32.keys() == q16.keys()
    for n, m in q32.items():
        for (a_name, a), b in zip(m.state_dict().items(), q16[n].state_dict().values()):
            assert torch.equal(a, b), f"{n}.{a_name}"
    s32, s16 = m32.state_dict(), m16.state_dict()
    assert {k: v.dtype for k, v in s32.items()} == {
        k: (F32 if v.is_floating_point() else v.dtype) for k, v in s16.items()}
    assert BF16 in {v.dtype for v in s16.values()}
    assert m32.quant_kv_int8 and m32.exact_f32 and not m16.exact_f32


# ---------------------------------------------------------------------------
# K7: the tracker at SAM image size 512
# ---------------------------------------------------------------------------
SCFG512 = dataclasses.replace(SAM2Config.tiny(), image_size=512,
                              memory_rope_feat_sizes=(32, 32))


def test_tracker_at_512_in_f32_takes_k7_and_matches_jax(monkeypatch):
    """`track_video` over 3 frames at a 32x32 memory grid: every memory
    self-attention ([1,1,1024,32], no mask) goes through
    `_window_attention` with exact=True, as the card's dispatcher sends it
    to K7's full-precision route; masks, scores and ious held to the JAX
    tracker in f32 at tests/test_torch_tracking.py's tolerances."""
    jm = JSAM2Base(SCFG512, dtype=jnp.float32)
    imgs = np.random.RandomState(20).randn(3, 512, 512, 3).astype(np.float32)
    text = np.random.RandomState(21).randn(1, 1, SCFG512.d_model).astype(np.float32)
    params = seeded_params(lambda: jm.init(jax.random.PRNGKey(0), imgs[:1]), 22)

    def fn(mdl, imgs_, text_):
        feats, pos = mdl.forward_image(imgs_)
        return jvp.track_video(mdl, feats, pos, text_)

    ref = jax.jit(lambda p, a, b: jm.apply(p, a, b, method=fn))(params, imgs, text)
    tm = SAM2Base(from_jax.port_config(SCFG512)).eval()
    tm.load_state_dict(from_jax.sam2_state_dict(params["params"]))
    set_exact_f32(tm, True)
    seen = []
    real = ttransformer.dot_product_attention

    def dispatch(q, k, v, **kw):
        if kw.get("kv_mask") is None and q.shape[2] == k.shape[2] == 1024:
            seen.append(kw.get("exact"))
            return tattn._window_attention(q, k, v, q.shape[-1] ** -0.5,
                                           kw.get("exact", False))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ttransformer, "dot_product_attention", dispatch)
    with torch.no_grad():
        feats, pos = tm.forward_image(_t(imgs))
        got = tvp.track_video(tm, feats, pos, _t(text))
    # the frames after the first, one memory-attention layer each
    assert seen == [True] * 2
    _close(got.object_score_logits, ref.object_score_logits, 1e-4, "scores")
    _close(got.ious, ref.ious, 1e-4, "ious")
    _close(got.low_res_masks, ref.low_res_masks, 1e-3, "masks")


# ---------------------------------------------------------------------------
# K8: the unhoisted Hiera in f32
# ---------------------------------------------------------------------------
def test_unhoisted_hiera_in_f32_takes_k8_exact_and_matches_jax(hiera_setup,
                                                                monkeypatch):
    """`Hiera(hoist_layout=False)` of an f32 model against the JAX module
    with hoist_layout=False (its small windows on `_smallwin_xla`): every
    small-window call carries exact=True; 1e-4 on O(1) activations after
    six blocks, as tests/test_torch_window_ops.py holds the unmarked
    one."""
    x, params, sd = hiera_setup
    ref = jax.jit(JHiera(_HIERA, dtype=jnp.float32, hoist_layout=False).apply)(
        params, x)
    tm = Hiera(from_jax.port_config(_HIERA), hoist_layout=False)
    tm.load_state_dict(sd)
    set_exact_f32(tm, True)
    seen = []
    small = thiera.attention_packed_qkv_smallwin
    monkeypatch.setattr(thiera, "attention_packed_qkv_smallwin",
                        lambda qkv, nh, hd, **kw: seen.append(kw.get("exact"))
                        or small(qkv, nh, hd, **kw))
    with torch.no_grad():
        got = tm(_t(x))
    assert seen == [True, True]
    for i, (a, b) in enumerate(zip(got, ref)):
        _close(a, b, 1e-4, f"stage {i}")


# ---------------------------------------------------------------------------
# K4's and K5's f32 routes: their summation orders against JAX
# ---------------------------------------------------------------------------
def _rel_l2(got, ref):
    g, r = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(g - r) / np.linalg.norm(r)


@pytest.mark.parametrize("name", list(ATTN_CASES) + ["stacked1"])
def test_k4_f32_walk_matches_the_xla_reference(name):
    """K4's f32 route as the kernel computes it (the plan's splits, phases
    and folds; q times the signed codes in four chains; p * vs in f32)
    against `_attention_xla` in f32."""
    q, kq, ks, vq, vs, kv_lens = _case(name)
    if name.startswith("stacked"):
        kq, ks, vq, vs = (a[int(name[-1])] for a in (kq, ks, vq, vs))
    B, Hq, _, hd = q.shape
    Hkv, C = ks.shape[1], ks.shape[2]
    rep = Hq // Hkv
    ref = np.asarray(_attention_xla(
        jnp.asarray(q), jnp.repeat(kq, rep, axis=1), jnp.repeat(vq, rep, axis=1),
        causal=False, sm_scale=hd ** -0.5, kv_lens=jnp.asarray(kv_lens),
        bias=None, k_scale=jnp.repeat(ks, rep, axis=1),
        v_scale=jnp.repeat(vs, rep, axis=1)))
    plan = tattn.k4_plan(B, Hq, Hkv, hd, C, SMS)
    got = _emulate(plan, torch.from_numpy(q), _flat(kq), _flat(vq),
                   torch.from_numpy(np.array(ks)), torch.from_numpy(np.array(vs)),
                   kv_lens, hd ** -0.5, f32=True).numpy()
    scale = max(1.0, np.abs(ref).max())
    assert np.abs(got - ref).max() <= TOL_ORDER * scale
    assert _rel_l2(got, ref) <= TOL_ORDER
    # the bf16 route's emulation misses the f32 reference by its rounding
    bf = _emulate(plan, torch.from_numpy(q).bfloat16(), _flat(kq), _flat(vq),
                  torch.from_numpy(np.array(ks)), torch.from_numpy(np.array(vs)),
                  kv_lens, hd ** -0.5).float().numpy()
    assert _rel_l2(bf, ref) > 50 * TOL_ORDER


@pytest.mark.parametrize("N,K", K5_SHAPES)
def test_k5_f32_sums_match_jax(N, K):
    """K5's f32 routes in their summation orders against
    `_dequant_matmul_ref` and the int4 dequantise-then-dot, at the five
    Phi-3 decode products (64 of their rows, in the order of the plan of
    all N) and the odd case: one row on the CUDA cores (its int8 and int4
    orders with f32 x); 4, 13 and 64 rows on the tensor cores (x's three
    bf16 planes, a fresh sum a stage, int4 stages scaled once, the k split
    of small-N plans)."""
    n = min(N, 64)
    rng = np.random.default_rng(K + N)
    x4 = rng.standard_normal((4, K)).astype(np.float32)
    w = (rng.standard_normal((n, K)) * K ** -0.5).astype(np.float32)
    qj, sj = jq.quantize_int8(jnp.asarray(w.T))
    pj, s4j = jq.quantize_int4(jnp.asarray(w.T), 128)
    q, s = tq.quantize_int8(torch.from_numpy(w))
    p, s4 = tq.quantize_int4(torch.from_numpy(w), 128)
    w4j = jq._dequant4_weights(pj, s4j, 128, jnp.float32)
    for M in (1, 4, 13, 64):
        x = x4[:M] if M <= 4 else rng.standard_normal((M, K)).astype(np.float32)
        ref8 = np.asarray(jq._dequant_matmul_ref(jnp.asarray(x), qj, sj))
        ref4 = np.asarray(jnp.dot(jnp.asarray(x), w4j))
        xt = torch.from_numpy(x)
        p8, p4 = (tq.k5_plan(M, N, K, g, SMS, f32=True) for g in (0, 128))
        assert p8.tc == p4.tc == (M >= tq.k5_f32_tc_min_m(N, SMS))
        orders = []
        if p8.tc:
            orders.append((_k5_f32_tc_order(xt, q, s, 0, p8).numpy(),
                           _k5_f32_tc_order(xt, p, s4, 128, p4).numpy()))
        if M <= 4:          # the CUDA-core route's order (asked for at 4 rows)
            orders.append((_k5_int8_order(xt, q, s, mma=False).numpy(),
                           _k5_int4_order(xt, p, s4, 128).numpy()))
        for got8, got4 in orders:
            for what, got, ref in (("int8", got8, ref8), ("int4", got4, ref4)):
                scale = max(1.0, np.abs(ref).max())
                assert np.abs(got - ref).max() <= TOL_ORDER * scale, (what, M)
                assert _rel_l2(got, ref) <= TOL_ORDER, (what, M)


@pytest.mark.parametrize("N,K", K5_SHAPES)
def test_k5_f32_plan_tiles_every_row_on_the_cuda_cores(N, K):
    """With f32 x below the crossover (`k5_f32_tc_min_m`), and wherever the CUDA-core
    route is asked for (the card's crossover timings), `k5_plan` tiles
    every row on the CUDA cores: tiles of up to 4 rows on grid.y covering
    M, x of a tile and the units' sums within the shared memory of
    `per_sm` CTAs an SM; at 1 to 3 rows the plan is the bf16 one."""
    for group in (0, 128):
        for M in list(range(1, 10)) + [63, 64, 65, 255]:
            p = tq.k5_plan(M, N, K, group, SMS, f32=True,
                           tc=None if M < tq.k5_f32_tc_min_m(N, SMS) else False)
            assert not p.mma and not p.tc and p.mt == min(M, tq.K5_F32_MT)
            assert p.m_tiles * p.mt >= M > (p.m_tiles - 1) * p.mt
            assert p.per_sm == (2 if M == 1 else 1)
            assert p.smem <= tq.K5_SMEM_SM // p.per_sm - tq.K5_SMEM_CTA
            assert p.s_off >= p.mt * p.xstride
            f = p.fields()
            assert f[1] == p.mt and f[2] == p.m_tiles and len(f) == 23
            if M <= tq.K5_ROWS_MAX_M:
                assert p == tq.k5_plan(M, N, K, group, SMS)


@pytest.mark.parametrize("N,K", K5_SHAPES)
def test_k5_f32_plan_takes_the_tensor_cores_from_the_crossover(N, K):
    """With f32 x from the crossover (`k5_f32_tc_min_m`: 5 rows where an SM
    would hold at most 64 channels, 2 where more than 96, 4 between: qkv,
    o_proj and down_proj, gate_up and lm_head), `k5_plan` takes the tensor-core
    route below the W8A8 gate (int4: to its matvec gate): one
    pass over the weights for up to 64 rows, ceil(M / 64) above, the planes'
    width the rows rounded up to 8 (64 above 32), within shared memory."""
    for group in (0, 128):
        for M in list(range(1, 10)) + [13, 32, 33, 63, 64, 65, 128, 255]:
            if group and M > tq.MATVEC4_MAX_M:
                continue
            p = tq.k5_plan(M, N, K, group, SMS, f32=True)
            assert p.tc == (M >= tq.k5_f32_tc_min_m(N, SMS))
            rows = -(-N // SMS)
            assert tq.k5_f32_tc_min_m(N, SMS) == (5 if rows <= 64 else 2 if rows > 96 else 4)
            if not p.tc:
                continue
            assert not p.mma and p.m_tiles == -(-M // 64) and p.mt == min(M, 64)
            assert p.xw == (-(-p.mt // 8) * 8 if p.mt <= 32 else 64)
            assert p.smem <= tq.K5_SMEM and p.per_sm == 1
            assert p == tq.k5_plan(M, N, K, group, SMS, f32=True, tc=True)


# ---------------------------------------------------------------------------
# the plain twins in f32, and the route rule
# ---------------------------------------------------------------------------
def test_plain_twins_round_nothing_to_bf16_in_f32():
    """Each f32 route's twin against a float64 evaluation of the same
    function: within f32 rounding (1e-6 relative L2), where one bf16
    rounding of an operand or of p * vs gives 1e-3."""
    rng = np.random.default_rng(3)
    f64 = lambda a: torch.from_numpy(np.asarray(a, np.float64))
    # K7
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 520, 32), np.float32))
               for _ in range(3))
    got = tattn._window_attention_plain(q, k, v, 32 ** -0.5)
    want = torch.softmax(f64(q) @ f64(k).transpose(-1, -2) * 32 ** -0.5, -1) @ f64(v)
    assert got.dtype == F32 and _rel_l2(got, want) <= 1e-6
    # K8
    qkv = torch.from_numpy(rng.standard_normal((6, 16, 3 * 2 * 24), np.float32))
    got = tattn._smallwin_plain(qkv, 2, 24 ** -0.5)
    x = f64(qkv).view(6, 16, 3, 2, 24).permute(2, 0, 3, 1, 4)
    want = (torch.softmax(x[0] @ x[1].transpose(-1, -2) * 24 ** -0.5, -1)
            @ x[2]).permute(0, 2, 1, 3).reshape(6, 16, 48)
    assert got.dtype == F32 and _rel_l2(got, want) <= 1e-6
    # K4
    B, Hq, Hkv, hd, C = 2, 4, 2, 16, 40
    qd = torch.from_numpy(rng.standard_normal((B, Hq, 1, hd), np.float32))
    kc, vc = (torch.from_numpy(rng.integers(-127, 128, (B, C, Hkv * hd), dtype=np.int8))
              for _ in range(2))
    ks, vs = (torch.from_numpy(rng.uniform(0.005, 0.02, (B, Hkv, C)).astype(np.float32))
              for _ in range(2))
    kvl = torch.tensor([C, 23])
    got = tattn._decode_attention_q8_plain(qd, kc, vc, ks, vs, sm_scale=hd ** -0.5,
                                           kv_lens=kvl)
    kh = (kc.view(B, C, Hkv, hd).transpose(1, 2).double() * ks[..., None].double())
    vh = (vc.view(B, C, Hkv, hd).transpose(1, 2).double() * vs[..., None].double())
    kh, vh = (t.repeat_interleave(Hq // Hkv, dim=1) for t in (kh, vh))
    s = qd.double() @ kh.transpose(-1, -2) * hd ** -0.5
    s = s.masked_fill(torch.arange(C)[None, None, None] >= kvl[:, None, None, None],
                      -1e30)
    want = torch.softmax(s, -1) @ vh
    assert got.dtype == F32 and _rel_l2(got, want) <= 1e-6
    # K5
    xm = torch.from_numpy(rng.standard_normal((3, 256), np.float32))
    wf = torch.from_numpy(rng.standard_normal((40, 256), np.float32)) * 256 ** -0.5
    q8, s8 = tq.quantize_int8(wf)
    got = tq._dequant_matmul_plain(xm, q8, s8)
    assert got.dtype == F32 and _rel_l2(got, xm.double() @ (q8.double() * s8.double()[:, None]).T) <= 1e-6
    p4, s4 = tq.quantize_int4(wf, 128)
    got = tq._dequant4_matmul_plain(xm, p4, s4, 128)
    w4 = tq._dequant4_weights(p4, s4, 128, torch.float64)
    assert got.dtype == F32 and _rel_l2(got, xm.double() @ w4.T) <= 1e-6


@pytest.mark.parametrize("exact", [True, False])
def test_route_rule_of_k7_and_k8(exact):
    """K7 routes as K1 (the memory self-attention's head dim 256): an f32
    model's f32 operands take "simt_f32", a bf16 model's the staged
    "wgmma_f32"; K8 takes "simt_f32" for an f32 model's f32 qkv, has no
    staged route (a bf16 model's f32 qkv raises) and its own "mma" body
    for bf16."""
    assert tattn.k1_route(F32, 256, exact) == ("simt_f32" if exact else "wgmma_f32")
    assert tattn.k1_route(BF16, 256, exact) == "wgmma"
    assert tattn.k8_route(BF16, exact) == "mma"
    if exact:
        assert tattn.k8_route(F32, exact) == "simt_f32"
    else:
        with pytest.raises(ValueError, match="K8 takes bf16 only"):
            tattn.k8_route(F32, exact)
