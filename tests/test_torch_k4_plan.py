"""K4 (the int8-KV decode attention) as it is laid out on the card, checked
on the CPU: its plan (`k4_plan`: splits, phases, shared memory, the
splits' partials) and its arithmetic (the split walk, the per-phase online
softmax in base 2, the phase fold and the fixed-order fold of the splits).

The walk is emulated in f32 from the plan, with the kernel's own
arithmetic: the code images (c + 128 as the bits of an f32), q and p
pre-scaled by powers of two against them, and the corrections that take
the scales and the 128 off again. It is held to the JAX package's XLA
reference `_attention_xla` at 2e-5 of the output scale, on the ragged, GQA
and stacked cases of tests/test_torch_quant.py (the same shapes and seeds):
the same f32 products, summed in another order, as the JAX tests of the
same kernel state (tests/test_ops.py:84-152). Where the kernel rounds
p * v_scale to bf16, the emulation rounds to q's dtype, as the reference
does, which is f32 here. No Pallas kernel runs here.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoglamm_torch.config import VideoGLaMMConfig
from videoglamm_torch.ops import attention as tattn
from videoglamm_tpu.models import kvcache as jkv
from videoglamm_tpu.ops.attention import _attention_xla
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 2e-5
SMS = 132                                   # an H100's SMs
LOG2E = 1.4426950408889634
K4_THREADS = tattn.K4_CONSUMERS + 32         # and a producer warp

# (B, Hq, Hkv, hd, C) of the models K4 serves
GEOMETRIES = {
    "phi3": (32, 32, 96, 3456),
    "llama3_1_8b": (32, 8, 128, 3456),
    "tiny": tuple(getattr(VideoGLaMMConfig.tiny().llm, f) for f in
                  ("num_heads", "num_kv_heads", "head_dim")) + (40,),
}

# the cases of tests/test_torch_quant.py: (B, Hq, Hkv, C, hd), seeds by name
ATTN_CASES = {"mha_ragged": (2, 4, 4, 300, 96),
              "gqa4": (1, 8, 2, 700, 64),
              "gqa2": (2, 8, 4, 160, 96)}
STACKED = (3, 2, 8, 4, 300, 96)             # L, B, Hq, Hkv, C, hd


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
def _split_range(plan, split, kv_len):
    """[start, end) of the tokens a split takes, as the kernel cuts them:
    ceil(kv_len / splits) a split, kv_len clamped to [0, C]."""
    kv_len = min(max(kv_len, 0), plan.C)
    per = -(-kv_len // plan.splits)
    start = split * per
    return start, max(start, min(start + per, kv_len))


def _phase_tokens(plan, split, phase, kv_len):
    """The tokens phase `phase` of split `split` walks, in order: rows phase,
    phase + phases, ... of the split's stages."""
    start, end = _split_range(plan, split, kv_len)
    return range(start + phase, end, plan.phases)


@pytest.mark.parametrize("B", range(1, 9))
@pytest.mark.parametrize("model", list(GEOMETRIES))
def test_k4_plan_covers_every_token_once_and_fits(model, B):
    Hq, Hkv, hd, C = GEOMETRIES[model]
    plan = tattn.k4_plan(B, Hq, Hkv, hd, C, SMS)
    # at most 16 splits, a power of two, and one wave: no more CTAs than one
    # an SM unless a split is already the whole cache
    assert plan.splits & (plan.splits - 1) == 0 and plan.splits <= 16
    assert B * Hkv * plan.splits <= SMS or plan.splits == 1
    assert plan.seg >= plan.vph > plan.seg // 2
    assert plan.seg * plan.phases == 480                  # 15 consumer warps
    assert plan.smem <= 227 * 1024 and 2 <= plan.stages <= 8
    # a stage: K and V tiles of `tile` rows `pitch` bytes apart, in TMA
    # boxes whose bytes are multiples of 128, then the two scale rows
    assert plan.box * plan.nbox == plan.tile and plan.box <= 256
    assert plan.pitch >= hd and plan.box * plan.pitch % 128 == 0
    T, G = plan.tile, plan.G
    stage = [(0, T * plan.pitch), (plan.v_off, plan.v_off + T * plan.pitch),
             (plan.ks_off, plan.ks_off + 4 * T), (plan.vs_off, plan.vs_off + 4 * T)]
    rest = [(0, plan.stages * plan.stage_bytes),
            (plan.part_off, plan.part_off + 4 * 15 * G * hd),
            (plan.pml_off, plan.pml_off + 8 * 15 * G),
            (plan.bar_off, plan.bar_off + 16 * 8)]
    for regions, size in ((stage, plan.stage_bytes), (rest, plan.smem)):
        for i, (a0, a1) in enumerate(regions):  # as the C entry checks them
            assert a0 % 16 == 0 and a1 <= size
            assert all(a1 <= b0 or b1 <= a0 for b0, b1 in regions[:i])
    tile = plan.tile
    for kv_len in sorted({0, 1, tile - 1, tile, tile + 1, C}):
        seen = [t for s in range(plan.splits) for ph in range(plan.phases)
                for t in _phase_tokens(plan, s, ph, kv_len)]
        assert sorted(seen) == list(range(min(kv_len, C))), (kv_len, plan)
    # the splits' partials in device memory: at most 5% of the slab's bytes
    # at the flagship geometries
    if model != "tiny":
        assert 4 * plan.ws_floats <= 0.05 * 2 * B * C * Hkv * (hd + 4)
    assert plan.ws_stride >= G * (hd + 2) and plan.ws_stride % 4 == 0
    # kv_len past the cache is clamped to C, below 0 to nothing
    assert _split_range(plan, plan.splits - 1, C + 5)[1] == C
    assert all(_split_range(plan, s, -3) == (0, 0) for s in range(plan.splits))


def test_k4_plan_fields_are_the_c_struct():
    plan = tattn.k4_plan(1, 32, 8, 128, 3456, SMS)
    f = plan.fields()
    assert len(f) == 21
    assert (f[0], 1 << f[1], f[2], 1 << f[3], f[4], f[5], f[6], f[7]) == (
        plan.splits, plan.splits, plan.seg, plan.seg, 128 // plan.dpl,
        plan.phases, plan.chunk, plan.phases * plan.chunk)
    assert f[8:13] == (plan.pitch, plan.box, plan.nbox, plan.stages,
                       plan.stage_bytes)
    assert f[-2:] == (plan.smem, plan.ws_stride)
    # the flagship plans: Phi-3 as 32 heads x 4 splits, Llama as 8 x 16,
    # one CTA an SM of 132 in either; a stage is one TMA box of each
    phi3 = tattn.k4_plan(1, 32, 32, 96, 3456, SMS)
    assert (phi3.splits, phi3.dpl, phi3.seg, phi3.vph, phi3.chunk, phi3.tile,
            phi3.nbox) == (4, 24, 4, 4, 2, 240, 1)
    assert (plan.splits, plan.seg, plan.vph, plan.chunk, plan.tile,
            plan.nbox) == (16, 16, 16, 2, 60, 1)
    # head dims whose rows would leave a box off the 128-byte grid read a
    # wider row (the next head's first codes, unused)
    odd = tattn.k4_plan(1, 16, 4, 80, 777, SMS)
    assert odd.pitch == 96 and odd.box * odd.pitch % 128 == 0


@pytest.mark.parametrize("args", [
    (1, 6, 2, 64, 100),          # G = 3
    (1, 4, 4, 24, 100),          # hd % 16
    (1, 4, 4, 144, 100),         # hd > 128
    (1, 64, 64, 96, 100),        # Hkv * hd > 4096
    (0, 4, 4, 64, 100),          # no rows
])
def test_k4_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        tattn.k4_plan(*args, SMS)


# ---------------------------------------------------------------------------
# the arithmetic: the kernel's walk in f32
# ---------------------------------------------------------------------------
def _fma(a, b, c):
    """f32 fma(a, b, c): the product exact in f64, one rounding to f32 (the
    sum's rounding to f64 first differs from the card's only at a tie)."""
    return (a.double() * b.double() + c.double()).float()


def _pow2(e):
    """2^e in f32 for -126 <= e <= 127, built from its bits as the kernel
    builds it."""
    return ((torch.as_tensor(e, dtype=torch.int32) + 127) << 23).view(
        torch.float32)


def _images(codes):
    """The kernel's code images: c + 128 as the bits of an f32, that is
    (c + 128) * 2^-149, a denormal (CPU torch keeps denormals)."""
    return (codes.to(torch.int32) + 128).view(torch.float32)


def _dots(plan, qh, kh, f32: bool = False):
    """q . k_j for G query heads against every token of a kv head, as a
    lane takes it: q pre-scaled by 2^(252 - ef) (ef: the exponent field of
    the lane's largest |q|, in [1, 230]) against the images, four chains
    over the lane's dims, then times 2^(ef - 103) less 128 * sum(q), and the
    segment's lanes summed in a butterfly (pad lanes add zeros). f32 (K4's
    f32 route): the four chains run on q and the signed codes themselves.
    qh [G, hd] f32, kh [T, hd] codes -> [G, T]."""
    G, hd = qh.shape
    dpl, vph, seg = plan.dpl, plan.vph, plan.seg
    ql = qh.view(G, vph, dpl)
    if f32:
        codes = kh.float().view(-1, vph, dpl)
        d = [torch.zeros(G, codes.shape[0], vph) for _ in range(4)]
        for i in range(dpl):
            d[i & 3] = _fma(ql[:, None, :, i], codes[None, :, :, i], d[i & 3])
        return _lane_sum(plan, (d[0] + d[1]) + (d[2] + d[3]))
    qmax = ql.abs().amax(dim=(0, 2))                                 # [vph]
    ef = ((qmax.view(torch.int32) >> 23) & 0xff).clamp(1, 230)
    e_up = 252 - ef
    qs = ql * _pow2(e_up >> 1)[:, None] * _pow2(e_up - (e_up >> 1))[:, None]
    qsum = torch.zeros(G, vph)
    for i in range(dpl):                                             # in order
        qsum = qsum + ql[:, :, i]
    qneg = -128.0 * qsum
    img = _images(kh).view(-1, vph, dpl)                             # [T, vph, dpl]
    d = [torch.zeros(G, img.shape[0], vph) for _ in range(4)]
    for i in range(dpl):
        d[i & 3] = _fma(qs[:, None, :, i], img[None, :, :, i], d[i & 3])
    return _lane_sum(plan, _fma((d[0] + d[1]) + (d[2] + d[3]),
                                _pow2(ef - 103), qneg[:, None]))


def _lane_sum(plan, lane):
    """A segment's lane sums [G, T, vph] met in a butterfly (pad lanes add
    zeros) -> [G, T]."""
    G, seg, vph = lane.shape[0], plan.seg, plan.vph
    lane = torch.cat([lane, torch.zeros(G, lane.shape[1], seg - vph)], dim=2)
    off = 1
    while off < seg:                        # every lane ends with lane 0's sum
        lane = lane + lane[:, :, torch.arange(seg) ^ off]
        off *= 2
    return lane[:, :, 0]


def _merge(a, b):
    """Two online-softmax states (m, l, acc) as one, as the kernel's warp
    butterfly merges them, a the lower lane's."""
    mx = torch.maximum(a[0], b[0])
    wa, wb = torch.exp2(a[0] - mx), torch.exp2(b[0] - mx)
    return (mx, _fma(wa, a[1], wb * b[1]),
            _fma(wa[:, None], a[2], wb[:, None] * b[2]))


def _fold(states):
    """States folded in order against their common maximum: (m, l, acc)."""
    mm = torch.stack([x[0] for x in states])
    top = mm.max(dim=0).values
    w = torch.exp2(mm - top)
    l = torch.zeros_like(top)
    acc = torch.zeros_like(states[0][2])
    for i, x in enumerate(states):
        l = _fma(w[i], x[1], l)
        acc = _fma(w[i][:, None], x[2], acc)
    return top, l, acc


def _fold_splits(plan, splits):
    """The last split's fold, (l, acc): K threads share four outputs, thread
    j folds splits j, j + K, ... in order against the splits' common
    maximum, and the K sums meet in a butterfly."""
    total = plan.G * plan.hd
    lk = 0
    while 2 << lk <= plan.splits and (total >> 2) << (lk + 1) <= K4_THREADS:
        lk += 1
    K = 1 << lk
    top = torch.stack([x[0] for x in splits]).max(dim=0).values
    parts = []
    for j in range(K):
        l = torch.zeros_like(top)
        acc = torch.zeros_like(splits[0][2])
        for r in range(j, plan.splits, K):
            w = torch.exp2(splits[r][0] - top)
            l = _fma(w, splits[r][1], l)
            acc = _fma(w[:, None], splits[r][2], acc)
        parts.append((l, acc))
    off = 1
    while off < K:
        parts = [(parts[i][0] + parts[i ^ off][0], parts[i][1] + parts[i ^ off][1])
                 for i in range(K)]
        off *= 2
    return parts[0]


def _emulate(plan, q, k, v, ks, vs, kv_lens, sm_scale, f32: bool = False):
    """K4 for one layer's slab as the kernel computes it. q [B,Hq,1,hd] f32;
    k, v: [B,C,Hkv*hd] codes; ks, vs: [B,Hkv,C]. The dot products run on
    the code images against pre-scaled q (`_dots`); each phase runs its
    online softmax in base 2 a chunk at a time (rescaling only on a new
    maximum), its V sums on the images against p * vs * 2^90 and, at its
    end, takes the scale and the 128 off (acc * 2^59 - 128 * psum * 2^-90);
    a warp's phases merge in a butterfly, a split folds its warps in warp
    order, and the last split folds the splits' partials (`_fold_splits`);
    l == 0 gives 0. Where the kernel rounds p * vs to bf16, the emulation
    rounds to q's dtype, as the reference does. f32 (K4's f32 route): the
    dot products and V sums on the signed codes, p * vs unscaled and
    unrounded, no correction at the end."""
    B, Hq, _, hd = q.shape
    G, Hkv, C = plan.G, plan.Hkv, k.shape[1]
    c2 = torch.tensor(sm_scale, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    vs_up, acc_up, psum_down = _pow2(90), _pow2(59), -_pow2(-83)
    if f32:
        vs_up = torch.tensor(1.0)
    out = torch.zeros(B, Hq, 1, hd)
    for b in range(B):
        kv_len = int(kv_lens[b])
        for h in range(Hkv):
            kh = k[b].view(C, Hkv, hd)[:, h]
            vh = v[b].view(C, Hkv, hd)[:, h]
            vimg = vh.float() if f32 else _images(vh)
            qh = q[b, h * G:(h + 1) * G, 0].float()                 # [G, hd]
            dots = _dots(plan, qh, kh[:min(max(kv_len, 1), C)], f32)         # [G, T]
            cks_all = c2 * ks[b, h]
            splits = []
            for s in range(plan.splits):
                phases = []
                for ph in range(plan.phases):
                    toks = list(_phase_tokens(plan, s, ph, kv_len))
                    m = torch.full((G,), -1e30)
                    l = torch.zeros(G)
                    psum = torch.zeros(G)
                    acc = torch.zeros(G, hd)
                    for c0 in range(0, len(toks), plan.chunk):
                        t = toks[c0:c0 + plan.chunk]
                        dot, cks = dots[:, t], cks_all[t]
                        mx = torch.maximum(m, (dot * cks).max(dim=1).values)
                        new = mx > m
                        alpha = torch.exp2(m - mx)
                        l = torch.where(new, l * alpha, l)
                        psum = torch.where(new, psum * alpha, psum)
                        acc = torch.where(new[:, None], acc * alpha[:, None], acc)
                        m = mx
                        for j, tok in enumerate(t):                  # token order
                            p = torch.exp2(_fma(dot[:, j], cks[j], -m))
                            l = l + p
                            pb = (p * (vs[b, h, tok] * vs_up)).to(q.dtype).float()
                            psum = psum + pb
                            acc = _fma(pb[:, None], vimg[tok][None], acc)
                    if not f32:
                        acc = _fma(acc, acc_up, psum[:, None] * psum_down)
                    phases.append((m, l, acc))
                # a warp's phases merge in a butterfly, the lower one first
                spw = 32 // plan.seg                 # phases a warp
                warps = []
                for w0 in range(0, plan.phases, spw):
                    st = phases[w0:w0 + spw]
                    off = 1
                    while off < spw:
                        st = [_merge(st[i], st[i ^ off]) if not i & off else
                              _merge(st[i ^ off], st[i]) for i in range(spw)]
                        off *= 2
                    warps.append(st[0])
                splits.append(_fold(warps))
            L, O = _fold_splits(plan, splits)
            inv = torch.where(L == 0, torch.zeros_like(L), 1.0 / L)
            out[b, h * G:(h + 1) * G, 0] = O * inv[:, None]
    return out


def _flat(q8):
    """[..., Hkv, C, hd] int8 -> token-major flat [..., C, Hkv*hd]."""
    sw = np.swapaxes(np.asarray(q8), -3, -2)
    return torch.from_numpy(np.ascontiguousarray(sw.reshape(*sw.shape[:-2], -1)))


def _case(name):
    """The inputs of test_torch_quant.py's case `name`, quantised by the JAX
    cache's own quantiser."""
    if name.startswith("stacked"):
        L, B, Hq, Hkv, C, hd = STACKED
        rng = np.random.RandomState(11)
        q = rng.randn(B, Hq, 1, hd).astype(np.float32)
        kf = rng.randn(L, B, Hkv, C, hd).astype(np.float32)
        vf = rng.randn(L, B, Hkv, C, hd).astype(np.float32)
    else:
        B, Hq, Hkv, C, hd = ATTN_CASES[name]
        rng = np.random.RandomState(sum(map(ord, name)))
        q = rng.randn(B, Hq, 1, hd).astype(np.float32)
        kf = rng.randn(B, Hkv, C, hd).astype(np.float32)
        vf = rng.randn(B, Hkv, C, hd).astype(np.float32)
    kv_lens = rng.randint(C // 2, C + 1, size=(B,)).astype(np.int32)
    kq, ks = jkv._quantize(jnp.asarray(kf))
    vq, vs = jkv._quantize(jnp.asarray(vf))
    return q, kq, ks, vq, vs, kv_lens


@pytest.mark.parametrize("name", list(ATTN_CASES) + [
    f"stacked{i}" for i in range(STACKED[0])])
def test_k4_walk_matches_the_xla_reference(name):
    q, kq, ks, vq, vs, kv_lens = _case(name)
    if name.startswith("stacked"):
        layer = int(name[-1])
        kq, ks, vq, vs = (a[layer] for a in (kq, ks, vq, vs))
    B, Hq, _, hd = q.shape
    Hkv, C = ks.shape[1], ks.shape[2]
    rep = Hq // Hkv
    ref = _attention_xla(
        jnp.asarray(q), jnp.repeat(kq, rep, axis=1), jnp.repeat(vq, rep, axis=1),
        causal=False, sm_scale=hd ** -0.5, kv_lens=jnp.asarray(kv_lens),
        bias=None, k_scale=jnp.repeat(ks, rep, axis=1),
        v_scale=jnp.repeat(vs, rep, axis=1))
    plan = tattn.k4_plan(B, Hq, Hkv, hd, C, SMS)
    assert plan.splits > 1 and plan.phases > 1       # both folds take part
    got = _emulate(plan, torch.from_numpy(q), _flat(kq), _flat(vq),
                   torch.from_numpy(np.array(ks)),
                   torch.from_numpy(np.array(vs)), kv_lens, hd ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kv", [(0, 1), (5, 0)])
def test_k4_walk_empty_and_one_token_rows(kv):
    """kv_len 0 gives zeros (l == 0); a single token gives its V row, scaled
    by its scale, whatever split and phase take it."""
    B, Hq, Hkv, hd, C = 2, 4, 2, 32, 64
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((B, Hq, 1, hd)).astype(np.float32))
    k = torch.from_numpy(rng.integers(-127, 128, (B, C, Hkv * hd), dtype=np.int8))
    v = torch.from_numpy(rng.integers(-127, 128, (B, C, Hkv * hd), dtype=np.int8))
    ks = torch.from_numpy(rng.uniform(0.01, 0.02, (B, Hkv, C)).astype(np.float32))
    vs = torch.from_numpy(rng.uniform(0.01, 0.02, (B, Hkv, C)).astype(np.float32))
    plan = tattn.k4_plan(B, Hq, Hkv, hd, C, SMS)
    got = _emulate(plan, q, k, v, ks, vs, np.array(kv), hd ** -0.5)
    ref = tattn._decode_attention_q8_plain(q, k, v, ks, vs, sm_scale=hd ** -0.5,
                                           kv_lens=torch.tensor(kv))
    for b in range(B):
        if kv[b] == 0:
            assert not got[b].abs().max()
        else:
            np.testing.assert_allclose(got[b].numpy(), ref[b].numpy(),
                                       atol=TOL, rtol=TOL)
    assert math.isfinite(float(got.abs().max()))
