"""K9 (the fused int8 decode-layer kernels) as it is laid out on the card,
checked on the CPU: `k9_plan` (the persistent row ranges of both phases, the
ring of bulk copies, shared memory), the fragments of the tensor-core
routes, the conversions that replace I2F, the W8A8 slot maxima, and the
kernels' summation orders against the JAX functions.

The integer and float steps of the kernel are emulated with torch ops on
32-bit values (IEEE f32, round to nearest even, as the card computes them):
they must give exactly the twin's codes and scales. The summation orders
are emulated in f32 and held to the JAX references of
scripts/decode_mlp_experiment.py at 2e-5 of the output scale: the same f32
products summed in another order. No Pallas kernel runs here.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoglamm_torch.experiments import decode_mlp as dm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import decode_mlp_experiment as jdm  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 2e-5
SMS = 132                                   # an H100's SMs
C = dm.k9_constants()
ROWS = C["GROUP_ROWS"]

# (entry, N or I, K, D, group): Phi-3's decode layer, Llama-3.1-8B's, and the
# narrow cases of chip_smoke.py's K9 phase (N and I no multiples of 1024)
SHAPES = [("norm_matmul", 9216, 3072, 0, 0), ("norm_matmul", 6144, 4096, 0, 0),
          ("norm_matmul", 1000, 256, 0, 0), ("matmul_residual", 3072, 3072, 0, 0),
          ("matmul_residual", 256, 256, 0, 0), ("mlp", 8192, 3072, 3072, 0),
          ("mlp", 14336, 4096, 4096, 0), ("mlp", 1536, 256, 256, 0),
          ("mlp", 768, 256, 256, 0), ("mlp_w8a8", 8192, 3072, 3072, 1024),
          ("mlp_w8a8", 14336, 4096, 4096, 1024), ("mlp_w8a8", 1536, 256, 256, 512),
          ("mlp_w8a8", 768, 256, 256, 1024)]


def _plan(entry, M, N, K, D, group):
    return dm.k9_plan(entry, M, N, K, D, SMS, group or dm.W8A8_GROUP)


def _regions(p):
    """Bytes of the scales-and-residual, sums and W8A8 regions, as the
    kernel lays them out."""
    two = p.entry in dm.ENTRIES[2:]
    rmax1, rmax2 = -(-p.N // p.ctas), -(-p.D // p.ctas)
    rres = rmax2 if two else rmax1
    sc = 4 * (2 * rmax1 + rmax2 + C["MMA_TILE"] * rres)
    groups = p.N // p.group if p.group else 0
    red = 2 * 4 * (max(C["CONS_WARPS"], groups) * 128 if p.mma else ROWS * C["MMA_TILE"])
    loc = 4 * (rmax1 * C["MMA_TILE"] + C["MMA_TILE"] * groups) if p.group else 0
    return sc, red, loc


@pytest.mark.parametrize("entry,N,K,D,group", SHAPES)
def test_k9_plan_covers_rows_and_fits(entry, N, K, D, group):
    two, w8 = entry in dm.ENTRIES[2:], entry == "mlp_w8a8"
    for M in range(1, C["MMA_TILE"] + 1):
        p = _plan(entry, M, N, K, D, group)
        assert p.mt == (M if M <= C["ROWS_MAX_M"] else C["MMA_TILE"])
        for phase, n in ((1, N), (2, D if two else 0)):
            shares = [p.rows(phase, c) for c in range(p.ctas)]
            counts = [k for _, k in shares]
            assert max(counts) - min(counts) <= 1
            assert [r for r0, k in shares for r in range(r0, r0 + k)] == list(range(n))
        f = p.fields()
        assert len(f) == 24 and f[18:22] == divmod(N, p.ctas) + divmod(p.D, p.ctas)
        assert p.ctas == min(SMS, max(N, p.D))
        # the regions the C entry checks, in order, aligned, inside the SM
        sc, red, loc = _regions(p)
        assert C["BARRIER_BYTES"] <= p.x_off and 16 * p.stages <= C["BARRIER_BYTES"]
        assert p.x_off + M * p.xstride <= p.sc_off
        assert p.sc_off + sc <= p.red_off and p.red_off + red <= p.loc_off
        assert p.loc_off + loc <= p.ring_off
        assert p.smem == p.ring_off + p.stages * ROWS * p.rstride <= C["SMEM_MAX"]
        assert p.x_off % 16 == p.sc_off % 16 == p.red_off % 16 == p.loc_off % 16 == 0
        assert p.ring_off % 128 == 0 and p.rstride % 128 == 16
        assert C["MIN_STAGES"] <= p.stages <= C["MAX_STAGES"]
        # x / h rows: 16 (W8A8) or 32 (bf16) mod 128 bytes apart on the mma
        # route, so that the fragment loads of rows g = 0..7 hit 32 banks
        if p.mma:
            assert p.xstride % 128 == (16 if w8 else 32)
        need = p.acols if w8 else (2 * p.acols if p.mma else 4 * -(-p.acols // 512) * 512)
        assert p.xstride >= need
        assert 16 <= p.kseg1 <= C["KSEG"] and p.kseg1 % 16 == 0
        assert p.nseg1 == -(-K // p.kseg1) and p.rstride >= p.kseg1
        if two:
            assert p.kseg2 % 16 == 0 and p.nseg2 == -(-N // p.kseg2)
            assert 1 <= p.segs_pass <= p.nseg2 and p.rstride >= p.kseg2
            assert p.acols >= max(K, min(N, p.segs_pass * p.kseg2))
        if w8:
            grp = min(group, N)
            assert grp % p.kseg2 == 0 and p.segs_group == grp // p.kseg2
            assert p.kseg1 <= p.kseg2             # no half-empty ring slots
            # the kernel divides by the group by multiplying (`fast_div`)
            n = np.arange(N, dtype=np.uint64)
            np.testing.assert_array_equal(
                (n * np.uint64(f[23] % (1 << 32))) >> np.uint64(32), n // np.uint64(grp))


def test_k9_plan_routes_and_passes():
    """1 to 3 rows on the CUDA cores, 4 and more on the tensor cores; h of
    Llama's MLP at 8 rows in passes; Phi-3's in one."""
    assert [_plan("mlp", M, 8192, 3072, 3072, 0).mma for M in range(1, 9)] == \
        [False] * 3 + [True] * 5
    assert _plan("mlp", 8, 8192, 3072, 3072, 0).segs_pass == \
        _plan("mlp", 8, 8192, 3072, 3072, 0).nseg2
    llama = _plan("mlp", 8, 14336, 4096, 4096, 0)
    assert llama.segs_pass < llama.nseg2 and llama.acols < 14336


def test_k9_plan_refuses_what_does_not_fit():
    for args in (("norm_matmul", 0, 9216, 3072, 0, 0),
                 ("norm_matmul", 9, 9216, 3072, 0, 0),       # more than 8 rows
                 ("norm_matmul", 8, 4096, 65536, 0, 0),      # x fills the SM
                 ("norm_matmul", 1, 9216, 3080, 0, 0),       # rows of 16 bytes
                 ("mlp_w8a8", 4, 1536, 256, 256, 640),       # group divides no I
                 ("entry", 1, 64, 64, 0, 0)):
        with pytest.raises(ValueError):
            _plan(*args)


def _copies(p):
    """The producer's bulk copies, CTA by CTA, in issue order (the walk of
    `k9_kernel`'s producer warp): (cta, stage, slot, phase, weight row, byte
    offset, bytes, shared-memory offset)."""
    two = p.entry in dm.ENTRIES[2:]
    gr1 = ROWS // 2 if two else ROWS
    out = []
    for cta in range(p.ctas):
        stage = 0
        r1, n1 = p.rows(1, cta)
        for grp in range(-(-n1 // gr1)):
            for seg in range(p.nseg1):
                off = seg * p.kseg1
                for lane in range(ROWS):
                    j = grp * gr1 + (lane % gr1)
                    if j < n1:
                        row = (p.N if two and lane >= gr1 else 0) + r1 + j
                        out.append((cta, stage, stage % p.stages, 1, row, off,
                                    min(p.kseg1, p.K - off),
                                    p.ring_off + ((stage % p.stages) * ROWS + lane) * p.rstride))
                stage += 1
        r2, n2 = p.rows(2, cta) if two else (0, 0)
        for grp in range(-(-n2 // ROWS)):
            for seg in range(p.nseg2):
                off = seg * p.kseg2
                for lane in range(ROWS):
                    j = grp * ROWS + lane
                    if j < n2:
                        out.append((cta, stage, stage % p.stages, 2, r2 + j, off,
                                    min(p.kseg2, p.N - off),
                                    p.ring_off + ((stage % p.stages) * ROWS + lane) * p.rstride))
                stage += 1
    return out


@pytest.mark.parametrize("entry,N,K,D,group", [s for s in SHAPES if s[1] <= 9216])
def test_k9_copies_stream_every_weight_byte_once(entry, N, K, D, group):
    """Every byte of the weights is copied once (the gate and up rows in the
    same stages), and each copy lands inside its ring slot."""
    two = entry in dm.ENTRIES[2:]
    for M in (1, 8):
        p = _plan(entry, M, N, K, D, group)
        w1 = np.zeros(2 * N if two else N, dtype=np.int64)
        w2 = np.zeros(D, dtype=np.int64)
        for cta, stage, slot, phase, row, off, size, dst in _copies(p):
            assert off % 16 == dst % 16 == size % 16 == 0 and size > 0
            assert p.ring_off <= dst and dst + size <= p.smem
            assert dst + size <= p.ring_off + (slot * ROWS + ROWS) * p.rstride
            (w1 if phase == 1 else w2)[row] += size
        np.testing.assert_array_equal(w1, K)
        np.testing.assert_array_equal(w2, N if two else 0)


# ---------------------------------------------------------------------------
# fragments and conversions
# ---------------------------------------------------------------------------
def test_k9_s8_fragments_pair_weight_and_x_codes():
    """mma.sync m16n8k32 (and the m16n8k16 of a last 16-byte chunk) as the
    W8A8 tensor-core route loads them: lane (g, t) takes bytes 4t.. and 16 +
    4t.. of weight rows g and g + 8 and of x row g. Rebuilding A and B from
    the lanes' registers by the PTX fragment layout must give D = W . X^T
    over the chunk's bytes, so A's and B's k name the same byte."""
    rng = np.random.default_rng(0)
    w = rng.integers(-127, 128, (16, 32))
    x = rng.integers(-127, 128, (8, 32))
    for kdim in (32, 16):
        A = np.zeros((16, kdim), np.int64)
        B = np.zeros((kdim, 8), np.int64)
        for lane in range(32):
            g, t = lane // 4, lane % 4
            regs_a = [w[g, 4 * t:4 * t + 4], w[g + 8, 4 * t:4 * t + 4]]
            regs_b = [x[g, 4 * t:4 * t + 4]]
            if kdim == 32:
                regs_a += [w[g, 16 + 4 * t:20 + 4 * t], w[g + 8, 16 + 4 * t:20 + 4 * t]]
                regs_b += [x[g, 16 + 4 * t:20 + 4 * t]]
            # PTX: a0 (row g), a1 (row g + 8): k = 4t + i; a2, a3: k = 16 + 4t + i;
            # b0: k = 4t + i, b1: k = 16 + 4t + i, column g
            for r, (row, kb) in enumerate(((g, 0), (g + 8, 0), (g, 16), (g + 8, 16))[:len(regs_a)]):
                A[row, kb + 4 * t:kb + 4 * t + 4] = regs_a[r]
            for r, kb in enumerate((0, 16)[:len(regs_b)]):
                B[kb + 4 * t:kb + 4 * t + 4, g] = regs_b[r]
        np.testing.assert_array_equal(A @ B, w[:, :kdim] @ x[:, :kdim].T)


def _bf16_bits(v):
    return int(torch.tensor([v], dtype=torch.float32).bfloat16().view(torch.int16)) & 0xFFFF


def test_k9_bf16_fragments_pair_weights_and_staged_x():
    """The bf16 tensor-core route converts weight bytes 4t..4t+3 into the
    pairs (b0, b2), (b1, b3) (`int8_to_bf16x2`) and stages x with each 4 k
    as (0, 2, 1, 3) (`put8_bf16`), so the 8-byte load at k = 4t gives the B
    pairs of the same k."""
    xs = [float(k + 1) for k in range(8)]            # x[k] = k + 1
    # put8_bf16: o.x = (v0, v2), o.y = (v1, v3), o.z = (v4, v6), o.w = (v5, v7)
    staged = [xs[0], xs[2], xs[1], xs[3], xs[4], xs[6], xs[5], xs[7]]
    for t in range(2):                               # k = 4t .. 4t + 3
        b_x, b_y = staged[4 * t:4 * t + 2], staged[4 * t + 2:4 * t + 4]
        a02, a13 = (4 * t, 4 * t + 2), (4 * t + 1, 4 * t + 3)
        assert [xs[k] for k in a02] == b_x and [xs[k] for k in a13] == b_y
    assert _bf16_bits(1.0) == 0x3F80                  # the packing's bit order


def test_k9_cuda_route_x_layout_is_conflict_free():
    """The CUDA-core route's f32 x (K5's permutation, pass-local): a
    bijection onto the row, and the 32 lanes' 16-byte loads of one
    quarter-chunk fall on consecutive addresses from any segment start."""
    K = 3072
    k = np.arange(K)
    ca, q, e = k // 16, (k % 16) // 4, k % 4
    pos = (ca // 32) * 512 + 128 * q + 4 * (ca % 32) + e
    assert len(set(pos.tolist())) == K and pos.max() < 4 * -(-K // 512) * 512 // 4
    for acol in (0, 1024, 2048, 768):
        lanes = ((acol // 16 + np.arange(32)) // 32) * 512 + 4 * ((acol // 16 + np.arange(32)) % 32)
        banks = (lanes % 32) // 4                      # 16-byte bank quads
        for start in range(0, 32, 8):                  # 8 lanes a wavefront
            assert len(set(banks[start:start + 8].tolist())) == 8


def _f32(bits):
    return torch.tensor(bits, dtype=torch.int64).to(torch.int32).view(torch.float32)


def _bits(f):
    return f.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _s32_to_f32(s):
    """The kernel's exact int -> float: hi = s >> 16 and lo = s & 0xFFFF by
    magic numbers, one rounding of hi * 65536 + lo."""
    hi = _f32((0x4B400000 + (s >> 16)).tolist()) - 12582912.0
    lo = _f32((0x4B000000 | (s & 0xFFFF)).tolist()) - 8388608.0
    return hi * 65536.0 + lo


def test_k9_s32_to_f32_is_the_correctly_rounded_float():
    rng = np.random.default_rng(1)
    s = np.concatenate([rng.integers(-2**31, 2**31, 20000),
                        [0, 1, -1, 2**24 + 1, -(2**24 + 1), 2**31 - 1, -2**31,
                         65535, 65536, -65536, -65537, 127 * 127 * 14336]])
    got = _s32_to_f32(torch.tensor(s, dtype=torch.int64))
    np.testing.assert_array_equal(got.numpy(), s.astype(np.float32))


def _quant_codes(v, s):
    """The kernel's `quant_word`: v * (1/s), the exact quotient only within
    1e-4 of a half, clipped, rounded by adding 1.5 * 2^23; the code is the
    sum's low byte. v: f32 [..., C]; s: f32 broadcastable."""
    rs = torch.ones_like(s) / s
    t = v * rs
    r = t + 12582912.0
    near = ((t - (r - 12582912.0)).abs() - 0.5).abs() < 1e-4
    t = torch.where(near, v / s, t).clamp(-127.0, 127.0)
    byte = _bits(t + 12582912.0) & 0xFF
    return (byte - 256 * (byte >= 128)).to(torch.int8)


def test_k9_quantisation_gives_the_twin_codes():
    """Codes by the magic-number rounding (no F2I) equal round-half-even of
    the twin's v / s, also on exact ties and where v * (1/s) and v / s fall
    on either side of a half."""
    rng = np.random.default_rng(2)
    v = torch.from_numpy(rng.standard_normal((64, 4096)).astype(np.float32))
    _, s = dm._quant_rows_f32(v)
    ties = torch.tensor([[(k + 0.5) * 0.25 for k in range(-127, 127)]], dtype=torch.float32)
    ts = torch.full((1, 1), 0.25)
    for vals, scale in ((v, s), (ties, ts), (v * 1e-3, s * 1e-3)):
        want = torch.clamp(torch.round(vals / scale), -127, 127).to(torch.int8)
        assert torch.equal(_quant_codes(vals, scale), want)
    # a half-way quotient that v * (1/s) misses: the exact path must decide
    near = torch.tensor([[2.5 * 0.1, 3.5 * 0.3, -6.5 * 0.7]], dtype=torch.float32)
    sc = torch.tensor([[0.1, 0.3, 0.7]], dtype=torch.float32)
    assert torch.equal(_quant_codes(near, sc),
                       torch.round(near / sc).to(torch.int8))


# ---------------------------------------------------------------------------
# the W8A8 slot maxima and the summation orders
# ---------------------------------------------------------------------------
def _layer(M, K, I, D, seed):
    rng = np.random.default_rng(seed)

    def codes(*shape):
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))

    def scales(n, fan):
        return torch.from_numpy(((0.5 + rng.random(n)) / (73.0 * fan ** 0.5)).astype(np.float32))

    return dict(x=torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)),
                nw=torch.from_numpy((1 + 0.1 * rng.standard_normal(K)).astype(np.float32)),
                wgu=codes(2 * I, K), sgu=scales(2 * I, K), wd=codes(D, I),
                sd=scales(D, I), w=codes(D, K), s=scales(D, K),
                res=torch.from_numpy(rng.standard_normal((M, D)).astype(np.float32)))


@pytest.mark.parametrize("M,I,group", [(1, 8192, 1024), (8, 8192, 1024),
                                       (4, 1536, 512), (8, 768, 1024),
                                       (3, 14336, 1024)])
def test_k9_slot_maxima_give_the_twin_group_scales(M, I, group):
    """Phase 1 leaves each CTA's largest |h| per (row, group) it covers in
    its slot; after the barrier every CTA takes the maximum over the slots
    of the CTAs covering the group. The resulting scales and codes are the
    twin's bit for bit."""
    K = 256
    L = _layer(M, K, I, K, seed=M + I)
    p = _plan("mlp_w8a8", M, I, K, K, group)
    _, tr = dm._mlp_w8a8_plain(L["x"], L["nw"], L["wgu"], L["sgu"], L["wd"],
                               L["sd"], 1e-5, group, trace=True)
    grp = min(group, I)
    # h as the twin computes it
    gi, ui = tr.gu[:, :I].float(), tr.gu[:, I:].float()
    g = gi * (tr.xs[:, None] * L["sgu"][:I])
    u = ui * (tr.xs[:, None] * L["sgu"][I:])
    h = g * torch.sigmoid(g) * u
    G = I // grp
    slots = torch.full((p.ctas, M, G), float("nan"))
    for c in range(p.ctas):
        r0, n = p.rows(1, c)
        for gq in range(r0 // grp, (r0 + n - 1) // grp + 1 if n else 0):
            lo, hi = max(r0, gq * grp), min(r0 + n, (gq + 1) * grp)
            slots[c, :, gq] = h[:, lo:hi].abs().amax(-1)
    amax = torch.zeros(M, G)
    for gq in range(G):
        for c in range(p.ctas):
            r0, n = p.rows(1, c)
            if n and r0 < (gq + 1) * grp and r0 + n > gq * grp:
                amax[:, gq] = torch.maximum(amax[:, gq], slots[c, :, gq])
    assert not torch.isnan(amax).any()
    hs = torch.clamp(amax, min=1e-6) * (1.0 / 127.0)
    assert torch.equal(hs, tr.hs)
    hq = _quant_codes(h, hs.repeat_interleave(grp, dim=1))
    assert torch.equal(hq, tr.hq)
    # and the JAX package's `_quant_rows_f32` on each group of the same h
    for gq in range(G):
        q, s = jdm._quant_rows_f32(jnp.asarray(h[:, gq * grp:(gq + 1) * grp].numpy()))
        np.testing.assert_array_equal(np.asarray(q), hq[:, gq * grp:(gq + 1) * grp].numpy())
        np.testing.assert_array_equal(np.asarray(s)[:, 0], hs[:, gq].numpy())


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _route_dots(x, q, kseg, mma):
    """x [M, C] f32 . q [N, C] codes^T in the order of K9's route: CUDA
    cores (a lane takes 16-byte chunks lane, lane + 32, ... of each segment,
    sums each chunk as ((t0 + t1) + (t2 + t3)) over four FMA chains of 4
    products, accumulates its chunks in order, and the lanes meet in a
    butterfly), or the tensor cores (warp w takes chunks w, w + 16, ... of
    each segment and accumulates them in order; the 16 warps add in order)."""
    M, Cc = x.shape
    nch = Cc // 16
    xw = x.view(M, 1, nch, 4, 4)
    qw = q.float().view(1, -1, nch, 4, 4)
    local = torch.cat([torch.arange(min(kseg, Cc - off) // 16)
                       for off in range(0, Cc, kseg)])
    if mma:
        chunk = (xw * qw).sum((-1, -2))
        warps = torch.zeros(16, M, q.shape[0])
        for gc in range(nch):
            warps[local[gc] % 16] += chunk[..., gc]
        total = torch.zeros(M, q.shape[0])
        for w in range(16):
            total = total + warps[w]
        return total
    prod = xw * qw                                    # [M, N, nch, 4 words, 4]
    t = prod[..., 0]
    for j in range(1, 4):
        t = _fma(xw[..., j].expand_as(t), qw[..., j].expand_as(t), t)
    chunk = (t[..., 0] + t[..., 1]) + (t[..., 2] + t[..., 3])
    lanes = torch.zeros(32, M, q.shape[0])
    for gc in range(nch):
        lanes[local[gc] % 32] += chunk[..., gc]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[torch.arange(32) ^ off]
    return lanes[0]


def _rms(x, nw):
    r = torch.rsqrt((x * x).sum(-1, keepdim=True) / x.shape[-1] + 1e-5)
    return x * r * nw


@pytest.mark.parametrize("mma", [False, True])
def test_k9_summation_orders_match_jax(mma):
    """The three bf16 entries' sums in f32 in each route's order (segments
    of the plan's size, h in the same order) against the JAX functions at
    2e-5 of the output scale."""
    M, K, I = (8, 3072, 2560) if mma else (2, 3072, 2560)
    L = _layer(M, K, I, K, seed=7)
    p = _plan("mlp", M, I, K, K, 0)
    assert p.kseg1 < K and p.kseg2 < I           # several segments a row
    j = {k: jnp.asarray(v.numpy()) for k, v in L.items()}
    x, nw = L["x"], L["nw"]

    def close(got, ref):
        ref = np.asarray(ref, np.float32)
        assert np.abs(got.numpy() - ref).max() <= TOL * max(1.0, np.abs(ref).max())

    # norm_matmul: the [D, K] weight as the qkv rows
    pn = _plan("norm_matmul", M, K, K, 0, 0)
    y = _route_dots(_rms(x, nw), L["w"], pn.kseg1, mma) * L["s"]
    close(y, jdm._norm_matmul_ref(j["x"], j["nw"], j["w"].T, j["s"], 1e-5))
    # matmul_residual: the JAX entry on the CPU is its `jnp.dot` branch; in
    # f32 both round nothing
    y = _route_dots(x, L["w"], pn.kseg1, mma) * L["s"] + L["res"]
    close(y, jdm.matmul_residual_int8(j["x"], j["w"].T, j["s"], j["res"]))
    # mlp: gate and up in one stage, then h . W_down and the residual
    gu = _route_dots(_rms(x, nw), L["wgu"], p.kseg1, mma) * L["sgu"]
    g, u = gu[:, :I], gu[:, I:]
    h = g * torch.sigmoid(g) * u
    y = _route_dots(h, L["wd"], p.kseg2, mma) * L["sd"] + x
    close(y, jdm._fused_mlp_ref(j["x"], j["nw"], j["wgu"].T, j["sgu"],
                                j["wd"].T, j["sd"], 1e-5))
