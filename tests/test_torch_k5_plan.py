"""K5 (the dequantising decode GEMV) and K3 (the row norms) as they are laid
out on the card, checked on the CPU: K5's conversions, its plan (the
persistent grid, the ring of bulk copies, shared memory) and its summation
order, and K3's persistent row assignment.

The conversions are emulated with torch integer ops and `.view` as float:
they must give exactly the codes of the JAX package (`_unpack4` and the
int8 cast) for all 256 byte values. The summation orders are emulated in
f32 and held to the JAX references (`_dequant_matmul_ref`,
`_dequant4_weights` + dot) at 2e-5 of the output scale: the same f32
products summed in another order, as the JAX tests of the same kernels
state (tests/test_ops.py). No Pallas kernel runs here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoglamm_tpu.ops import quant as jq
from videoglamm_torch.ops import norms
from videoglamm_torch.ops import quant as tq
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 2e-5
BYTES = torch.arange(256, dtype=torch.int32)         # every byte value
CODES8 = BYTES.to(torch.uint8).view(torch.int8)
SMS = 132                                             # an H100's SMs

# (N, K) of the five decode products of Phi-3 and the tests' odd case
SHAPES = [(9216, 3072), (3072, 3072), (16384, 3072), (3072, 8192),
          (32065, 3072), (193, 128)]


def _f32(bits):
    return bits.to(torch.int32).view(torch.float32)


def _bf16(bits16):
    return bits16.to(torch.int16).view(torch.bfloat16).float()


def _byte_perm(a, b, sel: int):
    """CUDA's __byte_perm on int64 tensors holding 32-bit words."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + \
          [(b >> (8 * i)) & 0xFF for i in range(4)]
    out = torch.zeros_like(a)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def test_int8_magic_numbers_give_the_codes():
    want = np.asarray(jnp.asarray(CODES8.numpy()).astype(jnp.float32))
    # f32: xor 0x80, the byte in the low mantissa of 0x4B000000, - (2^23 + 128)
    u = BYTES ^ 0x80
    got = _f32(0x4B000000 | u) - 8388736.0
    np.testing.assert_array_equal(got.numpy(), want)
    # bf16: low 7 bits in the mantissa of 128, minus 128 or 256 by the sign bit
    m = _bf16((BYTES & 0x7F) | 0x4300)
    s = _bf16((BYTES & 0x80) | 0x4300)
    np.testing.assert_array_equal((m - s).numpy(), want)
    np.testing.assert_array_equal(
        (m.bfloat16() - s.bfloat16()).float().numpy(), want)   # exact in bf16


def test_nibble_magic_numbers_give_the_codes():
    lo_j, hi_j = (np.asarray(v) for v in jq._unpack4(jnp.asarray(CODES8.numpy())))
    lo_t, hi_t = tq._unpack4(CODES8)
    np.testing.assert_array_equal(lo_t.numpy(), lo_j)
    np.testing.assert_array_equal(hi_t.numpy(), hi_j)
    u = BYTES ^ 0x88
    # the CUDA-core route leaves the high nibble in place: 16 x its code
    np.testing.assert_array_equal((_f32(0x4B000000 | (u & 0xF0)) - 8388736.0)
                                  .numpy(), 16 * hi_j)
    for nib, want in ((u & 0xF, lo_j), ((u >> 4) & 0xF, hi_j)):
        np.testing.assert_array_equal((_f32(0x4B000000 | nib) - 8388616.0)
                                      .numpy(), want)
        b = _bf16(nib | 0x4300).bfloat16() - _bf16(torch.tensor(0x4308))\
            .bfloat16()
        np.testing.assert_array_equal(b.float().numpy(), want)


def _word(vals16):
    """Two 16-bit values per 32-bit word (the first in the low half)."""
    v = vals16.to(torch.int64) & 0xFFFF
    return v[0::2] | (v[1::2] << 16)


def _halves(words):
    return torch.stack([words & 0xFFFF, (words >> 16) & 0xFFFF], 1).flatten()


@pytest.mark.parametrize("int4", [False, True])
def test_mma_route_pairs_weights_and_x_alike(int4):
    """The tensor-core route converts a weight word into bf16 pairs in its
    own k order and stages x permuted with __byte_perm: k index by k index,
    the pairs of A and of B must name the same k. x is emulated with its
    k indices as the bf16 payload, with the selectors of the source."""
    n = 8 if int4 else 4                     # k a weight word holds
    ks = torch.arange(n)
    if int4:
        # p[i] = (nibble i, nibble i + 4); step 0: a0 = p0, a2 = p1; step 1: p2, p3
        a_pairs = [(i, i + 4) for i in range(4)]
        w = _word(ks)                            # x words (0,1) (2,3) (4,5) (6,7)
        staged = [_byte_perm(w[0], w[2], 0x5410), _byte_perm(w[0], w[2], 0x7632),
                  _byte_perm(w[1], w[3], 0x5410), _byte_perm(w[1], w[3], 0x7632)]
    else:
        a_pairs = [(0, 2), (1, 3)]               # p02, p13 of one word
        w = _word(ks)
        staged = [_byte_perm(w[0], w[1], 0x5410), _byte_perm(w[0], w[1], 0x7632)]
    b_pairs = [tuple(_halves(s.reshape(1)).tolist()) for s in staged]
    assert b_pairs == a_pairs
    assert sorted(k for p in a_pairs for k in p) == list(range(n))


def _plans(M, N, K):
    return [tq.k5_plan(M, N, K, g, SMS) for g in (0, 128)]


def _units(p, cta):
    """CUDA-core route: the CTA's units as (row, byte offset, bytes), in the
    order of their sums in shared memory (the walk of `gemv_rows_kernel`)."""
    r0, n = p.rows(cta)
    unit = tq.K5_UNIT[bool(p.group)]
    return [(r0 + r, off, min(unit, p.rowbytes - off))
            for r in range(n) for off in range(0, p.rowbytes, unit)]


def _copies(p, cta):
    """Tensor-core route: the CTA's bulk copies in issue order (the walk of
    `gemv_mma_kernel`'s producer warp): (stage, slot, source byte offset in
    the weight, destination byte offset in shared memory, bytes)."""
    r0, n = p.rows(cta)
    rows_a_stage = tq.K5_GROUP_ROWS
    out = []
    for i in range(-(-n // rows_a_stage) * p.nseg):
        grp, seg = divmod(i, p.nseg)
        off = seg * p.kseg
        size = min(p.kseg, p.rowbytes - off)
        slot = i % p.stages
        for r in range(min(rows_a_stage, n - grp * rows_a_stage)):
            row = r0 + grp * rows_a_stage + r
            out.append((i, slot, row * p.rowbytes + off,
                        p.ring_off + (slot * rows_a_stage + r) * p.rstride,
                        size))
    return out


@pytest.mark.parametrize("M", [1, 2, 3, 4, 8, 9, 64, 255])
@pytest.mark.parametrize("N,K", SHAPES)
def test_k5_plan_covers_rows_and_fits(M, N, K):
    for p in _plans(M, N, K):
        shares = [p.rows(c) for c in range(p.ctas)]
        counts = [n for _, n in shares]
        assert max(counts) - min(counts) <= 1
        covered = [r for r0, n in shares for r in range(r0, r0 + n)]
        assert covered == list(range(N))         # every row once, in order
        assert p.smem <= tq.K5_SMEM
        assert p.x_off % 16 == p.s_off % 16 == p.xstride % 16 == 0
        f = p.fields()
        assert len(f) == 23 and f[13:15] == divmod(N, p.ctas)
        assert f[20:] == (0, 0, 0)                # not the f32 tensor-core route
        assert f[19] == p.per_sm == (tq.K5_ROW_CTAS[0] if M == 1 else 1)
        # the kernel divides by multiplying (`fast_div`): exact over the
        # numerators it takes (units of a CTA; 32-k slices along a row)
        for d, mul, top in ((f[15], f[16], (-(-N // p.ctas) + 1) * max(f[15], 1)),
                            (f[17], f[18], K // 32 + 1)):
            if d > 1:
                n = np.arange(top, dtype=np.uint64)
                np.testing.assert_array_equal((n * np.uint64(mul % (1 << 32))) >> np.uint64(32),
                                              n // np.uint64(d))
        if M <= 8:
            assert p.m_tiles == 1                # one pass over the weights
        else:
            assert p.mt == 8 and p.m_tiles == -(-M // 8)
        assert p.mma == (M >= 4)
        if not p.mma:
            # x in f32 past its blocks of 32 chunks, then a sum a unit
            assert p.mt == M and p.xstride >= 4 * K
            assert p.s_off >= p.x_off + M * p.xstride
            units = max(len(_units(p, c)) for c in (0, p.ctas - 1))
            assert p.smem >= p.s_off + units * M * 4
            # the CTAs an SM fit beside each other
            per_sm = tq.K5_ROW_CTAS[M - 1]
            assert p.ctas == min(N, SMS * per_sm)
            assert per_sm * (p.smem + tq.K5_SMEM_CTA) <= tq.K5_SMEM_SM
            continue
        assert p.smem == p.ring_off + p.stages * tq.K5_GROUP_ROWS * p.rstride
        assert tq.K5_BARRIERS <= p.x_off < p.s_off <= p.red_off <= p.ring_off
        # the regions the C entry checks: 8 rows of x, the CTA's scales,
        # two 16 x 8 f32 sums a consumer warp
        scols = K // p.group if p.group else 1
        assert p.s_off >= p.x_off + 8 * p.xstride
        assert p.red_off >= p.s_off + -(-N // p.ctas) * scols * 4
        assert p.ring_off >= p.red_off + 2 * 4 * tq.K5_MMA_WARPS * 128
        assert 16 * p.stages <= tq.K5_BARRIERS
        assert p.red_off % 16 == p.ring_off % 128 == 0
        assert p.rstride % 128 == 16 and p.rstride >= p.kseg
        assert 3 <= p.stages <= tq.K5_MAX_STAGES
        # x rows clear of bank conflicts
        assert p.xstride >= 2 * K and p.xstride % 128 == (64 if p.group else 32)
        assert (p.kseg, p.nseg) == (min(p.rowbytes, tq.K5_SEGMENT),
                                    -(-p.rowbytes // min(p.rowbytes, tq.K5_SEGMENT)))


@pytest.mark.parametrize("N,K", SHAPES)
def test_k5_units_take_every_byte_once(N, K):
    """CUDA-core route: units of at most 1 KB (int8: 32 lanes x 2 vectors of
    16 bytes) or 512 bytes (int4: 32 x 1) cover every row once, and x's permuted f32 layout is a bijection that
    puts the lanes' loads of one quarter-chunk side by side."""
    for p in _plans(1, N, K):
        seen = np.zeros(N, dtype=np.int64)
        for c in range(p.ctas):
            for row, off, size in _units(p, c):
                assert off % tq.K5_UNIT[bool(p.group)] == 0 and size % 16 == 0
                assert 0 < size <= tq.K5_UNIT[bool(p.group)]
                seen[row] += size
        np.testing.assert_array_equal(seen, p.rowbytes)
        kpc = 32 if p.group else 16
        k = np.arange(K)
        ca, q, e = k // kpc, (k % kpc) // 4, k % 4
        pos = (ca // 32) * 32 * kpc + 128 * q + 4 * (ca % 32) + e
        assert len(set(pos.tolist())) == K and pos.max() < p.xstride // 4
        lanes = pos[(q == 1) & (e == 0)][:32]  # quarter-chunk 1 of 32 chunks
        if len(lanes) == 32:
            np.testing.assert_array_equal(np.diff(lanes), 4)


@pytest.mark.parametrize("N,K", SHAPES)
def test_k5_copies_stream_every_byte_once(N, K):
    for M in (4, 8):
        for p in _plans(M, N, K):
            seen = np.zeros(N, dtype=np.int64)
            slots = {}
            for c in range(p.ctas):
                r0, n = p.rows(c)
                last = None
                for stage, slot, src, dst, size in _copies(p, c):
                    assert src % 16 == dst % 16 == size % 16 == 0 and size > 0
                    assert p.ring_off <= dst and dst + size <= p.smem
                    assert slot == stage % p.stages
                    assert last is None or stage >= last
                    last = stage
                    row, off = divmod(src, p.rowbytes)
                    assert r0 <= row < r0 + n and off + size <= p.rowbytes
                    seen[row] += size
                    slots.setdefault((c, dst), set()).add(slot)
            np.testing.assert_array_equal(seen, p.rowbytes)
            assert all(len(s) == 1 for s in slots.values())


def test_k5_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        tq.k5_plan(8, 4096, 65536, 0, SMS)       # x alone fills shared memory


def _weights(N, K, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((8, K)).astype(np.float32)
    w = (rng.standard_normal((N, K)) * K ** -0.5).astype(np.float32)
    return x, w


def _k5_int8_order(x, q, scale, mma: bool):
    """K5's int8 sums. CUDA cores: each lane sums the 16 products of each
    of its two 16-byte vectors of a 1 KB unit, four words apart, the 32
    lanes of a unit meet in a butterfly, and a row's units add in order. Tensor cores: the 8
    warps each sum the 16-byte chunks c = warp, warp + 8, ... of every 1 KB
    segment, then the warps add in order. The per-channel scale last."""
    M, K = x.shape
    nch = K // 16
    xw, qw = x.view(M, nch, 4, 4), q.float().view(-1, nch, 4, 4)
    words = torch.einsum("mcwk,ncwk->mncw", xw, qw)
    chunk = (words[..., 0] + words[..., 1]) + (words[..., 2] + words[..., 3])
    c = torch.arange(nch)
    if mma:
        owner = (c % (tq.K5_SEGMENT // 16)) % 8
        total = chunk[..., owner == 0].sum(-1)
        for o in range(1, 8):
            total = total + chunk[..., owner == o].sum(-1)
        return total * scale
    total = torch.zeros(chunk.shape[:2])
    for unit in range(-(-nch // 64)):
        part = torch.zeros(*chunk.shape[:2], 64)
        got = chunk[..., unit * 64:(unit + 1) * 64]
        part[..., :got.shape[-1]] = got
        lanes = part[..., :32] + part[..., 32:]
        for off in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[..., torch.arange(32) ^ off]
        total = total + lanes[..., 0]
    return total * scale


@pytest.mark.parametrize("N,K", [(193, 128), (96, 3072), (40, 8192)])
@pytest.mark.parametrize("mma", [False, True])
def test_k5_int8_summation_order_matches_jax(N, K, mma):
    x, w = _weights(N, K, 11)
    qj, sj = jq.quantize_int8(jnp.asarray(w.T))
    ref = np.asarray(jq._dequant_matmul_ref(jnp.asarray(x), qj, sj))
    q, s = tq.quantize_int8(torch.from_numpy(w))
    xt = torch.from_numpy(x)
    got = _k5_int8_order(xt, q, s, mma)
    scale = max(1.0, np.abs(ref).max())
    assert np.abs(got.numpy() - ref).max() <= TOL * scale
    plain = tq._dequant_matmul_plain(xt, q, s)
    assert (got - plain).abs().max().item() <= TOL * scale


def _k5_int4_order(x, packed, scales, group):
    """K5's int4 sums: x . nibbles over each 32-k slice of a row in f32,
    times that slice's group scale, summed over the slices (the Pallas body
    scales every weight first)."""
    lo, hi = tq._unpack4(packed)
    N, K2 = packed.shape
    q = torch.stack([lo, hi], dim=2).view(N, 2 * K2).float()
    nsl = 2 * K2 // 32
    part = torch.einsum("msk,nsk->mns", x.float().view(-1, nsl, 32),
                        q.view(N, nsl, 32))
    s = scales.float().repeat_interleave(group // 32, dim=1)
    return (part * s).sum(-1)


@pytest.mark.parametrize("N,K,group", [(193, 128, 128), (96, 3072, 128),
                                       (40, 8192, 128), (64, 256, 64)])
def test_k5_int4_summation_order_matches_jax(N, K, group):
    """32-k slices summed in f32, each times its group scale once."""
    x, w = _weights(N, K, 12)
    pj, sj = jq.quantize_int4(jnp.asarray(w.T), group)
    wj = jq._dequant4_weights(pj, sj, group, jnp.float32)
    ref = np.asarray(jnp.dot(jnp.asarray(x), wj))
    p, s = tq.quantize_int4(torch.from_numpy(w), group)
    np.testing.assert_array_equal(p.numpy(), np.asarray(pj).T)
    xt = torch.from_numpy(x)
    got = _k5_int4_order(xt, p, s, group)
    scale = max(1.0, np.abs(ref).max())
    assert np.abs(got.numpy() - ref).max() <= TOL * scale
    plain = tq._dequant4_matmul_plain(xt, p, s, group)
    assert (got - plain).abs().max().item() <= TOL * scale


@pytest.mark.parametrize("n_rows,d,elt", [
    (3391, 3072, 2), (4100, 1408, 2), (9232, 1024, 2), (131072, 256, 4),
    (37, 144, 2), (37, 1152, 2), (5, 3072, 2), (100, 256, 2)])
def test_k3_persistent_programs_take_every_row_once(n_rows, d, elt):
    plan = norms.k3_plan(n_rows, d, elt, SMS)
    assert plan["block_d"] >= d and plan["num_warps"] in (1, 2, 4, 8)
    assert plan["rows"] == 1 if d > 1024 else plan["rows"] * plan["block_d"] \
        <= norms.K3_BLOCK_ELEMS
    assert plan["programs"] <= SMS * norms.K3_WARPS_PER_SM // plan["num_warps"]
    rows = [r for pid in range(plan["programs"])
            for r in norms.k3_rows(plan, n_rows, pid)]
    assert sorted(rows) == list(range(n_rows))


# ---------------------------------------------------------------------------
# the f32 tensor-core route: x split into three bf16 planes, wgmma over them
# ---------------------------------------------------------------------------
def _split3(x):
    """f32 x -> its three bf16 planes (as f32), as the kernel's splitter
    computes them: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid),
    each rounded to nearest even."""
    hi = x.bfloat16().float()
    r = x - hi
    mid = r.bfloat16().float()
    return hi, mid, (r - mid).bfloat16().float()


def test_f32_x_splits_exactly_into_three_bf16_planes():
    """hi + mid + lo == x bit for bit for every f32 of magnitude 2^-110 and
    more (below bf16's overflow: |x| < 2^128 (1 - 2^-9) rounds to a finite
    hi): random values over that range and the edges, powers of two, values
    at and beside a bf16 rounding tie, large values, tiny values with all 24
    bits set. Below 2^-110 lo falls among bf16's subnormals (steps of
    2^-133) and may round: the split then misses x by at most 2^-134, which
    moves a product with a code (|c| <= 128) by under 1e-38."""
    rng = np.random.default_rng(0)
    n = 1 << 20
    e = rng.uniform(-110, 126, n)
    x = (rng.choice([-1.0, 1.0], n) * rng.uniform(1, 2, n) * 2.0 ** e).astype(np.float32)
    p2 = 2.0 ** np.arange(-110, 128, dtype=np.float64)
    ulp = 2.0 ** -23
    ties = np.array([(1 + k * 2.0 ** -8 + 2.0 ** -9 + d * ulp) * 2.0 ** s
                     for k in (0, 1, 127) for d in (-1, 0, 1)
                     for s in (-100, -3, 0, 7, 100)])
    large = np.array([1e31, 3e37, 1e38, 3.3e38, 65504.0, 1.7e38])
    tiny = np.array([(2 - 2.0 ** -23) * 2.0 ** -110, 2.0 ** -110 * 1.5,
                     (1 + 2.0 ** -23) * 2.0 ** -109])
    edges = np.concatenate([p2, ties, large, tiny]).astype(np.float32)
    for v in (torch.from_numpy(x), torch.from_numpy(np.concatenate([edges, -edges]))):
        hi, mid, lo = _split3(v)
        assert torch.isfinite(hi).all()
        assert torch.equal(hi.double() + mid.double() + lo.double(), v.double())
        # every plane is a bf16 value, and the f32 sum in the kernel's order too
        for pl in (hi, mid, lo):
            assert torch.equal(pl.bfloat16().float(), pl)
        assert torch.equal((hi + mid) + lo, v)
    # below 2^-110: within 2^-134 of x
    small = torch.from_numpy((rng.uniform(1, 2, 4096) * 2.0 ** rng.uniform(
        -149, -110, 4096)).astype(np.float32))
    hi, mid, lo = _split3(small)
    miss = (hi.double() + mid.double() + lo.double() - small.double()).abs()
    assert miss.max().item() <= 2.0 ** -134 and (miss > 0).any()


def _codes(w, group):
    """The integer codes of a quantised weight as f32 [N, K]: int8 codes, or
    int4 nibbles in k order."""
    if not group:
        return w.float()
    lo, hi = tq._unpack4(w)
    return torch.stack([lo, hi], dim=2).view(w.shape[0], -1).float()


def _k5_f32_tc_order(x, w, scale, group, plan):
    """K5's f32 tensor-core sums: x's three planes times the codes, each
    block of `k5_tc_bk(W)` k summed apart (the tensor core's order inside a
    block is its own, emulated by one f32 product a plane), the planes
    (lo + mid) + hi where they stand side by side along N (W <= 32; one
    accumulator above), times the block's group scale once (int4), the
    blocks added in order into one running sum, or into one a warpgroup
    with the k split (its alternate stages of `k5_tc_ks(W)` k; even stages
    + odd stages at the end); int8's per-channel scale last."""
    M, K = x.shape
    codes = _codes(w, group)
    W = plan.xw
    ks, bk = tq.k5_tc_ks(W), tq.k5_tc_bk(W)
    planes = _split3(x.float())
    tot = [torch.zeros(M, codes.shape[0]), torch.zeros(M, codes.shape[0])]
    for k0 in range(0, K, bk):
        c = codes[:, k0:k0 + bk].t()
        hi, mid, lo = (pl[:, k0:k0 + bk] @ c for pl in planes)
        v = (lo + mid) + hi if W <= tq.K5_TC_PN_MAX_W else hi + mid + lo
        if group:
            v = v * scale[:, k0 // group].float()
        side = (k0 // ks) % 2 if plan.ksplit else 0
        tot[side] = tot[side] + v
    y = tot[0] + tot[1] if plan.ksplit else tot[0]
    return y if group else y * scale.float()


@pytest.mark.parametrize("int4", [False, True])
def test_tc_route_pairs_weights_and_planes_alike(int4):
    """The f32 tensor-core route's A fragment (the bf16 route's conversions
    of a weight word, lane t of a warp) and its B planes (unit q of a
    16-byte weight chunk's k holds k = Q j + q at k-slot 8 q + j) name the
    same k at every k-slot of every k16 step."""
    Q = 4 if int4 else 2
    chunk = 8 * Q                          # k of a 16-byte weight chunk
    b_slot = {8 * q + j: Q * j + q for q in range(Q) for j in range(8)}
    assert sorted(b_slot.values()) == list(range(chunk))
    for t in range(4):
        if int4:
            # word t holds k 8t..8t+7; p[i] = (k 8t + i, 8t + i + 4); step s
            # takes p[2s] at k-slots (2t, 2t + 1), p[2s + 1] at (2t + 8, 2t + 9)
            for s in range(2):
                for base, i in ((2 * t, 2 * s), (2 * t + 8, 2 * s + 1)):
                    assert b_slot[16 * s + base] == 8 * t + i
                    assert b_slot[16 * s + base + 1] == 8 * t + i + 4
        else:
            # word t holds k 4t..4t+3; p02 at k-slots (2t, 2t + 1), p13 at (2t + 8, 2t + 9)
            assert (b_slot[2 * t], b_slot[2 * t + 1]) == (4 * t, 4 * t + 2)
            assert (b_slot[2 * t + 8], b_slot[2 * t + 9]) == (4 * t + 1, 4 * t + 3)


def _cu_plan_fields():
    """The `Plan` struct's field names in csrc/dequant_gemv.cu, in order."""
    from videoglamm_torch.ops import _cuda
    import re
    text = (_cuda.CSRC / "dequant_gemv.cu").read_text()
    body = re.search(r"struct Plan \{(.*?)\};", text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = [n for decl in body.split(";") if decl.strip()
             for n in re.sub(r"^\s*int\s+", "", decl.strip()).split(",")]
    return [n.strip() for n in names]


@pytest.mark.parametrize("N,K", SHAPES)
def test_k5_f32_tc_plan_one_pass_per_64_rows_and_fits(N, K):
    """`k5_plan(..., f32=True)` for M = 1 to 255 (int4 to its matvec gate,
    64): the CUDA-core route below the crossover (`k5_f32_tc_min_m`, by the
    channels an SM would hold), the tensor cores
    from it, one pass over the weights up to 64 rows and ceil(M / 64) above;
    each region of a slot, the ring, the scales and the k-split sums inside
    the shared memory a block can use; a CTA of at most 64 rows splits its
    stages between the warpgroups; `fields()` in the order of the .cu's
    `Plan`."""
    names = _cu_plan_fields()
    assert len(names) == 23 and names[-3:] == ["xw", "slot", "ksplit"]
    for group in (0, 128):
        for M in range(1, (tq.MATVEC4_MAX_M if group else tq.W8A8_MIN_M - 1) + 1):
            p = tq.k5_plan(M, N, K, group, SMS, f32=True)
            f = p.fields()
            assert len(f) == len(names)
            base, extra = divmod(N, p.ctas)
            derived = dict(base=base, extra=extra, gdiv=group // 32,
                           gdiv_mul=tq._div_mul(group // 32))
            for i, name in enumerate(names):
                want = derived[name] if name in derived else getattr(p, name, None)
                if want is not None:
                    assert f[i] == want, (name, f[i], want)
            assert p.tc == (M >= tq.k5_f32_tc_min_m(N, SMS))
            if not p.tc:
                assert p.mt == min(M, tq.K5_F32_MT) and p.m_tiles == -(-M // p.mt)
                assert p.xw == p.slot == p.ksplit == 0
                continue
            assert f[15] == f[16] == 0                      # no units
            assert p.mt == min(M, 64) and p.m_tiles == -(-M // 64)
            assert p.m_tiles == 1 if M <= 64 else p.m_tiles <= 4
            W, ks = p.xw, tq.k5_tc_ks(p.xw)
            assert W >= p.mt and W % 8 == 0 and W in (8, 16, 24, 32, 64)
            assert p.kseg == (ks // 2 if group else ks)
            assert p.nseg == -(-p.rowbytes // p.kseg)
            max_rows = -(-N // p.ctas)
            assert p.ksplit == (max_rows <= 64)
            # one CTA an SM, or where those would hold at most 64 rows, as
            # few CTAs of at most 64 rows
            assert p.ctas == (min(N, SMS) if -(-N // SMS) > 64 else -(-N // 64))
            rows = 64 if p.ksplit else 128
            # a slot: the planes, x's slice in f32, the weight rows
            assert p.xstride == 6 * W * ks and p.x_off == p.xstride
            assert p.slot % 1024 == 0 and p.x_off % 1024 == 0
            assert p.slot >= p.x_off + -(-4 * p.mt * ks // 1024) * 1024 + rows * p.kseg
            # weight rows in TMA boxes of 8 rows x min(kseg, 128) bytes, a
            # 256-byte slice in two halves, each swizzled over its span
            assert p.rstride == min(p.kseg, 128) and p.kseg in (32, 64, 128, 256)
            assert p.ring_off % 1024 == 0 and p.ring_off >= 24 * p.stages
            assert 2 <= p.stages <= tq.K5_TC_MAX_STAGES
            # with the k split a slot serves one warpgroup (stage i is in
            # slot i % stages and is warpgroup i % 2's)
            assert not p.ksplit or p.stages % 2 == 0
            assert p.s_off >= p.ring_off + p.stages * p.slot
            scols = K // group if group else 0
            assert p.red_off >= p.s_off + max_rows * scols * 4
            assert p.smem >= p.red_off + (128 * W // 2 * 4 if p.ksplit else 0) + 1024
            assert p.smem <= tq.K5_SMEM and p.per_sm == 1
            bk = tq.k5_tc_bk(W)
            assert ks % bk == 0 and bk <= tq.K5_TC_BK
            if group:
                assert group % bk == 0                       # a block inside a group


@pytest.mark.parametrize("N,K", SHAPES)
def test_k5_f32_tc_stages_take_every_weight_byte_and_x_slice_once(N, K):
    """The walk of the producer and the splitters: a CTA's stages (row groups
    of 128 or all its rows, k-slices of kseg bytes) copy every byte of its
    rows once, and each row group's stages split every x element once."""
    for M, group in ((4, 0), (64, 0), (4, 128), (64, 128), (200, 0)):
        p = tq.k5_plan(M, N, K, group, SMS, f32=True, tc=True)
        rows_a_stage = 64 if p.ksplit else 128
        ks = tq.k5_tc_ks(p.xw)
        seen = np.zeros(N, dtype=np.int64)
        for c in range(p.ctas):
            r0, n = p.rows(c)
            groups = 1 if p.ksplit else -(-n // 128)
            assert n <= rows_a_stage * groups
            for grp in range(groups):
                xk = np.zeros(K, dtype=np.int64)
                for seg in range(p.nseg):
                    rows = min(rows_a_stage, n - grp * rows_a_stage)
                    length = min(p.kseg, p.rowbytes - seg * p.kseg)
                    assert length > 0 and length % 16 == 0
                    seen[r0 + grp * rows_a_stage:r0 + grp * rows_a_stage + rows] += length
                    k0 = seg * ks
                    xk[k0:k0 + min(ks, K - k0)] += 1
                np.testing.assert_array_equal(xk, 1)
        np.testing.assert_array_equal(seen, p.rowbytes)


def _ring_protocol(total: int, S: int, ksplit: bool, seed: int):
    """The f32 tensor-core route's ring (csrc/dequant_gemv.cu
    `gemv_f32_tc_kernel`) under one random schedule: the producer (waits
    `empty` of a slot's previous lap, then loads), each stage's landing on
    `full` at any time after its load, in any order across slots, and each
    consumer warpgroup's stages (all, or with ksplit those of its parity),
    each waited on `full` and released on `empty`. A wait for lap L on a
    barrier that has completed c phases returns when c % 2 != L % 2,
    mbarrier.try_wait.parity's rule. Returns the waits that returned before
    their own phase completed; raises on a deadlock."""
    rng = np.random.default_rng(seed)
    full, empty = [0] * S, [0] * S              # phases completed
    arrived = [0] * S                           # arrivals of empty's current phase
    need = 1 if ksplit else 2                   # warpgroups arriving a stage
    landed_early = []

    def mine(wg):
        return [i for i in range(total) if not ksplit or i % 2 == wg]

    def consumer(wg):
        for i in mine(wg):
            yield ("wait", i)
            yield ("arrive", i)

    def producer():
        for i in range(total):
            if i >= S:
                yield ("wait_empty", i)
            yield ("load", i)

    actors = [producer(), consumer(0), consumer(1)]
    pending = [next(a, None) for a in actors]
    flying = []                                 # loaded, not yet landed
    while any(pending) or flying:
        ready = []
        for k, op in enumerate(pending):
            if op is None:
                continue
            kind, i = op
            slot, lap = i % S, i // S
            if kind == "wait" and full[slot] % 2 != lap % 2:
                ready.append(k)
            elif kind == "wait_empty" and empty[slot] % 2 != (lap - 1) % 2:
                ready.append(k)
            elif kind in ("arrive", "load"):
                ready.append(k)
        choices = ready + [("land", j) for j in range(len(flying))]
        if not choices:
            raise AssertionError(f"deadlock: total {total}, stages {S}, "
                                 f"ksplit {ksplit}: {pending}")
        c = choices[rng.integers(len(choices))]
        if isinstance(c, tuple):
            i = flying.pop(c[1])
            full[i % S] += 1
            continue
        kind, i = pending[c]
        slot, lap = i % S, i // S
        if kind == "wait" and full[slot] < lap + 1:
            landed_early.append(i)
        if kind == "wait_empty":
            assert empty[slot] >= lap
        if kind == "load":
            flying.append(i)
        if kind == "arrive":
            arrived[slot] += 1
            if arrived[slot] == need:
                arrived[slot] = 0
                empty[slot] += 1
        pending[c] = next(actors[c], None)
    return landed_early


@pytest.mark.parametrize("N,K", SHAPES)
def test_k5_f32_tc_ring_waits_for_every_stage_and_never_deadlocks(N, K):
    """The ring's barrier protocol under random schedules, at every plan of
    the five Phi-3 products and the odd case for M = 2 to 64 (int8 to 255):
    no consumer reads a stage before it landed, and no schedule deadlocks.
    An odd ring with the k split fails one way or the other (a warpgroup
    skips a phase of a slot's barrier, so its wait for lap L can pass on
    lap L - 1), which the last lines show."""
    plans = set()
    for group in (0, 128):
        for M in range(2, (tq.MATVEC4_MAX_M if group else tq.W8A8_MIN_M - 1) + 1):
            p = tq.k5_plan(M, N, K, group, SMS, f32=True, tc=True)
            groups = 1 if p.ksplit else -(-(-(-N // p.ctas)) // 128)
            plans.add((groups * p.nseg, p.stages, bool(p.ksplit)))
    for total, S, ksplit in sorted(plans):
        for seed in range(20):
            assert _ring_protocol(total, S, ksplit, seed) == [], (total, S, ksplit)
    bad = 0
    for seed in range(50):
        try:
            bad += bool(_ring_protocol(12, 3, True, seed))
        except AssertionError:
            bad += 1
    assert bad > 0


def test_k5_f32_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError):                 # 1024 rows' 64 group scales a CTA
        tq.k5_plan(8, SMS * 1024, 8192, 128, SMS, f32=True, tc=True)
    bk8 = tq.k5_tc_bk(8)
    with pytest.raises(ValueError):                 # a group smaller than a block
        tq.k5_plan(4, 4096, 3072, bk8 // 2, SMS, f32=True, tc=True)
    # without `tc`, such a group takes the CUDA-core route; wider planes'
    # shorter blocks may fit it
    assert not tq.k5_plan(4, 4096, 3072, bk8 // 2, SMS, f32=True).tc
    assert tq.k5_plan(64, 4096, 3072, tq.k5_tc_bk(64), SMS, f32=True).tc


@pytest.mark.parametrize("kseg", [32, 64, 128])
def test_tc_weight_reads_follow_the_tma_swizzle_without_conflicts(kseg):
    """A stage's weight rows arrive as TMA boxes of 8 rows x kseg bytes with
    the swizzle of that span: 16-byte unit u of the row starting at byte a
    (from a 1024-aligned base) lands at unit u ^ ((a >> 7) & (kseg/16 - 1)),
    TMA's pattern (address bits 4.. XOR bits 7..). The consumers read unit c
    of rows rr, rr + 8 there: each (row, unit) once, and a warp's 32 lanes
    (rows g, words t) on 32 different banks for every c."""
    units = kseg // 16
    for rr0 in (0, 16, 32, 48):                     # a warp's first row
        for c in range(units):
            banks = set()
            for g in range(8):
                for h in (0, 8):
                    rr = rr0 + g + h
                    a = rr * kseg
                    sw = (a >> 7) & (units - 1)
                    # TMA's swizzle of the same byte: bits [4, 4 + log2(units))
                    # XOR the bits above 7
                    addr = a + ((c ^ sw) << 4)
                    assert (addr >> 4) & (units - 1) == c ^ ((addr >> 7) & (units - 1))
                    if h == 0:
                        for t in range(4):
                            banks.add(((addr + 4 * t) >> 2) % 32)
            assert len(banks) == 32
    # the units of a row are a permutation of its kseg bytes
    for rr in range(64):
        sw = ((rr * kseg) >> 7) & (units - 1)
        assert sorted(c ^ sw for c in range(units)) == list(range(units))
