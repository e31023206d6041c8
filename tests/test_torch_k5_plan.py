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
        assert len(f) == 20 and f[13:15] == divmod(N, p.ctas)
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
