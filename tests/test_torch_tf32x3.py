"""The 3xTF32 arithmetic and tile plans of csrc/attention_f32.cu on the CPU.

The f32 attention kernels (K1's route "simt_f32", which K7 and K8 take for
an f32 model, and K6's f32 route) run every product as three TF32 products
on wgmma. `videoglamm_torch.ops.tf32x3` emulates that arithmetic in plain
torch; here it is held against the JAX package's f32 XLA reference
(`_attention_xla`, and `jax.grad` through it) on inputs from a numpy seed:
the forward with causal masks, kv_lens, q_start, the LSE and windows within
the card's f32 tolerance of 1e-5 relative L2 (`TOL_F32`,
tests/test_torch_cuda.py), the backward within K6's 2e-4 against jax.grad
(the JAX package's own tolerance for its backward, tests/test_ops.py:521)
and within 1e-5 of K6's f32 twin. A single TF32 product misses 1e-5 on the
same inputs, so the card's tolerance tells 3xTF32 from TF32. Then the tile
plans (`k1_f32_plan`, `k6_f32_plan`) against the shared-memory limit, and
the split passes' index arithmetic: every element lands once, where the
products read it, with no bank conflict. No Pallas kernel runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoglamm_tpu.ops.attention import _attention_xla
from videoglamm_torch.ops import attention as A
from videoglamm_torch.ops import tf32x3 as T
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL_F32 = 1e-5        # the card's tolerance of the f32 routes (relative L2)
TOL_LSE = 2e-5        # chip_smoke's TOL_F32_LSE (max |d|)
TOL_JAX_GRAD = 2e-4   # K6 against jax.grad (tests/test_ops.py:521)
SMEM = 232448         # dynamic shared memory a CTA can use on the H100


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _inputs(seed, B, H, Sq, Sk, D, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, S, D)).astype(np.float32)
            for S in (Sq, Sk, Sk, Sq)[:n]]


# (B, H, Sq, Sk, D, causal, kv_lens, q_start, win)
FWD_CASES = {
    "causal, kv_lens, q_start": (2, 2, 160, 160, 96, True, (160, 121), (0, 0), 0),
    "causal, a longer cache": (1, 2, 64, 200, 72, True, (180,), (116,), 0),
    "flash, Hiera global": (2, 2, 200, 200, 72, False, (200, 150), None, 0),
    "window of 16": (2, 3, 128, 128, 64, False, None, None, 16),
    "head dim 256": (1, 2, 96, 96, 256, False, None, None, 0),
}


def _jax_fwd(q, k, v, causal, kv, qs, win, D):
    B, Sk = q.shape[0], k.shape[2]
    bias = None
    if win:
        blk = np.arange(q.shape[2]) // win
        bias = jnp.asarray(np.where(blk[:, None] == blk[None, :], 0.0, -1e30)
                           .astype(np.float32))[None, None]
    return np.asarray(_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        sm_scale=D ** -0.5,
        kv_lens=jnp.asarray(kv or (Sk,) * B, jnp.int32),
        bias=bias, q_start=None if qs is None else jnp.asarray(qs, jnp.int32)))


def _emulate_fwd(q, k, v, causal, kv, qs, win, D, matmul):
    B, Sk = q.shape[0], k.shape[2]
    return T.attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)), sm_scale=D ** -0.5,
        causal=causal, kv_lens=torch.tensor(kv or (Sk,) * B),
        q_start=None if qs is None else torch.tensor(qs), win=win, matmul=matmul)


@pytest.mark.parametrize("name", list(FWD_CASES))
def test_forward_3xtf32_matches_jax_and_one_tf32_product_does_not(name):
    B, H, Sq, Sk, D, causal, kv, qs, win = FWD_CASES[name]
    q, k, v = _inputs(len(name), B, H, Sq, Sk, D)
    ref = _jax_fwd(q, k, v, causal, kv, qs, win, D)
    out, lse = _emulate_fwd(q, k, v, causal, kv, qs, win, D, T.matmul_3xtf32)
    assert _rel(out, ref) <= TOL_F32, name
    one, _ = _emulate_fwd(q, k, v, causal, kv, qs, win, D, T.matmul_tf32)
    assert _rel(one, ref) > 5 * TOL_F32, name
    # the LSE against float64 logits under the same mask
    ok, _ = T._valid(B, Sq, Sk, causal, torch.tensor(kv or (Sk,) * B),
                     None if qs is None else torch.tensor(qs), win)
    logits = torch.from_numpy(q).double() @ torch.from_numpy(k).double() \
        .transpose(-1, -2) * D ** -0.5
    want = torch.logsumexp(torch.where(ok[:, None], logits, -torch.inf), -1)
    assert (lse.double() - want).abs().max().item() <= TOL_LSE, name


BWD_CASES = {
    "train causal, kv_lens": (2, 2, 160, 96, True, (160, 121)),
    "Hiera global": (2, 2, 200, 72, False, None),
    "head dim 40, causal": (1, 3, 130, 40, True, (120,)),
}


@pytest.mark.parametrize("name", list(BWD_CASES))
def test_backward_3xtf32_matches_jax_grad_and_the_f32_twin(name):
    B, H, S, D, causal, kv = BWD_CASES[name]
    q, k, v, g = _inputs(len(name), B, H, S, S, D, n=4)
    kvl = kv or (S,) * B
    qs = (0,) * B   # a right-padded batch: every row has a key (JAX's softmax
                    # of a row with none is uniform, the kernels' is 0)

    def fwd(q_, k_, v_):
        return _attention_xla(q_, k_, v_, causal=causal, sm_scale=D ** -0.5,
                              kv_lens=jnp.asarray(kvl, jnp.int32), bias=None,
                              q_start=jnp.asarray(qs, jnp.int32))

    want = jax.grad(lambda *a: (fwd(*a) * jnp.asarray(g)).sum(),
                    argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    kw = dict(sm_scale=D ** -0.5, causal=causal, kv_lens=torch.tensor(kvl),
              q_start=torch.tensor(qs))
    out, lse = T.attention_fwd(tq, tk, tv, **kw)
    got = T.attention_bwd(tq, tk, tv, out, lse, tg, **kw)
    one = T.attention_bwd(tq, tk, tv, out, lse, tg, matmul=T.matmul_tf32, **kw)
    twin = A._flash_bwd_plain(tq, tk, tv, out, lse, tg, torch.tensor(kvl, dtype=torch.int32),
                              torch.tensor(qs, dtype=torch.int32), causal, D ** -0.5)
    for part, a, w, o, t in zip(("dq", "dk", "dv"), got, want, one, twin):
        assert _rel(a, w) <= TOL_JAX_GRAD, (name, part)
        assert _rel(a, t) <= TOL_F32, (name, part)
        assert _rel(o, t) > TOL_F32, (name, part)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """`tf32_round` keeps 10 stored mantissa bits, rounding half away from
    zero on the magnitude, for either sign; big + small holds x to 2^-22."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one, one + ulp / 2, one + ulp / 4, -(one + ulp / 2),
                      one + 3 * ulp / 4, 3.0e-38, -7.25])
    want = torch.tensor([one, one + ulp, one, -(one + ulp), one + ulp,
                         float(T.tf32_round(torch.tensor([3.0e-38]))[0]), -7.25])
    assert torch.equal(T.tf32_round(x), want)
    assert (T.tf32_round(x).view(torch.int32) & 0x1FFF).eq(0).all()
    r = torch.from_numpy(np.random.default_rng(5).standard_normal(4096)
                         .astype(np.float32))
    big, small = T.split_tf32(r)
    assert ((big + small - r).abs() <= r.abs() * 2.0 ** -21).all()
    assert ((T.tf32_round(r) - r).abs() > r.abs() * 2.0 ** -14).any()


# ---------------------------------------------------------------------------
# tile plans
# ---------------------------------------------------------------------------
FWD_TILES = {32: (128, 128, 1), 64: (128, 128, 1), 80: (128, 64, 1), 96: (128, 64, 1),
             128: (128, 64, 1), 256: (64, 32, 1)}   # query rows, keys, raw tiles
BWD_TILES = {32: 64, 64: 64, 80: 64, 96: 64, 128: 32}


@pytest.mark.parametrize("D", [8, 32, 40, 64, 72, 80, 88, 96, 128, 200, 256])
def test_forward_plan_fits_and_has_the_expected_tiles(D):
    plan = A.k1_f32_plan(D)
    dp = plan["depth"]
    assert dp == next(d for d in A.K1_DEPTHS if d >= D)
    assert (plan["query_rows"], plan["key_tile"], plan["stages"]) == FWD_TILES[dp]
    cols = -(-dp // 32) * 32
    rows, keys, stages = FWD_TILES[dp]
    # Q's two planes, a streamed tile's plane pair, the raw tiles, the slack
    assert plan["smem"] == (8 * rows * cols + 8 * keys * cols
                            + 4 * stages * keys * cols + 1024)
    assert plan["smem"] <= SMEM and plan["threads"] == 256


@pytest.mark.parametrize("D", [8, 32, 40, 64, 72, 88, 96, 128])
def test_backward_plan_fits_and_has_the_expected_tiles(D):
    plan = A.k6_f32_plan(D)
    dp = plan["depth"]
    assert plan["tile"] == BWD_TILES[dp] and plan["rows"] == 64
    cols = -(-dp // 32) * 32
    tile = BWD_TILES[dp]
    assert plan["smem"] == (16 * 64 * cols + 16 * tile * cols + 4 * tile * cols
                            + 8 * max(tile, 64) + 1024)
    assert plan["smem"] <= SMEM and plan["threads"] == 256


@pytest.mark.parametrize("D", [0, 12, 264])
def test_plans_refuse_what_the_kernels_do_not_build(D):
    with pytest.raises(ValueError):
        A.k1_f32_plan(D)
    with pytest.raises(ValueError):
        A.k6_f32_plan(D if D != 264 else 136)


# ---------------------------------------------------------------------------
# the split passes' index arithmetic (split_km, split_t in the source)
# ---------------------------------------------------------------------------
PERM = (0, 2, 4, 6, 1, 3, 5, 7)   # column 8m + s of a transposed plane: row 8m + PERM[s]


def _swizzled(rows, r, col):
    """(byte of the 16-byte unit, its bank group) of logical (r, col) in a
    K-major plane of `rows` rows: 32-column chunks, 128-byte swizzle."""
    u = (col % 32) // 4
    off = (col // 32) * rows * 128 + r * 128 + ((u ^ (r % 8)) << 4)
    return off, (u ^ (r % 8))


@pytest.mark.parametrize("rows,cols,nt", [(32, 256, 256), (64, 96, 256),
                                          (128, 32, 256), (64, 128, 256)])
def test_transposed_split_writes_each_element_once_where_the_product_reads_it(
        rows, cols, nt):
    """split_t: raw [rows][cols] -> planes [cols][rows] with the reduction
    index permuted inside groups of 8; a warp's loads and stores take the
    fewest wavefronts (4 for 32 lanes of 16 bytes)."""
    nm4, items = rows // 32, (rows // 8) * (cols // 4)
    seen = {}
    for w0 in range(0, items, 32):
        reads, stores = [], [[] for _ in range(8)]
        for i in range(w0, min(w0 + 32, items)):
            hi = i >> 5
            m = (hi % nm4) * 4 + (i & 3)
            c = (hi // nm4) * 8 + ((i >> 2) & 7)
            reads.append(((8 * m) * cols // 4 + c) % 8)
            for kk in range(4):           # store instruction kk writes column j
                d = 4 * c + ((kk + c) & 3)
                for half in range(2):
                    unit = 2 * (m & 3) + half
                    phys = unit ^ (d & 7)
                    stores[2 * kk + half].append(phys)
                    for e in range(4):
                        raw_row = 8 * m + 2 * e + half
                        byte = (m >> 2) * cols * 128 + d * 128 + (phys << 4) + 4 * e
                        assert (raw_row, d) not in seen
                        seen[(raw_row, d)] = byte
        assert max(reads.count(b) for b in set(reads)) <= 4
        for st in stores:
            assert max(st.count(b) for b in set(st)) <= 4
    assert len(seen) == rows * cols
    for (raw_row, d), byte in seen.items():
        col = 8 * (raw_row // 8) + PERM.index(raw_row % 8)
        off, _ = _swizzled(cols, d, col)
        assert byte == off + 4 * (col % 4)


def test_accumulator_to_fragment_order_meets_the_permutation():
    """to_frags: a thread's accumulators (g, 2t), (g, 2t + 1), (g + 8, 2t),
    (g + 8, 2t + 1) of each 8 columns become the A fragment (g, t), (g + 8,
    t), (g, t + 4), (g + 8, t + 4) of logical columns; with the transposed
    planes' permutation the product is unchanged."""
    rng = np.random.default_rng(9)
    p = rng.standard_normal((16, 8))
    v = rng.standard_normal((8, 5))
    frag = np.zeros((16, 8))      # logical columns of the A operand
    for g in range(8):
        for t in range(4):
            acc = (p[g, 2 * t], p[g, 2 * t + 1], p[g + 8, 2 * t], p[g + 8, 2 * t + 1])
            a = (acc[0], acc[2], acc[1], acc[3])      # the order to_frags writes
            frag[g, t], frag[g + 8, t], frag[g, t + 4], frag[g + 8, t + 4] = a
    vt = v[list(PERM)]            # row s of the B operand holds V row PERM[s]
    np.testing.assert_allclose(frag @ vt, p @ v, rtol=1e-12)


@pytest.mark.parametrize("rows,cols,nt", [(64, 96, 256), (128, 64, 256), (32, 256, 256)])
def test_kmajor_split_is_conflict_free(rows, cols, nt):
    u_row = cols // 4
    for w0 in range(0, rows * u_row, 32):
        groups = []
        for i in range(w0, w0 + 32):
            r, u = divmod(i, u_row)
            groups.append(_swizzled(rows, r, 4 * u)[1])
        assert max(groups.count(b) for b in set(groups)) <= 4


@pytest.mark.parametrize("shape,splits", [
    ((4, 1, 1024, 1024, 256), 2),     # K7's memory self-attention: 64 CTAs
    ((1, 2, 1536, 1536, 96), 3),      # 24 CTAs, 24 key tiles
    ((4, 1, 4096, 4096, 256), 1),     # the memory self-attention at 1024: 256 CTAs
    ((1, 32, 3391, 3391, 96), 1),     # the Phi-3 prefill
    ((2, 2, 130, 130, 32), 1),        # too few key tiles to share
])
def test_forward_splits_the_keys_only_on_a_grid_too_small_for_the_card(shape, splits):
    """`k1_f32_splits`: CTAs that share a query tile's keys, on an H100's
    132 SMs: several only where the query tiles fill less than half of
    them, at most 4, each keeping at least 8 key tiles."""
    assert A.k1_f32_splits(*shape, 132) == splits
