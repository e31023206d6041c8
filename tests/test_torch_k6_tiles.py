"""K6's tile walk (csrc/flash_bwd.cu), emulated in torch on the CPU.

`_dkv_emulate` and `_dq_emulate` follow the two device kernels tile by tile:
the same CTA and ring-tile sizes (`K6_ROWS`, `K6_TILE`), the first and last
tile each CTA visits (causal order, per-row q_start, kv_len), TMA's zero
fill of rows past Sq and Sk, the mask applied only on tiles that cross
kv_len or the causal diagonal and always by selection, p and ds rounded to
the storage type before the products, the K rows in [kv_len, Sk) zeroed in
the dq kernel's one tile that holds them, and rows with no valid key. They
are held against K6's plain twin `_flash_bwd_plain` and against the JAX
package's XLA reference (`jax.grad` through `_attention_xla`) on the inputs
of tests/test_ops.py:489. The JAX Pallas backward is not run: in interpret
mode on the CPU it deadlocks now and then (ROADMAP.md).

Tolerances: 2e-4 against jax.grad in f32, the tolerance at which the JAX
package holds its own Pallas backward to the same reference
(tests/test_ops.py:521); 1e-5 against the f32 twin, which differs from the
emulation by summation order only; relative L2 1e-2 against the bf16 twin,
the card's tolerance (kernel and twin round p and ds at the same place and
sum in another order, so single entries differ by one bf16 ulp, 2^-8).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoglamm_tpu.ops.attention import _attention_xla
from videoglamm_torch.ops import attention as A

ROWS, TILE = A.K6_ROWS, A.K6_TILE
LOG2E = 1.4426950408889634
TOL_JAX = 2e-4
TOL_TWIN_F32 = 1e-5
TOL_TWIN_BF16 = 1e-2


def _rows(x, r0, n):
    """Rows [r0, r0 + n) of x [..., S, D], zero past S (TMA's fill)."""
    out = x.new_zeros(*x.shape[:-2], n, x.shape[-1])
    m = max(0, min(n, x.shape[-2] - r0))
    out[..., :m, :] = x[..., r0:r0 + m, :]
    return out


def _vec(x, r0, n):
    """Entries [r0, r0 + n) of x [..., S], 0 past S (the producer's fill)."""
    out = x.new_zeros(*x.shape[:-1], n)
    m = max(0, min(n, x.shape[-1] - r0))
    out[..., :m] = x[..., r0:r0 + m]
    return out


def _delta(out, dout):
    return (dout.float() * out.float()).sum(-1)


def _dkv_emulate(q, k, v, out, lse, dout, kv_lens, q_start, causal, sm_scale,
                 stats):
    """`flash_bwd_dkv`: a CTA per 128-key tile, two 64-key warpgroups, the
    64-query tiles of the ring from the first that sees the key tile."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    dt = q.dtype
    qf, kf, vf, gf = (t.float() for t in (q, k, v, dout))
    lse2, delta = lse.float() * LOG2E, _delta(out, dout)
    dk = torch.zeros(B, H, Sk, D)
    dv = torch.zeros(B, H, Sk, D)
    nmt = -(-Sq // TILE)
    for b in range(B):
        kv_len, q_off = min(int(kv_lens[b]), Sk), int(q_start[b])
        for n0 in range(0, Sk, ROWS):      # key tile 0 first
            i_lo = max(0, n0 - q_off) // TILE if causal else 0
            n_it = max(0, nmt - i_lo) if n0 < kv_len else 0
            stats["dkv_ctas"] += 1
            for key0w in (n0, n0 + TILE):
                kw, vw = _rows(kf[b], key0w, TILE), _rows(vf[b], key0w, TILE)
                keys = torch.arange(key0w, key0w + TILE)
                dkw = torch.zeros(H, TILE, D)
                dvw = torch.zeros(H, TILE, D)
                for it in range(n_it):
                    m0 = (i_lo + it) * TILE
                    qt, gt = _rows(qf[b], m0, TILE), _rows(gf[b], m0, TILE)
                    l2, dl = _vec(lse2[b], m0, TILE), _vec(delta[b], m0, TILE)
                    st = kw @ qt.transpose(-1, -2)        # S^T [H, keys, queries]
                    dpt = vw @ gt.transpose(-1, -2)
                    p = torch.exp2(st * (sm_scale * LOG2E) - l2[:, None, :])
                    ds = p * (dpt - dl[:, None, :]) * sm_scale
                    edge = (key0w + TILE > kv_len
                            or (causal and key0w + TILE - 1 > q_off + m0))
                    stats["dkv_masked" if edge else "dkv_unmasked"] += 1
                    if edge:
                        qs = torch.arange(m0, m0 + TILE)
                        ok = (keys < kv_len)[:, None].expand(TILE, TILE)
                        if causal:
                            ok = ok & (keys[:, None] <= q_off + qs[None, :])
                        p = torch.where(ok, p, 0.0)
                        ds = torch.where(ok, ds, 0.0)
                    dvw += p.to(dt).float() @ gt
                    dkw += ds.to(dt).float() @ qt
                m = max(0, min(TILE, Sk - key0w))      # the store clips at Sk
                dk[b, :, key0w:key0w + m] = dkw[:, :m]
                dv[b, :, key0w:key0w + m] = dvw[:, :m]
    return dk.to(dt), dv.to(dt)


def _dq_emulate(q, k, v, out, lse, dout, kv_lens, q_start, causal, sm_scale,
                stats):
    """`flash_bwd_dq`: a CTA per 128-query tile, longest first, two 64-query
    warpgroups, the 64-key tiles of the ring up to the CTA's last live key;
    slack K rows of a tile zeroed before the products."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    dt = q.dtype
    qf, kf, vf, gf = (t.float() for t in (q, k, v, dout))
    lse2, delta = lse.float() * LOG2E, _delta(out, dout)
    dq = torch.zeros(B, H, Sq, D)
    for b in range(B):
        kv_len, q_off = min(int(kv_lens[b]), Sk), int(q_start[b])
        for m0 in reversed(range(0, Sq, ROWS)):
            last = min(m0 + ROWS, Sq) - 1
            k_hi = min(kv_len, q_off + last + 1) if causal else kv_len
            ntiles = -(-k_hi // TILE) if k_hi > 0 else 0
            stats["dq_ctas"] += 1
            halves = []
            for q0w in (m0, m0 + TILE):
                rows = torch.arange(q0w, q0w + TILE)
                hi = torch.full((TILE,), kv_len)
                if causal:
                    hi = torch.minimum(hi, q_off + rows + 1)
                halves.append(dict(q0w=q0w, hi=hi, q=_rows(qf[b], q0w, TILE),
                                   g=_rows(gf[b], q0w, TILE),
                                   l2=_vec(lse2[b], q0w, TILE),
                                   dl=_vec(delta[b], q0w, TILE),
                                   acc=torch.zeros(H, TILE, D)))
            for it in range(ntiles):
                k0 = it * TILE
                kt, vt = _rows(kf[b], k0, TILE), _rows(vf[b], k0, TILE)
                if kv_len - k0 < TILE and kv_len < Sk:
                    kt[:, kv_len - k0:] = 0.0          # slack K rows zeroed
                    stats["dq_zeroed"] += 1
                keys = torch.arange(k0, k0 + TILE)
                for hw in halves:
                    s = hw["q"] @ kt.transpose(-1, -2)
                    dp = hw["g"] @ vt.transpose(-1, -2)
                    p = torch.exp2(s * (sm_scale * LOG2E) - hw["l2"][:, :, None])
                    ds = p * (dp - hw["dl"][:, :, None]) * sm_scale
                    edge = (k0 + TILE > kv_len
                            or (causal and k0 + TILE - 1 > q_off + hw["q0w"]))
                    stats["dq_masked" if edge else "dq_unmasked"] += 1
                    if edge:
                        ds = torch.where(keys[None, :] < hw["hi"][:, None], ds, 0.0)
                    hw["acc"] += ds.to(dt).float() @ kt
            for hw in halves:
                m = max(0, min(TILE, Sq - hw["q0w"]))
                dq[b, :, hw["q0w"]:hw["q0w"] + m] = hw["acc"][:, :m]
    return dq.to(dt)


def _emulate(q, k, v, out, lse, dout, kv_lens, q_start, causal, sm_scale):
    stats = dict.fromkeys(("dkv_ctas", "dkv_masked", "dkv_unmasked", "dq_ctas",
                           "dq_masked", "dq_unmasked", "dq_zeroed"), 0)
    dq = _dq_emulate(q, k, v, out, lse, dout, kv_lens, q_start, causal,
                     sm_scale, stats)
    dk, dv = _dkv_emulate(q, k, v, out, lse, dout, kv_lens, q_start, causal,
                          sm_scale, stats)
    return (dq, dk, dv), stats


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


# ---------------------------------------------------------------------------
# against jax.grad of the XLA reference (the inputs of tests/test_ops.py:489)
# ---------------------------------------------------------------------------
FLASH_CASES = {"causal_prefill": (True, True), "causal_decode": (True, False),
               "full": (False, False)}


@pytest.fixture(scope="module")
def flash_ref():
    rng = np.random.RandomState(4)
    q = rng.randn(2, 2, 200, 64).astype(np.float32)
    k = rng.randn(2, 2, 320, 64).astype(np.float32)
    v = rng.randn(2, 2, 320, 64).astype(np.float32)
    kv_lens = np.array([320, 260], np.int32)
    g = rng.randn(2, 2, 200, 64).astype(np.float32)
    ref = {}
    for name, (causal, given) in FLASH_CASES.items():
        qs = np.zeros(2, np.int32) if given else kv_lens - 200

        def fwd(q_, k_, v_):
            return _attention_xla(q_, k_, v_, causal=causal, sm_scale=0.125,
                                  kv_lens=jnp.asarray(kv_lens), bias=None,
                                  q_start=jnp.asarray(qs))

        grads = jax.grad(lambda *a: (fwd(*a) * g).sum(), argnums=(0, 1, 2))(q, k, v)
        ref[name] = ([np.asarray(x) for x in grads], qs)
    return dict(q=q, k=k, v=v, kv_lens=kv_lens, g=g, ref=ref)


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_emulated_tile_walk_matches_jax_grad(flash_ref, case):
    causal, _ = FLASH_CASES[case]
    grads_ref, qs = flash_ref["ref"][case]
    q, k, v, g = (torch.from_numpy(flash_ref[n]) for n in ("q", "k", "v", "g"))
    kvl, qst = torch.from_numpy(flash_ref["kv_lens"]), torch.from_numpy(qs)
    out, lse = A._flash_fwd_plain(q, k, v, kvl, qst, causal, 0.125)
    got, stats = _emulate(q, k, v, out, lse, g, kvl, qst, causal, 0.125)
    twin = A._flash_bwd_plain(q, k, v, out, lse, g, kvl, qst, causal, 0.125)
    for name, a, want, tw in zip(("dq", "dk", "dv"), got, grads_ref, twin):
        np.testing.assert_allclose(a.numpy(), want, atol=TOL_JAX, rtol=TOL_JAX,
                                   err_msg=f"{name} {case}")
        np.testing.assert_allclose(a.numpy(), tw.numpy(), atol=TOL_TWIN_F32,
                                   rtol=TOL_TWIN_F32, err_msg=f"{name} {case}")
    # 200 queries: two dq CTAs; 320 keys: three dk/dv CTAs a batch row
    assert stats["dq_ctas"] == 2 * 2 and stats["dkv_ctas"] == 2 * 3
    # kv_len 260 lies inside the 64-key tile 256..319, which the prefill's
    # queries (q_start 0, keys < 200) never reach
    assert (stats["dq_zeroed"] > 0) == (case != "causal_prefill")


# ---------------------------------------------------------------------------
# the walk's edges, against the plain twin
# ---------------------------------------------------------------------------
def _case(name):
    """(B, H, Sq, Sk, D, kv_lens, q_start, causal) of one edge case."""
    return {
        # per-row q_start, one negative: the first rows have no valid key
        "causal_q_start": (2, 2, 200, 260, 16, (260, 190), (60, -37), True),
        "full": (2, 2, 150, 333, 16, (333, 211), (0, 0), False),
        # Sq > Sk, neither a multiple of a tile; interior tiles unmasked
        "causal_long": (1, 2, 390, 300, 8, (300,), (-90,), True),
        # kv_len inside the first 64-key tile, and a batch row of kv_len 0
        "kv_short": (2, 1, 70, 140, 8, (37, 0), (0, 0), False),
    }[name]


def _inputs(name, dtype=torch.float32):
    B, H, Sq, Sk, D, kv, qs, causal = _case(name)
    rng = np.random.RandomState(11)
    q, k, v, g = (torch.from_numpy(rng.randn(B, H, s, D).astype(np.float32)).to(dtype)
                  for s in (Sq, Sk, Sk, Sq))
    kvl, qst = torch.tensor(kv), torch.tensor(qs)
    out, lse = A._flash_fwd_plain(q, k, v, kvl, qst, causal, D ** -0.5)
    return q, k, v, out, lse, g, kvl, qst, causal, D ** -0.5


EDGE_CASES = ["causal_q_start", "full", "causal_long", "kv_short"]


@pytest.mark.parametrize("name", EDGE_CASES)
def test_emulated_tile_walk_matches_plain_twin(name):
    args = _inputs(name)
    got, stats = _emulate(*args)
    want = A._flash_bwd_plain(*args)
    for tag, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=TOL_TWIN_F32,
                                   rtol=TOL_TWIN_F32, err_msg=f"{tag} {name}")
    B, H, Sq, Sk = args[0].shape[0], args[0].shape[1], args[0].shape[2], args[1].shape[2]
    assert stats["dq_ctas"] == B * -(-Sq // ROWS)
    assert stats["dkv_ctas"] == B * -(-Sk // ROWS)
    if name == "causal_long":   # a long causal walk has interior tiles
        assert stats["dq_unmasked"] > 0 and stats["dkv_unmasked"] > 0


@pytest.mark.parametrize("name", EDGE_CASES)
def test_emulated_tile_walk_in_bf16_matches_bf16_twin(name):
    """In bf16 the emulation rounds p and ds before the products as the
    kernel does; the twin rounds at the same places."""
    args = _inputs(name, torch.bfloat16)
    got, _ = _emulate(*args)
    want = A._flash_bwd_plain(*args)
    for tag, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        if w.float().norm() > 0:
            assert _rel_l2(a, w) <= TOL_TWIN_BF16, f"{tag} {name}"
        else:
            assert (a == 0).all(), f"{tag} {name}"


def test_walk_skips_tiles_it_need_not_visit():
    """Causal order: a dk/dv CTA starts at the first query tile that sees
    its keys, a dq CTA stops at its last live key; a key tile wholly past
    kv_len and a key tile no query reaches do no products."""
    B, H, Sq, Sk, D = 1, 1, 256, 512, 8
    rng = np.random.RandomState(3)
    q, k, v, g = (torch.from_numpy(rng.randn(B, H, s, D).astype(np.float32))
                  for s in (Sq, Sk, Sk, Sq))
    kvl, qst = torch.tensor([400]), torch.tensor([0])
    out, lse = A._flash_fwd_plain(q, k, v, kvl, qst, True, D ** -0.5)
    (dq, dk, dv), stats = _emulate(q, k, v, out, lse, g, kvl, qst, True, D ** -0.5)
    # dq: CTAs of queries 128..255 (keys < 256: 4 tiles) and 0..127 (2 tiles),
    # two warpgroups each
    assert stats["dq_masked"] + stats["dq_unmasked"] == 2 * (4 + 2)
    # dk/dv: key tiles 0..127 (4 query tiles) and 128..255 (2); 256..383
    # and 384..511 see no query (causal) or lie past kv_len: no products
    assert stats["dkv_masked"] + stats["dkv_unmasked"] == 2 * (4 + 2)
    assert (dk[..., 256:, :] == 0).all() and (dv[..., 256:, :] == 0).all()
    want = A._flash_bwd_plain(q, k, v, out, lse, g, kvl, qst, True, D ** -0.5)
    for a, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=TOL_TWIN_F32,
                                   rtol=TOL_TWIN_F32)


@pytest.mark.parametrize("causal", [True, False])
def test_nan_in_the_kv_slack_stays_out(causal):
    """K and V rows in [kv_len, Sk) filled with NaN: the walk's selection and
    the dq kernel's zeroed K rows keep every gradient finite and equal to the
    twin on clean inputs; dk and dv are exactly 0 on those rows, dq exactly
    0 on the rows with no valid key. Without the zeroing, dS K would carry
    0 * NaN into dq."""
    q, k, v, out, lse, g, kvl, qst, _, scale = _inputs("causal_q_start")
    dirty_k, dirty_v = k.clone(), v.clone()
    for b, n in enumerate(kvl.tolist()):
        dirty_k[b, :, n:] = math.nan
        dirty_v[b, :, n:] = math.nan
    if not causal:
        out, lse = A._flash_fwd_plain(q, k, v, kvl, qst, False, scale)
    (dq, dk, dv), _ = _emulate(q, dirty_k, dirty_v, out, lse, g, kvl, qst,
                               causal, scale)
    want = A._flash_bwd_plain(q, k, v, out, lse, g, kvl, qst, causal, scale)
    for a, w in zip((dq, dk, dv), want):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=TOL_TWIN_F32,
                                   rtol=TOL_TWIN_F32)
    for b, n in enumerate(kvl.tolist()):
        assert (dk[b, :, n:] == 0).all() and (dv[b, :, n:] == 0).all()
    if causal:      # q_start -37: rows 0..36 of batch row 1 see no key
        assert (dq[1, :, :37] == 0).all() and (dq[1, :, 37:] != 0).any()
    bad = A._flash_bwd_plain(q, dirty_k, dirty_v, out, lse, g, kvl, qst,
                             causal, scale)[0]
    assert not torch.isfinite(bad).all()    # the twin has no zeroing
