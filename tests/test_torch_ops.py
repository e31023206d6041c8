"""videoglamm_torch ops against the JAX reference package on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
port's CPU path is each kernel's plain twin; the JAX side runs its XLA
reference and, where a Pallas kernel exists, the kernel itself in
interpret mode (as tests/test_ops.py runs them). All in f32: tolerances
are f32 reduction-order noise (1e-5 absolute on O(1) values) unless stated.

A torch emulation of K1's tile loop (csrc/attention_fwd.cu, the wgmma
route: 128-query by 128-key tiles, live-key-tile range, the mask only on
edge tiles of each 64-row warpgroup, slack V rows zeroed, online softmax on
exp2, empty rows written as 0) checks the kernel's masking and tile
skipping here, before the card.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from videoglamm_tpu.ops import attention as jattn
from videoglamm_tpu.ops import fused_block as jfb
from videoglamm_tpu.ops import norms as jnorms
from videoglamm_tpu.ops import rope as jrope
from videoglamm_torch.ops import attention as tattn
from videoglamm_torch.ops import fused_block as tfb
from videoglamm_torch.ops import norms as tnorms
from videoglamm_torch.ops import rope as trope
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-5


def _np(x):
    return np.asarray(x, np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# K3: norms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d,bias", [(256, True), (1152, False), (144, True)])
def test_norms_match_jax_ref_and_pallas(d, bias):
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, d) * 2).astype(np.float32)
    w = (rng.randn(d) * 0.1 + 1).astype(np.float32)
    b = (rng.randn(d) * 0.1).astype(np.float32) if bias else None
    (jx, tx), (jw, tw) = _both(x), _both(w)
    jb, tb = _both(b) if bias else (None, None)
    # the CPU wrapper takes the plain twin
    rms = tnorms.row_norm(tx, tw, None, 1e-6, rms=True).numpy()
    ln = tnorms.row_norm(tx, tw, tb, 1e-6, rms=False).numpy()
    np.testing.assert_allclose(rms, _np(jnorms._rms_norm_ref(jx, jw, 1e-6)),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(ln, _np(jnorms._layer_norm_ref(jx, jw, jb, 1e-6)),
                               atol=ATOL, rtol=ATOL)
    with pltpu.force_tpu_interpret_mode():
        jrms = jnorms._rms_norm_pallas(jx, jw, eps=1e-6)
        jln = jnorms._layer_norm_pallas(jx, jw, jb, eps=1e-6)
    np.testing.assert_allclose(rms, _np(jrms), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(ln, _np(jln), atol=ATOL, rtol=ATOL)
    # the dispatchers take the plain path on the CPU, as JAX takes XLA
    np.testing.assert_allclose(tnorms.rms_norm(tx, tw).numpy(), rms, atol=0)
    np.testing.assert_allclose(tnorms.layer_norm(tx, tw, tb, 1e-6).numpy(), ln,
                               atol=0)


def test_rope_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 7, 16).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(7) + 5]).astype(np.int32)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), 16)
    tc, ts = trope.rope_cos_sin(torch.from_numpy(pos).long(), 16)
    np.testing.assert_allclose(tc.numpy(), _np(jc), atol=1e-6)
    got = trope.apply_rope(torch.from_numpy(x), tc, ts).numpy()
    ref = jrope.apply_rope(jnp.asarray(x), jc, js)
    np.testing.assert_allclose(got, _np(ref), atol=ATOL)


# ---------------------------------------------------------------------------
# K1: attention
# ---------------------------------------------------------------------------
_CAUSAL_CASES = [
    # B, H, Sq, Sk, D, kv_lens, q_start (None = last-Sq convention)
    (2, 2, 70, 70, 16, (70, 41), (0, 0)),
    (1, 2, 5, 130, 16, (100,), None),
    (2, 1, 1, 96, 8, (61, 96), (60, 95)),       # single-query decode
]


@pytest.mark.parametrize("B,H,Sq,Sk,D,kv,qs", _CAUSAL_CASES)
def test_causal_attention_matches_jax(B, H, Sq, Sk, D, kv, qs):
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(B, H, s, D).astype(np.float32) for s in (Sq, Sk, Sk))
    kvl = np.asarray(kv, np.int32)
    jq, tq = _both(q)
    jk, tk = _both(k)
    jv, tv = _both(v)
    jqs = None if qs is None else jnp.asarray(qs, jnp.int32)
    tqs = None if qs is None else torch.tensor(qs)
    ref = jattn._attention_xla(jq, jk, jv, causal=True, sm_scale=D ** -0.5,
                               kv_lens=jnp.asarray(kvl), bias=None, q_start=jqs)
    got = tattn.dot_product_attention(tq, tk, tv, causal=True,
                                      kv_lens=torch.from_numpy(kvl),
                                      q_start=tqs).numpy()
    np.testing.assert_allclose(got, _np(ref), atol=ATOL, rtol=ATOL)
    fl = tattn.flash_attention(tq, tk, tv, causal=True,
                               kv_lens=torch.from_numpy(kvl), q_start=tqs)
    np.testing.assert_allclose(fl.numpy(), _np(ref), atol=ATOL, rtol=ATOL)


def test_flash_matches_pallas_interpret():
    """Port flash entry vs `_flash_fwd` in interpret mode, both causal
    conventions (as test_ops.py:56)."""
    rng = np.random.RandomState(3)
    q = rng.randn(1, 2, 256, 64).astype(np.float32)
    k = rng.randn(1, 2, 384, 64).astype(np.float32)
    v = rng.randn(1, 2, 384, 64).astype(np.float32)
    kv = jnp.array([300], jnp.int32)
    for q_start in (kv - 256, jnp.zeros((1,), jnp.int32)):
        with pltpu.force_tpu_interpret_mode():
            ref, _ = jattn._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), kv, q_start, causal=True,
                                      sm_scale=0.125)
        got = tattn.flash_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=True, kv_lens=torch.tensor([300]),
            q_start=torch.from_numpy(np.array(q_start)), sm_scale=0.125)
        np.testing.assert_allclose(got.numpy(), _np(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,S,H,D,win", [(2, 130, 3, 16, 0), (1, 256, 2, 72, 64),
                                         (1, 64, 2, 8, 16)])
def test_bshd_and_packed_match_jax(B, S, H, D, win):
    rng = np.random.RandomState(4)
    qkv = rng.randn(B, S, 3 * H * D).astype(np.float32)
    x = qkv.reshape(B, S, 3, H, D)
    jref = jattn._attention_xla_bshd(*(jnp.asarray(x[:, :, i]) for i in range(3)),
                                     D ** -0.5, win)
    tq = torch.from_numpy(qkv)
    got = tattn.attention_packed_qkv_padded(tq, H, D, win=win).numpy()
    np.testing.assert_allclose(got, _np(jref).reshape(B, S, H * D), atol=ATOL,
                               rtol=ATOL)
    # the JAX padded entry takes heads pre-padded to 128 lanes; the port
    # takes them unpadded
    xp = np.pad(x, ((0, 0), (0, 0), (0, 0), (0, 0), (0, 128 - D)))
    jpad = jattn.attention_packed_qkv_padded(
        jnp.asarray(xp.reshape(B, S, 3 * H * 128)), H, D, win=win)
    jpad = _np(jpad).reshape(B, S, H, 128)[..., :D].reshape(B, S, H * D)
    np.testing.assert_allclose(got, jpad, atol=ATOL, rtol=ATOL)
    if win == 0:
        t = [torch.from_numpy(np.ascontiguousarray(x[:, :, i])) for i in range(3)]
        got = tattn.attention_bshd(*t).numpy()
        np.testing.assert_allclose(got, _np(jref), atol=ATOL, rtol=ATOL)
        cross = tattn.attention_bshd_cross(t[0][:, :S // 2], t[1], t[2]).numpy()
        jc = jattn.attention_bshd_cross(jnp.asarray(x[:, :S // 2, 0]),
                                        jnp.asarray(x[:, :, 1]),
                                        jnp.asarray(x[:, :, 2]))
        np.testing.assert_allclose(cross, _np(jc), atol=ATOL, rtol=ATOL)


def test_bshd_matches_pallas_interpret():
    """Port BSHD entry vs `_bshd_kernel` in interpret mode (test_ops.py:422)."""
    rng = np.random.RandomState(5)
    B, S, H, D = 1, 130, 2, 88
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        ref = jattn._attention_bshd_tpu(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), D ** -0.5)
    got = tattn._bshd_fwd(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), D ** -0.5)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=2e-5, rtol=2e-5)


def test_masked_and_biased_attention_stay_plain():
    rng = np.random.RandomState(6)
    q, k, v = (rng.randn(2, 2, 9, 8).astype(np.float32) for _ in range(3))
    mask = rng.rand(2, 9) > 0.3
    bias = rng.randn(2, 2, 9, 9).astype(np.float32)
    ref = jattn.dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                      kv_mask=jnp.asarray(mask),
                                      bias=jnp.asarray(bias))
    got = tattn.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                      kv_mask=torch.from_numpy(mask),
                                      bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=ATOL, rtol=ATOL)
    # the int8-cache branch (tests/test_torch_quant.py) wants both scales
    # and, for a 4-D (stacked) cache, the layer
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        tattn.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                    k_scale=torch.ones(2, 2, 9))
    with pytest.raises(ValueError, match="layer"):
        tattn.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                    k_scale=torch.ones(2, 2, 9),
                                    v_scale=torch.ones(2, 2, 9))


# ---------------------------------------------------------------------------
# K1 tile-loop emulation
# ---------------------------------------------------------------------------
BM, BN = tattn.K1_BM, tattn.K1_BN
WG_ROWS = 64     # query rows of one consumer warpgroup


def _k1_emulate(q, k, v, *, causal, sm_scale, kv_lens=None, q_start=None,
                win=0):
    """q/k/v [B,H,S,D] f32. Follows attn_fwd_sm90 (K1's wgmma route) tile by
    tile: 128-query CTAs handed out longest first, the CTA's live key
    range, 128-key tiles zero-filled past Sk (TMA), V rows in [kv_len, Sk)
    of a tile zeroed, and per 64-row warpgroup the mask applied only on a
    tile that crosses kv_len, the causal diagonal or a window edge, each
    row's keys one interval [lo, hi); online softmax on exp2. Returns
    (out, key tiles visited, warpgroup tiles masked, warpgroup tiles
    unmasked)."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    out = torch.zeros_like(q)
    visited = masked = unmasked = 0
    log2e = 1.4426950408889634
    for b in range(B):
        kv_len = min(int(kv_lens[b]), Sk) if kv_lens is not None else Sk
        q_off = int(q_start[b]) if q_start is not None else 0
        for m0 in reversed(range(0, Sq, BM)):      # longest tiles first
            last = min(m0 + BM, Sq) - 1
            k_lo, k_hi = 0, kv_len
            if causal:
                k_hi = min(k_hi, q_off + last + 1)
            if win:
                k_lo = (m0 // win) * win
                k_hi = min(k_hi, (last // win + 1) * win)
            j_lo = k_lo // BN
            ntiles = -(-k_hi // BN) - j_lo if k_hi > k_lo else 0
            halves = []
            for m0w in range(m0, min(m0 + BM, Sq), WG_ROWS):
                rows = torch.arange(m0w, min(m0w + WG_ROWS, Sq))
                lo = torch.zeros(len(rows), dtype=torch.long)
                hi = torch.full((len(rows),), kv_len)
                if causal:
                    hi = torch.minimum(hi, q_off + rows + 1)
                if win:
                    lo = rows // win * win
                    hi = torch.minimum(hi, lo + win)
                halves.append(dict(m0w=m0w, rows=rows, lo=lo, hi=hi,
                                   m=torch.full((H, len(rows)), -math.inf),
                                   l=torch.zeros(H, len(rows)),
                                   acc=torch.zeros(H, len(rows), D)))
            for it in range(ntiles):
                visited += 1
                k0 = (j_lo + it) * BN
                n = max(0, min(BN, Sk - k0))
                kt = torch.zeros(H, BN, D)
                vt = torch.zeros(H, BN, D)
                kt[:, :n], vt[:, :n] = k[b, :, k0:k0 + n], v[b, :, k0:k0 + n]
                if kv_len - k0 < BN and kv_len < Sk:    # slack rows: zeroed
                    vt[:, kv_len - k0:] = 0
                keys = torch.arange(k0, k0 + BN)
                for hw in halves:
                    s = (q[b, :, hw["rows"]] @ kt.transpose(1, 2)) * (
                        sm_scale * log2e)
                    edge = (k0 + BN > kv_len
                            or (causal and k0 + BN - 1 > q_off + hw["m0w"])
                            or win > 0)
                    if edge:
                        masked += 1
                        ok = ((keys[None, :] >= hw["lo"][:, None])
                              & (keys[None, :] < hw["hi"][:, None]))
                        s = torch.where(ok, s, -math.inf)
                    else:
                        unmasked += 1
                    mx = torch.maximum(hw["m"], s.amax(-1))
                    base = torch.where(mx == -math.inf, 0.0, mx)
                    alpha = torch.exp2(hw["m"] - base)
                    p = torch.exp2(s - base[..., None])
                    hw["l"] = hw["l"] * alpha + p.sum(-1)
                    hw["acc"] = hw["acc"] * alpha[..., None] + p @ vt
                    hw["m"] = mx
            for hw in halves:
                inv = torch.where(hw["l"] > 0, 1.0 / hw["l"], 0.0)
                out[b, :, hw["rows"]] = hw["acc"] * inv[..., None]
    return out, visited, masked, unmasked


def _k1_case(case):
    """Inputs of one emulation case: (q, k, v, causal, kv_lens, q_start,
    win)."""
    rng = np.random.RandomState(7)
    B, H, D = 2, 2, 8
    Sq = Sk = 200
    causal, kv, qs, win = False, None, None, 0
    if case == "prefill":
        causal, kv, qs = True, [200, 130], [0, 0]
    elif case == "last_sq":
        Sq, causal, kv = 70, True, [200, 150]
        qs = [kv[0] - Sq, kv[1] - Sq]
    elif case == "kv_short":
        kv = [37, 200]
    elif case == "win16":
        Sq = Sk = 192
        win = 16
    elif case == "win64":
        Sq = Sk = 256
        win = 64
    elif case == "win256":
        Sq = Sk = 512
        win = 256
    elif case == "long_prefill":     # interior tiles below the diagonal
        Sq = Sk = 520
        causal, kv, qs = True, [520, 400], [0, 0]
    q = torch.from_numpy(rng.randn(B, H, Sq, D).astype(np.float32))
    k = torch.from_numpy(rng.randn(B, H, Sk, D).astype(np.float32))
    v = torch.from_numpy(rng.randn(B, H, Sk, D).astype(np.float32))
    kvt = None if kv is None else torch.tensor(kv)
    qst = None if qs is None else torch.tensor(qs)
    return q, k, v, causal, kvt, qst, win


def _k1_ref(q, k, v, causal, kvt, qst, win):
    D = q.shape[-1]
    if win:
        return tattn._attention_plain_bshd(q.transpose(1, 2), k.transpose(1, 2),
                                           v.transpose(1, 2), D ** -0.5,
                                           win).transpose(1, 2)
    return tattn._attention_plain(q, k, v, causal=causal, sm_scale=D ** -0.5,
                                  kv_lens=kvt, q_start=qst)


@pytest.mark.parametrize("case", ["prefill", "last_sq", "kv_short", "win16",
                                  "win64", "win256", "full", "long_prefill"])
def test_k1_tile_emulation_matches_plain(case):
    q, k, v, causal, kvt, qst, win = _k1_case(case)
    B, _, Sq, D = q.shape
    Sk = k.shape[2]
    got, visited, masked, unmasked = _k1_emulate(
        q, k, v, causal=causal, sm_scale=D ** -0.5, kv_lens=kvt, q_start=qst,
        win=win)
    ref = _k1_ref(q, k, v, causal, kvt, qst, win)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=ATOL)
    all_tiles = B * -(-Sq // BM) * -(-Sk // BN)
    if case in ("prefill", "kv_short", "win16", "win64", "win256",
                "long_prefill"):
        assert visited < all_tiles     # masked key tiles were skipped
    else:
        assert visited <= all_tiles
    if case in ("full", "long_prefill"):
        assert unmasked > 0            # interior tiles ran without the mask
    if win:
        assert unmasked == 0


def test_k1_emulation_empty_rows_write_zero():
    """A query row with no valid key (q_start + row < 0) is 0 in the kernel,
    where the plain twin averages V. Tests compare valid rows only."""
    q = torch.randn(1, 1, 10, 8)
    k = torch.randn(1, 1, 10, 8)
    v = torch.randn(1, 1, 10, 8)
    out = _k1_emulate(q, k, v, causal=True, sm_scale=0.3,
                      kv_lens=torch.tensor([10]), q_start=torch.tensor([-4]))[0]
    assert torch.all(out[0, 0, :4] == 0)
    ref = tattn._attention_plain(q, k, v, causal=True, sm_scale=0.3,
                                 kv_lens=torch.tensor([10]),
                                 q_start=torch.tensor([-4]))
    np.testing.assert_allclose(out[0, 0, 4:].numpy(), ref[0, 0, 4:].numpy(),
                               atol=ATOL, rtol=ATOL)


def test_k1_emulation_nan_slack_stays_finite():
    """Keys in [kv_len, Sk) are real memory, uninitialised in a KV cache's
    slack: filled with NaN they leave the output finite (their V rows are
    zeroed in the last live tile, their logits masked by selection) and
    equal to the twin on a copy with the slack zeroed."""
    rng = np.random.RandomState(11)
    B, H, Sq, Sk, D = 2, 2, 150, 300, 8
    kv, qs = [200, 257], [50, 107]
    q = torch.from_numpy(rng.randn(B, H, Sq, D).astype(np.float32))
    k = torch.from_numpy(rng.randn(B, H, Sk, D).astype(np.float32))
    v = torch.from_numpy(rng.randn(B, H, Sk, D).astype(np.float32))
    kvt, qst = torch.tensor(kv), torch.tensor(qs)
    ref = tattn._attention_plain(q, k, v, causal=True, sm_scale=D ** -0.5,
                                 kv_lens=kvt, q_start=qst)
    for b, n in enumerate(kv):
        k[b, :, n:] = float("nan")
        v[b, :, n:] = float("nan")
    out = _k1_emulate(q, k, v, causal=True, sm_scale=D ** -0.5, kv_lens=kvt,
                      q_start=qst)[0]
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=ATOL)


# ---------------------------------------------------------------------------
# K2 + fused window block
# ---------------------------------------------------------------------------
def _block_params(rng, C, H):
    M = 4 * C
    return dict(
        ln1_scale=rng.randn(C) * 0.1 + 1, ln1_bias=rng.randn(C) * 0.1,
        wqkv=rng.randn(C, 3 * C) / np.sqrt(C), bqkv=rng.randn(3 * C) * 0.02,
        wproj=rng.randn(C, C) / np.sqrt(C), bproj=rng.randn(C) * 0.02,
        ln2_scale=rng.randn(C) * 0.1 + 1, ln2_bias=rng.randn(C) * 0.1,
        wup=rng.randn(C, M) / np.sqrt(C), bup=rng.randn(M) * 0.02,
        wdown=rng.randn(M, C) / np.sqrt(M), bdown=rng.randn(C) * 0.02)


def _to_torch_block(p):
    t = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in p.items()}
    return dict(ln1_weight=t["ln1_scale"], ln1_bias=t["ln1_bias"],
                qkv_weight=t["wqkv"].T.contiguous(), qkv_bias=t["bqkv"],
                proj_weight=t["wproj"].T.contiguous(), proj_bias=t["bproj"],
                ln2_weight=t["ln2_scale"], ln2_bias=t["ln2_bias"],
                fc1_weight=t["wup"].T.contiguous(), fc1_bias=t["bup"],
                fc2_weight=t["wdown"].T.contiguous(), fc2_bias=t["bdown"])


@pytest.mark.parametrize("NW,S,H,hd", [(4, 64, 2, 24), (8, 16, 4, 8),
                                       (2, 256, 2, 16)])
def test_fused_window_block_matches_jax(NW, S, H, hd):
    rng = np.random.RandomState(8)
    C = H * hd
    p = _block_params(rng, C, H)
    x = (rng.randn(NW, S, C) * 0.5).astype(np.float32)
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
    ref = jfb._fused_block_ref(jnp.asarray(x), jp, H)
    got = tfb.fused_window_block(torch.from_numpy(x), _to_torch_block(p), H)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=3e-5, rtol=3e-5)
    if S == 64:
        # the Pallas kernel itself, interpret mode (test_ops.py:359)
        kern = jfb._fused_block_fwd(jnp.asarray(x), jp, num_heads=H, eps=1e-6,
                                    interpret=True)
        np.testing.assert_allclose(got.numpy(), _np(kern), atol=3e-5, rtol=3e-5)


def test_gemm_epilogue_plain_rounding_order():
    """K2's CPU twin: product, + bias, GELU, + residual, each in the working
    dtype (bf16 here, so the rounding points matter)."""
    rng = np.random.RandomState(9)
    a = torch.from_numpy(rng.randn(5, 16).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.randn(24, 16).astype(np.float32) / 4).bfloat16()
    b = torch.from_numpy(rng.randn(24).astype(np.float32)).bfloat16()
    r = torch.from_numpy(rng.randn(5, 24).astype(np.float32)).bfloat16()
    got = tfb.gemm_epilogue(a, w, b, gelu=True, residual=r)
    y = torch.nn.functional.linear(a, w)          # rounded to bf16
    y = torch.nn.functional.gelu(y + b, approximate="tanh")
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, r + y, atol=0, rtol=0)
