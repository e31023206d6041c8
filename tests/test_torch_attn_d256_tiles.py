"""The tile walks of K1 at head dim 256 and of K7 on Hopper
(csrc/attention_fwd.cu, csrc/window_attention.cu, csrc/attn_sm90.cuh),
emulated in torch on the CPU.

`_k1_walk` follows K1's body tile by tile: 128-query CTAs of two 64-row
consumer warpgroups, key tiles of `key_tile(depth)` keys (64 at depth 256),
the live key range of each CTA (causal order, per-row q_start, kv_len) so
that wholly masked tiles are never visited, the mask applied only on tiles
that cross kv_len or the diagonal, the online softmax on exp2, the V rows
in [kv_len, Sk) zeroed, TMA's zero fill of rows past S and of the depth
past D (D = 200 pads to 256), and the row LSE. `_k7_walk` follows K7's two
passes at 64- and 128-row query tiles: the exact row maximum and sum from
Q K^T alone, then exp(s - m) / l into P V, the key columns past S masked
on the last tile. With `bf16=True` the walks round as the card does: f32
operands to bf16 first (the staging pass, `stage_bf16`), K1's unnormalised
p and K7's normalised p to bf16 before P V.

Held in f32 against the JAX package: `_attention_xla` in this process, and
`_flash_fwd` (K1's TPU kernel, with its LSE) and `_window_attention` (K7's)
through Pallas interpret mode in ONE child process with a time limit, fed
by an .npz of the same inputs, so that an interpret-mode deadlock fails
these comparisons and cannot hang the suite; and against the port's plain
twins. Tolerances: 2e-5 against JAX in f32 (summation order; the JAX
package's own tests hold its Pallas kernels there, tests/test_ops.py:80,
:310); 1e-5 against the f32 twins; with bf16 rounding, relative L2 1e-2
against K1's twin (the walk rounds the unnormalised p, the twin the
normalised one: the card's tolerance) and 5e-4 against K7's (both round
the normalised p; the card's `TOL_ATTN_L2_EXACT`).
"""
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoglamm_tpu.ops.attention import _attention_xla
from videoglamm_torch.ops import attention as A
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LOG2E = 1.4426950408889634
BM = A.K1_BM
TOL_JAX = 2e-5
TOL_TWIN_F32 = 1e-5
TOL_K1_BF16 = 1e-2
TOL_K7_BF16 = 5e-4

# (B, H, Sq, Sk, D, kv_lens, q_start, causal): depth 256 (D 256 and 200)
K1_CASES = {
    "d256": (2, 1, 300, 300, 256, (300, 300), (0, 0), False),
    "d256_kvlen": (1, 2, 190, 333, 256, (250,), (60,), False),
    "d200_causal": (2, 2, 200, 333, 200, (333, 250), (-40, 50), True),
    "d256_prefill": (1, 1, 260, 260, 256, (260,), (0,), True),
}
# (B, H, S, D): K7 at depth 256 and at the towers' padded depths
K7_CASES = {"memory": (2, 1, 300, 256), "d200": (1, 2, 130, 200),
            "iv2": (1, 2, 260, 88), "clip": (1, 1, 577, 64)}


def _inputs(name, shapes):
    rng = np.random.RandomState(sum(map(ord, name)))
    return tuple(rng.randn(*s).astype(np.float32) for s in shapes)


def _k1_inputs(name):
    B, H, Sq, Sk, D, kv, qs, causal = K1_CASES[name]
    q, k, v = _inputs(name, [(B, H, Sq, D), (B, H, Sk, D), (B, H, Sk, D)])
    return q, k, v, np.array(kv, np.int32), np.array(qs, np.int32), causal


def _k7_inputs(name):
    B, H, S, D = K7_CASES[name]
    return _inputs(name, [(B, H, S, D)] * 3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rows(x, r0, n, depth):
    """Rows [r0, r0 + n) of x [H, S, D] and columns up to `depth`, zero past
    S and past D (TMA's fill)."""
    out = x.new_zeros(x.shape[0], n, depth)
    m = max(0, min(n, x.shape[1] - r0))
    out[:, :m, :x.shape[2]] = x[:, r0:r0 + m]
    return out


def _bf(x):
    return x.to(torch.bfloat16).float()


def _operands(q, k, v, bf16):
    """What the body reads: bf16 operands (the staging pass's copies for
    f32), as f32 values."""
    if bf16:
        return tuple(t.float() for t in A.stage_bf16(q, k, v))
    return q.float(), k.float(), v.float()


def _k1_walk(q, k, v, kv_lens, q_start, causal, sm_scale, bf16, stats):
    """K1's body: returns (out [B,H,Sq,D] f32, lse [B,H,Sq])."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    depth = A._tma_depth(D, "walk")
    BN = A.key_tile(depth)
    qf, kf, vf = _operands(q, k, v, bf16)
    out = torch.zeros(B, H, Sq, D)
    lse = torch.full((B, H, Sq), A.NEG_INF)
    scale2 = sm_scale * LOG2E
    for b in range(B):
        kv_len, q_off = min(int(kv_lens[b]), Sk), int(q_start[b])
        for m0 in range(0, Sq, BM):
            last_row = min(m0 + BM, Sq) - 1
            k_hi = min(kv_len, q_off + last_row + 1) if causal else kv_len
            ntiles = -(-k_hi // BN) if k_hi > 0 else 0
            stats["tiles"] += ntiles
            for m0w in (m0, m0 + 64):
                rows = torch.arange(m0w, m0w + 64)
                hi = torch.full((64,), kv_len)
                if causal:
                    hi = torch.minimum(hi, q_off + rows + 1)
                qw = _rows(qf[b], m0w, 64, depth)
                o = torch.zeros(H, 64, depth)
                m = torch.full((H, 64, 1), -math.inf)
                l = torch.zeros(H, 64, 1)
                for j in range(ntiles):
                    k0 = j * BN
                    kt, vt = _rows(kf[b], k0, BN, depth), _rows(vf[b], k0, BN, depth)
                    if k0 + BN > kv_len and kv_len < Sk:   # the slack's V rows
                        vt[:, kv_len - k0:] = 0
                    s = qw @ kt.transpose(-1, -2)
                    edge = k0 + BN > kv_len or (causal and k0 + BN - 1 > q_off + m0w)
                    if edge:
                        stats["masked"] += 1
                        keys = torch.arange(k0, k0 + BN)
                        ok = keys[None, :] < hi[:, None]
                        s = torch.where(ok, s * scale2, -math.inf)
                    else:
                        s = s * scale2
                    mx = torch.maximum(m, s.amax(-1, keepdim=True))
                    base = torch.where(mx == -math.inf, 0.0, mx)
                    alpha = torch.exp2(m - base)
                    p = torch.exp2(s - base)
                    l = l * alpha + p.sum(-1, keepdim=True)
                    o = o * alpha + (_bf(p) if bf16 else p) @ vt
                    m = mx
                n = max(0, min(64, Sq - m0w))
                inv = torch.where(l > 0, 1.0 / l, 0.0)
                out[b, :, m0w:m0w + n] = (o * inv)[:, :n, :D]
                ls = torch.where(l > 0, m / LOG2E + torch.log(l), A.NEG_INF)
                lse[b, :, m0w:m0w + n] = ls[:, :n, 0]
    return out, lse


def _k7_walk(q, k, v, sm_scale, rows, bf16, stats):
    """K7's body with `rows`-query CTAs: the two passes. Returns out f32."""
    B, H, S, D = q.shape
    depth = A._tma_depth(D, "walk")
    BN = A.key_tile(depth)
    qf, kf, vf = _operands(q, k, v, bf16)
    out = torch.zeros(B, H, S, D)
    scale2 = sm_scale * LOG2E
    ntiles = -(-S // BN)
    for b in range(B):
        for m0 in range(0, S, rows):
            stats["ctas"] += 1
            for m0w in range(m0, m0 + rows, 64):
                qw = _rows(qf[b], m0w, 64, depth)

                def logits(j):
                    k0 = j * BN
                    s = qw @ _rows(kf[b], k0, BN, depth).transpose(-1, -2)
                    keys = torch.arange(k0, k0 + BN)
                    return torch.where(keys < S, s * scale2, -math.inf)

                m = torch.full((H, 64, 1), -math.inf)
                l = torch.zeros(H, 64, 1)
                for j in range(ntiles):                      # pass 1
                    s = logits(j)
                    mx = torch.maximum(m, s.amax(-1, keepdim=True))
                    l = l * torch.exp2(m - mx) + torch.exp2(s - mx).sum(-1, keepdim=True)
                    m = mx
                inv = 1.0 / l
                o = torch.zeros(H, 64, depth)
                for j in range(ntiles):                      # pass 2
                    p = torch.exp2(logits(j) - m) * inv
                    o = o + (_bf(p) if bf16 else p) @ _rows(vf[b], j * BN, BN, depth)
                stats["tiles"] += 2 * ntiles
                n = max(0, min(64, S - m0w))
                out[b, :, m0w:m0w + n] = o[:, :n, :D]
    return out


_CHILD = r"""
import sys
import numpy as np
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from videoglamm_tpu.ops.attention import _flash_fwd, _window_attention
d = np.load(sys.argv[1])
out = {}
with pltpu.force_tpu_interpret_mode():
    for key in d.files:
        kind, name = key.split(".", 1)
        if kind == "k1q":
            q, k, v, kvl, qs = (jnp.asarray(d[f"{c}.{name}"])
                                for c in ("k1q", "k1k", "k1v", "k1kvl", "k1qs"))
            causal = bool(d["k1causal." + name])
            o, lse = _flash_fwd(q, k, v, kvl, qs, causal=causal,
                                sm_scale=q.shape[-1] ** -0.5)
            out["k1." + name] = np.asarray(o)
            B, H, Sq = q.shape[:3]
            out["k1lse." + name] = np.asarray(lse)[:, :Sq, 0].reshape(B, H, Sq)
        elif kind == "k7q":
            q, k, v = (jnp.asarray(d[f"{c}.{name}"]) for c in ("k7q", "k7k", "k7v"))
            out["k7." + name] = np.asarray(
                _window_attention(q, k, v, q.shape[-1] ** -0.5))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def pallas_refs(tmp_path_factory):
    """K1's and K7's TPU kernels (interpret mode) on this file's inputs,
    from a child process with a time limit."""
    tmp = tmp_path_factory.mktemp("pallas_d256_refs")
    feed = {}
    for name in K1_CASES:
        q, k, v, kvl, qs, causal = _k1_inputs(name)
        feed.update({f"k1q.{name}": q, f"k1k.{name}": k, f"k1v.{name}": v,
                     f"k1kvl.{name}": kvl, f"k1qs.{name}": qs,
                     f"k1causal.{name}": np.array(causal)})
    for name in K7_CASES:
        q, k, v = _k7_inputs(name)
        feed.update({f"k7q.{name}": q, f"k7k.{name}": k, f"k7v.{name}": v})
    np.savez(tmp / "in.npz", **feed)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, JAX_PLATFORMS="cpu")
    try:
        res = subprocess.run(
            [sys.executable, "-c", _CHILD, str(tmp / "in.npz"),
             str(tmp / "out.npz")], capture_output=True, text=True, cwd=root,
            env=env, timeout=300)
    except subprocess.TimeoutExpired:
        pytest.fail("the Pallas interpret-mode child did not return in 300 s")
    assert res.returncode == 0, res.stderr[-2000:]
    return dict(np.load(tmp / "out.npz"))


def _close(got, ref, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol,
                               err_msg=what)


def _rel_l2(got, ref):
    g, r = got.double(), ref.double()
    return ((g - r).norm() / r.norm()).item()


# ---------------------------------------------------------------------------
# K1 at depth 256
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(K1_CASES))
def test_k1_d256_walk_matches_jax_f32(name, pallas_refs):
    """The walk in f32 against `_attention_xla`, the Pallas flash kernel in
    interpret mode (output and LSE) and the port's f32 twin."""
    q, k, v, kvl, qs, causal = _k1_inputs(name)
    D = q.shape[-1]
    stats = {"tiles": 0, "masked": 0}
    got, lse = _k1_walk(_t(q), _t(k), _t(v), kvl, qs, causal, D ** -0.5, False,
                        stats)
    assert A.key_tile(A._tma_depth(D, "walk")) == 64
    ref = _attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, sm_scale=D ** -0.5,
                         kv_lens=jnp.asarray(kvl), bias=None,
                         q_start=jnp.asarray(qs))
    # rows with no valid key (q_start < 0): the port writes 0 there and its
    # LSE -1e30, where both JAX functions spread the row over the masked
    # keys (a finite NEG_INF); the rows that have keys are compared
    live = pallas_refs["k1lse." + name] > -1e29
    _close(got.numpy()[live], np.asarray(ref)[live], TOL_JAX, "vs _attention_xla")
    _close(got.numpy()[live], pallas_refs["k1." + name][live], TOL_JAX,
           "vs _flash_kernel")
    assert (got.numpy()[~live] == 0).all()
    _close(lse.numpy()[live], pallas_refs["k1lse." + name][live], TOL_JAX,
           "lse vs _flash_kernel")
    assert (lse.numpy()[~live] == A.NEG_INF).all()
    twin, twin_lse = A._flash_fwd_plain(_t(q), _t(k), _t(v), _t(kvl), _t(qs),
                                        causal, D ** -0.5)
    _close(got, twin, TOL_TWIN_F32, "vs _flash_fwd_plain")
    _close(lse, twin_lse, TOL_TWIN_F32, "lse vs _flash_fwd_plain")
    # a key tile wholly past kv_len or the diagonal is never visited
    B, Sk = q.shape[0], k.shape[2]
    want = 0
    for b in range(B):
        for m0 in range(0, q.shape[2], BM):
            hi = min(int(kvl[b]), Sk)
            if causal:
                hi = min(hi, int(qs[b]) + min(m0 + BM, q.shape[2]))
            want += -(-hi // 64) if hi > 0 else 0
    assert stats["tiles"] == want


@pytest.mark.parametrize("name", list(K1_CASES))
def test_k1_d256_walk_rounds_as_the_card(name):
    """f32 operands rounded to bf16 by the staging pass and the
    unnormalised p rounded before P V: against the port's twin on the
    staged operands at the card's tolerance; and the walk on bf16 operands
    is the walk on the f32 ones after staging."""
    q, k, v, kvl, qs, causal = _k1_inputs(name)
    D = q.shape[-1]
    stats = {"tiles": 0, "masked": 0}
    got, lse = _k1_walk(_t(q), _t(k), _t(v), kvl, qs, causal, D ** -0.5, True,
                        stats)
    qb, kb, vb = A.stage_bf16(_t(q), _t(k), _t(v))
    assert qb.dtype == torch.bfloat16 and qb.is_contiguous()
    assert torch.equal(qb, _t(q).to(torch.bfloat16))
    twin, twin_lse = A._flash_fwd_plain(qb, kb, vb, _t(kvl), _t(qs), causal,
                                        D ** -0.5)
    live = twin_lse > -1e29
    rows = live[..., None].expand_as(got)
    assert _rel_l2(got[rows], twin.float()[rows]) <= TOL_K1_BF16
    assert (got[~rows] == 0).all()
    assert (lse[live] - twin_lse[live]).abs().max().item() <= 1e-3
    again, _ = _k1_walk(qb, kb, vb, kvl, qs, causal, D ** -0.5, True, stats)
    assert torch.equal(again, got)


# ---------------------------------------------------------------------------
# K7: two passes, 64- and 128-row query tiles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("name", list(K7_CASES))
def test_k7_walk_matches_jax_f32(name, rows, pallas_refs):
    """Both query tiles, in f32, against `_attention_xla`, `_window_kernel`
    in interpret mode and the port's twin; the CTA count follows the tile."""
    q, k, v = _k7_inputs(name)
    B, H, S, D = q.shape
    stats = {"ctas": 0, "tiles": 0}
    got = _k7_walk(_t(q), _t(k), _t(v), D ** -0.5, rows, False, stats)
    assert stats["ctas"] == B * -(-S // rows)
    ref = _attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=False, sm_scale=D ** -0.5, kv_lens=None,
                         bias=None)
    _close(got, ref, TOL_JAX, "vs _attention_xla")
    _close(got, pallas_refs["k7." + name], TOL_JAX, "vs _window_kernel")
    _close(got, A._window_attention_plain(_t(q), _t(k), _t(v), D ** -0.5),
           TOL_TWIN_F32, "vs _window_attention_plain")


@pytest.mark.parametrize("name", list(K7_CASES))
def test_k7_walk_rounds_where_the_twin_rounds(name):
    """With the card's rounding (staged operands, the normalised p to bf16)
    the walk is the twin on the staged operands to `TOL_ATTN_L2_EXACT`, and
    the two query tiles give the same values (a row's arithmetic does not
    depend on the tile that holds it)."""
    q, k, v = _k7_inputs(name)
    D = q.shape[-1]
    stats = {"ctas": 0, "tiles": 0}
    got64 = _k7_walk(_t(q), _t(k), _t(v), D ** -0.5, 64, True, stats)
    got128 = _k7_walk(_t(q), _t(k), _t(v), D ** -0.5, 128, True, stats)
    assert torch.equal(got64, got128)
    twin = A._window_attention_plain(*A.stage_bf16(_t(q), _t(k), _t(v)),
                                     D ** -0.5)
    # the card stores O in the operands' dtype, as the twin returns it
    assert _rel_l2(_bf(got64), twin.float()) <= TOL_K7_BF16
