"""The differentiable ops of the videoglamm_torch training path against the
JAX package on the CPU: K6's plain twin and the `flash_attention`
autograd Function, K1's LSE twin, the norm backwards, `resize_bilinear`,
RoPE, the label splice, the three losses, the schedule and the optimizer.

Inputs come from numpy seeds and go through both sides in f32. The JAX
side is the XLA reference (`_attention_xla`, `_rms_norm_ref`,
`_layer_norm_ref`): the Pallas backward in interpret mode deadlocks on the
CPU (ROADMAP.md) and is not run.

Tolerances: 2e-4 on the attention gradients, the tolerance at which the JAX
package's own test holds its Pallas backward to the same reference
(tests/test_ops.py:521); 1e-5 / 1e-4 on the other f32 values and
gradients, which differ by summation order only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from videoglamm_tpu import config as jconfig
from videoglamm_tpu.constants import (IGNORE_INDEX, IMAGE_TOKEN_INDEX,
                                      MASK_IGNORE_INDEX)
from videoglamm_tpu.models import videoglamm as jvg
from videoglamm_tpu.models.multimodal import splice_visual_prefix as jsplice
from videoglamm_tpu.ops.attention import _attention_xla
from videoglamm_tpu.ops.norms import _layer_norm_ref, _rms_norm_ref
from videoglamm_tpu.ops.resize import resize_bilinear as jresize
from videoglamm_tpu.ops.rope import apply_rope as japply_rope
from videoglamm_tpu.ops.rope import rope_cos_sin as jrope_cos_sin
from videoglamm_tpu.training import lr_schedule as jlr_schedule
from videoglamm_torch import constants as tconst
from videoglamm_torch.io.from_jax import port_config
from videoglamm_torch.models import videoglamm as tvg
from videoglamm_torch.models.multimodal import splice_visual_prefix
from videoglamm_torch.ops import attention as A
from videoglamm_torch.ops import norms as N
from videoglamm_torch.ops.resize import resize_bilinear
from videoglamm_torch.ops.rope import apply_rope, rope_cos_sin
from videoglamm_torch.training.train_step import AdamW, lr_schedule

TOL_ATTN = 2e-4


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol, err_msg=what)


# the three cases of tests/test_ops.py:489-523: (causal, q_start given)
FLASH_CASES = {"causal_prefill": (True, True), "causal_decode": (True, False),
               "full": (False, False)}


@pytest.fixture(scope="module")
def flash_ref():
    """Inputs of tests/test_ops.py:489 (same numpy seed) and, per case, the
    XLA reference's output and jax.grad of sum(out * g)."""
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

        out = fwd(q, k, v)
        grads = jax.grad(lambda *a: (fwd(*a) * g).sum(), argnums=(0, 1, 2))(q, k, v)
        ref[name] = (np.asarray(out), [np.asarray(x) for x in grads], qs)
    return dict(q=q, k=k, v=v, kv_lens=kv_lens, g=g, ref=ref)


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_bwd_plain_matches_jax_grad(flash_ref, case):
    causal, _ = FLASH_CASES[case]
    out_ref, grads_ref, qs = flash_ref["ref"][case]
    q, k, v, g = (_t(flash_ref[n]) for n in ("q", "k", "v", "g"))
    kvl, qst = _t(flash_ref["kv_lens"]), _t(qs)
    out, lse = A._flash_fwd_plain(q, k, v, kvl, qst, causal, 0.125)
    _close(out, out_ref, 2e-5, "out")
    got = A._flash_bwd_plain(q, k, v, out, lse, g, kvl, qst, causal, 0.125)
    for name, a, b in zip(("dq", "dk", "dv"), got, grads_ref):
        _close(a, b, TOL_ATTN, f"{name} {case}")


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_function_matches_jax_grad(flash_ref, case):
    """`flash_attention` with inputs that ask for a gradient goes through
    the autograd Function (forward with LSE, K6's twin backward)."""
    causal, given = FLASH_CASES[case]
    out_ref, grads_ref, qs = flash_ref["ref"][case]
    q, k, v = (_t(flash_ref[n], grad=True) for n in ("q", "k", "v"))
    out = A.flash_attention(q, k, v, causal=causal,
                            kv_lens=_t(flash_ref["kv_lens"]),
                            q_start=_t(qs) if given else None, sm_scale=0.125)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    _close(out, out_ref, 2e-5, "out")
    # a strided gradient, as o.transpose(1, 2).reshape(...) hands it back
    g = _t(flash_ref["g"]).transpose(1, 2).contiguous().transpose(1, 2)
    got = torch.autograd.grad(out, (q, k, v), g)
    for name, a, b in zip(("dq", "dk", "dv"), got, grads_ref):
        _close(a, b, TOL_ATTN, f"{name} {case}")
    with torch.no_grad():      # no gradient asked for: the serving path
        plain = A.flash_attention(q, k, v, causal=causal,
                                  kv_lens=_t(flash_ref["kv_lens"]),
                                  q_start=_t(qs) if given else None,
                                  sm_scale=0.125)
    assert plain.grad_fn is None
    _close(plain, out_ref, 2e-5, "out (no grad)")


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_lse_plain_is_logsumexp_of_scaled_logits(flash_ref, case):
    causal, _ = FLASH_CASES[case]
    _, _, qs = flash_ref["ref"][case]
    q, k, v = (flash_ref[n] for n in ("q", "k", "v"))
    s = np.einsum("bhqd,bhkd->bhqk", q, k).astype(np.float64) * 0.125
    col = np.arange(320)[None, None, None, :]
    mask = col < flash_ref["kv_lens"][:, None, None, None]
    if causal:
        row = np.arange(200)[None, None, :, None] + qs[:, None, None, None]
        mask = mask & (row >= col)
    s = np.where(mask, s, -np.inf)
    want = np.asarray(jax.nn.logsumexp(jnp.asarray(s, jnp.float32), axis=-1))
    _, lse = A._flash_fwd_plain(_t(q), _t(k), _t(v), _t(flash_ref["kv_lens"]),
                                _t(qs), causal, 0.125)
    assert lse.shape == (2, 2, 200) and lse.dtype == torch.float32
    _close(lse, want, 1e-5)


def test_flash_rows_without_a_valid_key():
    """q_start < 0 leaves the first rows with no attendable key: lse is
    NEG_INF there, the output 0 and dq exactly 0, though exp(s - lse)
    overflows before the mask selects."""
    rng = np.random.RandomState(6)
    q, k, v = (_t(rng.randn(1, 2, 24, 16).astype(np.float32), grad=True)
               for _ in range(3))
    kvl, qst = torch.tensor([20]), torch.tensor([-5])
    out = A.flash_attention(q, k, v, causal=True, kv_lens=kvl, q_start=qst)
    _, lse = A._flash_fwd_plain(q, k, v, kvl, qst, True, 0.25)
    assert (lse[:, :, :5] == A.NEG_INF).all() and (lse[:, :, 5:] > -1e3).all()
    assert (out[:, :, :5] == 0).all()
    dq, dk, dv = torch.autograd.grad(out.sum(), (q, k, v))
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    assert (dq[:, :, :5] == 0).all() and (dq[:, :, 5:] != 0).any()
    assert (dk[:, :, 19:] == 0).all() and (dv[:, :, 19:] == 0).all()


def test_flash_bwd_plain_rounds_p_and_ds_to_the_storage_dtype():
    """In bf16 the twin rounds p and ds before the three products, as the
    kernel does: it then agrees with an f32 run to bf16 resolution only."""
    rng = np.random.RandomState(7)
    q, k, v, g = (_t(rng.randn(1, 2, 40, 32).astype(np.float32))
                  for _ in range(4))
    kvl, qst = torch.tensor([40]), torch.tensor([0])
    out, lse = A._flash_fwd_plain(q, k, v, kvl, qst, True, 32 ** -0.5)
    want = A._flash_bwd_plain(q, k, v, out, lse, g, kvl, qst, True, 32 ** -0.5)
    b = [t.bfloat16() for t in (q, k, v, out, g)]
    outb, lseb = A._flash_fwd_plain(b[0], b[1], b[2], kvl, qst, True, 32 ** -0.5)
    got = A._flash_bwd_plain(b[0], b[1], b[2], outb, lseb, b[4], kvl, qst,
                             True, 32 ** -0.5)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        rel = ((a.float() - w).norm() / w.norm()).item()
        assert 1e-4 < rel < 2e-2, rel     # 2^-8 per entry, not f32 noise


NORM_CASES = {"rms": (True, False), "ln_bias": (False, True),
              "ln_nobias": (False, False)}


@pytest.mark.parametrize("route", ["plain", "function"])
@pytest.mark.parametrize("case", sorted(NORM_CASES))
def test_norm_gradients_match_jax_vjp(case, route):
    """`rms_norm` / `layer_norm` as the CPU path runs them (autograd through
    the plain twin) and the `_RowNorm` Function the card uses (whose forward
    is the twin on CPU tensors) against jax.vjp of the references."""
    rms, has_bias = NORM_CASES[case]
    rng = np.random.RandomState(8)
    x = rng.randn(3, 17, 48).astype(np.float32) * 2
    w = (1 + 0.1 * rng.randn(48)).astype(np.float32)
    b = (0.1 * rng.randn(48)).astype(np.float32) if has_bias else None
    g = rng.randn(3, 17, 48).astype(np.float32)
    if rms:
        y_ref, vjp = jax.vjp(lambda x_, w_: _rms_norm_ref(x_, w_, 1e-5), x, w)
    elif has_bias:
        y_ref, vjp = jax.vjp(lambda x_, w_, b_: _layer_norm_ref(x_, w_, b_, 1e-5),
                             x, w, b)
    else:
        y_ref, vjp = jax.vjp(lambda x_, w_: _layer_norm_ref(x_, w_, None, 1e-5),
                             x, w)
    want = vjp(jnp.asarray(g))
    tx, tw = _t(x, True), _t(w, True)
    tb = _t(b, True) if has_bias else None
    if route == "function":
        y = N._RowNorm.apply(tx, tw, tb, 1e-5, rms)
    else:
        y = N.rms_norm(tx, tw, 1e-5) if rms else N.layer_norm(tx, tw, tb, 1e-5)
    _close(y, y_ref, 1e-5, "forward")
    ins = [tx, tw] + ([tb] if has_bias else [])
    got = torch.autograd.grad(y, ins, _t(g))
    for name, a, r in zip(("dx", "dweight", "dbias"), got, want):
        _close(a, r, 1e-4, f"{name} {case} {route}")


def test_row_norm_function_skips_gradients_not_asked_for():
    x = torch.randn(4, 32, requires_grad=True)
    w, b = torch.randn(32), torch.randn(32)
    y = N._RowNorm.apply(x, w, b, 1e-5, False)
    (dx,) = torch.autograd.grad(y.sum(), (x,))
    assert dx.shape == x.shape and w.grad is None and b.grad is None


@pytest.mark.parametrize("src,dst", [((8, 8), (20, 12)), ((32, 32), (48, 48)),
                                     ((16, 24), (8, 8))])
def test_resize_bilinear_matches_jax(src, dst):
    rng = np.random.RandomState(9)
    x = rng.randn(3, *src, 2).astype(np.float32)
    g = rng.randn(3, *dst, 2).astype(np.float32)
    y_ref, vjp = jax.vjp(lambda a: jresize(a, dst), x)
    tx = _t(x, True)
    y = resize_bilinear(tx, dst)
    _close(y, y_ref, 1e-5, "forward")
    _close(torch.autograd.grad(y, tx, _t(g))[0], vjp(jnp.asarray(g))[0], 1e-5,
           "gradient")
    yc = resize_bilinear(_t(x).movedim(-1, -3), dst, channels_last=False)
    _close(yc.movedim(-3, -1), y_ref, 1e-5, "channels first")


def test_rope_gradient_matches_jax():
    rng = np.random.RandomState(10)
    x = rng.randn(2, 3, 9, 16).astype(np.float32)
    g = rng.randn(2, 3, 9, 16).astype(np.float32)
    pos = np.tile(np.arange(9)[None], (2, 1)).astype(np.int32)
    cos, sin = jrope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    y_ref, vjp = jax.vjp(lambda a: japply_rope(a, cos, sin), x)
    tx = _t(x, True)
    tcos, tsin = rope_cos_sin(_t(pos.astype(np.int64)), 16, 10000.0)
    y = apply_rope(tx, tcos, tsin)
    _close(y, y_ref, 1e-5, "forward")
    _close(torch.autograd.grad(y, tx, _t(g))[0], vjp(jnp.asarray(g))[0], 1e-5,
           "gradient")


def test_splice_labels_and_token_ids_match_jax():
    rng = np.random.RandomState(11)
    B, S, D, V = 3, 10, 8, 5
    emb = rng.randn(B, S, D).astype(np.float32)
    vis = rng.randn(B, V, D).astype(np.float32)
    ids = rng.randint(1, 50, size=(B, S)).astype(np.int32)
    ids[0, 2] = IMAGE_TOKEN_INDEX
    ids[1, 0] = IMAGE_TOKEN_INDEX       # row 2: no placeholder
    lens = np.array([10, 7, 6], np.int32)
    labels = ids.copy()
    labels[labels < 0] = IGNORE_INDEX
    labels[:, :3] = IGNORE_INDEX
    want = jsplice(jnp.asarray(emb), jnp.asarray(ids), jnp.asarray(vis),
                   jnp.asarray(lens), jnp.asarray(labels))
    got = splice_visual_prefix(_t(emb), _t(ids.astype(np.int64)), _t(vis),
                               _t(lens.astype(np.int64)),
                               _t(labels.astype(np.int64)))
    for f in ("embeds", "labels", "attn_lens", "positions", "is_visual",
              "token_ids"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    none = splice_visual_prefix(_t(emb), _t(ids.astype(np.int64)), _t(vis),
                                _t(lens.astype(np.int64)))
    assert (none.labels == IGNORE_INDEX).all()
    assert (tconst.IGNORE_INDEX, tconst.MASK_IGNORE_INDEX,
            tconst.IMAGE_TOKEN_INDEX) == (IGNORE_INDEX, MASK_IGNORE_INDEX,
                                          IMAGE_TOKEN_INDEX)


def test_ce_loss_matches_jax_with_ignored_positions():
    rng = np.random.RandomState(12)
    logits = rng.randn(2, 9, 37).astype(np.float32) * 3
    labels = rng.randint(0, 37, size=(2, 9)).astype(np.int32)
    labels[0, :4] = IGNORE_INDEX
    labels[1, 6:] = IGNORE_INDEX
    val, grad = jax.value_and_grad(
        lambda l: jvg.ce_loss_fn(l, jnp.asarray(labels), 37))(logits)
    tl = _t(logits, True)
    loss = tvg.ce_loss_fn(tl, _t(labels.astype(np.int64)))
    _close(loss, val, 1e-6)
    _close(torch.autograd.grad(loss, tl)[0], grad, 1e-6, "gradient")
    all_ignored = tvg.ce_loss_fn(_t(logits), torch.full((2, 9), IGNORE_INDEX))
    assert float(all_ignored) == 0.0


@pytest.mark.parametrize("which", ["sigmoid_ce_loss", "dice_loss"])
def test_mask_losses_match_jax_with_ignore_regions(which):
    rng = np.random.RandomState(13)
    pred = rng.randn(2, 3, 2, 12, 12).astype(np.float32) * 4
    gt = (rng.rand(2, 3, 2, 12, 12) > 0.5).astype(np.float32)
    gt[0, 1:] = MASK_IGNORE_INDEX          # padded slots
    gt[1, 0, :, :, 6:] = MASK_IGNORE_INDEX  # partly ignored masks
    jfn, tfn = getattr(jvg, which), getattr(tvg, which)
    val, vjp = jax.vjp(lambda p: jfn(p, jnp.asarray(gt)), pred)
    tp = _t(pred, True)
    got = tfn(tp, _t(gt))
    assert got.shape == (2, 3, 2)
    _close(got, val, 1e-5)
    assert float(got[0, 1:].detach().abs().max()) <= 1e-5    # padded slots cost nothing
    w = rng.randn(2, 3, 2).astype(np.float32)
    _close(torch.autograd.grad(got, tp, _t(w))[0], vjp(jnp.asarray(w))[0], 1e-5,
           "gradient")


@pytest.mark.parametrize("warmup,total", [(0, 10), (1, 10), (100, 5000),
                                          (5, 5)])
def test_lr_schedule_matches_optax(warmup, total):
    jcfg = jconfig.TrainConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    want = jlr_schedule(jcfg)
    got = lr_schedule(port_config(jcfg))
    for count in (0, 1, 2, warmup - 1, warmup, warmup + 1, total // 2, total - 1,
                  total, total + 7):
        if count >= 0:
            # optax evaluates 1 - count / steps in f32, which cancels
            np.testing.assert_allclose(got(count), float(want(count)),
                                       rtol=1e-5, atol=1e-12,
                                       err_msg=f"count {count}")
    if warmup >= 1:
        assert got(0) == 0.0     # the first update has learning rate 0


@pytest.mark.parametrize("scale,weight_decay", [(5.0, 0.0), (0.01, 0.0),
                                                (5.0, 0.1)])
def test_adamw_update_matches_optax(scale, weight_decay):
    """clip_by_global_norm + adamw + schedule on a small tree, four updates,
    with the clip active (scale 5) and inactive (scale 0.01)."""
    jcfg = jconfig.TrainConfig(lr=1e-2, warmup_steps=2, total_steps=8,
                               grad_clip=1.0, weight_decay=weight_decay)
    rng = np.random.RandomState(14)
    shapes = {"a": (7, 5), "b": (11,), "c": (2, 3, 4)}
    params = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: (rng.randn(*s) * scale).astype(np.float32)
              for n, s in shapes.items()} for _ in range(4)]
    tx = optax.chain(optax.clip_by_global_norm(jcfg.grad_clip),
                     optax.adamw(jlr_schedule(jcfg), b1=jcfg.beta1, b2=jcfg.beta2,
                                 weight_decay=jcfg.weight_decay))
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    jstate = tx.init(jp)
    tp = {n: _t(v) for n, v in params.items()}
    opt = AdamW(port_config(jcfg), list(shapes))
    tstate = opt.init(tp)
    for i, g in enumerate(grads):
        upd, jstate = tx.update({n: jnp.asarray(v) for n, v in g.items()},
                                jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update_(tp, {n: _t(v) for n, v in g.items()}, tstate)
        for n in shapes:
            _close(tp[n], jp[n], 2e-6, f"update {i} {n}")
    assert tstate["count"] == 4
    assert not np.array_equal(tp["a"].numpy(), params["a"])
