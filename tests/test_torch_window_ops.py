"""The window-attention entries of videoglamm_torch against the JAX package
on the CPU: the medium whole-row-softmax attention (K7's function), the
tiny-window attention straight from a fused qkv (K8's function), their
recompute backwards, and `Hiera(hoist_layout=False)`, which reaches both
unfused window branches.

Inputs come from numpy seeds and everything runs in f32. On the CPU the
port's wrappers take the plain twins of K7 and K8, which is what these
tests hold to the JAX functions; the kernels themselves are held to the
twins on the card (tests/test_torch_cuda.py, chip_smoke.py).

The JAX side runs as its own tests run it on the CPU (tests/test_ops.py:
284-356): through `_attention_xla` / `_smallwin_xla` in this process, and
through the Pallas kernels `_window_attention` and `_smallwin_tpu` under
`pltpu.force_tpu_interpret_mode()`. The interpret-mode runs happen in ONE
child process with a time limit, fed by an .npz of the same inputs, so
that an interpret-mode deadlock can fail these comparisons but cannot hang
the suite.

Tolerance 2e-5 (f32 summation order), as the JAX tests of the same kernels
state; gradients the same.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import seeded_params
from videoglamm_tpu.config import HieraConfig
from videoglamm_tpu.models.sam2.hiera import Hiera as JHiera
from videoglamm_tpu.ops import dot_product_attention as jdot
from videoglamm_tpu.ops.attention import (_attention_xla, _smallwin_xla,
                                          attention_packed_qkv_smallwin as jsmallwin)
from videoglamm_torch.io import from_jax
from videoglamm_torch.models.sam2.hiera import Hiera
from videoglamm_torch.ops import attention as tattn
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 2e-5

WINDOW_CASES = {"hiera256": (2, 3, 256, 72),      # tests/test_ops.py:292
                "clip577": (1, 2, 577, 64),
                "odd130": (1, 1, 130, 88),
                "memory": (2, 1, 640, 32)}        # one wide head, as the tracker
SMALLWIN_CASES = {"stage1": (16, 64, 2, 72),      # tests/test_ops.py:327-328
                  "stage2": (32, 16, 4, 72),
                  "stage4": (8, 64, 16, 72),
                  "hd40": (6, 64, 2, 40),
                  "hd88": (24, 16, 1, 88)}
SMALLWIN_ODD = (3, 64, 2, 72)                     # NW % (128 // S) != 0


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol,
                               err_msg=what)


def _window_inputs(name):
    B, H, S, D = WINDOW_CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    return tuple(rng.randn(B, H, S, D).astype(np.float32) for _ in range(3))


def _smallwin_input(name):
    NW, S, H, hd = SMALLWIN_CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    return rng.randn(NW, S, 3 * H * hd).astype(np.float32)


_CHILD = r"""
import sys
import numpy as np
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from videoglamm_tpu.ops.attention import _smallwin_tpu, _window_attention
d = np.load(sys.argv[1])
out = {}
with pltpu.force_tpu_interpret_mode():
    for key in d.files:
        kind, name = key.split(".", 1)
        if kind == "wq":
            q, k, v = (jnp.asarray(d[f"{c}.{name}"]) for c in ("wq", "wk", "wv"))
            out["window." + name] = np.asarray(
                _window_attention(q, k, v, q.shape[-1] ** -0.5))
        elif kind == "sw":
            H, hd = (int(x) for x in d["swgeom." + name])
            out["smallwin." + name] = np.asarray(
                _smallwin_tpu(jnp.asarray(d[key]), H, hd, hd ** -0.5))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def pallas_refs(tmp_path_factory):
    """Outputs of the JAX package's two Pallas window kernels (interpret
    mode) on the inputs of this file, from a child process with a time
    limit."""
    tmp = tmp_path_factory.mktemp("pallas_window_refs")
    feed = {}
    for name in WINDOW_CASES:
        q, k, v = _window_inputs(name)
        feed.update({f"wq.{name}": q, f"wk.{name}": k, f"wv.{name}": v})
    for name, (_, _, H, hd) in SMALLWIN_CASES.items():
        feed[f"sw.{name}"] = _smallwin_input(name)
        feed[f"swgeom.{name}"] = np.array([H, hd])
    np.savez(tmp / "in.npz", **feed)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, JAX_PLATFORMS="cpu")
    try:
        res = subprocess.run(
            [sys.executable, "-c", _CHILD, str(tmp / "in.npz"),
             str(tmp / "out.npz")], capture_output=True, text=True, cwd=root,
            env=env, timeout=600)
    except subprocess.TimeoutExpired:
        pytest.fail("the Pallas interpret-mode child did not return in 600 s")
    assert res.returncode == 0, res.stderr[-2000:]
    return dict(np.load(tmp / "out.npz"))


# ---------------------------------------------------------------------------
# K7's function
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(WINDOW_CASES))
def test_window_attention_matches_jax(name, pallas_refs):
    """The port's `_window_attention` (the twin, on the CPU) against
    `_attention_xla` and against `_window_kernel` in interpret mode (padded
    key columns 577 -> 640, 130 -> 256), 2e-5."""
    q, k, v = _window_inputs(name)
    D = q.shape[-1]
    ref = _attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=False, sm_scale=D ** -0.5, kv_lens=None,
                         bias=None)
    got = tattn._window_attention(_t(q), _t(k), _t(v), D ** -0.5)
    _close(got, ref, what="vs _attention_xla")
    _close(got, pallas_refs["window." + name], what="vs _window_kernel")


def test_dispatcher_medium_branch_matches_jax():
    """`dot_product_attention`, non-causal with 512 < S <= 1536 (the branch
    of K7), against the JAX dispatcher on the same inputs, through strided
    [B,S,H,D] views as the models hand them over."""
    q, k, v = (a.transpose(0, 2, 1, 3).copy() for a in _window_inputs("clip577"))
    ref = jdot(*(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)))
    got = tattn.dot_product_attention(*(_t(a).transpose(1, 2) for a in (q, k, v)))
    _close(got, ref)


@pytest.mark.parametrize("name", ["hiera256", "odd130"])
def test_window_attention_backward_matches_jax(name):
    """The recompute backward: gradients of sum(out * g) in q, k and v
    through the port's entry against `jax.grad` of `_attention_xla`, which
    is what the JAX `custom_vjp` differentiates (attention.py:588-595)."""
    q, k, v = _window_inputs(name)
    D = q.shape[-1]
    g = np.random.RandomState(7).randn(*q.shape).astype(np.float32)

    def loss(q_, k_, v_):
        return (_attention_xla(q_, k_, v_, causal=False, sm_scale=D ** -0.5,
                               kv_lens=None, bias=None) * g).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    ins = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out = tattn._window_attention(*ins, D ** -0.5)
    got = torch.autograd.grad(out, ins, _t(g))
    for n, a, b in zip("qkv", got, want):
        _close(a, b, what=f"d{n}")


# ---------------------------------------------------------------------------
# K8's function
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(SMALLWIN_CASES))
def test_smallwin_attention_matches_jax(name, pallas_refs):
    """16- and 64-token windows, several heads at their natural offsets
    (hd 72, 40, 88): the port's entry against `_smallwin_xla` and against
    `_smallwin_kernel` in interpret mode, 2e-5."""
    NW, S, H, hd = SMALLWIN_CASES[name]
    qkv = _smallwin_input(name)
    ref = _smallwin_xla(jnp.asarray(qkv), H, hd ** -0.5)
    got = tattn.attention_packed_qkv_smallwin(_t(qkv), H, hd)
    assert got.shape == (NW, S, H * hd)
    _close(got, ref, what="vs _smallwin_xla")
    _close(got, pallas_refs["smallwin." + name], what="vs _smallwin_kernel")


def test_smallwin_attention_odd_window_count_matches_jax():
    """A window count that the TPU kernel cannot pack (the JAX entry falls
    back to XLA, tests/test_ops.py:350-356) is the same function."""
    NW, S, H, hd = SMALLWIN_ODD
    qkv = np.random.RandomState(9).randn(NW, S, 3 * H * hd).astype(np.float32)
    ref = jsmallwin(jnp.asarray(qkv), H, hd)
    _close(tattn.attention_packed_qkv_smallwin(_t(qkv), H, hd), ref)
    _close(tattn.attention_packed_qkv_smallwin(_t(qkv), H, hd, sm_scale=0.3),
           jsmallwin(jnp.asarray(qkv), H, hd, sm_scale=0.3), what="sm_scale")


def test_smallwin_attention_backward_matches_jax():
    NW, S, H, hd = 4, 64, 2, 72                     # tests/test_ops.py:337
    rng = np.random.RandomState(10)
    qkv = rng.randn(NW, S, 3 * H * hd).astype(np.float32)
    g = rng.randn(NW, S, H * hd).astype(np.float32)
    want = jax.grad(lambda x: (_smallwin_xla(x, H, hd ** -0.5) * g).sum())(
        jnp.asarray(qkv))
    x = _t(qkv).requires_grad_(True)
    (got,) = torch.autograd.grad(tattn.attention_packed_qkv_smallwin(x, H, hd),
                                 x, _t(g))
    _close(got, want)


def test_recompute_backward_runs_the_plain_twin():
    """`_RecomputeAttention` (what a CUDA tensor under a gradient goes
    through) with the twin standing in for the launch: the forward is the
    launch's, the gradients are autograd's through the twin."""
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randn(4, 16, 3 * 2 * 8).astype(np.float32))
    g = torch.from_numpy(rng.randn(4, 16, 2 * 8).astype(np.float32))
    plain = lambda t: tattn._smallwin_plain(t, 2, 8 ** -0.5)
    calls = []

    def launch(t):
        calls.append(torch.is_grad_enabled())       # off inside the Function
        return plain(t).detach() + 1.0              # a marked forward

    xg = x.clone().requires_grad_(True)
    out = tattn._kernel_or_recompute(launch, plain, xg)
    assert calls == [False] and torch.equal(out, plain(x) + 1.0)
    (got,) = torch.autograd.grad(out, xg, g)
    xr = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(plain(xr), xr, g)
    assert torch.equal(got, want)
    with torch.no_grad():                           # no gradient: launch alone
        assert torch.equal(tattn._kernel_or_recompute(launch, plain, xg), out)


# ---------------------------------------------------------------------------
# Hiera(hoist_layout=False): the unfused window branches
# ---------------------------------------------------------------------------
# 128^2 input -> 32x32 tokens. Stage 1: 4x4 windows (16 tokens, 128 windows
# over 2 images... B >= 512 needs 8 images: the tiny-window branch is taken
# with 8 images); stage 2: 16x16 windows (256 tokens: the super-window
# branch, fold 2); a global block after them; stage 3/4 generic.
_HIERA = HieraConfig(embed_dim=16, num_heads=1, stages=(2, 2, 2, 1),
                     global_att_blocks=(5,), window_spec=(4, 16, 4, 2))


@pytest.fixture(scope="module")
def hiera_setup():
    x = np.random.RandomState(12).randn(8, 128, 128, 3).astype(np.float32)
    jm = JHiera(_HIERA, dtype=jnp.float32)
    params = seeded_params(lambda: jm.init(jax.random.PRNGKey(0), x[:1]), 12)
    sd = from_jax.hiera_state_dict(params["params"])
    return x, params, sd


@pytest.mark.parametrize("hoist", [True, False], ids=["hoisted", "unhoisted"])
def test_hiera_hoist_flag_matches_jax(hiera_setup, hoist):
    """The port's Hiera with and without layout hoisting against the JAX
    module with the same flag (tests/test_sam2_golden.py:59-75 is the
    model), 1e-4 on O(1) activations after six blocks."""
    x, params, sd = hiera_setup
    ref = jax.jit(JHiera(_HIERA, dtype=jnp.float32, hoist_layout=hoist).apply)(
        params, x)
    tm = Hiera(from_jax.port_config(_HIERA), hoist_layout=hoist)
    tm.load_state_dict(sd)
    with torch.no_grad():
        got = tm(_t(x))
    assert len(got) == len(ref) == 4
    for i, (a, b) in enumerate(zip(got, ref)):
        _close(a, b, 1e-4, f"stage {i}")


def test_hiera_unhoisted_takes_both_window_branches(hiera_setup, monkeypatch):
    """Without hoisting the stage-1 blocks (16-token windows, 512 of them)
    go through `attention_packed_qkv_smallwin` and the stage-2 windowed
    block (256 tokens) through the super-window fold; the outputs equal the
    hoisted port's to f32 reduction-order noise (1e-5, as
    tests/test_sam2_golden.py:59-78 holds the JAX pair)."""
    from videoglamm_torch.models.sam2 import hiera as thiera
    x, _, sd = hiera_setup
    seen = []
    small, padded = thiera.attention_packed_qkv_smallwin, \
        thiera.attention_packed_qkv_padded
    monkeypatch.setattr(thiera, "attention_packed_qkv_smallwin",
                        lambda qkv, nh, hd, **kw: seen.append(
                            ("small", tuple(qkv.shape))) or small(qkv, nh, hd, **kw))
    monkeypatch.setattr(thiera, "attention_packed_qkv_padded",
                        lambda qkv, nh, hd, win=0, **kw: seen.append(
                            ("super", tuple(qkv.shape), win))
                        or padded(qkv, nh, hd, win=win, **kw))
    a, b = Hiera(from_jax.port_config(_HIERA)), \
        Hiera(from_jax.port_config(_HIERA), hoist_layout=False)
    a.load_state_dict(sd)
    b.load_state_dict(sd)
    with torch.no_grad():
        hoisted = a(_t(x))
        assert seen == []                 # the hoisted path takes fused blocks
        plain = b(_t(x))
    assert seen == [("small", (512, 16, 48)), ("small", (512, 16, 48)),
                    ("super", (4, 512, 96), 256)]
    for p, q in zip(hoisted, plain):
        _close(p, q.numpy(), 1e-5)
