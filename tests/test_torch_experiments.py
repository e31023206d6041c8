"""The experiment modules of videoglamm_torch against the JAX scripts they
port, on the CPU: the four fused decode-layer functions of
`videoglamm_torch/experiments/decode_mlp.py` (K9's functions) against
`scripts/decode_mlp_experiment.py`, and `flash_attention_bshd` against the
JAX package's `flash_attention` on transposed inputs.

Inputs come from numpy seeds. On the CPU the port's entries take the plain
twins of K9, which is what these tests hold to the JAX functions; the
kernels themselves are held to the twins on the card
(tests/test_torch_cuda.py, chip_smoke.py). The JAX weights are [K, N]; the
test transposes them into the port's [N, K].

The JAX side runs as it can run on the CPU: the unfused chains
(`_fused_mlp_ref`, `_norm_matmul_ref`) in this process, and the four Pallas
bodies with `interpret=True`, and `flash_attention` under
`pltpu.force_tpu_interpret_mode()`, in ONE child process with a time limit,
so that an interpret-mode deadlock fails these cases and hangs nothing.

Shapes: M in {1, 4, 8} rows, K = D = 256, I = 2048, which is two 1024-wide
groups, so the W8A8 body's per-group quantisation of h is exercised.

Tolerances, from the f32 control (the port's twin in f32 against the Pallas
body in f32: at most 4.9e-7 of the output's largest value over the four
functions and the three row counts): 5e-6 of the largest reference value
in f32 (summation order over K and I). In bf16 the twin and the body round
at the same points (most cases come out bit-equal), but f32 sums taken in
another order flip a rounding here and there (1.9e-3 seen): 2 bf16 ulps
(2^-7) of the largest value. The W8A8 body quantises f32 values that differ
in their last bits between XLA and PyTorch (rsqrt, the sigmoid), so a code
may differ by one where a value sits on a rounding tie (none did: 3.4e-7
measured): one code step of one group is 1/127 of that group's largest h,
and the output is held to 1e-3 of its largest value in f32.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoglamm_torch.experiments import decode_mlp as dm
from videoglamm_torch.experiments import flash_bshd as fbshd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import decode_mlp_experiment as jdm  # noqa: E402

ROWS = (1, 4, 8)
K, I, N = 256, 2048, 512
EPS = 1e-5
TOL_F32 = 5e-6
TOL_BF16 = 2.0 ** -7
TOL_W8A8 = 1e-3
FLASH = dict(B=2, Sq=40, Sk=56, H=2, D=16)


def _layer(M: int):
    """One decode layer's inputs in the JAX orientation ([K, N] codes)."""
    rng = np.random.RandomState(100 + M)

    def codes(k, n):
        return rng.randint(-127, 128, size=(k, n)).astype(np.int8)

    def scales(n, fan):
        return ((0.5 + rng.rand(n)) / (73.0 * np.sqrt(fan))).astype(np.float32)

    return dict(x=rng.randn(M, K).astype(np.float32),
                res=rng.randn(M, N).astype(np.float32),
                nw=(1 + 0.1 * rng.randn(K)).astype(np.float32),
                w=codes(K, N), s=scales(N, K),
                wgu=codes(K, 2 * I), sgu=scales(2 * I, K),
                wd=codes(I, K), sd=scales(K, I))


def _flash_inputs():
    f = FLASH
    rng = np.random.RandomState(9)
    q = rng.randn(f["B"], f["Sq"], f["H"], f["D"]).astype(np.float32)
    k = rng.randn(f["B"], f["Sk"], f["H"], f["D"]).astype(np.float32)
    v = rng.randn(f["B"], f["Sk"], f["H"], f["D"]).astype(np.float32)
    kv_lens = np.array([56, 45], np.int32)
    q_start = np.array([16, 3], np.int32)
    return q, k, v, kv_lens, q_start


_CHILD = r"""
import os, sys
import numpy as np
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
sys.path.insert(0, os.path.join(os.getcwd(), "scripts"))
import decode_mlp_experiment as dm
from videoglamm_tpu.ops.attention import flash_attention
d = np.load(sys.argv[1])
out = {}
for key in d.files:
    if not key.endswith(".x"):
        continue
    n = key[:-2]
    a = lambda name: jnp.asarray(d[n + "." + name])
    for dt_name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        x, res = a("x").astype(dt), a("res").astype(dt)
        mlp = (x, a("nw"), a("wgu"), a("sgu"), a("wd"), a("sd"), 1e-5)
        got = {
            "nm": dm._norm_matmul_pallas(x, a("nw"), a("w"), a("s"), 1e-5,
                                         interpret=True),
            "mr": dm._matmul_residual_pallas(x, a("w"), a("s"), res,
                                             block_n=a("w").shape[1],
                                             interpret=True),
            "mlp": dm._fused_mlp_pallas(*mlp, interpret=True),
            "w8a8": dm._fused_mlp_pallas_w8a8(*mlp, interpret=True),
        }
        for name, y in got.items():
            out[f"{n}.{dt_name}.{name}"] = np.asarray(y.astype(jnp.float32))
with pltpu.force_tpu_interpret_mode():
    q, k, v = (jnp.asarray(d["flash." + n]).transpose(0, 2, 1, 3)
               for n in "qkv")
    o = flash_attention(q, k, v, causal=True,
                        kv_lens=jnp.asarray(d["flash.kv_lens"]),
                        q_start=jnp.asarray(d["flash.q_start"]))
    out["flash"] = np.asarray(o.transpose(0, 2, 1, 3))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def pallas_refs(tmp_path_factory):
    """Outputs of the scripts' Pallas bodies (interpret mode) and of the JAX
    flash kernel on this file's inputs, from one child process with a time
    limit."""
    tmp = tmp_path_factory.mktemp("pallas_experiments")
    feed = {}
    for M in ROWS:
        feed.update({f"m{M}.{k}": v for k, v in _layer(M).items()})
    q, k, v, kv_lens, q_start = _flash_inputs()
    feed.update({"flash.q": q, "flash.k": k, "flash.v": v,
                 "flash.kv_lens": kv_lens, "flash.q_start": q_start})
    np.savez(tmp / "in.npz", **feed)
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    try:
        res = subprocess.run(
            [sys.executable, "-c", _CHILD, str(tmp / "in.npz"),
             str(tmp / "out.npz")], capture_output=True, text=True, cwd=ROOT,
            env=env, timeout=600)
    except subprocess.TimeoutExpired:
        pytest.fail("the Pallas interpret-mode child did not return in 600 s")
    assert res.returncode == 0, res.stderr[-2000:]
    return dict(np.load(tmp / "out.npz"))


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _port_layer(M: int, dtype):
    """The same layer in the port's orientation ([N, K] codes)."""
    p = _layer(M)
    out = {k: _t(p[k]) for k in ("nw", "s", "sgu", "sd")}
    out.update(x=_t(p["x"], dtype), res=_t(p["res"], dtype),
               w=_t(p["w"].T), wgu=_t(p["wgu"].T), wd=_t(p["wd"].T))
    return out


def _close(got, ref, tol, what):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    scale = max(float(np.abs(ref).max()), 1.0)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: max|d| {err:.3e} > {tol:g} * {scale:.3g}"


DTYPES = {"f32": (torch.float32, jnp.float32, TOL_F32),
          "bf16": (torch.bfloat16, jnp.bfloat16, TOL_BF16)}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("M", ROWS)
def test_norm_matmul_matches_jax(M, dt, pallas_refs):
    tdt, jdt, tol = DTYPES[dt]
    p, j = _port_layer(M, tdt), _layer(M)
    got = dm.fused_norm_matmul_int8(p["x"], p["nw"], p["w"], p["s"], EPS)
    assert got.shape == (M, N) and got.dtype == tdt
    ref = jdm._norm_matmul_ref(jnp.asarray(j["x"]).astype(jdt),
                               jnp.asarray(j["nw"]), jnp.asarray(j["w"]),
                               jnp.asarray(j["s"]), EPS)
    _close(got, np.asarray(ref.astype(jnp.float32)), tol, "vs _norm_matmul_ref")
    _close(got, pallas_refs[f"m{M}.{dt}.nm"], tol, "vs _nm_kernel")
    chain = dm._norm_matmul_ref(p["x"], p["nw"], p["w"], p["s"], EPS)
    _close(chain, np.asarray(ref.astype(jnp.float32)), tol, "the port's chain")


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("M", ROWS)
def test_matmul_residual_matches_jax(M, dt, pallas_refs):
    tdt, _, tol = DTYPES[dt]
    p = _port_layer(M, tdt)
    got = dm.matmul_residual_int8(p["x"], p["w"], p["s"], p["res"])
    assert got.shape == (M, N) and got.dtype == tdt
    _close(got, pallas_refs[f"m{M}.{dt}.mr"], tol, "vs _mr_kernel")
    # leading dims and a padded weight (QDense pads to a multiple of 8 rows)
    wpad = torch.cat([p["w"], torch.zeros(3, K, dtype=torch.int8)])
    again = dm.matmul_residual_int8(p["x"][None], wpad, p["s"], p["res"][None])
    assert torch.equal(again[0], got)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("M", ROWS)
def test_fused_mlp_matches_jax(M, dt, pallas_refs):
    tdt, jdt, tol = DTYPES[dt]
    p, j = _port_layer(M, tdt), _layer(M)
    args = (p["x"], p["nw"], p["wgu"], p["sgu"], p["wd"], p["sd"])
    got = dm.fused_decode_mlp_int8(*args, EPS)
    assert got.shape == (M, K) and got.dtype == tdt
    _close(got, pallas_refs[f"m{M}.{dt}.mlp"], tol, "vs _mlp_kernel")
    ref = jdm._fused_mlp_ref(jnp.asarray(j["x"]).astype(jdt),
                             *(jnp.asarray(j[k]) for k in
                               ("nw", "wgu", "sgu", "wd", "sd")), EPS)
    chain = dm._fused_mlp_ref(*args, EPS)
    _close(chain, np.asarray(ref.astype(jnp.float32)), tol, "vs _fused_mlp_ref")
    # the fused body rounds after the residual, the chain before it
    _close(got, np.asarray(ref.astype(jnp.float32)), 2 * tol, "fused vs chain")


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("M", ROWS)
def test_fused_mlp_w8a8_matches_jax(M, dt, pallas_refs):
    tdt, _, tol = DTYPES[dt]
    p = _port_layer(M, tdt)
    args = (p["x"], p["nw"], p["wgu"], p["sgu"], p["wd"], p["sd"])
    got = dm.fused_decode_mlp_int8(*args, EPS, w8a8=True)
    assert got.shape == (M, K) and got.dtype == tdt
    _close(got, pallas_refs[f"m{M}.{dt}.w8a8"], max(tol, TOL_W8A8),
           "vs _mlp_w8a8_kernel")
    # the group width is arithmetic: one 2048-wide group is another function
    other = dm.fused_decode_mlp_int8(*args, EPS, w8a8=True, group=2048)
    assert not torch.equal(other, got)
    # W8A8 stays near the weight-only body (activation quantisation noise)
    plain = dm.fused_decode_mlp_int8(*args, EPS)
    _close(got, plain.float().numpy(), 5e-2, "w8a8 vs weight-only")


def test_w8a8_trace_is_consistent():
    """The traced integers are the ones the output is made of: the s32 sums
    are integer products of the traced codes, group by group."""
    p = _port_layer(4, torch.float32)
    args = (p["x"], p["nw"], p["wgu"], p["sgu"], p["wd"], p["sd"], EPS)
    out, tr = dm._mlp_w8a8_plain(*args, trace=True)
    assert torch.equal(out, dm._mlp_w8a8_plain(*args))
    assert tr.xq.shape == (4, K) and tr.hs.shape == (4, 2)
    assert torch.equal(tr.gu, dm._int_dot(tr.xq, p["wgu"]))
    for g in range(2):
        cols = slice(g * 1024, (g + 1) * 1024)
        assert torch.equal(tr.down[g], dm._int_dot(tr.hq[:, cols],
                                                   p["wd"][:, cols]))
    with pytest.raises(ValueError):
        dm._mlp_w8a8_plain(*args, group=768)


def test_flash_attention_bshd_matches_jax(pallas_refs):
    q, k, v, kv_lens, q_start = _flash_inputs()
    got = fbshd.flash_attention_bshd(_t(q), _t(k), _t(v), _t(kv_lens),
                                     _t(q_start), causal=True)
    assert got.shape == q.shape and got.is_contiguous()
    _close(got, pallas_refs["flash"], 2e-5, "vs flash_attention")
    via = fbshd.flash_attention_transposed(_t(q), _t(k), _t(v), _t(kv_lens),
                                           _t(q_start), causal=True,
                                           sm_scale=FLASH["D"] ** -0.5)
    _close(via, pallas_refs["flash"], 2e-5, "transposed layout")


def test_harnesses_run_on_the_cpu():
    """Both harnesses at a toy size on the CPU (the twins): every variant
    gives finite values, and the two attention layouts agree."""
    from videoglamm_torch.experiments import bench_decode_fused as bench
    lines = []
    rows = bench.run_harness(rows=(1, 4), layers=2, k=64, i=256, n_qkv=96,
                             device="cpu", dtype=torch.float32, reps=1,
                             log=lines.append)
    assert len(rows) == 2 * len(bench.MLP_VARIANTS + bench.ATTN_VARIANTS)
    assert all(r["finite"] and r["graph_us"] is None for r in rows)
    assert len(lines) == len(rows)
    res = fbshd.run_harness(1, 2, 40, 48, 16, layers=2, reps=1, device="cpu",
                            dtype=torch.float32, log=lines.append)
    assert res["max_abs_diff"] <= 1e-6
