"""K2's f32 route (csrc/gemm_f32.cu: 3xTF32 on wgmma) on the CPU.

`videoglamm_torch.ops.tf32x3.gemm_3xtf32` emulates the kernel's arithmetic
in plain torch: both operands split into TF32 big and small parts, each
k-block of KBLOCK columns summed apart (big.small + small.big, then
big.big) and added to the running sum in f32, then + bias, the erf GELU
and the residual. Here it is held against the
JAX package's f32 product and epilogue (the matmul stages of
`_fused_block_ref`, videoglamm_tpu/ops/fused_block.py:71-105) within the
card's f32 tolerance of 1e-5 relative L2 (`TOL_F32`,
tests/test_torch_cuda.py) at the K and N of all 16 of Hiera-L's products
and at tails of M, N and K; a single TF32 product misses it at K = 4608. A
whole f32 window block through the port's kernel chain, with K2 and K1's
window mode emulated in 3xTF32, is held to JAX's `fused_window_block` in
f32. Then `k2_f32_plan`. No Pallas kernel runs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoglamm_tpu.ops import fused_block as jfb
from videoglamm_torch.ops import fused_block as FB
from videoglamm_torch.ops import tf32x3 as T
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL_F32 = 1e-5        # the card's tolerance of the f32 routes (relative L2)
SMEM = 232448         # dynamic shared memory a CTA can use on the H100


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _hiera_products():
    """{name: (K, N, gelu, residual)} of Hiera-L's 16 products, C = 144 *
    2^s at stage s + 1."""
    out = {}
    for s in range(4):
        C = 144 * 2 ** s
        out.update({f"stage {s + 1} qkv": (C, 3 * C, False, False),
                    f"stage {s + 1} proj": (C, C, False, True),
                    f"stage {s + 1} fc1": (C, 4 * C, True, False),
                    f"stage {s + 1} fc2": (4 * C, C, False, True)})
    return out


PRODUCTS = _hiera_products()
# M: not a multiple of the 128-row tile; the tails: N past a 144-column
# tile, K past a 32-column chunk and a 64-column k-block
CASES = {**{n: (100,) + v for n, v in PRODUCTS.items()},
         "N and K tails": (70, 280, 200, True, True),
         "one k8 step": (9, 8, 16, False, True)}


def _operands(seed, M, K, N, res):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((N, K)) * K ** -0.5).astype(np.float32)
    b = (0.1 * rng.standard_normal(N)).astype(np.float32)
    r = rng.standard_normal((M, N)).astype(np.float32) if res else None
    return a, w, b, r


def _jax_gemm(a, w, b, gelu, r):
    """The JAX block's f32 matmul stage: einsum against the [in, out]
    weight with f32 accumulation, + bias, GELU by dtype, residual first."""
    y = jnp.einsum("sc,cd->sd", jnp.asarray(a), jnp.asarray(w.T),
                   preferred_element_type=jnp.float32) + jnp.asarray(b)
    if gelu:
        y = jfb._gelu(y)
    if r is not None:
        y = jnp.asarray(r) + y
    return np.asarray(y)


@pytest.mark.parametrize("name", list(CASES))
def test_gemm_3xtf32_matches_the_jax_block_product(name):
    M, K, N, gelu, res = CASES[name]
    a, w, b, r = _operands(len(name), M, K, N, res)
    got = T.gemm_3xtf32(*(torch.from_numpy(x) if x is not None else None
                          for x in (a, w, b)), gelu=gelu,
                        residual=None if r is None else torch.from_numpy(r))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert _rel(got, _jax_gemm(a, w, b, gelu, r)) <= TOL_F32, name


def test_one_tf32_product_misses_at_k4608_and_3xtf32_does_not():
    """Stage 4 fc2's K = 4608: a single TF32 product (both operands
    rounded once) is far outside the tolerance; the 3xTF32 GEMM with its
    k-block sums is inside it on the same operands."""
    a, w, b, _ = _operands(5, 64, 4608, 1152, False)
    want = _jax_gemm(a, w, np.zeros_like(b), False, None)
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    assert _rel(T.matmul_tf32(ta, tw.T), want) > 5 * TOL_F32
    assert _rel(T.gemm_3xtf32(ta, tw), want) <= TOL_F32


def test_f32_window_block_through_the_emulated_kernels(monkeypatch):
    """The port's kernel chain (`_fused_block_kernels`: K3 LN, K2 qkv, K1
    window over packed windows, K2 proj + residual, K3 LN, K2 fc1 + GELU,
    K2 fc2 + residual) with K2 as `gemm_3xtf32` and K1's window mode as
    the 3xTF32 forward of `tf32x3.attention_fwd`, against JAX's
    `fused_window_block` in f32 at a narrow width: 16 windows of 16
    tokens, packed 8 to a 128-row query tile, C = 64, 2 heads."""
    NW, S, C, H = 16, 16, 64, 2
    rng = np.random.default_rng(11)
    x = rng.standard_normal((NW, S, C)).astype(np.float32)
    shapes = dict(ln1_weight=(C,), ln1_bias=(C,), qkv_weight=(3 * C, C),
                  qkv_bias=(3 * C,), proj_weight=(C, C), proj_bias=(C,),
                  ln2_weight=(C,), ln2_bias=(C,), fc1_weight=(4 * C, C),
                  fc1_bias=(4 * C,), fc2_weight=(C, 4 * C), fc2_bias=(C,))
    p = {}
    for k, shp in shapes.items():
        scale = shp[-1] ** -0.5 if len(shp) == 2 else 0.1
        p[k] = (rng.standard_normal(shp) * scale).astype(np.float32)
        if k.startswith("ln") and k.endswith("weight"):
            p[k] += 1.0
    jp = dict(ln1_scale=p["ln1_weight"], ln1_bias=p["ln1_bias"],
              wqkv=p["qkv_weight"].T, bqkv=p["qkv_bias"],
              wproj=p["proj_weight"].T, bproj=p["proj_bias"],
              ln2_scale=p["ln2_weight"], ln2_bias=p["ln2_bias"],
              wup=p["fc1_weight"].T, bup=p["fc1_bias"],
              wdown=p["fc2_weight"].T, bdown=p["fc2_bias"])
    want = np.asarray(jfb.fused_window_block(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in jp.items()}, H))

    calls = {"gemm": 0, "window": 0}

    def k2(a, w, bias=None, *, gelu=False, residual=None):
        calls["gemm"] += 1
        return T.gemm_3xtf32(a, w, bias, gelu=gelu, residual=residual)

    def k1(q, k, v, out, *, causal, sm_scale, mode, win=0, exact=False, **kw):
        assert mode == "window" and exact and not causal and win == S
        calls["window"] += 1
        out.copy_(T.attention_fwd(q, k, v, sm_scale=sm_scale, win=win)[0])

    monkeypatch.setattr(FB, "gemm_epilogue", k2)
    monkeypatch.setattr(FB, "attention_fwd_kernel", k1)
    got = FB._fused_block_kernels(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
        H, 1e-6, True)
    assert calls == {"gemm": 4, "window": 1}
    assert _rel(got, want) <= TOL_F32


@pytest.mark.parametrize("name", list(PRODUCTS))
def test_k2_f32_plan_tiles_every_hiera_product_without_waste(name):
    """144-column tiles divide every N of Hiera-L (no column past N), the
    shared memory fits a CTA, and the K-chunk, k-block and counts are
    the kernel's."""
    K, N, _, _ = PRODUCTS[name]
    M = 524288
    plan = FB.k2_f32_plan(M, N, K)
    assert plan["bn"] == 144 and N % plan["bn"] == 0
    assert plan["bm"] == 128 and plan["bk"] == 32 and plan["kblock"] == 64
    assert plan["threads"] == 384 and plan["stages"] == 3
    assert plan["smem"] <= SMEM
    assert plan["col_tiles"] == N // 144 and plan["tiles"] == M // 128 * N // 144
    assert plan["chunks"] == -(-K // 32)


@pytest.mark.parametrize("M,N,K", [(0, 144, 144), (128, 144, 0), (128, 140, 144),
                                   (128, 144, 100), (2 ** 31, 144, 144)])
def test_k2_f32_plan_refuses_what_the_kernel_does_not_build(M, N, K):
    with pytest.raises(ValueError, match="k2_f32_plan"):
        FB.k2_f32_plan(M, N, K)


def test_k2_f32_plan_smem_is_the_sum_of_its_regions():
    """The ring (A [128 x 32] and W [144 x 32] f32 a stage), W's small
    planes, two warpgroups' [64 x 144] f32 output staging, the mbarriers
    and 1024 bytes of alignment slack, as the source lays them out."""
    plan = FB.k2_f32_plan(300, 432, 144)
    ring = plan["stages"] * (128 + 144) * 32 * 4
    small = plan["split_stages"] * 144 * 32 * 4
    bars = 8 * (3 * plan["stages"] + plan["split_stages"] + 2)
    assert plan["smem"] == ring + small + 2 * 64 * 144 * 4 + bars + 1024


def _wavefronts(addrs, width):
    """Shared-memory wavefronts of one warp's access: `addrs` the byte
    address of each lane's `width`-byte load or store. A wavefront serves
    one 4-byte word a bank, so the count is the most distinct words that
    fall in one of the 32 banks."""
    words = {a // 4 + i for a in addrs for i in range(width // 4)}
    per_bank = [0] * 32
    for wd in words:
        per_bank[wd % 32] += 1
    return max(per_bank)


def test_w_split_touches_each_unit_once_in_the_fewest_wavefronts():
    """Warps 9 to 11's split of a W chunk: SPLITTERS threads, a batch of
    SPLIT_BATCH 16-byte units each before their stores, unit u0 + i *
    SPLITTERS (gemm_f32.cu); loads from the raw stage and stores to both
    planes at the same offsets. Every unit of the chunk is split once, and
    every warp-wide access takes 4 wavefronts (512 bytes, no conflict)."""
    c = FB._K2F
    units, nthreads, batch = c["BN"] * c["BK"] * 4 // 16, c["SPLITTERS"], c["SPLIT_BATCH"]
    assert nthreads % 32 == 0
    seen = []
    for st0 in range(0, nthreads, 32):
        for u0 in range(st0, units, batch * nthreads):
            for i in range(batch):
                lanes = [u0 - st0 + st + i * nthreads for st in range(st0, st0 + 32)]
                seen += lanes
                assert _wavefronts([16 * u for u in lanes], 16) == 4
    assert sorted(seen) == list(range(units))


@pytest.mark.parametrize("wg", [0, 1])
def test_a_fragment_loads_are_the_swizzled_fragment_in_one_wavefront(wg):
    """A consumer thread's A fragment of each k8 step (rows g and g + 8 of
    its warp's 16, columns t and t + 4): the kernel's offsets arow + ((2ks
    ^ g) << 4) (+ 1024 for row g + 8, + 16 for column t + 4) are the
    128-byte swizzle's place of that element, and each of the four 4-byte
    loads takes one wavefront across the warp."""
    c = FB._K2F
    for warp in range(4):
        for ks in range(c["BK"] // 8):
            loads = [[] for _ in range(4)]
            for lane in range(32):
                g, t = lane // 4, lane % 4
                arow = (64 * wg + 16 * warp + g) * 128 + 4 * t
                u0, u1 = ((2 * ks) ^ g) << 4, ((2 * ks + 1) ^ g) << 4
                kernel = (arow + u0, arow + 1024 + u0, arow + u1, arow + 1024 + u1)
                for j, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
                    r, col = 64 * wg + 16 * warp + g + dr, 8 * ks + t + dc
                    want = r * 128 + (((col // 4) ^ (r % 8)) << 4) + 4 * (col % 4)
                    assert kernel[j] == want
                    loads[j].append(kernel[j])
            for addrs in loads:
                assert _wavefronts(addrs, 4) == 1
