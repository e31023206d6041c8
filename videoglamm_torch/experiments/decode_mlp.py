"""Fused decode-step programs for int8-weight LLM serving (PyTorch port of
scripts/decode_mlp_experiment.py).

A decode step of the int8 LLM is a chain of about a dozen small launches a
layer (norm -> product -> GLU -> product -> add ...). This experiment folds
the layer into three programs for at most 8 rows (one decoded token a row,
or the `draft_k` rows of a speculative iteration):

  fused_norm_matmul_int8   rmsnorm(x) @ W_qkv * s            (K9 norm_matmul)
  matmul_residual_int8     res + (o @ W_o) * s               (K9 matmul_residual)
  fused_decode_mlp_int8    x + down(silu(gate) * up)(norm)   (K9 mlp, mlp_w8a8)

K9 (`csrc/decode_fused.cu`) holds the four kernels; its header says which
Pallas body each replaces and how the work is laid out on the card (K5's
design: persistent row ranges fed by a ring of bulk copies, CUDA cores for
1 to 3 rows and tensor cores from 4, and for the two MLP entries one grid
barrier that the weight stream runs through). `k9_plan` computes each
launch's row ranges and shared-memory layout. It is an experiment: no
serving path calls these functions, as in the JAX package, whose Phi-3 only
points at the script (videoglamm_tpu/models/phi3.py:81-86).
`experiments/bench_decode_fused.py` is the A/B harness against the port's
serving chain.

Rows: the JAX entries run their Pallas bodies for at most 8 rows and the
unfused composition above that (decode_mlp_experiment.py:270-276, :339-343,
:392-398). The port does the same by shape, before any launch: up to 8 rows
go to K9 (or, on the CPU, its twin), more rows to the chain, which on the
card is the port's own kernels (K3 norm, K5 products, SiLU, add) rounding
where the JAX composition rounds. The W8A8 variant has no JAX gate (its
Pallas body takes any row count); above 8 rows it runs K9 on tiles of 8
rows, which is the same function row by row.

Weights are in the port's orientation, [N, K] int8 with [N] f32 scales, so
a `QDense`'s `weight` and `scale` go in with no copy (rows past N are its
padding); the JAX script keeps [K, N]. The gate rows come first in
`wgu_q` [2I, K], then the up rows, as the fused `gate_up_proj` holds them.

Beside each kernel stands its plain twin with the body's arithmetic step by
step (the same rounding points, the same `group`-wide activation
quantisation). A CPU tensor takes the twin; a CUDA tensor launches K9 or
raises. `_fused_mlp_ref` and `_norm_matmul_ref` are the unfused chain of the
script (the composition the fused programs are held to there).
"""
from __future__ import annotations

import collections
import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops import _cuda, norms, quant

# K9 launches by entry ("norm_matmul", "matmul_residual", "mlp", "mlp_w8a8")
LAUNCHES = collections.Counter()

MAX_ROWS = 8          # rows a fused program takes (decode, speculative rows)
W8A8_GROUP = 1024     # decode_mlp_experiment.py:201, `block_i`
ENTRIES = ("norm_matmul", "matmul_residual", "mlp", "mlp_w8a8")


# ---------------------------------------------------------------------------
# shared arithmetic
# ---------------------------------------------------------------------------
def _rmsnorm_f32(x2, norm_w, eps: float):
    """`_rmsnorm_block` (:71) before its cast: f32 statistics, f32 weight."""
    xf = x2.float()
    var = (xf * xf).sum(dim=-1, keepdim=True) / xf.shape[-1]
    return xf * torch.rsqrt(var + eps) * norm_w.float()


def _quant_rows_f32(x):
    """`_quant_rows_f32` (:152): per-row symmetric int8 in f32, scale floor
    1e-6. x: [M, C] f32 -> (int8 [M, C], f32 [M, 1])."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp(amax, min=1e-6) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x / s), -127, 127)
    return q.to(torch.int8), s


def _int_dot(q, w_q):
    """s8 [M, C] x s8 [N, C]^T -> s32 [M, N], exact. Integer matmul on the
    CPU; through f64 on a CUDA tensor (every sum is below 2^53), where torch
    has no integer product for so few rows."""
    if q.device.type == "cpu":
        return torch.matmul(q.to(torch.int32), w_q.to(torch.int32).t())
    return torch.matmul(q.double(), w_q.double().t()).to(torch.int32)


def _dot_f32(a, w_q):
    """[M, C] float x int8 [N, C]^T with f32 accumulation (the int8 codes
    are exact in bf16, so this is the bf16 x bf16 -> f32 dot of the body)."""
    return torch.matmul(a.float(), w_q.float().t())


# ---------------------------------------------------------------------------
# plain twins of K9's four entries
# ---------------------------------------------------------------------------
def _norm_matmul_plain(x2, norm_w, w_q, s, eps: float):
    """Twin of K9 norm_matmul, `_nm_kernel` (:282): the normalised rows land
    in x's dtype, f32 accumulation, the scale in the epilogue, one rounding.
    x2: [M, K]; w_q: [>= N, K] int8; s: [N] -> [M, N]."""
    N = s.shape[0]
    xn = _rmsnorm_f32(x2, norm_w, eps).to(x2.dtype)
    return (_dot_f32(xn, w_q[:N]) * s.float()).to(x2.dtype)


def _matmul_residual_plain(x2, w_q, s, res2):
    """Twin of K9 matmul_residual, `_mr_kernel` (:349): the residual is
    added in f32 before the one rounding."""
    N = s.shape[0]
    return (_dot_f32(x2, w_q[:N]) * s.float() + res2.float()).to(x2.dtype)


def _mlp_plain(x2, norm_w, wgu_q, wgu_s, wd_q, wd_s, eps: float):
    """Twin of K9 mlp, `_mlp_kernel` (:80): gate and up land in x's dtype
    before the GLU (:96-100), h in x's dtype before the down product, the
    down product accumulates in f32 over the whole of I, and the residual
    and the last rounding come after the whole sum (:107-108)."""
    I, D = wgu_q.shape[0] // 2, wd_s.shape[0]
    dt = x2.dtype
    xn = _rmsnorm_f32(x2, norm_w, eps).to(dt)
    sgu = wgu_s.float()
    g = (_dot_f32(xn, wgu_q[:I]) * sgu[:I]).to(dt).float()
    u = (_dot_f32(xn, wgu_q[I:2 * I]) * sgu[I:]).to(dt).float()
    h = (g * torch.sigmoid(g) * u).to(dt)
    acc = _dot_f32(h, wd_q[:D])
    return (acc * wd_s.float() + x2.float()).to(dt)


class W8A8Trace(NamedTuple):
    """The integers of one mlp_w8a8 call, for holding kernel and twin equal
    up to the f32 epilogue."""
    xq: torch.Tensor       # [M, K] int8 codes of the normalised rows
    xs: torch.Tensor       # [M] f32 row scales
    gu: torch.Tensor       # [M, 2I] s32 gate and up sums
    hq: torch.Tensor       # [M, I] int8 codes of h
    hs: torch.Tensor       # [M, I / group] f32 group scales
    down: torch.Tensor     # [I / group, M, D] s32 down sums per group


def _mlp_w8a8_plain(x2, norm_w, wgu_q, wgu_s, wd_q, wd_s, eps: float,
                    group: int = W8A8_GROUP, trace: bool = False):
    """Twin of K9 mlp_w8a8, `_mlp_w8a8_kernel` (:160): the normalised row
    is quantised to int8 once, in f32 with no rounding before it; gate and
    up are s8 x s8 -> s32 products scaled by (xs * s); h stays f32 and is
    quantised per row over each `group` columns of I (:189, one I-block of
    the Pallas grid); the down products of the groups are added in
    ascending order, each scaled by its group's hs."""
    I, D = wgu_q.shape[0] // 2, wd_s.shape[0]
    group = min(group, I)
    if I % group:
        raise ValueError(f"mlp_w8a8: I={I} is not a multiple of the group {group}")
    xq, xs = _quant_rows_f32(_rmsnorm_f32(x2, norm_w, eps))
    gu = _int_dot(xq, wgu_q[:2 * I])
    sgu = wgu_s.float()
    g = gu[:, :I].float() * (xs * sgu[:I])
    u = gu[:, I:].float() * (xs * sgu[I:])
    h = g * torch.sigmoid(g) * u
    acc = torch.zeros(x2.shape[0], D, dtype=torch.float32, device=x2.device)
    hqs, hss, downs = [], [], []
    for j in range(I // group):
        cols = slice(j * group, (j + 1) * group)
        hq, hs = _quant_rows_f32(h[:, cols])
        part = _int_dot(hq, wd_q[:D, cols])
        acc = acc + part.float() * hs
        hqs.append(hq), hss.append(hs), downs.append(part)
    out = (acc * wd_s.float() + x2.float()).to(x2.dtype)
    if not trace:
        return out
    return out, W8A8Trace(xq, xs[:, 0], gu, torch.cat(hqs, dim=1),
                          torch.cat(hss, dim=1), torch.stack(downs))


# ---------------------------------------------------------------------------
# the unfused chain of the script
# ---------------------------------------------------------------------------
# `_norm_matmul_ref` (:324), rmsnorm and then the dequantising product, rounds
# where the fused body rounds: the chain and the twin are one function
_norm_matmul_ref = _norm_matmul_plain


def _fused_mlp_ref(x2, norm_w, wgu_q, wgu_s, wd_q, wd_s, eps: float):
    """`_fused_mlp_ref` (:242): rmsnorm -> dequant gate_up -> silu * up ->
    dequant down -> + residual, each step rounded to x's dtype (the down
    product is rounded BEFORE the residual is added, where the fused body
    rounds after)."""
    I, D = wgu_q.shape[0] // 2, wd_s.shape[0]
    dt = x2.dtype
    h = _rmsnorm_f32(x2, norm_w, eps).to(dt)
    gu = (_dot_f32(h, wgu_q[:2 * I]) * wgu_s.float()).to(dt)
    gate, up = gu[:, :I].float(), gu[:, I:].float()
    m = (gate * torch.sigmoid(gate) * up).to(dt)
    y = _dot_f32(m, wd_q[:D])
    return x2 + (y * wd_s.float()).to(dt)


def _matmul_residual_ref(x2, w_q, s, res2):
    """The `jnp.dot` branch of `matmul_residual_int8` (:395-397): the
    product is rounded to x's dtype BEFORE the residual is added."""
    N = s.shape[0]
    return res2 + (_dot_f32(x2, w_q[:N]) * s.float()).to(x2.dtype)


# the same chains on the card, through the port's own kernels: the K3 row
# norm, K5 at any row count (tiles of 8 rows), SiLU times up, K5, add
def _norm_matmul_chain(x2, norm_w, w_q, s, eps: float):
    return quant.dequant_gemv_int8(norms.row_norm(x2, norm_w, None, eps, rms=True),
                                   w_q, s)


def _matmul_residual_chain(x2, w_q, s, res2):
    return res2 + quant.dequant_gemv_int8(x2, w_q, s)


def _mlp_chain(x2, norm_w, wgu_q, wgu_s, wd_q, wd_s, eps: float):
    I = wgu_s.shape[0] // 2
    h = norms.row_norm(x2, norm_w, None, eps, rms=True)
    gu = quant.dequant_gemv_int8(h, wgu_q, wgu_s)
    gate, up = gu[:, :I].float(), gu[:, I:].float()
    m = (gate * torch.sigmoid(gate) * up).to(x2.dtype)
    return x2 + quant.dequant_gemv_int8(m, wd_q, wd_s)


# ---------------------------------------------------------------------------
# K9's plan: the persistent grid, the ring and the shared-memory layout
# ---------------------------------------------------------------------------
@lru_cache(maxsize=None)
def k9_constants() -> dict:
    """K9's `constexpr int` constants, read from its source (one
    definition for the kernel and the plan)."""
    return _cuda.constants("decode_fused")


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclass(frozen=True)
class K9Plan:
    """What `csrc/decode_fused.cu` launches for one entry: `ctas` CTAs, one
    an SM, each a contiguous range of whole rows of phase 1 (the N output
    rows, or for the MLP entries the I columns of h, a gate and an up row
    each) and of phase 2 (the D rows of the down product): `rows(phase,
    cta)`. A producer warp streams the rows in stages of 16 rows (8 gate +
    8 up rows in phase 1 of the MLP entries) x one segment of `kseg1` (phase
    1) or `kseg2` bytes (phase 2) through `stages` ring slots, rows
    `rstride` bytes apart, at `ring_off`. The activation rows (x, then h)
    sit at `x_off`, `xstride` bytes apart, `acols` columns each: h takes
    `segs_pass` phase-2 segments at a time (all of them where it fits). The
    scales and residual of the CTA's rows sit at `sc_off`, the consumers'
    sums at `red_off`, W8A8's h of the CTA and group scales at `loc_off`.
    The C entry checks every region against its own constants."""
    entry: str
    M: int
    N: int              # phase-1 rows: N, or I for the MLP entries
    K: int
    D: int              # phase-2 rows (MLP entries), else 0
    group: int          # W8A8 group along I, else 0
    ctas: int
    mt: int
    kseg1: int
    nseg1: int
    kseg2: int
    nseg2: int
    segs_pass: int
    segs_group: int
    stages: int
    rstride: int
    xstride: int
    acols: int
    x_off: int
    sc_off: int
    red_off: int
    loc_off: int
    ring_off: int
    smem: int

    def fields(self) -> tuple:
        """The integers the C entry takes, in its `Plan` struct's order."""
        base1, extra1 = divmod(self.N, self.ctas)
        base2, extra2 = divmod(self.D, self.ctas)
        groups = self.N // self.group if self.group else 0
        return (self.ctas, self.mt, self.kseg1, self.nseg1, self.kseg2,
                self.nseg2, self.segs_pass, self.segs_group, self.stages,
                self.rstride, self.xstride, self.acols, self.x_off,
                self.sc_off, self.red_off, self.loc_off, self.ring_off,
                self.smem, base1, extra1, base2, extra2, groups,
                quant._div_mul(self.group) if self.group else 0)

    @property
    def mma(self) -> bool:
        return self.mt == k9_constants()["MMA_TILE"]

    def rows(self, phase: int, cta: int) -> Tuple[int, int]:
        """(first row, row count) of a CTA in phase 1 or 2: shares differ
        by at most one."""
        n = self.N if phase == 1 else self.D
        base, extra = divmod(n, self.ctas)
        return cta * base + min(cta, extra), base + (cta < extra)


def k9_plan(entry: str, M: int, N: int, K: int, D: int, sms: int,
            group: int = W8A8_GROUP) -> K9Plan:
    """K9's launch of `entry` for x [M, K] on a card of `sms` SMs: the CUDA
    cores up to ROWS_MAX_M rows, the tensor cores above. N: the output rows
    (norm_matmul, matmul_residual) or I (mlp, mlp_w8a8, whose down product
    has D rows); group: mlp_w8a8's activation group along I (min(group, I)
    is taken). Raises ValueError where the layout does not fit."""
    c = k9_constants()
    if entry not in ENTRIES:
        raise ValueError(f"k9_plan: unknown entry {entry!r}")
    if not 1 <= M <= c["MMA_TILE"] or K <= 0 or K % 16 or N <= 0 \
            or (N % 16 and entry in ENTRIES[2:]):
        raise ValueError(f"k9_plan: {entry} takes 1 to {c['MMA_TILE']} rows "
                         f"and 16-byte rows (M={M}, K={K}, N={N})")
    two, w8 = entry in ENTRIES[2:], entry == "mlp_w8a8"
    mma = M > c["ROWS_MAX_M"]
    if w8:
        group = min(group, N)
        if group % 16 or N % group:
            raise ValueError(f"k9_plan: group {group} must be a multiple of 16 "
                             f"that divides I={N}")
    else:
        group = 0
    tile, rows_a_stage = c["MMA_TILE"], c["GROUP_ROWS"]
    n2 = D if two else 0
    ctas = min(sms, max(N, n2))
    rmax1, rmax2 = -(-N // ctas), -(-n2 // ctas)
    rres = rmax2 if two else rmax1
    sc_bytes = 4 * (2 * rmax1 + rmax2 + tile * rres)
    groups = N // group if w8 else 0
    # the sums: two buffers of the warps' 16 x 8 tiles (mma; W8A8 also two
    # row groups of a tile per group of I) or of a sum a (stage row, row of x)
    red = 2 * 4 * (max(c["CONS_WARPS"], groups) * 128 if mma else rows_a_stage * tile)
    loc = 4 * (rmax1 * tile + tile * groups) if w8 else 0

    def xstride_of(acols):
        # x / h rows: int8 codes (W8A8); bf16 in 4-k pairs (mma); f32 in K5's
        # permuted blocks of 512 k (CUDA cores); mma rows 16 (W8A8) or 32
        # (bf16) mod 128 bytes apart, so that the fragment loads hit 32 banks
        if w8:
            return _round_up(acols, 128) + 16 if mma else _round_up(acols, 16)
        return _round_up(2 * acols, 128) + 32 if mma else 4 * _round_up(acols, 512)

    def layout(kseg, segs_pass):
        """The layout with segments of at most `kseg` bytes and h staged
        `segs_pass` phase-2 segments at a time (0: all of it)."""
        if w8:
            # phase-2 segments never cross a group: a divisor of it; phase 1
            # no longer, or the ring's slots would be half empty in phase 2
            kseg2 = max(d for d in range(16, min(group, kseg) + 1, 16)
                        if group % d == 0)
            kseg1 = min(K, kseg2)
        else:
            kseg1, kseg2 = min(K, kseg), (min(N, kseg) if two else 0)
        nseg2 = -(-N // kseg2) if two else 0
        segs_pass = segs_pass or nseg2
        acols = max(K, min(N, segs_pass * kseg2) if two else 0)
        # rows 16 mod 128 bytes apart: no bank conflicts in the mma loads
        rstride = _round_up(max(kseg1, kseg2), 128) + 16
        xstride = xstride_of(acols)
        x_off = c["BARRIER_BYTES"]
        sc_off = _round_up(x_off + M * xstride, 16)
        red_off = _round_up(sc_off + sc_bytes, 16)
        loc_off = red_off + red
        ring_off = _round_up(loc_off + loc, 128)
        stages = min(c["MAX_STAGES"],
                     (c["SMEM_MAX"] - ring_off) // (rows_a_stage * rstride))
        return dict(kseg1=kseg1, nseg1=-(-K // kseg1), kseg2=kseg2, nseg2=nseg2,
                    segs_pass=segs_pass if two else 0,
                    segs_group=group // kseg2 if w8 else 0, stages=stages,
                    rstride=rstride, xstride=xstride, acols=acols, x_off=x_off,
                    sc_off=sc_off, red_off=red_off, loc_off=loc_off,
                    ring_off=ring_off,
                    smem=ring_off + stages * rows_a_stage * rstride)

    # 2 KB segments halve the handshakes a byte where they leave a ring of
    # GOOD_STAGES; else 1 KB, and h in passes where even that leaves no ring
    lay = layout(c["KSEG"], 0)
    if lay["stages"] < c["GOOD_STAGES"]:
        lay = layout(c["KSEG"] // 2, 0)
    if two and lay["stages"] < c["MIN_STAGES"]:
        for segs in range(lay["nseg2"] - 1, 0, -1):
            lay = layout(c["KSEG"] // 2, segs)
            if lay["stages"] >= c["MIN_STAGES"]:
                break
    if lay["stages"] < c["MIN_STAGES"]:
        raise ValueError(f"k9_plan: {entry} M={M} K={K} N={N} D={D} leaves no "
                         f"room for a ring of {c['MIN_STAGES']} stages")
    return K9Plan(entry, M, N, K, n2, group, ctas, tile if mma else M, **lay)


# ---------------------------------------------------------------------------
# K9 launchers
# ---------------------------------------------------------------------------
def _fn(entry: str):
    fn = getattr(_cuda.load("decode_fused").lib, f"vgt_decode_{entry}")
    if fn.argtypes is None:
        P, L, I, F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_float)
        fn.argtypes = {
            "norm_matmul": [P, L, P, P, P, P, L, I, I, I, F],
            "matmul_residual": [P, L, P, P, P, L, P, L, I, I, I],
            "mlp": [P, L, P, P, P, P, P, P, P, L, I, I, I, I, F],
            "mlp_w8a8": [P, L, P, P, P, P, P, P, P, P, L, I, I, I, I, I, F,
                         P, P, P, P, P, P],
        }[entry] + [P, I, P]                  # plan, its length, stream
        fn.restype = ctypes.c_int
    return fn


def _plan(entry: str, x2, n: int, d: int = 0, group: int = 0, plan=None):
    """`k9_plan`'s plan for this launch unless one is given (the card tests
    hand in altered plans, which the C entry must refuse), and its fields
    as a C array."""
    if plan is None:
        plan = k9_plan(entry, x2.shape[0], n, x2.shape[1], d,
                       _cuda.sm_count(x2.device.index), group or W8A8_GROUP)
    f = plan.fields()
    return plan, (ctypes.c_int * len(f))(*f)


def _check_x(x2, what: str):
    _cuda.check_operand(x2, f"{what}: x", torch.bfloat16)
    if not 1 <= x2.shape[0] <= MAX_ROWS:
        raise ValueError(f"{what}: {x2.shape[0]} rows; a fused decode program "
                         f"takes 1 to {MAX_ROWS}")


def _check_weight(w_q, s, K: int, what: str, rows: Optional[int] = None):
    """int8 [>= len(s), K] rows of 16-byte vectors with f32 scales, on the
    card."""
    N = s.shape[0] if rows is None else rows
    if w_q.dim() != 2 or w_q.shape[0] < N or w_q.shape[1] != K:
        raise ValueError(f"{what}: weight {tuple(w_q.shape)} for K={K} and "
                         f"{N} channels")
    for name, t, dt in ((f"{what} weight", w_q, torch.int8),
                        (f"{what} scale", s, torch.float32)):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA {dt} tensor")
    if K % 16 or w_q.data_ptr() % 16:
        raise ValueError(f"{what}: weight rows of {K} bytes are not 16-byte "
                         "vectors")


def _check_norm(norm_w, K: int, what: str):
    if not norm_w.is_cuda or norm_w.dtype != torch.float32 \
            or norm_w.shape != (K,) or not norm_w.is_contiguous() \
            or norm_w.data_ptr() % 16:
        raise ValueError(f"{what}: the norm weight must be a contiguous, "
                         f"16-byte aligned CUDA f32 [{K}] tensor")


def norm_matmul_kernel(x2, norm_w, w_q, s, eps: float, plan=None):
    """Launch K9 norm_matmul. x2: [M <= 8, K] bf16; norm_w: [K] f32; w_q:
    [>= N, K] int8, K % 16 == 0; s: [N] f32 -> [M, N] bf16.

    K9 is a programmatic dependent launch, as K5 (`dequant_gemv_int8`):
    it reads the weights and scales before the kernel before it on the
    stream has finished, so no kernel still running may write them."""
    M, K = x2.shape
    N = s.shape[0]
    _check_x(x2, "norm_matmul")
    _check_norm(norm_w, K, "norm_matmul")
    _check_weight(w_q, s, K, "norm_matmul")
    _, fields = _plan("norm_matmul", x2, N, plan=plan)
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    err = _fn("norm_matmul")(
        x2.data_ptr(), x2.stride(0), norm_w.data_ptr(), w_q.data_ptr(),
        s.data_ptr(), out.data_ptr(), out.stride(0), M, N, K, float(eps),
        fields, len(fields), _cuda.stream_ptr(x2))
    _cuda.check_launch(err, "decode_fused norm_matmul")
    LAUNCHES["norm_matmul"] += 1
    return out


def matmul_residual_kernel(x2, w_q, s, res2, plan=None):
    """Launch K9 matmul_residual. x2: [M <= 8, K] bf16; w_q: [>= N, K]
    int8; s: [N] f32; res2: [M, N] bf16 -> [M, N] bf16."""
    M, K = x2.shape
    N = s.shape[0]
    _check_x(x2, "matmul_residual")
    _check_weight(w_q, s, K, "matmul_residual")
    _cuda.check_operand(res2, "matmul_residual: res", torch.bfloat16)
    if res2.shape != (M, N):
        raise ValueError(f"matmul_residual: res {tuple(res2.shape)} for an "
                         f"output [{M},{N}]")
    _, fields = _plan("matmul_residual", x2, N, plan=plan)
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    err = _fn("matmul_residual")(
        x2.data_ptr(), x2.stride(0), w_q.data_ptr(), s.data_ptr(),
        res2.data_ptr(), res2.stride(0), out.data_ptr(), out.stride(0),
        M, N, K, fields, len(fields), _cuda.stream_ptr(x2))
    _cuda.check_launch(err, "decode_fused matmul_residual")
    LAUNCHES["matmul_residual"] += 1
    return out


def _check_mlp(x2, norm_w, wgu_q, wgu_s, wd_q, wd_s, what: str):
    M, K = x2.shape
    I, D = wgu_s.shape[0] // 2, wd_s.shape[0]
    _check_x(x2, what)
    _check_norm(norm_w, K, what)
    _check_weight(wgu_q, wgu_s, K, f"{what} gate_up")
    _check_weight(wd_q, wd_s, I, f"{what} down")
    if wgu_s.shape[0] != 2 * I or D != K:
        raise ValueError(f"{what}: gate_up of {wgu_s.shape[0]} channels, down "
                         f"[{D},{I}] for x [{M},{K}] (the residual needs D == K)")
    return M, K, I, D


def mlp_kernel(x2, norm_w, wgu_q, wgu_s, wd_q, wd_s, eps: float, plan=None):
    """Launch K9 mlp. x2: [M <= 8, K] bf16; wgu_q: [2I, K] int8 (gate rows,
    then up rows) with wgu_s [2I]; wd_q: [>= K, I] int8 with wd_s [K]; K
    and I multiples of 16 -> [M, K] bf16. A cooperative launch (one grid
    barrier between h and the down product); the weights' contract is
    `norm_matmul_kernel`'s."""
    M, K, I, D = _check_mlp(x2, norm_w, wgu_q, wgu_s, wd_q, wd_s, "mlp")
    _, fields = _plan("mlp", x2, I, D, plan=plan)
    out = torch.empty((M, D), dtype=x2.dtype, device=x2.device)
    hbuf = torch.empty((M, I), dtype=x2.dtype, device=x2.device)
    err = _fn("mlp")(
        x2.data_ptr(), x2.stride(0), norm_w.data_ptr(), wgu_q.data_ptr(),
        wgu_s.data_ptr(), wd_q.data_ptr(), wd_s.data_ptr(), hbuf.data_ptr(),
        out.data_ptr(), out.stride(0), M, K, I, D, float(eps),
        fields, len(fields), _cuda.stream_ptr(x2))
    _cuda.check_launch(err, "decode_fused mlp")
    LAUNCHES["mlp"] += 1
    return out


def mlp_w8a8_kernel(x2, norm_w, wgu_q, wgu_s, wd_q, wd_s, eps: float,
                    group: int = W8A8_GROUP, trace: bool = False, plan=None):
    """Launch K9 mlp_w8a8; operands as `mlp_kernel`. group: the columns of
    I that share one activation scale (min(group, I) must divide I and be a
    multiple of 16). trace=True also returns the kernel's integers as a
    `W8A8Trace`."""
    M, K, I, D = _check_mlp(x2, norm_w, wgu_q, wgu_s, wd_q, wd_s, "mlp_w8a8")
    group = min(int(group), I)
    if group % 16 or I % group:
        raise ValueError(f"mlp_w8a8: group {group} must be a multiple of 16 "
                         f"that divides I={I}")
    plan, fields = _plan("mlp_w8a8", x2, I, D, group, plan=plan)
    dev, G = x2.device, I // group
    out = torch.empty((M, D), dtype=x2.dtype, device=dev)
    hf = torch.empty((M, I), dtype=torch.float32, device=dev)
    slots = torch.empty((plan.ctas, M, G), dtype=torch.float32, device=dev)
    dbg = [None] * 6
    if trace:
        dbg = [torch.empty((M, K), dtype=torch.int8, device=dev),
               torch.empty((M,), dtype=torch.float32, device=dev),
               torch.empty((M, 2 * I), dtype=torch.int32, device=dev),
               torch.empty((G, M, D), dtype=torch.int32, device=dev),
               torch.empty((M, I), dtype=torch.int8, device=dev),
               torch.empty((M, G), dtype=torch.float32, device=dev)]
    err = _fn("mlp_w8a8")(
        x2.data_ptr(), x2.stride(0), norm_w.data_ptr(), wgu_q.data_ptr(),
        wgu_s.data_ptr(), wd_q.data_ptr(), wd_s.data_ptr(), hf.data_ptr(),
        slots.data_ptr(), out.data_ptr(), out.stride(0), M, K, I, D, group,
        float(eps), *(t.data_ptr() if t is not None else None for t in dbg),
        fields, len(fields), _cuda.stream_ptr(x2))
    _cuda.check_launch(err, "decode_fused mlp_w8a8")
    LAUNCHES["mlp_w8a8"] += 1
    if not trace:
        return out
    xq, xs, gu, down, hq, hs = dbg
    return out, W8A8Trace(xq, xs, gu, hq, hs, down)


# ---------------------------------------------------------------------------
# entries
# ---------------------------------------------------------------------------
def fused_norm_matmul_int8(x, norm_w, w_q, s, eps: float = 1e-5):
    """rmsnorm(x) @ dequant(w_q, s) in one program (decode qkv projection;
    `fused_norm_matmul_int8`, :333). x: [..., K]; w_q: [>= N, K] int8; s:
    [N] -> [..., N]. More than 8 rows take the unfused chain."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    cpu = x2.device.type == "cpu"
    if x2.shape[0] > MAX_ROWS:
        y = (_norm_matmul_ref if cpu else _norm_matmul_chain)(
            x2, norm_w, w_q, s, float(eps))
    elif cpu:
        y = _norm_matmul_plain(x2, norm_w, w_q, s, float(eps))
    else:
        y = norm_matmul_kernel(x2, norm_w, w_q, s, float(eps))
    return y.reshape(*lead, s.shape[0])


def matmul_residual_int8(x, w_q, s, res):
    """res + x @ dequant(w_q, s) in one program (decode o_proj;
    `matmul_residual_int8`, :384). x: [..., K]; w_q: [>= N, K] int8; s:
    [N]; res: [..., N] -> [..., N]. More than 8 rows take the unfused
    chain, which rounds the product before the residual is added."""
    lead, K = x.shape[:-1], x.shape[-1]
    N = s.shape[0]
    x2, r2 = x.reshape(-1, K), res.reshape(-1, N)
    cpu = x2.device.type == "cpu"
    if x2.shape[0] > MAX_ROWS:
        y = (_matmul_residual_ref if cpu else _matmul_residual_chain)(
            x2, w_q, s, r2)
    elif cpu:
        y = _matmul_residual_plain(x2, w_q, s, r2)
    else:
        y = matmul_residual_kernel(x2, w_q, s, r2)
    return y.reshape(*lead, N)


def fused_decode_mlp_int8(x, norm_w, wgu_q, wgu_s, wd_q, wd_s,
                          eps: float = 1e-5, *, w8a8: bool = False,
                          group: int = W8A8_GROUP):
    """x + down(silu(gate) * up) over rmsnorm(x) in one program
    (`fused_decode_mlp_int8`, :259; w8a8=True is `_fused_mlp_pallas_w8a8`,
    :201). x: [..., D]; wgu_q: [2I, D] int8 (+ scale [2I]); wd_q: [>= D, I]
    int8 (+ scale [D]) -> [..., D]. group: the w8a8 variant's
    activation-scale width along I. More than 8 rows take the unfused chain
    (w8a8: K9 on tiles of 8 rows)."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    args = (x2, norm_w, wgu_q, wgu_s, wd_q, wd_s, float(eps))
    cpu = x2.device.type == "cpu"
    if w8a8 and cpu:
        y = _mlp_w8a8_plain(*args, group)
    elif w8a8 and x2.shape[0] <= MAX_ROWS:
        y = mlp_w8a8_kernel(*args, group)
    elif w8a8:
        y = torch.cat([mlp_w8a8_kernel(x2[i:i + MAX_ROWS], *args[1:], group)
                       for i in range(0, x2.shape[0], MAX_ROWS)])
    elif x2.shape[0] > MAX_ROWS:
        y = (_fused_mlp_ref if cpu else _mlp_chain)(*args)
    else:
        y = _mlp_plain(*args) if cpu else mlp_kernel(*args)
    return y.reshape(*lead, wd_s.shape[0])
