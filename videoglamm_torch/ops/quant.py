"""Weight-only int8 / int4 quantisation and the dequantising products
(PyTorch port of videoglamm_tpu/ops/quant.py).

The port stores quantised weights in nn.Linear orientation, [N, K] with
each output channel's K values contiguous (int4: [N, K/2] packed bytes,
scales [N, K/group]); the JAX package keeps flax's [K, N]. `io/from_jax.py`
transposes. The nibble order along K is the JAX one: packed byte r of a row
holds k = 2r in its low and k = 2r + 1 in its high nibble.

K5 (`csrc/dequant_gemv.cu`) is the decode GEMV, with two entry points. The
int8 entry replaces the Pallas kernel `_kernel` (quant.py:36): y = (x . w_q)
* scale with f32 accumulation and the per-channel scale in the epilogue.
The int4 entry replaces `_kernel4` (quant.py:132): nibbles are
sign-extended and multiplied by x, each 32-k slice summed in f32 and
multiplied by its group scale once (the Pallas body scales every weight
first: the same function, f32 rounding in another order). Both are bound by the bytes of the weights, which a persistent
grid of contiguous row ranges reads once: for 1 to 3 rows of x on the
CUDA cores straight into registers, for 4 or more on the tensor cores
through a ring of bulk copies, in tiles of 8 rows. f32 activations (an f32
model) take K5's f32 entries, with nothing rounded: one row on the
CUDA-core kernel (x staged from f32, y stored in f32), and from the
crossover (`k5_f32_tc_min_m`: 2, 4 or 5 rows by the output channels an
SM holds) a tensor-core kernel that splits x exactly into three bf16
planes (hi + mid + lo == x) and streams the weights once for every 64
rows of x. `k5_plan` computes the grid and its shared-memory layout and
hands them to the kernel.

Routing follows the JAX package. `dequant_matmul` sends M >= `w8a8_min_m`
rows through dynamic per-token W8A8 (activations quantised per row, an
s8 x s8 -> s32 product, both scales in the epilogue), which the JAX package
leaves to XLA outside any Pallas kernel and which `torch._int_mm` serves on
the card; fewer rows go to K5. `dequant4_matmul` sends M <= `matvec_max_m`
rows to K5 and dequantises once for a plain matmul above that. The
thresholds are arguments, not environment variables. A CPU tensor takes
the plain twins; a CUDA tensor launches K5 or raises.
"""
from __future__ import annotations

import collections
import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _cuda

# K5 launches by entry point ("int8", "int4"; f32 activations:
# "gemv_int8:f32", "gemv_int4:f32"); counted where it launches
LAUNCHES = collections.Counter()

W8A8_MIN_M = 256       # quant.py:253: rows from which the W8A8 branch runs
MATVEC4_MAX_M = 64     # quant.py:225: rows up to which int4 takes the matvec


# ---------------------------------------------------------------------------
# quantisers (copied exactly: the parity tests hold the codes equal)
# ---------------------------------------------------------------------------
def quantize_int8(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, K] float -> (int8 [N, K], scale f32 [N]), symmetric per output
    channel (quant.py:20)."""
    wf = w.float()
    amax = wf.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_rows(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 over the last dim (quant.py:233).
    x: [..., K] float -> (int8 [..., K], scale f32 [..., 1])."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) * (1.0 / 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_int4(w, group: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, K] float -> (packed int8 [N, K/2], scales f32 [N, K/group]):
    4-bit signed symmetric with one scale per (output channel, group of K)
    (quant.py:93)."""
    N, K = w.shape
    if K % group or K % 2:
        raise ValueError(f"quantize_int4: K={K} must be a multiple of the "
                         f"group {group} and of 2")
    wf = w.float().view(N, K // group, group)
    amax = wf.abs().amax(dim=2)
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale[:, :, None]), -8, 7)
    q = q.view(N, K).to(torch.int16)
    packed = (q[:, 0::2] & 0x0F) | ((q[:, 1::2] & 0x0F) << 4)
    return packed.to(torch.uint8).view(torch.int8), scale


def pad_rows8(w_q):
    """Zero-pad an int8 [N, K] weight to a multiple of 8 rows: the s8 x s8
    product of the W8A8 branch needs N % 8 == 0 on the card, and the
    lm_head has vocab + 1 = 32065 rows."""
    pad = -w_q.shape[0] % 8
    return F.pad(w_q, (0, 0, 0, pad)) if pad else w_q


def _unpack4(p):
    """packed int8 -> (lo, hi) sign-extended nibbles as int32 (quant.py:112):
    hi is the arithmetic shift of the byte, lo is ((b & 15) ^ 8) - 8."""
    p32 = p.to(torch.int32)
    return ((p32 & 15) ^ 8) - 8, p32 >> 4


def _dequant4_weights(packed, scales, group: int, dtype):
    """packed [N, K/2], scales [N, K/group] -> [N, K] in `dtype`
    (quant.py:124)."""
    lo, hi = _unpack4(packed)
    N, K2 = packed.shape
    q = torch.stack([lo, hi], dim=2).view(N, 2 * K2)
    w = q.float() * scales.float().repeat_interleave(group, dim=1)
    return w.to(dtype)


# ---------------------------------------------------------------------------
# plain twins of K5
# ---------------------------------------------------------------------------
def _dequant_matmul_plain(x2, w_q, scale):
    """Twin of K5's int8 entry: the arithmetic of the Pallas body
    (quant.py:43-51) and of the small-M branch (quant.py:289-291), f32
    accumulation with the scale in the epilogue. `_dequant_matmul_ref`
    (quant.py:30) scales the weights first; the two agree to f32 rounding.
    x2: [M, K]; w_q: [>= N, K] int8; scale: [N] -> [M, N] in x2.dtype."""
    N = scale.shape[0]
    y = torch.matmul(x2.float(), w_q[:N].float().t())
    return (y * scale.float()).to(x2.dtype)


def _dequant4_matmul_plain(x2, packed, scales, group: int):
    """Twin of K5's int4 entry (quant.py:143-155): weights dequantised in
    f32 (nibble * group scale), f32 products and accumulation."""
    w = _dequant4_weights(packed, scales, group, torch.float32)
    return torch.matmul(x2.float(), w.t()).to(x2.dtype)


# ---------------------------------------------------------------------------
# K5's plan: the persistent grid and its shared-memory layout
# ---------------------------------------------------------------------------
K5_GROUP_ROWS = 16       # rows of a ring stage (tensor-core route)
K5_SEGMENT = 1024        # bytes of a row a stage holds (the last one shorter)
K5_MAX_STAGES = 6
K5_ROWS_MAX_M = 3        # up to 3 rows on the CUDA cores, from 4 on mma
K5_F32_MT = 4            # rows of x a pass takes with f32 x (.cu: F32_MT)
K5_MMA_TILE = 8          # rows of x a tensor-core pass takes
K5_MMA_WARPS = 16        # consumer warps of the tensor-core route (.cu)
K5_UNIT = {False: 1024, True: 512}  # bytes of a CUDA-core unit, int8 / int4
K5_ROW_CTAS = (2, 1, 1, 1)  # CUDA cores: CTAs an SM by rows of x a tile (.cu)
K5_SMEM = 232448         # dynamic shared memory a block can use (H100)
K5_SMEM_SM = 233472      # shared memory of an SM (228 KB)
K5_SMEM_CTA = 1024       # of which the system reserves per CTA
K5_BARRIERS = 128        # bytes for the full / empty mbarriers at offset 0
# the f32 tensor-core route (csrc/dequant_gemv.cu `gemv_f32_tc_kernel`):
# its constexpr lines, read from the source (the functions below take them)
_K5 = _cuda.constants("dequant_gemv")
K5_TC_MT = _K5["TC_MT"]                 # rows of x a pass over the weights
K5_TC_PN_MAX_W = _K5["TC_PN_MAX_W"]     # planes side by side along N up to W
K5_TC_BK = _K5["TC_BK"]                 # k a fresh accumulator sums at most
K5_TC_MAX_STAGES = 8
K5_TC_ALIGN = 1024       # the ring's slots and planes: the swizzle's period


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _div_mul(d: int) -> int:
    """ceil(2^32 / d) as a signed 32-bit int (0 for d <= 1): n // d is then
    the high word of n * mul for n * d < 2^32, as the kernel's `fast_div`
    takes it."""
    if d <= 1:
        return 0
    m = -(-(1 << 32) // d)
    return m - (1 << 32) if m >= 1 << 31 else m


@dataclass(frozen=True)
class K5Plan:
    """What `csrc/dequant_gemv.cu` launches: `ctas` CTAs along N, each a
    contiguous range of whole rows (`rows(cta)`), times `m_tiles` tiles of
    `mt` rows of x. Shared memory holds x at `x_off` (rows `xstride` bytes
    apart) and `smem` bytes in all.

    CUDA-core route (mt <= 4): `per_sm` CTAs an SM; a CTA's rows are cut
    into units of 32 lanes x 2 vectors of 16 bytes (int8) or 32 x 1 (int4);
    their sums sit at `s_off` until a row's add in order. With f32 x it
    takes the rows below the crossover (`k5_f32_tc_min_m`), in tiles of up
    to 4 rows.
    Tensor-core route (mt = 8): one CTA an SM streams its rows in stages of
    16 rows x one `kseg`-byte segment of each row, through a ring of
    `stages` slots of 16 rows `rstride` bytes apart at `ring_off`, behind
    the barriers at 0; the CTA's scales sit at `s_off` and the warps' sums
    at `red_off`.
    f32 tensor-core route (`xw` = W > 0, mt <= 64 rows a pass): one CTA an
    SM, or for few output channels as few CTAs of up to 64 rows; a ring of
    `stages` slots of `slot` bytes at `ring_off`, each the three bf16
    planes of x's k-slice (`xstride` bytes), x's slice in f32 at `x_off`,
    then 128 weight rows (64 with `ksplit`) of `kseg` bytes (TMA boxes of
    8 to 64 rows, `rstride`-byte halves, swizzled); the CTA's group scales
    (int4) at `s_off`, the warpgroups' k-split sums at `red_off`. The C
    entry checks every region against its own constants before it
    launches."""
    M: int
    N: int
    K: int
    group: int          # 0 for int8
    ctas: int
    mt: int
    m_tiles: int
    kseg: int
    nseg: int
    stages: int
    rstride: int
    xstride: int
    x_off: int
    s_off: int
    red_off: int
    ring_off: int
    smem: int
    per_sm: int
    xw: int = 0         # f32 tensor cores: the planes' width W (0: another route)
    slot: int = 0       # bytes of a ring slot
    ksplit: int = 0     # 1: the two warpgroups take alternate k-slices

    def fields(self) -> tuple:
        """The integers the C entry takes, in its `Plan` struct's order:
        the layout, then N = ctas * base + extra, two divisors with their
        multipliers (`fast_div`): a row's units (CUDA-core route) and the
        32-k slices of a scale group (int4), the CTAs an SM, and the f32
        tensor-core route's plane width, slot bytes and k split."""
        base, extra = divmod(self.N, self.ctas)
        vpr = 0 if self.mma or self.tc else \
            -(-self.rowbytes // K5_UNIT[bool(self.group)])
        gdiv = self.group // 32
        return (self.ctas, self.mt, self.m_tiles, self.kseg, self.nseg,
                self.stages, self.rstride, self.xstride, self.x_off,
                self.s_off, self.red_off, self.ring_off, self.smem, base,
                extra, vpr, _div_mul(vpr), gdiv, _div_mul(gdiv), self.per_sm,
                self.xw, self.slot, self.ksplit)

    @property
    def mma(self) -> bool:
        """The bf16 tensor-core route (mma.sync, tiles of 8 rows)."""
        return self.mt == K5_MMA_TILE and not self.tc

    @property
    def tc(self) -> bool:
        """The f32 tensor-core route (wgmma over x's three bf16 planes)."""
        return self.xw > 0

    @property
    def rowbytes(self) -> int:
        return self.K // 2 if self.group else self.K

    def rows(self, cta: int) -> Tuple[int, int]:
        """(first row, row count) of a CTA: shares differ by at most one."""
        base, extra = divmod(self.N, self.ctas)
        return cta * base + min(cta, extra), base + (cta < extra)


def k5_f32_tc_min_m(N: int, sms: int, src: dict = _K5) -> int:
    """The rows of f32 x from which `k5_plan` takes the tensor cores for N
    output channels on `sms` SMs (the crossovers measured on the card, by
    the channels an SM would hold): F32_TC_MIN_M_FEW_ROWS for at most 64,
    F32_TC_MIN_M_MANY_ROWS for more than F32_TC_MANY_ROWS, F32_TC_MIN_M
    between. `src`: the .cu's constants (`_cuda.constants`), here and in the
    functions below (a rebuilt variant's, experiments/k5_f32_variants.py)."""
    rows = -(-N // sms)
    return (src["F32_TC_MIN_M_FEW_ROWS"] if rows <= 64 else
            src["F32_TC_MIN_M_MANY_ROWS"] if rows > src["F32_TC_MANY_ROWS"] else
            src["F32_TC_MIN_M"])


def k5_tc_width(mt: int, src: dict = _K5) -> int:
    """The planes' width W (B columns a plane) for `mt` rows of x on the
    f32 tensor-core route: a multiple of 8, and TC_MT above TC_NARROW_MAX."""
    return src["TC_MT"] if mt > src["TC_NARROW_MAX"] else _round_up(mt, 8)


def k5_tc_ks(W: int, src: dict = _K5) -> int:
    """k a stage of the f32 tensor-core route at plane width W."""
    return (src["TC_KS_SMALL"] if W <= src["TC_SMALL_MAX"] else
            src["TC_KS_NARROW"] if W <= src["TC_NARROW_MAX"] else src["TC_KS_WIDE"])


def k5_tc_bk(W: int, src: dict = _K5) -> int:
    """k a fresh accumulator sums (within a stage, inside one int4 scale
    group) at plane width W."""
    return min(k5_tc_ks(W, src), src["TC_BK"])


def k5_plan(M: int, N: int, K: int, group: int, sms: int,
            f32: bool = False, tc=None, src: dict = _K5) -> K5Plan:
    """K5's launch for x [M, K] against N weight rows (group = 0: int8 rows
    of K bytes; else int4 rows of K/2 bytes with a scale per `group` k) on
    a card of `sms` SMs. f32: x is f32. It takes the f32 tensor-core route
    from `k5_f32_tc_min_m(N, sms)` rows (where an int4 scale group is a
    whole number of its k-blocks), else the CUDA-core route in tiles of up
    to K5_F32_MT rows; `tc` True / False forces one (the card's crossover
    timings). `src`: the .cu's constants the f32 tensor-core route is planned
    by. Raises ValueError where the layout does not fit."""
    rowbytes = K // 2 if group else K
    if f32 and M >= 2 and (tc if tc is not None else M >= k5_f32_tc_min_m(N, sms, src) and (
            not group or group % k5_tc_bk(k5_tc_width(min(M, src["TC_MT"]), src), src) == 0)):
        return _k5_f32_tc_plan(M, N, K, group, sms, src)
    if f32 or M <= K5_ROWS_MAX_M:
        mt = min(M, K5_F32_MT) if f32 else M
        per_sm = K5_ROW_CTAS[mt - 1]
        ctas = min(N, sms * per_sm)
        max_rows = -(-N // ctas)
        # x in f32, in blocks of 32 chunks of 16 bytes (512 k int8, 1024 k
        # int4), then the units' sums; `per_sm` CTAs an SM side by side (1
        # KB of each SM's shared memory is the system's a CTA)
        xstride = 4 * _round_up(K, 32 * (32 if group else 16))
        s_off = mt * xstride
        smem = s_off + max_rows * -(-rowbytes // K5_UNIT[bool(group)]) * mt * 4
        if smem > K5_SMEM_SM // per_sm - K5_SMEM_CTA:
            raise ValueError(f"k5_plan: M={M} K={K} N={N} needs {smem} bytes "
                             "of shared memory")
        return K5Plan(M, N, K, group, ctas, mt, -(-M // mt), 0, 0, 0, 0,
                      xstride, 0, s_off, 0, 0, smem, per_sm)
    ctas = min(N, sms)
    max_rows = -(-N // ctas)
    kseg = min(rowbytes, K5_SEGMENT)
    nseg = -(-rowbytes // kseg)
    # rows 16 mod 128 bytes apart: the 32-bit loads of rows g = 0..7, word
    # t = 0..3 fall on 32 different banks; x rows 32 (int8: 8-byte loads)
    # or 64 (int4: 16-byte loads) mod 128 bytes apart, likewise
    rstride = _round_up(kseg, 128) + 16
    xstride = _round_up(2 * K, 128) + (64 if group else 32)
    x_off = K5_BARRIERS
    s_off = x_off + K5_MMA_TILE * xstride
    scols = K // group if group else 1
    red_off = s_off + _round_up(max_rows * scols * 4, 16)
    # the warps' 16 x 8 sums, two buffers
    ring_off = _round_up(red_off + 2 * 4 * K5_MMA_WARPS * 128, 128)
    stage_bytes = K5_GROUP_ROWS * rstride
    stages = min(K5_MAX_STAGES, (K5_SMEM - ring_off) // stage_bytes)
    if stages < 2:
        raise ValueError(f"k5_plan: M={M} K={K} leaves no room for a ring "
                         f"of two {stage_bytes}-byte stages")
    return K5Plan(M, N, K, group, ctas, K5_MMA_TILE, -(-M // K5_MMA_TILE),
                  kseg, nseg, stages, rstride, xstride, x_off, s_off, red_off,
                  ring_off, ring_off + stages * stage_bytes, 1)


def _k5_f32_tc_plan(M: int, N: int, K: int, group: int, sms: int,
                    src: dict) -> K5Plan:
    """The f32 tensor-core route: CTAs over contiguous row ranges (one
    an SM, or as few of up to 64 rows where an SM would hold at most 64),
    x in passes of up to 64 rows (grid.y), a stage `k5_tc_ks(W)` k of x's
    planes, x in f32 and 128 weight rows (two warpgroups of 64; a CTA of
    at most 64 rows gives its warpgroups alternate stages instead)."""
    rowbytes = K // 2 if group else K
    mt = min(M, src["TC_MT"])
    W = k5_tc_width(mt, src)
    ks, bk = k5_tc_ks(W, src), k5_tc_bk(W, src)
    if group and group % bk:
        raise ValueError(f"k5_plan: an int4 scale group of {group} k is not a "
                         f"whole number of the f32 tensor-core route's "
                         f"{bk}-k blocks")
    kseg = ks // 2 if group else ks
    # a warpgroup's products take 64 rows whatever a CTA holds: where the
    # card's SMs would hold at most 64 rows each, as few CTAs of 64 rows
    # (the two warpgroups then take alternate stages)
    ctas = min(N, sms) if -(-N // sms) > 64 else -(-N // 64)
    max_rows = -(-N // ctas)
    ksplit = int(max_rows <= 64)
    # weight rows in TMA boxes of 8 to 64 rows x min(kseg, 128) bytes (a
    # 256-byte row slice in two such halves), swizzled over that span: a
    # warp's 8 rows x 4 words fall on 32 banks
    rstride = min(kseg, 128)
    planes = 6 * W * ks          # three bf16 planes of W rows
    slot = _round_up(planes + _round_up(4 * mt * ks, K5_TC_ALIGN)
                     + (64 if ksplit else 128) * kseg, K5_TC_ALIGN)
    scales = _round_up(max_rows * (K // group) * 4, 16) if group else 0
    red = 128 * W // 2 * 4 if ksplit else 0
    ring_off = K5_TC_ALIGN       # the barriers below it
    stages = min(K5_TC_MAX_STAGES,
                 (K5_SMEM - K5_TC_ALIGN - ring_off - scales - red) // slot)
    if ksplit:
        # even: stage i lies in slot i % stages and belongs to warpgroup
        # i % 2, so a slot serves one warpgroup, which waits on every phase
        # of its barrier (with an odd ring a warpgroup would skip phases, and
        # a wait for a lap's parity could return on the phase before it)
        stages -= stages % 2
    if stages < 2:
        raise ValueError(f"k5_plan: M={M} K={K} N={N} leaves no room for two "
                         f"{slot}-byte stages of the f32 tensor-core route")
    s_off = ring_off + stages * slot
    red_off = s_off + scales
    return K5Plan(M, N, K, group, ctas, mt, -(-M // mt), kseg,
                  -(-rowbytes // kseg), stages, rstride, planes, planes, s_off,
                  red_off, ring_off, red_off + red + K5_TC_ALIGN, 1, xw=W,
                  slot=slot, ksplit=ksplit)


# ---------------------------------------------------------------------------
# K5 launchers
# ---------------------------------------------------------------------------
def _gemv_fn(kind: str, f32: bool = False):
    fn = getattr(_cuda.load("dequant_gemv").lib,
                 f"vgt_dequant_gemv_{kind}{'_f32' if f32 else ''}")
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        group = [I] if kind == "int4" else []
        fn.argtypes = [P, L, P, P, P, L, I, I, I] + group + [P, I, P]
        fn.restype = ctypes.c_int
    return fn


def _launch_gemv(kind, x2, w, scale, N, group, plan=None):
    """plan: `k5_plan`'s for these shapes unless given (the card tests hand
    in altered plans, which the C entry must refuse). f32 x takes the f32
    entry."""
    M, K = x2.shape
    f32 = x2.dtype == torch.float32
    if plan is None:
        plan = k5_plan(M, N, K, group, _cuda.sm_count(x2.device.index), f32)
    fields = (ctypes.c_int * len(plan.fields()))(*plan.fields())
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    tail = [group] if kind == "int4" else []
    err = _gemv_fn(kind, f32)(x2.data_ptr(), x2.stride(0), w.data_ptr(),
                         scale.data_ptr(), out.data_ptr(), out.stride(0),
                         M, N, K, *tail, fields, len(fields),
                         _cuda.stream_ptr(x2))
    _cuda.check_launch(err, f"dequant_gemv_{kind}")
    LAUNCHES[f"gemv_{kind}:f32" if f32 else kind] += 1
    return out


def _check_gemv(x2, w, scale, row_bytes: int, what: str):
    _cuda.check_operand(x2, f"{what}: x", torch.float32
                        if x2.dtype == torch.float32 else torch.bfloat16)
    for name, t, dt in (("weight", w, torch.int8), ("scale", scale,
                                                    torch.float32)):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous CUDA "
                             f"{dt} tensor")
    if row_bytes % 16 or w.data_ptr() % 16:
        raise ValueError(f"{what}: weight rows of {row_bytes} bytes are not "
                         "16-byte vectors")


def dequant_gemv_int8(x2, w_q, scale):
    """Launch K5's int8 entry. x2: [M, K] bf16 or f32; w_q: [>= N, K] int8
    with K % 16 == 0; scale: [N] f32 -> [M, N] of x2's dtype. Every M is
    taken (bf16: tiles of 8 rows from M = 4 on; f32: the f32 entry, one row
    on the CUDA cores, from `k5_f32_tc_min_m` rows the tensor cores in
    passes of 64 rows). Raises unless the operands are CUDA tensors of these
    types.

    K5 is a programmatic dependent launch: it starts while the kernel
    before it on the stream drains and reads the weights and scales before
    it waits for that kernel (it waits only before it reads x). So no
    kernel still running on the stream may write w_q or scale: they are
    written once, when the model is loaded or quantised, and a caller that
    rewrites them in place must synchronise the stream before the next
    launch."""
    M, K = x2.shape
    N = scale.shape[0]
    if w_q.dim() != 2 or w_q.shape[0] < N or w_q.shape[1] != K:
        raise ValueError(f"dequant_gemv_int8: weight {tuple(w_q.shape)} for "
                         f"x [{M},{K}] and {N} channels")
    _check_gemv(x2, w_q, scale, K, "dequant_gemv_int8")
    return _launch_gemv("int8", x2, w_q, scale, N, 0)


def dequant_gemv_int4(x2, packed, scales, group: int = 128):
    """Launch K5's int4 entry. x2: [M, K] bf16 or f32 (the f32 entry, as
    `dequant_gemv_int8`); packed: [N, K/2] int8 with K % 32 == 0; scales:
    [N, K/group] f32 with group % 32 == 0 -> [M, N] of x2's dtype. The
    weights' contract is `dequant_gemv_int8`'s: no kernel still running on
    the stream writes packed or scales."""
    M, K = x2.shape
    N = packed.shape[0]
    if packed.shape != (N, K // 2) or group % 32 or K % group \
            or scales.shape != (N, K // group):
        raise ValueError(f"dequant_gemv_int4: packed {tuple(packed.shape)}, "
                         f"scales {tuple(scales.shape)}, group {group} for "
                         f"x [{M},{K}]")
    _check_gemv(x2, packed, scales, K // 2, "dequant_gemv_int4")
    return _launch_gemv("int4", x2, packed, scales, N, group)


# ---------------------------------------------------------------------------
# entries
# ---------------------------------------------------------------------------
def _int_matmul(q, w_q):
    """s8 [M, K] x s8 [Np, K]^T -> s32 [M, Np], exact."""
    if q.is_cuda:
        if w_q.shape[0] % 8:
            raise ValueError("W8A8 on the card needs the int8 weight padded "
                             f"to a multiple of 8 rows (pad_rows8), got "
                             f"{w_q.shape[0]}")
        return torch._int_mm(q, w_q.t())
    return torch.matmul(q.to(torch.int32), w_q.to(torch.int32).t())


def _w8a8_matmul(x2, w_q, scale):
    """Dynamic per-token W8A8 (quant.py:243): quantise the activations per
    row, s8 x s8 -> s32, fold both scales into the f32 epilogue."""
    N = scale.shape[0]
    q, s = quantize_rows(x2)
    acc = _int_matmul(q, w_q)[:, :N]
    return (acc.float() * s * scale.float()).to(x2.dtype)


def dequant_matmul(x, w_q, scale, *, w8a8_min_m: int = W8A8_MIN_M):
    """x: [..., K] float; w_q: [>= N, K] int8 (rows past N are padding);
    scale: [N] f32 -> [..., N] (quant.py:268).

    M >= w8a8_min_m rows (prefill): dynamic per-token W8A8. Fewer rows
    (decode): the weights stream once as int8 through K5 on the card, and
    through its plain twin for a CPU tensor."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if x2.shape[0] >= w8a8_min_m:
        y = _w8a8_matmul(x2, w_q, scale)
    elif x2.device.type == "cpu":
        y = _dequant_matmul_plain(x2, w_q, scale)
    else:
        y = dequant_gemv_int8(x2, w_q, scale)
    return y.reshape(*lead, scale.shape[0])


def dequant4_matmul(x, packed, scales, group: int = 128, *,
                    matvec_max_m: int = MATVEC4_MAX_M):
    """x: [..., K]; packed: [N, K/2] int8 nibbles; scales: [N, K/group] f32
    -> [..., N] (quant.py:209). M <= matvec_max_m rows (decode) stream the
    weights at 4 bits through K5; more rows (prefill) dequantise once to
    x's dtype and take a plain matmul."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if x2.shape[0] > matvec_max_m:
        y = F.linear(x2, _dequant4_weights(packed, scales, group, x.dtype))
    elif x2.device.type == "cpu":
        y = _dequant4_matmul_plain(x2, packed, scales, group)
    else:
        y = dequant_gemv_int4(x2, packed, scales, group)
    return y.reshape(*lead, packed.shape[0])
