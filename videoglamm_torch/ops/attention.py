"""Attention ops (PyTorch port of videoglamm_tpu/ops/attention.py).

K1 (`csrc/attention_fwd.cu`) is one online-softmax forward kernel. It takes
the place of two Pallas kernels: the flash kernel `_flash_kernel`
(attention.py:93) and the BSHD single-block kernel `_bshd_kernel`
(attention.py:738). It reads q, k, v and writes o through element strides,
so the [B,H,S,D], [B,S,H,D] and fused [B,S,3,H,D] layouts all go in with
no copies. One body serves every launch: TMA loads into an mbarrier ring,
a producer warpgroup, two consumer warpgroups on wgmma, head dims up to 256
(the SAM-2 memory self-attention [4,1,4096,256] f32 is its "flash_d256"
mode). `k1_route` names the three ways in: "wgmma" for bf16 operands;
"wgmma_f32" for f32 storage in a bf16 model (the SAM-2 memory attention),
where a hand-written staging pass (`stage_bf16`, counted as "stage_bf16")
first writes contiguous bf16 copies of q, k and v, rounded to nearest even,
and the body stores O in f32; and "simt_f32" for the f32 operands of a
model whose compute dtype is f32, a full-precision body of its own
(`csrc/attention_f32.cu`: f32 FFMA on the CUDA cores, every mode K1 serves,
head dims up to 256). The model passes that choice down explicitly
(`exact=True`). The wrapper computes the TMA plan (`k1_tma_plan`) of the
wgmma routes and refuses a view that TMA cannot take.

K7 (`csrc/window_attention.cu`) is the whole-row-softmax kernel for medium
non-causal self-attention (512 < S <= 1536). It replaces the Pallas kernel
`_window_kernel` (attention.py:523) on K1's design: two passes over the
key tiles through the same TMA ring, first the exact row maximum and sum
from q k^T alone, then exp(s - m) / l rounded to bf16 into p v, so no
accumulator is rescaled. On a grid too small for 128-query tiles it takes
64-query tiles (`k7_plan`). f32 operands in a bf16 model take the same
staging pass; an f32 model's (`exact`) take K7's full-precision route,
which is K1's "simt_f32" body (`csrc/attention_f32.cu`) launched from K7's
wrapper as non-causal full self-attention: an online softmax and the TPU
kernel's two passes agree to f32 rounding. `dot_product_attention` takes it
where the JAX package takes `_window_attention` (attention.py:1308-1310).

K8 (`csrc/smallwin_attention.cu`) is the attention inside 16-, 32- or
64-token windows straight from a fused qkv projection. It replaces the
Pallas kernel `_smallwin_kernel` (attention.py:605): a (window, head) pair
is a unit of S/16 warps, a window's keys are one tile, and the softmax is a
single pass in registers; nothing is packed or masked. An f32 model's f32
qkv takes K8's full-precision route: the "simt_f32" body over the packed
qkv's strides in its block-diagonal mode, the NW windows of S tokens read
as one sequence of NW * S with window S, so a 64-row tile holds 64 / S
whole windows and the keys of other windows are masked, never summed. K7
and K8 get the recompute backward of the JAX `custom_vjp`s (autograd
through the plain twin, attention.py:588-599 and :709-714).

K4 (`csrc/decode_attention_q8.cu`) is the single-query attention over the
int8 token-major KV cache. It replaces the Pallas kernel `_decode_q_kernel`
(attention.py:1061): the stacked cache is read in place (TMA tensor maps
over the whole cache, the layer a coordinate), the per-token and per-head
scales fold into the logits (K) and the probabilities (V), GQA is native,
and kv_lens is read on the device; f32 queries (an f32 model) take the
same kernel with q and o in f32 and nothing rounded to bf16. One launch a
call: CTAs split the tokens of a (row, kv head), and the last split to
finish folds the others' partials from a workspace kept per device and
stream (`k4_plan` sizes it all). `dot_product_attention` sends every Sq == 1 call with `k_scale` on a
CUDA tensor to K4 (the TPU's lane-layout condition `_decode_group_plan`
has no counterpart here).

K6 (`csrc/flash_bwd.cu`) is the backward of K1 for training. It replaces
the Pallas kernels `_flash_bwd_dq_kernel` (attention.py:302) and
`_flash_bwd_dkv_kernel` (attention.py:336) with a delta prepass, a dq kernel
and a dk/dv kernel on the same Hopper design as K1's wgmma route (TMA into
an mbarrier ring, a producer warpgroup, two consumer warpgroups on wgmma);
the wrapper checks its TMA plan (`k6_tma_plan`). f32 operands take K6's
f32 route in `csrc/attention_f32.cu` (the same three passes in f32 FFMA,
counted as "flash_bwd:simt_f32" too), its only way in for f32.
`flash_attention` is a `torch.autograd.Function` when a gradient is asked
for: the forward has K1 write the row log-sum-exp, the backward launches
K6 on CUDA tensors and runs K6's plain twin `_flash_bwd_plain` on CPU
tensors. The BSHD entries
get the recompute backward that the JAX package gives them (autograd
through the plain twin), which is no TPU kernel.

The dispatch mirrors the JAX package. A call site takes K1 exactly where
the JAX package takes a Pallas kernel on the TPU, and takes the plain
PyTorch twin where JAX used XLA. Each condition cites its JAX line. The
kernel wrappers take the plain twins only for CPU tensors. On a CUDA
tensor they launch K1 or raise.

Shapes follow the JAX functions: [B, H, S, D] for `dot_product_attention`
and `flash_attention`, and [B, S, H, D] for the BSHD entries.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import _cuda

NEG_INF = -1e30

# K1 launches by mode: "causal" (LLM prefill), "flash" (long non-causal,
# Hiera global blocks), "bshd" (CLIP / InternVideo2 self-attention),
# "flash_d256" (the same at head dims above 128: SAM-2 memory
# self-attention), "window" (Hiera window attention inside
# fused_window_block); K4 launches under "decode_q8", K6 under "flash_bwd",
# K7 under "window_attn", K8 under "smallwin". K1 also counts each launch
# under its route: "route:wgmma" (bf16), "route:wgmma_f32" (f32 storage in
# a bf16 model) or "route:simt_f32" (an f32 model); the staging pass of f32
# operands (K1 and K7) counts under "stage_bf16"; K6's f32 route counts
# under "flash_bwd:simt_f32" beside "flash_bwd". The f32 routes of K4, K7
# and K8 count under "decode_q8:f32", "window:simt_f32" and
# "smallwin:simt_f32" instead of their kernel's name
LAUNCHES = collections.Counter()

# K1 and K7: a CTA owns up to K1_BM query rows (two consumer warpgroups of
# 64) and walks key tiles of `key_tile(depth)` keys
K1_BM = 128
K1_BN = 128                              # keys a tile up to depth 128
K1_BN_D256 = 64                          # at depth 256 (shared memory)
K1_DEPTHS = (32, 64, 80, 96, 128, 256)   # padded head dims K1 and K7 build

# K6: a dq CTA owns K6_ROWS queries, a dk/dv CTA K6_ROWS keys (two consumer
# warpgroups of 64 each); a ring stage holds K6_TILE keys (dq) or queries
# (dk/dv). K6 pads the head dim to K6_DEPTHS as K1 does.
K6_ROWS = 128
K6_TILE = 64
K6_DEPTHS = K1_DEPTHS[:-1]

# K4 (csrc/decode_attention_q8.cu), its constants as that source defines them:
# consumer warps a CTA (and a producer warp), the splits a fold takes, ring
# stages, dynamic shared memory, and by query heads a kv head G the dims
# (int8 codes) a lane owns and the tokens a phase takes from a stage
# between softmax updates (G = 1 at head dims divisible by 24: the wide lanes)
_K4 = _cuda.constants("decode_attention_q8")
K4_CONSUMERS = 32 * _K4["CWARPS"]
K4_SHAPE = {g: (_K4[f"DPL_G{g}"], _K4[f"CHUNK_G{g}"]) for g in (1, 2, 4)}
K4_SHAPE_WIDE = (_K4["DPL_G1_WIDE"], _K4["CHUNK_G1_WIDE"])
K4_MAX_STAGES = _K4["MAX_STAGES"]
K4_MAX_SPLITS = _K4["MAX_SPLITS"]
K4_SMEM = _K4["DYN_SMEM"]


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------
def _attention_plain(q, k, v, *, causal: bool, sm_scale: float,
                     kv_lens=None, bias=None, kv_mask=None, q_start=None,
                     k_scale=None, v_scale=None):
    """Twin of `_attention_xla` (attention.py:34-87).
    q: [B,H,Sq,D]; k/v: [B,H,Sk,D]. Products accumulate in f32. With
    k_scale/v_scale ([B,H,Sk] f32) k and v are int8 codes: the K scale
    folds into the logits, the V scale into the probabilities before they
    are rounded to q's dtype."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if k_scale is not None:
        logits = logits * k_scale[:, :, None, :].float()
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        # q_start is the absolute KV position of query 0; without it the
        # queries are the LAST Sq valid tokens (attention.py:60-69)
        if q_start is not None:
            offs = q_start
        elif kv_lens is not None:
            offs = kv_lens - Sq
        else:
            offs = torch.full((B,), Sk - Sq, dtype=torch.int64, device=q.device)
        qi = (torch.arange(Sq, device=q.device)[None, :, None]
              + offs.to(q.device).view(B, 1, 1))
        ki = torch.arange(Sk, device=q.device)[None, None, :]
        logits = torch.where((qi >= ki)[:, None], logits, NEG_INF)
    if kv_lens is not None:
        valid = (torch.arange(Sk, device=q.device)[None, :]
                 < kv_lens.to(q.device)[:, None])
        logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    if kv_mask is not None:
        logits = torch.where(kv_mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        probs = (probs * v_scale[:, :, None, :].float()).to(q.dtype)
    else:
        probs = probs.to(v.dtype)
    out = torch.matmul(probs.float(), v.float())
    return out.to(q.dtype)


def _pair_mask(q, k, kv_lens, q_start, causal: bool):
    """Bool [B,1,Sq,Sk] of attendable pairs as K1 and K6 mask them:
    key < kv_len, and for causal key <= q_start + row."""
    B, Sq, Sk = q.shape[0], q.shape[2], k.shape[2]
    ki = torch.arange(Sk, device=q.device)[None, None, :]
    mask = (ki < kv_lens.to(q.device).view(B, 1, 1)).expand(B, Sq, Sk)
    if causal:
        qi = (torch.arange(Sq, device=q.device)[None, :, None]
              + q_start.to(q.device).view(B, 1, 1))
        mask = mask & (qi >= ki)
    return mask[:, None]


def _flash_fwd_plain(q, k, v, kv_lens, q_start, causal: bool, sm_scale: float):
    """Twin of K1 with its LSE output (`_flash_fwd`, attention.py:203):
    returns (out, lse). lse [B,H,Sq] f32 is the log-sum-exp of the scaled
    logits over the attendable keys, NEG_INF for a row with none; such a
    row's output is 0 (attention.py:170-180)."""
    mask = _pair_mask(q, k, kv_lens, q_start, causal)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    s = torch.where(mask, s, NEG_INF)
    any_valid = mask.any(dim=-1)
    lse = torch.where(any_valid, torch.logsumexp(s, dim=-1), NEG_INF)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return out.to(q.dtype), lse


def _flash_bwd_plain(q, k, v, out, lse, dout, kv_lens, q_start, causal: bool,
                     sm_scale: float):
    """Twin of K6 (`_flash_bwd`, attention.py:377, tile math `_bwd_common`
    :281): the probabilities are recomputed from `lse`, p and ds are rounded
    to the storage dtype before the three products, which accumulate in f32
    (:327-329, :364-369). The mask is applied by selection, so a row with
    lse = NEG_INF (no valid key) gives zeros though its exp overflows.
    Returns (dq, dk, dv) in q's dtype."""
    mask = _pair_mask(q, k, kv_lens, q_start, causal)
    qf, kf, vf, gf = q.float(), k.float(), v.float(), dout.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    delta = (gf * out.float()).sum(dim=-1, keepdim=True)
    ds = torch.where(mask, p * (dp - delta) * sm_scale, 0.0)
    p = p.to(q.dtype).float()
    ds = ds.to(q.dtype).float()
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _decode_attention_q8_plain(q, k, v, k_scale, v_scale, *, sm_scale: float,
                               kv_lens=None, layer=None, causal: bool = False,
                               bias=None, kv_mask=None, q_start=None):
    """Twin of K4 and of the JAX fallback (attention.py:1276-1294): take the
    layer's slab if the cache is stacked, view the token-major int8 rows
    head-major, repeat the kv heads for GQA, and run the scale-folding path
    of `_attention_plain`. q: [B,Hq,Sq,hd]; k/v: [(L,) B, C, Hkv*hd] int8;
    k_scale/v_scale: [(L,) B, Hkv, C] f32."""
    if k.dim() == 4:
        k, v, k_scale, v_scale = (t[layer] for t in (k, v, k_scale, v_scale))
    B, Hq, _, hd = q.shape
    Hkv, C = k_scale.shape[-2], k.shape[-2]
    k = k.view(B, C, Hkv, hd).transpose(1, 2)
    v = v.view(B, C, Hkv, hd).transpose(1, 2)
    if Hq != Hkv:
        rep = Hq // Hkv
        k, v, k_scale, v_scale = (t.repeat_interleave(rep, dim=1)
                                  for t in (k, v, k_scale, v_scale))
    return _attention_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                            kv_lens=kv_lens, bias=bias, kv_mask=kv_mask,
                            q_start=q_start, k_scale=k_scale, v_scale=v_scale)


def _attention_plain_bshd(q, k, v, sm_scale: float, win: int = 0):
    """Twin of `_attention_xla_bshd` (attention.py:846-856).
    q: [B,Sq,H,D]; k/v: [B,Sk,H,D] -> [B,Sq,H,D]."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if win and win < k.shape[1]:
        row = torch.arange(q.shape[1], device=q.device)[:, None] // win
        col = torch.arange(k.shape[1], device=q.device)[None, :] // win
        logits = torch.where((row == col)[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _window_attention_plain(q, k, v, sm_scale: float):
    """Twin of K7 and of the reference its backward recomputes through
    (`_attention_xla` with no mask, attention.py:588-595). q/k/v:
    [B,H,S,D]."""
    return _attention_plain(q, k, v, causal=False, sm_scale=sm_scale)


def _smallwin_plain(qkv, num_heads: int, sm_scale: float):
    """Twin of K8 and of `_smallwin_xla` (attention.py:697-701).
    qkv: [NW,S,3*H*hd] -> [NW,S,H*hd]."""
    NW, S, C3 = qkv.shape
    x = qkv.reshape(NW, S, 3, num_heads, C3 // (3 * num_heads))
    return _attention_plain_bshd(x[:, :, 0], x[:, :, 1], x[:, :, 2],
                                 sm_scale).reshape(NW, S, C3 // 3)


# ---------------------------------------------------------------------------
# K1 launcher
# ---------------------------------------------------------------------------
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _kernel_fn():
    built = _cuda.load("attention_fwd")
    fn = built.lib.vgt_attention_fwd
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [P, P, P, P] + [L] * 12 + [P, P] + [I] * 7 + [
            ctypes.c_float, P, I, P]
        fn.restype = ctypes.c_int
    return fn


def _check_qkvo(what: str, q, k, v, out, max_d: int):
    """The operand rules K1 and K7 share: bf16 or f32 CUDA tensors of one
    dtype, [B,H,S,D] views with a contiguous head dim, D % 8 == 0."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{what}: expected bf16 or f32 operands, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _cuda.check_operand(t, name, q.dtype)
    if k.shape != (B, H, Sk, D) or v.shape != k.shape or out.shape != q.shape:
        raise ValueError(f"{what}: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"out{tuple(out.shape)}")
    if D % 8 or D > max_d:
        raise ValueError(f"{what}: head dim {D} unsupported "
                         f"(needs D % 8 == 0 and D <= {max_d})")


def k1_route(dtype, D: int, exact: bool = False) -> str:
    """The way into K1 for a launch on operands of `dtype`:
    "wgmma" for bf16 operands (csrc/attention_fwd.cu); for f32 operands,
    "simt_f32" when `exact` (csrc/attention_f32.cu: f32 products, f32
    accumulation) and "wgmma_f32" otherwise (the staging pass to bf16
    first, O stored in f32).

    The rule: only a model whose compute dtype is f32 takes "simt_f32". Its
    modules carry `exact_f32 = True` (`models.common.set_exact_f32`, called
    by `build_inference`, `build_training` and `build_sam2` for
    dtype=torch.float32) and pass it here as `exact`; f32 operands in a
    bf16 model (the SAM-2 memory attention) keep the staged route. No
    environment variable or global switch takes part. Every route takes
    head dims up to 256; the wrapper raises on anything else."""
    if dtype != torch.float32:
        return "wgmma"
    return "simt_f32" if exact else "wgmma_f32"


def k8_route(dtype, exact: bool = False) -> str:
    """The way into K8 for qkv of `dtype`: "mma" for bf16 (its own body,
    csrc/smallwin_attention.cu) and, for f32 qkv, "simt_f32" when `exact`
    (the rule of `k1_route`: only an f32 model takes it). K8 has no staged
    route: f32 qkv in a bf16 model raises ValueError. K7 routes as K1
    (`k1_route`)."""
    if dtype != torch.float32:
        return "mma"
    if not exact:
        raise ValueError(
            "smallwin_attention: f32 qkv takes K8's full-precision route only "
            "in an f32 model (exact=True); K8 takes bf16 only otherwise")
    return "simt_f32"


def key_tile(depth: int) -> int:
    """Keys a ring tile of K1 and K7 at a padded head dim: 128, and 64 at
    256, where Q and two stages of K and V fill the shared memory."""
    return K1_BN_D256 if depth > 128 else K1_BN


def _tma_refusal(t) -> Optional[str]:
    """Why TMA cannot take the [B,H,S,D] view `t` as a tensor map of its
    own strides, or None: the head dim must be contiguous, the base address
    16-byte aligned, and every byte stride of a dim longer than 1 a positive
    multiple of 16 below 2**40."""
    if t.stride(-1) != 1:
        return "head dim is not contiguous"
    if t.data_ptr() % 16:
        return "is not 16-byte aligned"
    for s, n, what in ((t.stride(2), t.shape[2], "token"),
                       (t.stride(1), t.shape[1], "head"),
                       (t.stride(0), t.shape[0], "batch")):
        nb = 2 * s if n > 1 else 16
        if nb <= 0 or nb % 16 or nb >= 2 ** 40:
            return (f"{what} stride of {nb} bytes (TMA needs a positive "
                    "multiple of 16 below 2**40)")
    return None


def _tma_map(t, name: str, who: str, rows: int) -> dict:
    """The rank-4 map that `map_bhsd` (csrc/sm90_common.cuh) encodes for the
    [B,H,S,D] view `t`: dims (D, S, H, B) innermost first; the byte strides
    of S, H and B (an extent of 1 gets a placeholder of 16); the box (64
    columns: one 128-byte swizzled chunk, `rows` rows). Raises ValueError
    where TMA would refuse the view."""
    why = _tma_refusal(t)
    if why is not None:
        raise ValueError(f"{who}: {name} {why}")
    B, H, S, D = t.shape
    strides = tuple(2 * s if n > 1 else 16 for s, n in
                    ((t.stride(2), S), (t.stride(1), H), (t.stride(0), B)))
    return dict(dims=(D, S, H, B), strides=strides, box=(64, rows, 1, 1))


def _tma_depth(D: int, who: str, depths=K1_DEPTHS) -> int:
    if D > depths[-1]:
        raise ValueError(f"{who}: head dim {D} above {depths[-1]}")
    return next(d for d in depths if d >= D)


def k1_tma_plan(q, k, v, out) -> dict:
    """The tensor maps that K1 encodes for a launch (`map_bhsd`), from the
    [B,H,S,D] views alone, so it also runs on meta tensors: for each operand
    its dims, byte strides and box (`_tma_map`; boxes of K1_BM query rows,
    `key_tile` key rows, 64 output rows). Also the padded depth of QK^T (the
    N of PV), its number of 64-column chunks and the key tile. f32 operands
    (route "wgmma_f32") are read through the staging pass's contiguous bf16
    copies, whose shapes `staged` lists; their f32 output is stored from
    the registers and has no map. TMA fills columns past D with zeros, so a
    fused-qkv view needs no copy. Raises ValueError where TMA would refuse
    a view: a head dim that is not contiguous or above 256, a base address
    that is not 16-byte aligned, a byte stride that is not a positive
    multiple of 16 below 2**40."""
    depth = _tma_depth(q.shape[-1], "k1_tma_plan")
    bn = key_tile(depth)
    staged = None
    ops = [("q", q, K1_BM), ("k", k, bn), ("v", v, bn), ("out", out, 64)]
    if q.dtype == torch.float32:
        staged = {n: tuple(t.shape) for n, t, _ in ops[:3]}
        ops = [(n, torch.empty(t.shape, dtype=torch.bfloat16, device="meta"), r)
               for n, t, r in ops[:3]]
    maps = {name: _tma_map(t, name, "k1_tma_plan", rows)
            for name, t, rows in ops}
    return dict(depth=depth, chunks=-(-depth // 64), key_tile=bn,
                staged=staged, maps=maps)


def k7_plan(q, k, v, out, sms: int) -> dict:
    """K7's launch (`vgt_window_attention`), from the [B,H,S,D] views alone
    (meta tensors too) and the card's SM count: the padded depth, its
    chunks, the key tile, the query rows a CTA (128 with two consumer
    warpgroups; 64 with one when 128-row tiles would leave more than half
    the SMs idle), the CTAs, and the tensor maps as `k1_tma_plan` gives
    them (f32 operands through the staging copies, no output map)."""
    B, H, S, D = q.shape
    plan = k1_tma_plan(q, k, v, out)
    wide = -(-S // K1_BM) * B * H
    rows = 64 if 2 * wide < sms else K1_BM
    plan.update(query_rows=rows, ctas=-(-S // rows) * B * H)
    plan["maps"]["q"]["box"] = (64, rows, 1, 1)
    return plan


def k6_tma_plan(q, k, v, out, dout) -> dict:
    """The tensor maps of a K6 launch (`vgt_flash_bwd`), from the [B,H,S,D]
    views alone (meta tensors too): the loads of q, k, v and dout and the
    stores of dq, dk and dv (new contiguous tensors shaped like q, k, v),
    every box 64 columns by K6_TILE rows (a CTA's K6_ROWS rows are two
    boxes); `out` is read by the delta prepass through its strides and is
    held to the same rule. Returns the padded depth (K6_DEPTHS), its number
    of 64-column chunks and the eight maps (`_tma_map`). Raises ValueError
    on a view that the maps cannot take."""
    depth = _tma_depth(q.shape[-1], "k6_tma_plan", K6_DEPTHS)
    ops = dict(q=q, k=k, v=v, out=out, dout=dout)
    ops.update({"d" + n: torch.empty(t.shape, dtype=t.dtype, device="meta")
                for n, t in (("q", q), ("k", k), ("v", v))})
    maps = {name: _tma_map(t, name, "k6_tma_plan", K6_TILE)
            for name, t in ops.items()}
    return dict(depth=depth, chunks=-(-depth // 64), maps=maps)


def _as_int32(t, B: int, device):
    if t is None:
        return None
    t = t.to(device=device, dtype=torch.int32).reshape(B).contiguous()
    return t


def _stage_fn():
    fn = _cuda.load("attention_fwd").lib.vgt_stage_bf16
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ctypes.POINTER(P), ctypes.POINTER(P),
                       ctypes.POINTER(ctypes.c_longlong),
                       ctypes.POINTER(ctypes.c_int)] + [I] * 4 + [P]
        fn.restype = ctypes.c_int
    return fn


def stage_bf16(*ts):
    """The staging pass of the f32 routes of K1 and K7: contiguous bf16
    copies of 1 to 3 f32 [B,H,S_i,D] views (one B, H and D; a contiguous
    head dim), rounded to nearest even, as `Tensor.to` rounds. The plain
    twin for CPU tensors; on the card one launch of `stage_bf16_kernel`
    (csrc/attention_fwd.cu) for all of them, into new tensors, or it
    raises."""
    if ts[0].device.type == "cpu":
        return tuple(t.to(torch.bfloat16).contiguous() for t in ts)
    B, H, _, D = ts[0].shape
    if not 1 <= len(ts) <= 3 or D % 8:
        raise ValueError(f"stage_bf16: 1 to 3 tensors with D % 8 == 0, got "
                         f"{len(ts)} of head dim {D}")
    for i, t in enumerate(ts):
        _cuda.check_operand(t, f"stage_bf16[{i}]", torch.float32)
        if t.dim() != 4 or (t.shape[0], t.shape[1], t.shape[3]) != (B, H, D):
            raise ValueError(f"stage_bf16: shapes {[tuple(x.shape) for x in ts]}")
    outs = tuple(torch.empty(t.shape, dtype=torch.bfloat16, device=t.device)
                 for t in ts)
    n = len(ts)
    src = (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))
    dst = (ctypes.c_void_p * n)(*(t.data_ptr() for t in outs))
    strides = (ctypes.c_longlong * (3 * n))(*(s for t in ts for s in t.stride()[:3]))
    rows = (ctypes.c_int * n)(*(t.shape[2] for t in ts))
    err = _stage_fn()(src, dst, strides, rows, n, B, H, D, _cuda.stream_ptr(ts[0]))
    _cuda.check_launch(err, "stage_bf16")
    LAUNCHES["stage_bf16"] += 1
    return outs


def _f32_fwd_fn():
    fn = _cuda.load("attention_f32").lib.vgt_attention_fwd_f32
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [P, P, P, P] + [L] * 12 + [P, P] + [I] * 7 + [
            ctypes.c_float, P, P]
        fn.restype = ctypes.c_int
    return fn


def _simt_f32(q, k, v, out, *, sm_scale: float, what: str, causal=False,
              kv_lens=None, q_start=None, win: int = 0, lse=None):
    """One launch of the full-precision f32 body (csrc/attention_f32.cu) on
    [B,H,S,D] views through their (batch, head, token) strides: K1's
    "simt_f32" route, and K7's and K8's f32 routes. kv_lens / q_start:
    int32 [B] on the device or None; lse: None or a contiguous f32
    [B,H,Sq]."""
    B, H, Sq, D = q.shape
    err = _f32_fwd_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        kv_lens.data_ptr() if kv_lens is not None else None,
        q_start.data_ptr() if q_start is not None else None,
        B, H, Sq, k.shape[2], D, int(causal), int(win), float(sm_scale),
        lse.data_ptr() if lse is not None else None, _cuda.stream_ptr(q))
    _cuda.check_launch(err, what)


def attention_fwd_kernel(q, k, v, out, *, causal: bool, sm_scale: float,
                         mode: str, kv_lens=None, q_start=None, win: int = 0,
                         lse=None, exact: bool = False):
    """Launch K1. q: [B,H,Sq,D], k/v: [B,H,Sk,D], out: [B,H,Sq,D] — any
    strides with a contiguous head dim (views of BSHD or fused-qkv tensors
    are read in place). kv_lens/q_start: [B] ints or None. `mode` names the
    launch counter. lse: None (serving), or a contiguous f32 [B,H,Sq] that
    the kernel fills with the row log-sum-exp of the scaled logits (NEG_INF
    for a row with no valid key). Raises unless the operands are CUDA
    tensors of one dtype, bf16 or f32, with D % 8 == 0 and D <= 256; the
    block-diagonal `win` mode serves D <= 128; and on views that the TMA
    plan refuses (`k1_tma_plan`). f32 operands take the route
    `k1_route(torch.float32, D, exact)` names: "simt_f32" (the
    full-precision body of csrc/attention_f32.cu, no staging) for a model
    whose compute dtype is f32, else "wgmma_f32": the staging pass
    (`stage_bf16`) first, then the body with an f32 output."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    _check_qkvo("attention_fwd", q, k, v, out, 128 if win else 256)
    if causal and q_start is None:
        raise ValueError("attention_fwd: causal launches need q_start")
    if lse is not None and (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
                            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError("attention_fwd: lse must be a contiguous f32 "
                         f"[{B},{H},{Sq}] on {q.device}")
    route = k1_route(q.dtype, D, exact)
    kvl = _as_int32(kv_lens, B, q.device)
    qs = _as_int32(q_start, B, q.device)
    if route == "simt_f32":
        _simt_f32(q, k, v, out, sm_scale=sm_scale, what="attention_fwd",
                  causal=causal, kv_lens=kvl, q_start=qs, win=win, lse=lse)
    else:
        k1_tma_plan(q, k, v, out)
        if route == "wgmma_f32":
            q, k, v = stage_bf16(q, k, v)
        err = _kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], kvl.data_ptr() if kvl is not None else None,
            qs.data_ptr() if qs is not None else None,
            B, H, Sq, Sk, D, int(causal), int(win), float(sm_scale),
            lse.data_ptr() if lse is not None else None,
            int(out.dtype == torch.float32), _cuda.stream_ptr(q))
        _cuda.check_launch(err, "attention_fwd")
    LAUNCHES[mode] += 1
    LAUNCHES["route:" + route] += 1
    return out


# ---------------------------------------------------------------------------
# K7 and K8 launchers
# ---------------------------------------------------------------------------
def _window_fn():
    fn = _cuda.load("window_attention").lib.vgt_window_attention
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [P, P, P, P] + [L] * 12 + [I] * 4 + [ctypes.c_float, I, P]
        fn.restype = ctypes.c_int
    return fn


def window_attention_kernel(q, k, v, *, sm_scale: float, exact: bool = False):
    """Launch K7. q/k/v: [B,H,S,D] views with a contiguous head dim, one
    dtype, bf16 or f32, on the card; non-causal full self-attention with a
    whole-row softmax. Returns a new contiguous [B,H,S,D] tensor of the
    operands' dtype. f32 operands take the route `k1_route(torch.float32,
    D, exact)` names: "simt_f32" for an f32 model (the full-precision body
    of csrc/attention_f32.cu, f32 FFMA, nothing staged; counted as
    "window:simt_f32"), else the staging pass (`stage_bf16`) first. Raises
    on other operands, on D % 8 != 0 or D > 256, on S > 1536 (the branch
    `dot_product_attention` sends here) and, on the staged and bf16 routes,
    on views that the TMA plan refuses (`k7_plan`)."""
    B, H, S, D = q.shape
    out = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    _check_qkvo("window_attention", q, k, v, out, 256)
    if k.shape[2] != S or S > 1536:
        raise ValueError(f"window_attention: needs Sq == Sk <= 1536, got "
                         f"Sq {S}, Sk {k.shape[2]}")
    if k1_route(q.dtype, D, exact) == "simt_f32":
        _simt_f32(q, k, v, out, sm_scale=sm_scale, what="window_attention")
        LAUNCHES["window:simt_f32"] += 1
        return out
    k7_plan(q, k, v, out, torch.cuda.get_device_properties(q.device)
            .multi_processor_count)
    if q.dtype == torch.float32:
        q, k, v = stage_bf16(q, k, v)
    err = _window_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        B, H, S, D, float(sm_scale), int(out.dtype == torch.float32),
        _cuda.stream_ptr(q))
    _cuda.check_launch(err, "window_attention")
    LAUNCHES["window_attn"] += 1
    return out


def _smallwin_fn():
    fn = _cuda.load("smallwin_attention").lib.vgt_smallwin_attention
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P] + [I] * 4 + [ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def smallwin_attention_kernel(qkv, num_heads: int, head_dim: int, *,
                              sm_scale: float, exact: bool = False):
    """Launch K8. qkv: contiguous [NW,S,3*H*hd] on the card, S in (16, 32,
    64), hd % 8 == 0, hd <= 128; any window count. Returns [NW,S,H*hd] of
    qkv's dtype. bf16 takes K8's body (csrc/smallwin_attention.cu); f32
    takes K8's full-precision route, and only for an f32 model (`exact`):
    the "simt_f32" body of csrc/attention_f32.cu over qkv's strides as one
    sequence of NW * S tokens with windows of S (its block-diagonal mode),
    counted as "smallwin:simt_f32". Raises on anything else."""
    NW, S, C3 = qkv.shape
    C = num_heads * head_dim
    f32 = k8_route(qkv.dtype, exact) == "simt_f32"
    _cuda.check_operand(qkv, "qkv", torch.float32 if f32 else torch.bfloat16)
    if not qkv.is_contiguous() or C3 != 3 * C:
        raise ValueError(f"smallwin_attention: qkv {tuple(qkv.shape)} must be "
                         f"contiguous [NW,S,3*{num_heads}*{head_dim}]")
    if S not in (16, 32, 64) or head_dim % 8 or head_dim > 128:
        raise ValueError(f"smallwin_attention: window of {S} tokens, head dim "
                         f"{head_dim} unsupported (needs S in 16, 32, 64, "
                         "hd % 8 == 0, hd <= 128)")
    out = torch.empty((NW, S, C), dtype=qkv.dtype, device=qkv.device)
    if f32:
        x = qkv.view(1, NW * S, 3, num_heads, head_dim)
        q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
        o = out.view(1, NW * S, num_heads, head_dim).transpose(1, 2)
        _simt_f32(q, k, v, o, sm_scale=sm_scale, what="smallwin_attention",
                  win=S)
        LAUNCHES["smallwin:simt_f32"] += 1
        return out
    err = _smallwin_fn()(qkv.data_ptr(), out.data_ptr(), NW, S, num_heads,
                         head_dim, float(sm_scale), _cuda.stream_ptr(qkv))
    _cuda.check_launch(err, "smallwin_attention")
    LAUNCHES["smallwin"] += 1
    return out


# ---------------------------------------------------------------------------
# K6 launcher
# ---------------------------------------------------------------------------
def _flash_bwd_fn():
    fn = _cuda.load("flash_bwd").lib.vgt_flash_bwd
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ctypes.POINTER(P), ctypes.POINTER(ctypes.c_longlong),
                       P, P, P, P] + [I] * 6 + [ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def _flash_bwd_f32_fn():
    fn = _cuda.load("attention_f32").lib.vgt_flash_bwd_f32
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ctypes.POINTER(P), ctypes.POINTER(ctypes.c_longlong),
                       P, P, P, P] + [I] * 6 + [ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return fn


def flash_bwd_kernel(q, k, v, out, lse, dout, *, causal: bool, sm_scale: float,
                     kv_lens=None, q_start=None):
    """Launch K6. q, out, dout: [B,H,Sq,D]; k, v: [B,H,Sk,D], bf16 or f32
    on the card (f32 takes K6's f32 route, csrc/attention_f32.cu, with
    f32 products); lse: f32 [B,H,Sq] as K1 wrote it. q, k, v, out and dout are read
    in place through their (batch, head, token) strides, so the gradient of
    `o.transpose(1, 2).reshape(...)` arrives with no copy; an operand that
    TMA cannot take as it is (`_tma_refusal`: a broadcast gradient, a head
    dim that is not contiguous) is made contiguous here first. The TMA plan
    (`k6_tma_plan`) is checked before the launch. Returns (dq, dk, dv), new
    contiguous tensors of the operands' dtype. Raises on anything else."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if k.shape != (B, H, Sk, D) or v.shape != k.shape or out.shape != q.shape \
            or dout.shape != q.shape or lse.shape != (B, H, Sq):
        raise ValueError(f"flash_bwd: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} out{tuple(out.shape)} "
                         f"dout{tuple(dout.shape)} lse{tuple(lse.shape)}")
    if D % 8 or D > 128:
        raise ValueError(f"flash_bwd: head dim {D} unsupported "
                         "(needs D % 8 == 0 and D <= 128)")
    if causal and q_start is None:
        raise ValueError("flash_bwd: causal launches need q_start")
    if lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"flash_bwd: lse must be f32 on {q.device}")
    f32 = q.dtype == torch.float32
    dt = torch.float32 if f32 else torch.bfloat16
    ops = [t if _tma_refusal(t) is None else t.contiguous()
           for t in (q, k, v, out, dout)]
    for name, t in zip(("q", "k", "v", "out", "dout"), ops):
        _cuda.check_operand(t, name, dt)
    if not f32:
        k6_tma_plan(*ops)
    ops += [torch.empty(t.shape, dtype=t.dtype, device=t.device)
            for t in (q, k, v)]
    lse = lse.contiguous()
    delta = torch.empty_like(lse)
    kvl = _as_int32(kv_lens, B, q.device)
    qs = _as_int32(q_start, B, q.device)
    ptrs = (ctypes.c_void_p * 8)(*(t.data_ptr() for t in ops))
    strides = (ctypes.c_longlong * 24)(*(s for t in ops for s in t.stride()[:3]))
    err = (_flash_bwd_f32_fn() if f32 else _flash_bwd_fn())(
        ptrs, strides, lse.data_ptr(), delta.data_ptr(),
        kvl.data_ptr() if kvl is not None else None,
        qs.data_ptr() if qs is not None else None,
        B, H, Sq, Sk, D, int(causal), float(sm_scale), _cuda.stream_ptr(q))
    _cuda.check_launch(err, "flash_bwd")
    LAUNCHES["flash_bwd"] += 1
    if f32:
        LAUNCHES["flash_bwd:simt_f32"] += 1
    return ops[5], ops[6], ops[7]


# ---------------------------------------------------------------------------
# K4 plan and launcher
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class K4Plan:
    """What `csrc/decode_attention_q8.cu` launches for B rows, Hkv kv heads
    of `hd` dims (G = Hq / Hkv query heads each) over a cache of C tokens:
    CTA (split, kv head, row) on a grid (splits, Hkv, B), about one CTA an
    SM. A split takes ceil(kv_len / splits) contiguous tokens. Its producer
    warp streams them in stages of `tile` tokens (K and V by `nbox` TMA
    boxes of `box` rows of `pitch` bytes, the scales by 4-byte copies)
    through a ring of `stages` slots of `stage_bytes`. Lane v of consumer
    segment p (`seg` lanes, `vph` of them live) holds `dpl` dims from dpl
    * v and takes rows p, p + phases, ... (`chunk` of them) of each stage:
    tokens p, p + phases, ... of the split, `chunk` between softmax
    updates. The phases of a warp merge in a butterfly of shuffles; the
    warps' states sit at part_off and pml_off. Each split leaves a partial
    of `ws_stride` floats (o for the G heads, then their m and l) in the
    workspace, and the last split of a (row, head) folds them. The C entry
    takes the choices (`splits`, `pitch`, `box`, `stages`) and derives the
    rest as this plan does (`vgt_decode_q8_layout`, compared with `fields`
    on the card), refusing choices that do not fit."""
    B: int
    Hq: int
    Hkv: int
    hd: int
    C: int
    splits: int
    seg: int
    chunk: int
    pitch: int
    box: int
    nbox: int
    stages: int
    stage_bytes: int
    v_off: int
    ks_off: int
    vs_off: int
    part_off: int
    pml_off: int
    bar_off: int
    smem: int
    ws_stride: int

    @property
    def G(self) -> int:
        return self.Hq // self.Hkv

    @property
    def dpl(self) -> int:
        """Dims (int8 codes) a lane owns."""
        return _k4_shape(self.G, self.hd)[0]

    @property
    def vph(self) -> int:
        return self.hd // self.dpl

    @property
    def phases(self) -> int:
        return K4_CONSUMERS // self.seg

    @property
    def tile(self) -> int:
        """Tokens a stage."""
        return self.phases * self.chunk

    @property
    def ws_floats(self) -> int:
        """The partials of one call, in floats."""
        return self.B * self.Hkv * self.splits * self.ws_stride

    def fields(self) -> tuple:
        """The layout as the C entry's `Plan` struct holds it."""
        lg = lambda n: n.bit_length() - 1
        return (self.splits, lg(self.splits), self.seg, lg(self.seg),
                self.vph, self.phases, self.chunk, self.tile, self.pitch,
                self.box, self.nbox, self.stages, self.stage_bytes, self.v_off,
                self.ks_off, self.vs_off, self.part_off, self.pml_off,
                self.bar_off, self.smem, self.ws_stride)


def _round(n: int, m: int) -> int:
    return -(-n // m) * m


def _k4_shape(G: int, hd: int) -> Tuple[int, int]:
    """(dims a lane owns, chunk) of K4's instantiation for G and hd."""
    return K4_SHAPE_WIDE if G == 1 and hd % K4_SHAPE_WIDE[0] == 0 \
        else K4_SHAPE[G]


def k4_plan(B: int, Hq: int, Hkv: int, hd: int, C: int, sms: int) -> K4Plan:
    """K4's launch on a card of `sms` SMs: as many splits (a power of two,
    at most K4_MAX_SPLITS) as keep B * Hkv * splits within one CTA an SM and
    every split at least one token a phase at kv_len = C; as many ring
    stages as shared memory holds, up to 8. Raises ValueError for a
    geometry the kernel does not take."""
    G = Hq // Hkv if Hkv > 0 else 0
    if hd % 16 or not 16 <= hd <= 128 or Hkv * hd > 4096 or Hq != G * Hkv \
            or G not in K4_SHAPE or B < 1 or C < 1:
        raise ValueError(f"k4_plan: head dim {hd}, Hkv*hd {Hkv * hd}, "
                         f"Hq/Hkv {Hq}/{Hkv}, B {B}, C {C} unsupported (needs "
                         "hd % 16 == 0, hd <= 128, Hkv*hd <= 4096, Hq/Hkv in "
                         "1, 2, 4)")
    dpl, chunk = _k4_shape(G, hd)
    vph = hd // dpl
    seg = 1 << (vph - 1).bit_length()
    phases = K4_CONSUMERS // seg
    splits = 1
    while (2 * splits <= K4_MAX_SPLITS and B * Hkv * 2 * splits <= sms
           and 2 * splits * phases <= C):
        splits *= 2
    # a stage: `chunk` rows a phase, `pitch` bytes a row (hd, or more where
    # no box of a stage's rows takes a multiple of 128 bytes, the boxes'
    # alignment); the stage in 1, 3, 5 or 15 TMA boxes of at most 256 rows
    tile = phases * chunk
    pitch, nbox = next((pitch, n) for pitch in (hd, _round(hd, 32),
                                                _round(hd, 64), 128)
                       for n in (1, 3, 5, 15) if tile % n == 0
                       and tile // n <= 256 and tile // n * pitch % 128 == 0)
    box = tile // nbox
    v_off = _round(tile * pitch, 128)
    ks_off = v_off + _round(tile * pitch, 128)
    vs_off = ks_off + _round(4 * tile, 16)
    stage_bytes = _round(vs_off + 4 * tile, 128)
    warps = K4_CONSUMERS // 32
    rest = _round(4 * warps * G * hd, 16) + _round(8 * warps * G, 16) \
        + 16 * K4_MAX_STAGES
    stages = min(K4_MAX_STAGES, (K4_SMEM - rest) // stage_bytes)
    if stages < 2:
        raise ValueError(f"k4_plan: a {stage_bytes}-byte stage leaves no room "
                         "for a ring of two")
    part_off = stages * stage_bytes
    pml_off = part_off + _round(4 * warps * G * hd, 16)
    bar_off = pml_off + _round(8 * warps * G, 16)
    smem = bar_off + 16 * K4_MAX_STAGES
    ws_stride = -(-G * (hd + 2) // 4) * 4
    return K4Plan(B, Hq, Hkv, hd, C, splits, seg, chunk, pitch, box, nbox,
                  stages, stage_bytes, v_off, ks_off, vs_off, part_off,
                  pml_off, bar_off, smem, ws_stride)


# made once per geometry: the decode loop calls K4 with the same one every layer
_k4_plan_cached = functools.lru_cache(maxsize=256)(k4_plan)


# K4's workspace by (device, stream): the splits' partials (f32) and a
# ticket a (row, kv head) (int32, zero between calls: a call's last split
# wraps its ticket back to 0). A workspace outgrown by a larger call is
# kept alive too, for CUDA graphs that captured it.
_K4_WORKSPACE: dict = {}
_K4_OUTGROWN: list = []


def _k4_workspace(device, stream: int, floats: int, tickets: int):
    key = (device.index, stream)
    ws = _K4_WORKSPACE.get(key)
    if ws is None or ws[0].numel() < floats or ws[1].numel() < tickets:
        if ws is not None:
            _K4_OUTGROWN.append(ws)
        ws = (torch.empty(max(floats, 1 << 16), dtype=torch.float32,
                          device=device),
              torch.zeros(max(tickets, 1024), dtype=torch.int32, device=device))
        _K4_WORKSPACE[key] = ws
    return ws


def _decode_fn(f32: bool = False):
    lib = _cuda.load("decode_attention_q8").lib
    fn = lib.vgt_decode_attention_q8_f32 if f32 else lib.vgt_decode_attention_q8
    if fn.argtypes is None:
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [P, L, L, P, P, P, P, P, P, L, L, P, L, P, L] + \
            [I] * 7 + [ctypes.c_float] + [I] * 4 + [P]
        fn.restype = ctypes.c_int
    return fn


def decode_attention_q8(q, k, v, k_scale, v_scale, kv_lens, layer=None, *,
                        sm_scale: float):
    """Launch K4. q: [B,Hq,1,hd] bf16 or f32 (q head i reads kv head i //
    G); k/v: the token-major int8 cache, one layer's slab [B,C,Hkv*hd] or
    the stacked [L,B,C,Hkv*hd] with `layer` an int, read in place; k_scale
    / v_scale: [(L,) B,Hkv,C] f32; kv_lens: [B] ints on the device.
    Returns [B,Hq,1,hd] of q's dtype: f32 q takes K4's f32 route (the same
    kernel, q and o in f32, p * vs not rounded to bf16; counted as
    "decode_q8:f32"). Supports hd % 16 == 0, hd <= 128,
    Hkv*hd <= 4096 and G = Hq/Hkv in (1, 2, 4); raises otherwise, and
    unless q is a bf16 or f32 CUDA tensor. One device kernel a call; the wrapper
    allocates only the output (the splits' partials go to a workspace kept
    per device and stream, so calls on one stream run one after the other,
    as a stream runs them)."""
    B, Hq, Sq, hd = q.shape
    if k.dim() == 3:
        k, v, k_scale, v_scale = (t[None] for t in (k, v, k_scale, v_scale))
        layer = 0
    L, _, C, HD = k.shape
    Hkv = k_scale.shape[-2]
    f32 = q.dtype == torch.float32
    _cuda.check_operand(q, "q", torch.float32 if f32 else torch.bfloat16)
    if Sq != 1 or HD != Hkv * hd or v.shape != k.shape or k.shape[1] != B \
            or k_scale.shape != (L, B, Hkv, C) or v_scale.shape != k_scale.shape:
        raise ValueError(f"decode_attention_q8: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"k_scale{tuple(k_scale.shape)} "
                         f"v_scale{tuple(v_scale.shape)}")
    if layer is None or not 0 <= int(layer) < L:
        raise ValueError(f"decode_attention_q8: layer {layer} of {L}")
    for name, t, dt in (("k", k, torch.int8), ("v", v, torch.int8),
                        ("k_scale", k_scale, torch.float32),
                        ("v_scale", v_scale, torch.float32)):
        if t.device != q.device or t.dtype != dt or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"decode_attention_q8: {name} must be a "
                             f"contiguous {dt} tensor on {q.device}")
    if not (kv_lens.dtype == torch.int32 and kv_lens.device == q.device
            and kv_lens.numel() == B and kv_lens.is_contiguous()):
        kv_lens = _as_int32(kv_lens, B, q.device)
    try:
        plan = _k4_plan_cached(B, Hq, Hkv, hd, C, _cuda.sm_count(q.device.index))
    except ValueError as e:
        raise ValueError(f"decode_attention_q8: {e}") from None
    stream = _cuda.stream_ptr(q)
    ws, tickets = _k4_workspace(q.device, stream, plan.ws_floats, B * Hkv)
    out = torch.empty((B, Hq, 1, hd), dtype=q.dtype, device=q.device)
    err = _decode_fn(f32)(
        q.data_ptr(), q.stride(0), q.stride(1), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), kv_lens.data_ptr(),
        out.data_ptr(), out.stride(0), out.stride(1), ws.data_ptr(), ws.numel(),
        tickets.data_ptr(), tickets.numel(), int(layer), L, B, Hq, Hkv, C, hd,
        float(sm_scale), plan.splits, plan.pitch, plan.box, plan.stages, stream)
    _cuda.check_launch(err, "decode_attention_q8")
    LAUNCHES["decode_q8:f32" if f32 else "decode_q8"] += 1
    return out


# ---------------------------------------------------------------------------
# entries
# ---------------------------------------------------------------------------
def _flash_fwd(q, k, v, kv_lens, q_start, causal: bool, sm_scale: float,
               need_lse: bool, exact: bool = False):
    """(out, lse or None): the plain twin for CPU tensors, K1 on the card
    (`exact`: see `k1_route`)."""
    if q.device.type == "cpu":
        out, lse = _flash_fwd_plain(q, k, v, kv_lens, q_start, causal, sm_scale)
        return out, (lse if need_lse else None)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) \
        if need_lse else None
    mode = "causal" if causal else \
        ("flash_d256" if q.shape[-1] > 128 else "flash")
    attention_fwd_kernel(q, k, v, out, causal=causal, sm_scale=sm_scale,
                         mode=mode, kv_lens=kv_lens, q_start=q_start, lse=lse,
                         exact=exact)
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """Counterpart of `_flash_attention_custom` (attention.py:479-501): the
    forward saves q, k, v, out and the LSE rows; the backward launches K6
    on CUDA tensors (f32 operands: K6's f32 route) and runs its plain twin
    on CPU tensors. The integer inputs get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, q_start, causal, sm_scale, exact):
        out, lse = _flash_fwd(q, k, v, kv_lens, q_start, causal, sm_scale, True,
                              exact)
        ctx.save_for_backward(q, k, v, out, lse, kv_lens, q_start)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, kv_lens, q_start = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = _flash_bwd_plain(q, k, v, out, lse, dout, kv_lens,
                                          q_start, ctx.causal, ctx.sm_scale)
        else:
            dq, dk, dv = flash_bwd_kernel(q, k, v, out, lse, dout,
                                          causal=ctx.causal,
                                          sm_scale=ctx.sm_scale,
                                          kv_lens=kv_lens, q_start=q_start)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = False, kv_lens=None,
                    q_start=None, sm_scale: Optional[float] = None,
                    exact: bool = False):
    """Port of `flash_attention` (attention.py:504). q/k/v: [B,H,S,D].
    q_start: [B] absolute KV position of query 0 (defaults to
    kv_lens - Sq, the decode convention). Differentiable in q, k and v:
    when one of them asks for a gradient the call goes through
    `_FlashAttention` (K1 with the LSE output, K6 backward); otherwise K1
    runs alone, as in serving. exact: the caller is a model whose compute
    dtype is f32, whose f32 operands take K1's "simt_f32" route
    (`k1_route`)."""
    B, H, Sq, D = q.shape
    if sm_scale is None:
        sm_scale = D ** -0.5
    if kv_lens is None:
        kv_lens = torch.full((B,), k.shape[2], dtype=torch.int32,
                             device=q.device)
    if q_start is None:
        q_start = kv_lens - Sq
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, kv_lens, q_start, bool(causal),
                                     float(sm_scale), bool(exact))
    if q.device.type == "cpu":
        return _attention_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                                kv_lens=kv_lens, q_start=q_start)
    return _flash_fwd(q, k, v, kv_lens, q_start, bool(causal), float(sm_scale),
                      False, bool(exact))[0]


class _RecomputeAttention(torch.autograd.Function):
    """A kernel forward with the recompute backward that the JAX package
    gives its short-sequence kernels (the `custom_vjp`s of the BSHD
    entries, attention.py:868-872 and :889-897, of `_window_attention`,
    :588-599, and of `_smallwin_tpu`, :709-714): autograd through
    `plain(*tensors)` on the saved inputs. `launch` and `plain` take the
    same tensors."""

    @staticmethod
    def forward(ctx, launch, plain, *tensors):
        ctx.save_for_backward(*tensors)
        ctx.plain = plain
        return launch(*tensors)

    @staticmethod
    def backward(ctx, dout):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            grads = torch.autograd.grad(ctx.plain(*ins), ins, dout)
        return (None, None, *grads)


def _kernel_or_recompute(launch, plain, *tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _RecomputeAttention.apply(launch, plain, *tensors)
    return launch(*tensors)


def _bshd_fwd(q, k, v, sm_scale: float, win: int = 0, exact: bool = False):
    """K1 in BSHD mode: q/k/v [B,S,H,D] (views allowed) -> [B,S,H,D]. Under
    a gradient the backward is the recompute of `_bshd_bwd_rule` /
    `_packed_bwd_rule` (attention.py:868-872, :889-897)."""
    if q.device.type == "cpu":
        return _attention_plain_bshd(q, k, v, sm_scale, win)
    return _kernel_or_recompute(
        lambda q_, k_, v_: _bshd_launch(q_, k_, v_, sm_scale, win, exact),
        lambda q_, k_, v_: _attention_plain_bshd(q_, k_, v_, sm_scale, win),
        q, k, v)


def _bshd_launch(q, k, v, sm_scale: float, win: int = 0, exact: bool = False):
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    attention_fwd_kernel(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), out.transpose(1, 2),
                         causal=False, sm_scale=sm_scale, mode="bshd", win=win,
                         exact=exact)
    return out


def attention_bshd(q, k, v, *, sm_scale: Optional[float] = None,
                   exact: bool = False):
    """Full non-causal self-attention in [B,S,H,D] (port of
    attention_bshd, attention.py:985). Returns [B,S,H,D]. exact: see
    `k1_route`."""
    B, S, H, D = q.shape
    if sm_scale is None:
        sm_scale = D ** -0.5
    # attention.py:997
    if q.is_cuda and 128 <= S <= 1536 and D <= 128:
        return _bshd_fwd(q, k, v, float(sm_scale), exact=exact)
    return _attention_plain_bshd(q, k, v, sm_scale)


def attention_packed_qkv_padded(qkv, num_heads: int, head_dim: int, *,
                                win: int = 0,
                                sm_scale: Optional[float] = None,
                                exact: bool = False):
    """Port of attention_packed_qkv_padded (attention.py:968). The JAX
    entry takes heads pre-padded to 128 lanes, which is a TPU layout device.
    This port takes the UNPADDED fused qkv [B,S,3*H*hd] and returns
    [B,S,H*hd]. win > 0 = block-diagonal attention over win-token windows.
    exact: see `k1_route`."""
    B, S, _ = qkv.shape
    if sm_scale is None:
        sm_scale = head_dim ** -0.5
    x = qkv.view(B, S, 3, num_heads, head_dim)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    # attention.py:980
    if qkv.is_cuda and 128 <= S <= 1536:
        o = _bshd_fwd(q, k, v, float(sm_scale), win, exact)
    else:
        o = _attention_plain_bshd(q, k, v, sm_scale, win)
    return o.reshape(B, S, num_heads * head_dim)


def _window_attention(q, k, v, sm_scale: float, exact: bool = False):
    """Port of `_window_attention` (attention.py:580): medium non-causal
    self-attention [B,H,S,D] with a whole-row softmax. The plain twin for
    CPU tensors, K7 on the card (`exact`: see `window_attention_kernel`)."""
    if q.device.type == "cpu":
        return _window_attention_plain(q, k, v, sm_scale)
    return _kernel_or_recompute(
        lambda q_, k_, v_: window_attention_kernel(q_, k_, v_,
                                                   sm_scale=sm_scale,
                                                   exact=exact),
        lambda q_, k_, v_: _window_attention_plain(q_, k_, v_, sm_scale),
        q, k, v)


def attention_packed_qkv_smallwin(qkv, num_heads: int, head_dim: int, *,
                                  sm_scale: Optional[float] = None,
                                  exact: bool = False):
    """Port of attention_packed_qkv_smallwin (attention.py:717).
    Self-attention inside tiny fixed windows straight from a fused qkv
    projection: qkv [NW,S,3*H*hd], S tokens a window -> [NW,S,H*hd]. The
    plain twin for CPU tensors; on the card K8 (S in 16, 32, 64, any window
    count: nothing is packed) or it raises. exact: the caller is a model
    whose compute dtype is f32, whose f32 qkv takes K8's full-precision
    route (`smallwin_attention_kernel`)."""
    if sm_scale is None:
        sm_scale = head_dim ** -0.5
    sm_scale = float(sm_scale)
    if qkv.device.type == "cpu":
        return _smallwin_plain(qkv, num_heads, sm_scale)
    return _kernel_or_recompute(
        lambda x: smallwin_attention_kernel(x, num_heads, head_dim,
                                            sm_scale=sm_scale, exact=exact),
        lambda x: _smallwin_plain(x, num_heads, sm_scale), qkv)


def attention_bshd_cross(q, k, v, *, sm_scale: Optional[float] = None):
    """Cross-length BSHD attention (Sq != Sk) of the pooled-query Hiera
    blocks. JAX runs it on XLA (attention.py:1020-1028), so it stays plain."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _attention_plain_bshd(q, k, v, float(sm_scale))


def dot_product_attention(q, k, v, *, causal: bool = False, kv_lens=None,
                          kv_mask=None, bias=None, q_start=None,
                          sm_scale: Optional[float] = None,
                          k_scale=None, v_scale=None, layer=None,
                          exact: bool = False):
    """Attention entry used by every model stack (attention.py:1231).
    q/k/v: [B,H,S,D]; kv_mask: [B,Sk] bool, True = attendable.

    With k_scale/v_scale (the int8 KV cache) k and v arrive as int8,
    token-major and unrepeated: one layer's slab [B,C,Hkv*hd] or the stacked
    cache [L,B,C,Hkv*hd] with `layer` an int. Decode (Sq == 1) on a CUDA
    tensor launches K4 or raises; it never takes the plain twin. Sq == 1
    with causal and q_start == kv_len - 1 reduces to the kv_lens mask that
    K4 applies (f32 q: K4's f32 route). exact: the caller is a model whose
    compute dtype is f32; its f32 operands take the full-precision routes
    of K1 (`k1_route`) and K7 (`window_attention_kernel`), and nothing is
    staged to bf16."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together (the int8 KV cache)")
    if k_scale is not None:
        if k.dim() == 4 and layer is None:
            raise ValueError("a stacked int8 cache [L,B,C,Hkv*hd] needs `layer`")
        if q.is_cuda and q.shape[2] == 1:
            if bias is not None or kv_mask is not None or kv_lens is None:
                raise ValueError("int8-cache decode attention on the card "
                                 "takes kv_lens and no bias or kv_mask")
            return decode_attention_q8(q, k, v, k_scale, v_scale, kv_lens,
                                       layer, sm_scale=float(sm_scale))
        # CPU tensors, and Sq > 1, which the JAX package leaves to XLA
        # (attention.py:1276)
        return _decode_attention_q8_plain(
            q, k, v, k_scale, v_scale, sm_scale=sm_scale, kv_lens=kv_lens,
            layer=layer, causal=causal, bias=bias, kv_mask=kv_mask,
            q_start=q_start)
    # attention.py:1295: biased / per-token-masked attention and non-device
    # tensors stay plain
    if bias is not None or kv_mask is not None or not q.is_cuda:
        return _attention_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                                kv_lens=kv_lens, bias=bias, kv_mask=kv_mask,
                                q_start=q_start)
    Sq, Sk = q.shape[2], k.shape[2]
    # attention.py:1308-1310: medium non-causal self-attention takes the
    # whole-row-softmax kernel (K7)
    if (not causal and kv_lens is None and q_start is None and Sq == Sk
            and 512 < Sq <= 1536):
        return _window_attention(q, k, v, float(sm_scale), exact)
    # attention.py:1315: short and windowed shapes stay plain
    long_enough = Sq >= 1024 and Sk >= 1024 and (causal or Sq >= 2048)
    if not long_enough:
        return _attention_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                                kv_lens=kv_lens, q_start=q_start)
    return flash_attention(q, k, v, causal=causal, kv_lens=kv_lens,
                           q_start=q_start, sm_scale=sm_scale, exact=exact)
