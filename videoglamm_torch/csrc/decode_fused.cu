// K9: the fused int8 decode-layer programs for at most 8 rows, for Hopper
// (sm_90a). Four entry points over weights in nn.Linear orientation ([N, K]
// int8 rows with one f32 scale per output channel), one per Pallas body of
// scripts/decode_mlp_experiment.py:
//
//   norm_matmul      y = bf16( (bf16(rmsnorm(x) * nw) . w[n]) * s[n] )
//                    replaces `_nm_kernel` (:282, launched at :304)
//   matmul_residual  y = bf16( (x . w[n]) * s[n] + res )
//                    replaces `_mr_kernel` (:349, launched at :366)
//   mlp              xn = bf16(rmsnorm(x) * nw); g, u = bf16((xn . wg) * sg),
//                    bf16((xn . wu) * su); h = bf16(g * sigmoid(g) * u);
//                    y = bf16( (h . wd[d]) * sd[d] + x )
//                    replaces `_mlp_kernel` (:80, launched at :123)
//   mlp_w8a8         xq, xs = quant_rows(rmsnorm(x) * nw) in f32, no rounding;
//                    g, u = f32(s32(xq . wg)) * (xs * sg), ...; h = g *
//                    sigmoid(g) * u; per row and per `group` columns of I:
//                    hq, hs = quant_rows(h[group]); acc += f32(s32(hq . wd)) *
//                    hs, groups in ascending order; y = bf16(acc * sd + x)
//                    replaces `_mlp_w8a8_kernel` (:160, launched at :212)
//
// quant_rows is `_quant_rows_f32` (:152): s = max(amax, 1e-6) * (1/127),
// q = clip(round_half_even(v / s), -127, 127). The group width of mlp_w8a8 is
// arithmetic, not tuning: the Pallas body quantises h over one 1024-wide
// I-block, so `group` = 1024 computes its function.
//
// What bounds them on the H100: bytes. Every weight byte is read once and
// used for at most 8 rows, so the least time is the weights' size over the
// memory rate. The design is K5's (dequant_gemv.cu) with a prologue and an
// epilogue of its own, and for the MLP entries two phases around one grid
// barrier:
//
// - One CTA an SM, each a contiguous range of whole output rows, balanced
//   to within one row (`k9_plan` in experiments/decode_mlp.py computes the
//   ranges and the shared-memory layout and hands them in).
// - A producer warp streams the CTA's weight rows into a ring of shared-
//   memory stages with 1-D bulk copies that complete on mbarriers: a stage
//   is 16 rows x one segment of 1 or 2 KB of each row. Its first stages
//   go out before the consumers have staged x and computed the norm (every
//   CTA recomputes the RMS norm of the few rows from L2).
// - 16 consumer warps. x (or h) sits in shared memory once a CTA, in the k
//   order that the conversions give, so it is not re-read for every code.
//   No I2F anywhere: int8 codes become f32 by the magic number (1 to 3 rows,
//   CUDA cores, one warp a stage row) or bf16 pairs feeding mma.sync
//   m16n8k16 (from 4 rows: 16 weight rows as A, 8 rows of x as B, f32
//   accumulators, the warps on alternate 16-byte chunks, added in order at
//   the end of a row group). The W8A8 products are s8 x s8 -> s32: __dp4a
//   on 1 to 3 rows, mma.sync m16n8k32 from 4, where the warps' partials of a
//   group of I meet by shared-memory integer adds (exact in any order), so
//   that only a row group's end waits for all warps. Integer sums become f32 by a
//   split into two exactly converted halves; quantisation rounds by the
//   magic number. All integer divisions by runtime values are gone too.
// - The MLP entries: phase 1 computes h with gate row i and up row I + i in
//   one stage (rows 0-7 and 8-15, so that an mma lane holds g and u of the
//   same column); then ONE grid barrier (cooperative launch); phase 2 is
//   the down product with the residual. The producer issues the first ring
//   stages of the CTA's W_down rows before it joins the barrier: the weight
//   stream does not stop there. mlp_w8a8 writes each CTA's partial maximum
//   per (row, group) into a slot buffer [CTAs, M, groups]; after the barrier
//   each CTA takes the maximum over the slots of the CTAs that cover a group
//   (exact, so the codes are those of one global maximum) and quantises h as
//   it stages it. No atomics, no zeroing.
// - Programmatic dependent launch on all four entries, as in K5: weights
//   load at once, griddepcontrol.wait only before x (and res) are read.
// - Deterministic: every output is summed in a fixed order, the maxima are
//   exact; two calls are bit-equal. The f32 epilogues are unfused multiplies
//   and adds in the twins' order.
//
// Buffers (h, the slots) come from the caller, the launch goes to the
// caller's stream, and nothing synchronises: each entry captures into a
// CUDA graph.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

#include "sm90_common.cuh"
#include "mma_common.cuh"

constexpr int CONS_WARPS = 16;         // consumer warps
constexpr int NCONS = CONS_WARPS * 32;
constexpr int NTHREADS = NCONS + 32;   // and one producer warp
constexpr int GROUP_ROWS = 16;         // weight rows of a ring stage
constexpr int KSEG = 2048;             // bytes of a row a stage holds, at most
constexpr int MAX_STAGES = 8;
constexpr int MIN_STAGES = 3;          // the plan's least ring (k9_plan)
constexpr int GOOD_STAGES = 4;         // k9_plan: 2 KB segments from this ring on
constexpr int BARRIER_BYTES = 128;     // full / empty mbarriers at offset 0
constexpr int MMA_TILE = 8;            // rows of x an mma takes (B columns)
constexpr int ROWS_MAX_M = 3;          // CUDA cores up to 3 rows, mma from 4
constexpr int SMEM_MAX = 231424;       // dynamic shared memory a block can use,
                                       // 1 KB left for the static arrays
constexpr int CONS_BAR = 1;            // named barrier of the consumer warps

enum Kind { NORM_MM = 0, MAT_RES = 1, MLP = 2, W8A8 = 3 };

// the plan's fields, in the order of `k9_plan(...).fields()`
struct Plan {
  int ctas, mt;
  int kseg1, nseg1;          // phase 1: segment bytes, segments a row (K)
  int kseg2, nseg2;          // phase 2 (MLP entries): the same along I
  int segs_pass, segs_group; // phase-2 segments a staging of h, a W8A8 group
  int stages, rstride;       // ring: slots of 16 rows rstride bytes apart
  int xstride, acols;        // staged activation rows: bytes apart, columns
  int x_off, sc_off, red_off, loc_off, ring_off, smem;
  int base1, extra1;         // phase-1 rows = ctas * base1 + extra1
  int base2, extra2;         // phase-2 rows
  int groups, gdiv_mul;      // W8A8 groups along I, ceil(2^32 / group)
};
constexpr int PLAN_FIELDS = 24;
static_assert(sizeof(Plan) == PLAN_FIELDS * sizeof(int), "Plan is PLAN_FIELDS ints");

struct Args {
  const __nv_bfloat16* x; long long ldx;
  const float* nw;
  const int8_t* w1; const float* s1;     // phase 1: w (N rows) or wgu (2I)
  const int8_t* w2; const float* s2;     // phase 2: wd (D rows)
  const __nv_bfloat16* res; long long ldr;
  __nv_bfloat16* out; long long ldo;
  void* h;                               // [M, I] bf16 (mlp) / f32 (w8a8)
  float* slots;                          // [ctas, M, groups] (w8a8)
  int M, N, K, I, D, group;
  float eps, kf;                         // kf = K as a float
  int8_t* dbg_xq; float* dbg_xs; int* dbg_gu; int* dbg_down;
  int8_t* dbg_hq; float* dbg_hs;
};

// ---------------------------------------------------------------------------
// arithmetic
// ---------------------------------------------------------------------------
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float sigmoidf(float v) {
  return 1.0f / (1.0f + expf(-v));
}
__device__ __forceinline__ int warp_isum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
// f32(s) for any s32, correctly rounded, without I2F: the high and the low
// 16 bits convert exactly by magic numbers, and one FADD rounds their sum
__device__ __forceinline__ float s32_to_f32(int s) {
  const float hi = __int_as_float(0x4B400000 + (s >> 16)) - 12582912.0f;
  const float lo = __int_as_float(0x4B000000 | (s & 0xFFFF)) - 8388608.0f;
  return __fadd_rn(hi * 65536.0f, lo);
}
__device__ __forceinline__ float quant_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-6f), 1.0f / 127.0f);
}
// clip(round_half_even(v / s), -127, 127), v / s correctly rounded as the
// twin divides. v * (1 / s) is within two ulps of it, so it rounds alike
// unless it lies near a half; only there the exact quotient is taken. The
// FADD of 1.5 * 2^23 rounds to an integer, ties to even (no F2I): its low
// byte is the code, and the word holds 0x4B400000 + code.
__device__ __forceinline__ uint32_t quant_word(float v, float s, float rs) {
  float t = __fmul_rn(v, rs);
  const float r = __fadd_rn(t, 12582912.0f);
  if (fabsf(fabsf(__fsub_rn(t, __fsub_rn(r, 12582912.0f))) - 0.5f) < 1e-4f)
    t = __fdiv_rn(v, s);
  t = fminf(fmaxf(t, -127.f), 127.f);
  return __float_as_uint(__fadd_rn(t, 12582912.0f));
}

__device__ __forceinline__ void mma_s8_k32(int* c, uint32_t a0, uint32_t a1,
                                           uint32_t a2, uint32_t a3,
                                           uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_s8_k16(int* c, uint32_t a0, uint32_t a1,
                                           uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// ---------------------------------------------------------------------------
// activation layouts in shared memory (rows xstride bytes apart)
// ---------------------------------------------------------------------------
// Store 8 consecutive values of one row, columns k .. k+7 (k % 8 == 0).
// bf16 kinds, CUDA cores: f32, K5's permutation (each block of 32 chunks of
// 16 k laid out so that the lanes' 16-byte loads of one quarter-chunk are
// consecutive). bf16 kinds, mma: bf16, each 4 k in the order (0,2,1,3) the
// int8 -> bf16 pairs give. W8A8: int8 codes in order.
template <bool MMA>
__device__ __forceinline__ void put8_bf16(unsigned char* row, int k,
                                          const float (&v)[8]) {
  if (!MMA) {
    float* xr = reinterpret_cast<float*>(row);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = k + 4 * h, ca = kk >> 4, q = (kk & 15) >> 2;
      *reinterpret_cast<float4*>(xr + (ca >> 5) * 512 + 128 * q + 4 * (ca & 31)) =
          make_float4(round_bf16(v[4 * h]), round_bf16(v[4 * h + 1]),
                      round_bf16(v[4 * h + 2]), round_bf16(v[4 * h + 3]));
    }
  } else {
    uint4 o;
    o.x = pack_bf16(v[0], v[2]); o.y = pack_bf16(v[1], v[3]);
    o.z = pack_bf16(v[4], v[6]); o.w = pack_bf16(v[5], v[7]);
    *reinterpret_cast<uint4*>(row + 2 * k) = o;
  }
}
// the codes of 8 values (their quant_words' low bytes) as 8 bytes
__device__ __forceinline__ uint2 quant8(const float (&v)[8], float s, float rs) {
  uint32_t q[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) q[e] = quant_word(v[e], s, rs);
  return make_uint2(__byte_perm(__byte_perm(q[0], q[1], 0x0040), __byte_perm(q[2], q[3], 0x0040), 0x5410),
                    __byte_perm(__byte_perm(q[4], q[5], 0x0040), __byte_perm(q[6], q[7], 0x0040), 0x5410));
}
__device__ __forceinline__ void unpack8_bf16(uint4 u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) { v[2 * i] = bf16_lo(w[i]); v[2 * i + 1] = bf16_hi(w[i]); }
}


// ---------------------------------------------------------------------------
// the consumers' work on one ring stage
// ---------------------------------------------------------------------------
// CUDA cores, bf16 kinds: warp w owns stage row w (wrow); lanes take its
// 16-byte chunks; x in f32 in K5's permuted layout, rows xrowf floats apart;
// acol: the staged column of the segment's first byte.
template <int MT>
__device__ __forceinline__ void rows_bf16(const unsigned char* wrow, const float* x,
                                          int xrowf, int acol, int len, int lane,
                                          float (&acc)[MT]) {
  for (int c = lane; c < (len >> 4); c += 32) {
    const uint4 q = lds128(wrow + 16 * c);
    float f[4][4];
    int8_to_f32(q.x, f[0]);
    int8_to_f32(q.y, f[1]);
    int8_to_f32(q.z, f[2]);
    int8_to_f32(q.w, f[3]);
    const int ca = (acol >> 4) + c;
    const float* xc = x + (ca >> 5) * 512 + 4 * (ca & 31);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      float t4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 xv = *reinterpret_cast<const float4*>(xc + mi * xrowf + 128 * e);
        t4[e] = xv.x * f[e][0];
        t4[e] = fmaf(xv.y, f[e][1], t4[e]);
        t4[e] = fmaf(xv.z, f[e][2], t4[e]);
        t4[e] = fmaf(xv.w, f[e][3], t4[e]);
      }
      acc[mi] += (t4[0] + t4[1]) + (t4[2] + t4[3]);
    }
  }
}

// CUDA cores, W8A8: the same walk, s8 x s8 -> s32 by __dp4a; x codes in order
template <int MT>
__device__ __forceinline__ void rows_s8(const unsigned char* wrow,
                                        const unsigned char* x, int xstride,
                                        int acol, int len, int lane,
                                        int (&acc)[MT]) {
  for (int c = lane; c < (len >> 4); c += 32) {
    const uint4 q = lds128(wrow + 16 * c);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const uint4 xq = lds128(x + mi * xstride + acol + 16 * c);
      int s = acc[mi];
      s = __dp4a(static_cast<int>(q.x), static_cast<int>(xq.x), s);
      s = __dp4a(static_cast<int>(q.y), static_cast<int>(xq.y), s);
      s = __dp4a(static_cast<int>(q.z), static_cast<int>(xq.z), s);
      s = __dp4a(static_cast<int>(q.w), static_cast<int>(xq.w), s);
      acc[mi] = s;
    }
  }
}

// Tensor cores, bf16 kinds (K5's gemv_mma_kernel): D[16 rows][8 x rows] +=
// A (weights) . B (x); warp w takes chunks w, w + 16, ... of the stage; lane
// (g, t) word t of rows g and g + 8. wg = stage + g * rstride + 4t; xg = x +
// g * xstride (bf16, each 4 k as (0,2,1,3)); only the M rows of x are
// staged, and B's columns past them (live false) are zeros.
__device__ __forceinline__ void mma_bf16_stage(const unsigned char* wg, int rstride,
                                               const unsigned char* xg, bool live,
                                               int acol, int len, int warp, int t,
                                               float (&acc)[4]) {
  const unsigned char* wg8 = wg + 8 * rstride;
#pragma unroll 4
  for (int c = warp; c < (len >> 4); c += CONS_WARPS) {
    const uint32_t qa = lds32(wg + 16 * c), qb = lds32(wg8 + 16 * c);
    const uint2 b = live ? lds64(xg + 2 * (acol + 16 * c + 4 * t)) : make_uint2(0, 0);
    uint32_t a4[4];
    int8_to_bf16x2(qa, a4[0], a4[2]);
    int8_to_bf16x2(qb, a4[1], a4[3]);
    mma_bf16(acc, a4, b.x, b.y);
  }
}

// Tensor cores, W8A8: s8 m16n8k32 on 32-byte chunks (a last 16-byte one by
// m16n8k16); lane (g, t) bytes 4t.. and 16 + 4t.. of rows g and g + 8, and
// of x row g (codes in order). wg and xg as above, xg + 4t folded in.
__device__ __forceinline__ void mma_s8_stage(const unsigned char* wg, int rstride,
                                             const unsigned char* xg, bool live,
                                             int acol, int len, int warp,
                                             int (&acc)[4]) {
  const unsigned char* wg8 = wg + 8 * rstride;
#pragma unroll 2
  for (int c = warp; 32 * c < len; c += CONS_WARPS) {
    const int o = 32 * c;
    const uint32_t a0 = lds32(wg + o), a1 = lds32(wg8 + o);
    const uint32_t b0 = live ? lds32(xg + acol + o) : 0u;
    if (o + 32 <= len)
      mma_s8_k32(acc, a0, a1, lds32(wg + o + 16), lds32(wg8 + o + 16), b0,
                 live ? lds32(xg + acol + o + 16) : 0u);
    else
      mma_s8_k16(acc, a0, a1, b0);
  }
}

// ---------------------------------------------------------------------------
// the kernel: one template for the four entries and the two routes
// ---------------------------------------------------------------------------
template <int MT, int KIND>
__global__ void __launch_bounds__(NTHREADS, 1)
k9_kernel(const Args a, const Plan p) {
  constexpr bool MMA = MT == MMA_TILE;
  constexpr bool W8 = KIND == W8A8;
  constexpr bool TWO = KIND == MLP || KIND == W8A8;   // two phases, one barrier
  constexpr bool NORM = KIND != MAT_RES;
  constexpr int GR1 = TWO ? GROUP_ROWS / 2 : GROUP_ROWS;   // phase-1 rows a stage
  constexpr int MS = MMA ? MMA_TILE : MT;                  // rows of x, at most
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float nred[MMA_TILE][CONS_WARPS];
  __shared__ float rrms[MMA_TILE];       // 1 / rms of each row of x
  __shared__ float xsc[MMA_TILE];        // W8A8: each row's scale
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bx = blockIdx.x;
  const int M = a.M, K = a.K, I = a.I, G = p.groups;
  const int r1 = bx * p.base1 + min(bx, p.extra1);
  const int n1 = p.base1 + (bx < p.extra1 ? 1 : 0);
  const int r2 = TWO ? bx * p.base2 + min(bx, p.extra2) : 0;
  const int n2 = TWO ? p.base2 + (bx < p.extra2 ? 1 : 0) : 0;
  const int ng1 = (n1 + GR1 - 1) / GR1, ng2 = (n2 + GROUP_ROWS - 1) / GROUP_ROWS;
  const int rmax1 = p.base1 + (p.extra1 ? 1 : 0);
  const int rmax2 = p.base2 + (p.extra2 ? 1 : 0);
  const int S = p.stages;
  const int stage_bytes = GROUP_ROWS * p.rstride;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  unsigned char* ring = smem + p.ring_off;
  unsigned char* xs = smem + p.x_off;
  // the CTA's scales (phase-1 rows, their up rows, phase-2 rows) and the
  // residual of its outputs, in f32
  float* sc1 = reinterpret_cast<float*>(smem + p.sc_off);
  float* sc1u = sc1 + rmax1;
  float* sc2 = sc1u + rmax1;
  float* resid = sc2 + rmax2;
  const int rres = TWO ? rmax2 : rmax1;
  float* red = reinterpret_cast<float*>(smem + p.red_off);
  float* hloc = reinterpret_cast<float*>(smem + p.loc_off);   // W8A8 [rmax1][8]
  float* hsc = hloc + rmax1 * MMA_TILE;                        // W8A8 [8][groups]

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONS_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  allow_next_grid();

  // ---------------------------------------------------------------- producer
  if (warp == CONS_WARPS) {
    int slot = 0, lap = 0;
    // one stage: `rows` rows of `len` bytes, this lane's from src
    auto put = [&](const int8_t* src, int rows, int len) {
      if (lap > 0) mbar_wait(&empty[slot], (lap - 1) & 1);
      if (lane == 0) mbar_expect_tx(&full[slot], static_cast<uint32_t>(rows * len));
      __syncwarp();
      if (src != nullptr)
        bulk_load_1d(ring + slot * stage_bytes + lane * p.rstride, src,
                     static_cast<uint32_t>(len), &full[slot]);
      if (++slot == S) slot = 0, ++lap;
    };
    for (int grp = 0; grp < ng1; ++grp) {
      // two phases: stage rows 0-7 are gate rows, 8-15 the up rows of the
      // same columns of I
      const int j = grp * GR1 + (TWO ? (lane & 7) : lane);
      const bool live = lane < GROUP_ROWS && j < n1;
      const int left = min(GR1, n1 - grp * GR1);
      const long long row = (TWO && lane >= GR1 ? I : 0) + r1 + j;
      for (int seg = 0; seg < p.nseg1; ++seg) {
        const int off = seg * p.kseg1, len = min(p.kseg1, K - off);
        put(live ? a.w1 + row * K + off : nullptr, TWO ? 2 * left : left, len);
      }
    }
    if constexpr (TWO) {
      // the first S stages of W_down before the barrier (each waits only for
      // a phase-1 stage to be consumed), the rest after it
      int issued = 0;
      bool synced = false;
      for (int grp = 0; grp < ng2; ++grp) {
        const int j = grp * GROUP_ROWS + lane;
        const bool live = lane < GROUP_ROWS && j < n2;
        const int left = min(GROUP_ROWS, n2 - grp * GROUP_ROWS);
        for (int seg = 0; seg < p.nseg2; ++seg, ++issued) {
          if (issued == S && !synced) { cg::this_grid().sync(); synced = true; }
          const int off = seg * p.kseg2, len = min(p.kseg2, I - off);
          put(live ? a.w2 + static_cast<long long>(r2 + j) * I + off : nullptr,
              left, len);
        }
      }
      if (!synced) cg::this_grid().sync();
    }
    return;
  }

  // --------------------------------------------------------------- consumers
  const int tid = threadIdx.x;
  const int g = lane >> 2, t = lane & 3;       // mma fragment coordinates
  // the CTA's scales are weights: read before the prior grid has finished
  for (int i = tid; i < n1; i += NCONS) {
    sc1[i] = a.s1[r1 + i];
    if (TWO) sc1u[i] = a.s1[I + r1 + i];
  }
  for (int i = tid; i < n2; i += NCONS) sc2[i] = a.s2[r2 + i];
  wait_prior_grid();
  // the residual of the CTA's outputs: res, or under the MLP x itself
  if (KIND != NORM_MM) {
    const int nr = TWO ? n2 : n1;
    for (int m = 0; m < M; ++m)
      for (int i = tid; i < nr; i += NCONS)
        resid[m * rres + i] =
            TWO ? __bfloat162float(a.x[m * a.ldx + r2 + i])
                : __bfloat162float(a.res[m * a.ldr + r1 + i]);
  }

  // ---- x: 1 / rms of each row, (W8A8) its scale, then the staged rows
  if (NORM) {
    float ss[MS];
#pragma unroll
    for (int m = 0; m < MS; ++m) ss[m] = 0.f;
    for (int c = tid; c < K / 8; c += NCONS) {
      // the norm weight into L1 now: the staging pass below reads it
      asm volatile("prefetch.global.L1 [%0];" :: "l"(a.nw + 8 * c));
#pragma unroll
      for (int m = 0; m < MS; ++m) {
        if (m < M) {
          float v[8];
          unpack8_bf16(*reinterpret_cast<const uint4*>(a.x + m * a.ldx + 8 * c), v);
#pragma unroll
          for (int e = 0; e < 8; ++e) ss[m] = fmaf(v[e], v[e], ss[m]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MS; ++m) {
      const float s = warp_sum(ss[m]);
      if (lane == 0) nred[m][warp] = s;
    }
    named_bar_sync(CONS_BAR, NCONS);
    if (tid < MS) {
      float s = 0.f;
      for (int w = 0; w < CONS_WARPS; ++w) s += nred[tid][w];
      rrms[tid] = rsqrtf(__fdiv_rn(s, a.kf) + a.eps);   // `_rmsnorm_block` (:71)
    }
    named_bar_sync(CONS_BAR, NCONS);
  }
  // x[m, k .. k+7], normalised in f32 where the entry has a norm
  auto xrow8 = [&](int m, int k, float (&v)[8]) {
    unpack8_bf16(*reinterpret_cast<const uint4*>(a.x + m * a.ldx + k), v);
    if (NORM) {
      const float4 w0 = *reinterpret_cast<const float4*>(a.nw + k);
      const float4 w1 = *reinterpret_cast<const float4*>(a.nw + k + 4);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const float r = rrms[m];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __fmul_rn(__fmul_rn(v[e], r), wv[e]);
    }
  };
  if (W8) {
    float mx[MS];
#pragma unroll
    for (int m = 0; m < MS; ++m) mx[m] = 0.f;
    for (int c = tid; c < K / 8; c += NCONS) {
#pragma unroll
      for (int m = 0; m < MS; ++m) {
        if (m < M) {
          float v[8];
          xrow8(m, 8 * c, v);
#pragma unroll
          for (int e = 0; e < 8; ++e) mx[m] = fmaxf(mx[m], fabsf(v[e]));
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MS; ++m) {
      const float s = warp_max(mx[m]);
      if (lane == 0) nred[m][warp] = s;
    }
    named_bar_sync(CONS_BAR, NCONS);
    if (tid < MS) {
      float s = 0.f;
      for (int w = 0; w < CONS_WARPS; ++w) s = fmaxf(s, nred[tid][w]);
      xsc[tid] = quant_scale(s);
      if (a.dbg_xs != nullptr && bx == 0 && tid < M) a.dbg_xs[tid] = xsc[tid];
    }
    named_bar_sync(CONS_BAR, NCONS);
  }
  for (int m = 0; m < M; ++m) {           // the rows of x, staged
    unsigned char* row = xs + m * p.xstride;
    for (int c = tid; c < K / 8; c += NCONS) {
      float v[8];
      xrow8(m, 8 * c, v);
      if constexpr (W8) {
        const float s = xsc[m];
        const uint2 o = quant8(v, s, 1.0f / s);
        *reinterpret_cast<uint2*>(row + 8 * c) = o;
        if (a.dbg_xq != nullptr && bx == 0)
          *reinterpret_cast<uint2*>(a.dbg_xq + static_cast<long long>(m) * K + 8 * c) = o;
      } else {
        put8_bf16<MMA>(row, 8 * c, v);
      }
    }
  }
  named_bar_sync(CONS_BAR, NCONS);

  int slot = 0, lap = 0, done = 0;      // the ring, as the producer walks it
  const float* xf = reinterpret_cast<const float*>(xs);
  const int xrowf = p.xstride >> 2;
  const unsigned char* xg = xs + g * p.xstride + (W8 ? 4 * t : 0);
  const bool xlive = g < M;              // mma: this lane's column of B is a row of x
  // the sums of a row group meet through `red`, two buffers: the warps'
  // 16 x 8 tiles (mma route) or a sum a (stage row, row of x) (CUDA cores)
  auto red_buf = [&]() {
    return red + (done & 1) * (MMA ? CONS_WARPS * 128 : GROUP_ROWS * MMA_TILE);
  };
  auto red_idx = [](int row, int col) {
    // D[row][col]: lane 4 (row % 8) + col / 2, register 2 (row / 8) + col % 2
    return ((row & 7) * 4 + (col >> 1)) * 4 + (row >> 3) * 2 + (col & 1);
  };

  // ================================================================ phase 1
  for (int grp = 0; grp < ng1; ++grp) {
    float acc[MMA ? 4 : MT];
    int iacc[MMA ? 4 : MT];
#pragma unroll
    for (int i = 0; i < (MMA ? 4 : MT); ++i) acc[i] = 0.f, iacc[i] = 0;
    for (int seg = 0; seg < p.nseg1; ++seg) {
      const int off = seg * p.kseg1, len = min(p.kseg1, K - off);
      mbar_wait(&full[slot], lap & 1);
      const unsigned char* wst = ring + slot * stage_bytes;
      if constexpr (MMA) {
        if constexpr (W8)
          mma_s8_stage(wst + g * p.rstride + 4 * t, p.rstride, xg, xlive, off, len, warp, iacc);
        else
          mma_bf16_stage(wst + g * p.rstride + 4 * t, p.rstride, xg, xlive, off, len, warp, t, acc);
      } else {
        if constexpr (W8)
          rows_s8<MT>(wst + warp * p.rstride, xs, p.xstride, off, len, lane, iacc);
        else
          rows_bf16<MT>(wst + warp * p.rstride, xf, xrowf, off, len, lane, acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      if (++slot == S) slot = 0, ++lap;
    }
    // the row group's sums: f32 (or s32) per (stage row, row of x)
    float* rb = red_buf();
    int* rbi = reinterpret_cast<int*>(rb);
    if constexpr (MMA) {
      if constexpr (W8)
        *reinterpret_cast<int4*>(rbi + warp * 128 + lane * 4) =
            make_int4(iacc[0], iacc[1], iacc[2], iacc[3]);
      else
        *reinterpret_cast<float4*>(rb + warp * 128 + lane * 4) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      // warp w's stage row w: its sums over the lanes, into rb[w][m]
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        if constexpr (W8) {
          const int s = warp_isum(iacc[mi]);
          if (lane == 0) rbi[warp * MMA_TILE + mi] = s;
        } else {
          const float s = warp_sum(acc[mi]);
          if (lane == 0) rb[warp * MMA_TILE + mi] = s;
        }
      }
    }
    named_bar_sync(CONS_BAR, NCONS);
    // (row, col) of this thread's output in the group, and its sum(s)
    auto total = [&](int row, int col) -> float {
      if constexpr (MMA) {
        float v = 0.f;
        for (int w = 0; w < CONS_WARPS; ++w) v += rb[w * 128 + red_idx(row, col)];
        return v;
      } else {
        return rb[row * MMA_TILE + col];
      }
    };
    auto itotal = [&](int row, int col) -> int {
      if constexpr (MMA) {
        int v = 0;
        for (int w = 0; w < CONS_WARPS; ++w) v += rbi[w * 128 + red_idx(row, col)];
        return v;
      } else {
        return rbi[row * MMA_TILE + col];
      }
    };
    if constexpr (!TWO) {
      if (tid < GROUP_ROWS * MMA_TILE) {
        const int row = tid >> 3, col = tid & 7, lrow = grp * GROUP_ROWS + row;
        if (lrow < n1 && col < M) {
          const float y = __fmul_rn(total(row, col), sc1[lrow]);
          a.out[col * a.ldo + r1 + lrow] = __float2bfloat16(
              KIND == MAT_RES ? __fadd_rn(y, resid[col * rres + lrow]) : y);
        }
      }
    } else {
      if (tid < GR1 * MMA_TILE) {
        const int r = tid >> 3, col = tid & 7, j = grp * GR1 + r;
        if (j < n1 && col < M) {
          const long long hi = static_cast<long long>(col) * I + r1 + j;
          if constexpr (W8) {
            const int gi = itotal(r, col), ui = itotal(r + GR1, col);
            const float gv = __fmul_rn(s32_to_f32(gi), __fmul_rn(xsc[col], sc1[j]));
            const float uv = __fmul_rn(s32_to_f32(ui), __fmul_rn(xsc[col], sc1u[j]));
            const float hv = __fmul_rn(__fmul_rn(gv, sigmoidf(gv)), uv);
            static_cast<float*>(a.h)[hi] = hv;
            hloc[j * MMA_TILE + col] = hv;
            if (a.dbg_gu != nullptr) {
              a.dbg_gu[static_cast<long long>(col) * 2 * I + r1 + j] = gi;
              a.dbg_gu[static_cast<long long>(col) * 2 * I + I + r1 + j] = ui;
            }
          } else {
            // the projections land in bf16 before the GLU (:96-100)
            const float gv = round_bf16(__fmul_rn(total(r, col), sc1[j]));
            const float uv = round_bf16(__fmul_rn(total(r + GR1, col), sc1u[j]));
            static_cast<__nv_bfloat16*>(a.h)[hi] =
                __float2bfloat16(__fmul_rn(__fmul_rn(gv, sigmoidf(gv)), uv));
          }
        }
      }
    }
    ++done;
  }
  if constexpr (!TWO) return;

  // ===================================================== the grid barrier
  if constexpr (W8) {
    // this CTA's largest |h| per (row, group) it covers, into its slots
    named_bar_sync(CONS_BAR, NCONS);
    if (n1 > 0) {
      const int glo = fast_div(r1, a.group, p.gdiv_mul);
      const int ghi = fast_div(r1 + n1 - 1, a.group, p.gdiv_mul);
      for (int m = 0; m < M; ++m)
        for (int gq = glo + warp; gq <= ghi; gq += CONS_WARPS) {
          const int lo = max(r1, gq * a.group) - r1;
          const int hi = min(r1 + n1, (gq + 1) * a.group) - r1;
          float mx = 0.f;
          for (int j = lo + lane; j < hi; j += 32)
            mx = fmaxf(mx, fabsf(hloc[j * MMA_TILE + m]));
          mx = warp_max(mx);
          if (lane == 0) a.slots[(static_cast<long long>(bx) * M + m) * G + gq] = mx;
        }
    }
  }
  cg::this_grid().sync();
  // W8A8, tensor cores: the per-group s32 tiles of phase 2 (below), two row
  // groups' worth, zeroed before first use (phase 1 used the region)
  int* gtile = reinterpret_cast<int*>(red);
  if constexpr (W8 && MMA)
    for (int i = tid; i < 2 * G * 128; i += NCONS) gtile[i] = 0;
  if constexpr (W8) {
    // each group's scale: the maximum over the slots of the CTAs covering
    // it; 8 threads a (row, group), 64 pairs at once, the loads in flight
    // together, then a butterfly over the 8
    const int m = (tid >> 3) & (MMA_TILE - 1), sub = tid & 7;
    for (int gq = tid >> 6; gq < G; gq += NCONS / 64) {
      float mx = 0.f;
      if (m < M) {
#pragma unroll 4
        for (int c = sub; c < p.ctas; c += 8) {
          const int cr = c * p.base1 + min(c, p.extra1);
          const int cn = p.base1 + (c < p.extra1 ? 1 : 0);
          const bool covers = cn > 0 && cr < (gq + 1) * a.group && cr + cn > gq * a.group;
          const float v = covers ? __ldcg(a.slots + (static_cast<long long>(c) * M + m) * G + gq)
                                 : 0.f;
          mx = fmaxf(mx, v);
        }
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (m < M && sub == 0) {
        hsc[m * G + gq] = quant_scale(mx);
        if (a.dbg_hs != nullptr && bx == 0) a.dbg_hs[m * G + gq] = quant_scale(mx);
      }
    }
    named_bar_sync(CONS_BAR, NCONS);
  }

  // ================================================================ phase 2
  // h columns [c0, c0 + ncols) into the activation rows (W8A8: quantised)
  auto stage_h = [&](int c0, int ncols) {
    for (int m = 0; m < M; ++m) {
      unsigned char* row = xs + m * p.xstride;
      for (int c = tid; c < ncols / 8; c += NCONS) {
        const int k = c0 + 8 * c;
        const long long src = static_cast<long long>(m) * I + k;
        if constexpr (W8) {
          const float4 h0 = __ldcg(reinterpret_cast<const float4*>(
              static_cast<const float*>(a.h) + src));
          const float4 h1 = __ldcg(reinterpret_cast<const float4*>(
              static_cast<const float*>(a.h) + src + 4));
          const float v[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
          const float s = hsc[m * G + fast_div(k, a.group, p.gdiv_mul)];
          const uint2 o = quant8(v, s, 1.0f / s);
          *reinterpret_cast<uint2*>(row + 8 * c) = o;
          if (a.dbg_hq != nullptr && bx == 0)
            *reinterpret_cast<uint2*>(a.dbg_hq + src) = o;
        } else {
          float v[8];
          unpack8_bf16(__ldcg(reinterpret_cast<const uint4*>(
              static_cast<const __nv_bfloat16*>(a.h) + src)), v);
          put8_bf16<MMA>(row, 8 * c, v);
        }
      }
    }
  };
  const bool passes = p.segs_pass < p.nseg2;
  if (!passes) {
    stage_h(0, I);
    named_bar_sync(CONS_BAR, NCONS);
  }
  for (int grp = 0; grp < ng2; ++grp) {
    float acc[MMA ? 4 : MT];
    int iacc[MMA ? 4 : MT];
    float accf[MMA ? 1 : MT];             // W8A8: the sum over the groups
#pragma unroll
    for (int i = 0; i < (MMA ? 4 : MT); ++i) acc[i] = 0.f, iacc[i] = 0;
#pragma unroll
    for (int i = 0; i < (MMA ? 1 : MT); ++i) accf[i] = 0.f;
    const int row = tid >> 3, col = tid & 7;          // mma: this thread's output
    const int lrow = grp * GROUP_ROWS + (MMA ? row : warp);
    int pseg = 0, pbase = 0, qseg = 0, gq = 0;
    for (int seg = 0; seg < p.nseg2; ++seg) {
      if (passes && pseg == 0) {
        named_bar_sync(CONS_BAR, NCONS);
        stage_h(pbase, min(p.acols, I - pbase));
        named_bar_sync(CONS_BAR, NCONS);
      }
      const int off = seg * p.kseg2, len = min(p.kseg2, I - off), acol = off - pbase;
      mbar_wait(&full[slot], lap & 1);
      const unsigned char* wst = ring + slot * stage_bytes;
      if constexpr (MMA) {
        if constexpr (W8)
          mma_s8_stage(wst + g * p.rstride + 4 * t, p.rstride, xg, xlive, acol, len, warp, iacc);
        else
          mma_bf16_stage(wst + g * p.rstride + 4 * t, p.rstride, xg, xlive, acol, len, warp, t, acc);
      } else {
        if constexpr (W8)
          rows_s8<MT>(wst + warp * p.rstride, xs, p.xstride, acol, len, lane, iacc);
        else
          rows_bf16<MT>(wst + warp * p.rstride, xf, xrowf, acol, len, lane, acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      if (++slot == S) slot = 0, ++lap;
      if (++pseg == p.segs_pass) pseg = 0, pbase += p.segs_pass * p.kseg2;
      if constexpr (W8) {
        if (++qseg == p.segs_group) {
          // a group of I is complete: its exact s32 sums, scaled by hs, added
          // to the f32 sum in ascending group order
          qseg = 0;
          if constexpr (MMA) {
            // the warps' s32 partials meet in the group's tile by shared-
            // memory integer adds (exact in any order): no barrier a group
            int* tile = gtile + ((grp & 1) * G + gq) * 128 + lane * 4;
#pragma unroll
            for (int i = 0; i < 4; ++i) atomicAdd(tile + i, iacc[i]);
            iacc[0] = iacc[1] = iacc[2] = iacc[3] = 0;
          } else {
#pragma unroll
            for (int mi = 0; mi < MT; ++mi) {
              const int s = warp_isum(iacc[mi]);
              iacc[mi] = 0;
              if (mi < M) {
                accf[mi] = __fadd_rn(accf[mi], __fmul_rn(s32_to_f32(s), hsc[mi * G + gq]));
                if (a.dbg_down != nullptr && lane == 0 && lrow < n2)
                  a.dbg_down[(static_cast<long long>(gq) * M + mi) * a.D + r2 + lrow] = s;
              }
            }
          }
          ++gq;
        }
      }
    }
    // the row group's outputs: bf16(sum * sd + x)
    auto emit = [&](int lr, int m, float v) {
      a.out[m * a.ldo + r2 + lr] = __float2bfloat16(
          __fadd_rn(__fmul_rn(v, sc2[lr]), resid[m * rres + lr]));
    };
    if constexpr (W8) {
      if constexpr (MMA) {
        // the groups' exact sums, scaled by hs and added in ascending group
        // order; each tile cleared for the row group after next
        named_bar_sync(CONS_BAR, NCONS);
        if (tid < GROUP_ROWS * MMA_TILE) {
          const bool live = lrow < n2 && col < M;
          int* tile = gtile + (grp & 1) * G * 128 + red_idx(row, col);
          for (int q = 0; q < G; ++q) {
            const int s = tile[q * 128];
            tile[q * 128] = 0;
            if (live) {
              accf[0] = __fadd_rn(accf[0], __fmul_rn(s32_to_f32(s), hsc[col * G + q]));
              if (a.dbg_down != nullptr)
                a.dbg_down[(static_cast<long long>(q) * M + col) * a.D + r2 + lrow] = s;
            }
          }
          if (live) emit(lrow, col, accf[0]);
        }
      } else {
        if (lane == 0 && lrow < n2)
          for (int mi = 0; mi < MT; ++mi)
            if (mi < M) emit(lrow, mi, accf[mi]);
      }
    } else if constexpr (MMA) {
      float* rb = red_buf();
      *reinterpret_cast<float4*>(rb + warp * 128 + lane * 4) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
      named_bar_sync(CONS_BAR, NCONS);
      if (tid < GROUP_ROWS * MMA_TILE && lrow < n2 && col < M) {
        float v = 0.f;
        for (int w = 0; w < CONS_WARPS; ++w) v += rb[w * 128 + red_idx(row, col)];
        emit(lrow, col, v);
      }
      ++done;
    } else {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const float v = warp_sum(acc[mi]);
        if (lane == 0 && lrow < n2 && mi < M) emit(lrow, mi, v);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------
inline long long round_up(long long v, long long m) { return (v + m - 1) / m * m; }

// The plan's invariants that the kernel relies on, each region of shared
// memory against this source's constants.
bool plan_ok(const Plan& p, int kind, int M, int N, int K, int I, int D, int group) {
  const bool mma = M > ROWS_MAX_M, w8 = kind == W8A8, two = kind == MLP || w8;
  const long long n1 = two ? I : N;
  if (p.mt != (mma ? MMA_TILE : M) || p.ctas <= 0 || p.smem > SMEM_MAX ||
      p.stages < 2 || p.stages > MAX_STAGES || 16 * p.stages > BARRIER_BYTES ||
      p.kseg1 <= 0 || p.kseg1 % 16 || p.kseg1 > KSEG ||
      p.nseg1 != (K + p.kseg1 - 1) / p.kseg1 ||
      (long long)p.ctas * p.base1 + p.extra1 != n1 || p.extra1 < 0 ||
      p.extra1 >= p.ctas || p.base1 < 0)
    return false;
  if (two) {
    if (p.kseg2 <= 0 || p.kseg2 % 16 || p.kseg2 > KSEG ||
        p.nseg2 != (I + p.kseg2 - 1) / p.kseg2 || p.segs_pass < 1 ||
        p.segs_pass > p.nseg2 || (long long)p.ctas * p.base2 + p.extra2 != D ||
        p.extra2 < 0 || p.extra2 >= p.ctas || p.base2 < 0 || p.acols < K ||
        p.acols < (p.segs_pass == p.nseg2 ? I : p.segs_pass * p.kseg2))
      return false;
  } else if (p.kseg2 || p.nseg2 || p.base2 || p.extra2 || p.acols < K) {
    return false;
  }
  if (w8) {
    if (group <= 0 || I % group || group % p.kseg2 || p.groups != I / group ||
        p.segs_group != group / p.kseg2 ||
        (uint32_t)p.gdiv_mul != (uint32_t)((0x100000000ULL + group - 1) / group))
      return false;
  } else if (p.groups) {
    return false;
  }
  const long long rmax1 = p.base1 + (p.extra1 ? 1 : 0);
  const long long rmax2 = p.base2 + (p.extra2 ? 1 : 0);
  const long long rres = two ? rmax2 : rmax1;
  const long long ms = M;                // rows of x staged
  const long long need = w8 ? p.acols : mma ? 2LL * p.acols : 4 * round_up(p.acols, 512);
  // the sums: two buffers of the warps' 16 x 8 tiles (mma; W8A8 also two row
  // groups of a tile per group of I) or of a sum a (stage row, row of x)
  const long long red = !mma ? 2LL * GROUP_ROWS * MMA_TILE * 4
                             : 2LL * 128 * 4 * (CONS_WARPS > p.groups ? CONS_WARPS : p.groups);
  const long long loc = w8 ? 4 * (rmax1 * MMA_TILE + (long long)MMA_TILE * p.groups) : 0;
  return p.rstride >= p.kseg1 && p.rstride >= p.kseg2 && p.rstride % 16 == 0 &&
         p.xstride % 16 == 0 && p.xstride >= need && p.x_off >= BARRIER_BYTES &&
         p.x_off % 16 == 0 && p.sc_off >= p.x_off + ms * p.xstride &&
         p.sc_off % 16 == 0 &&
         p.red_off >= p.sc_off + 4 * (2 * rmax1 + rmax2 + MMA_TILE * rres) &&
         p.red_off % 16 == 0 && p.loc_off >= p.red_off + red && p.loc_off % 16 == 0 &&
         p.ring_off >= p.loc_off + loc && p.ring_off % 128 == 0 &&
         p.smem >= p.ring_off + (long long)p.stages * GROUP_ROWS * p.rstride;
}

template <int MT, int KIND>
int launch_k(const Args& a, const Plan& p, cudaStream_t st) {
  auto kernel = k9_kernel<MT, KIND>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ctas);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.numAttrs = 1;
  if (KIND == MLP || KIND == W8A8) {     // the grid barrier needs co-residency
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.numAttrs = 2;
  }
  cfg.attrs = attr;
  e = cudaLaunchKernelEx(&cfg, kernel, a, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int launch(const Args& a, const int* fields, int nfields, void* stream) {
  if (a.M <= 0) return 0;
  if (a.M > MMA_TILE || nfields != PLAN_FIELDS || a.K <= 0 || a.K % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < PLAN_FIELDS; ++i) dst[i] = fields[i];
  if (!plan_ok(p, KIND, a.M, a.N, a.K, a.I, a.D, a.group))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p.mt) {
    case 1: return launch_k<1, KIND>(a, p, st);
    case 2: return launch_k<2, KIND>(a, p, st);
    case 3: return launch_k<3, KIND>(a, p, st);
    default: return launch_k<MMA_TILE, KIND>(a, p, st);
  }
}

Args make_args(const void* x, long long ldx, const void* nw, int M, int K, float eps) {
  Args a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.ldx = ldx;
  a.nw = static_cast<const float*>(nw);
  a.M = M;
  a.K = K;
  a.eps = eps;
  a.kf = static_cast<float>(K);
  return a;
}

}  // namespace

// Plain C entries (bound with ctypes). Each returns a cudaError_t code,
// 0 = ok. x: [M, K] bf16 with row stride ldx (elements, a multiple of 8),
// 1 <= M <= 8; out: bf16 with row stride ldo; weights int8 rows of K (resp.
// I) contiguous bytes, a multiple of 16; pointers 16-byte aligned (checked
// in Python). plan: the PLAN_FIELDS integers of `k9_plan(...).fields()`.

// w: [>= N, K] int8; scale: [N] f32; nw: [K] f32 -> out [M, N].
extern "C" int vgt_decode_norm_matmul(
    const void* x, long long ldx, const void* nw, const void* w,
    const void* scale, void* out, long long ldo, int M, int N, int K, float eps,
    const int* plan, int nplan, void* stream) {
  Args a = make_args(x, ldx, nw, M, K, eps);
  a.w1 = static_cast<const int8_t*>(w);
  a.s1 = static_cast<const float*>(scale);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.ldo = ldo;
  a.N = N;
  return launch<NORM_MM>(a, plan, nplan, stream);
}

// res: [M, N] bf16 with row stride ldr -> out [M, N].
extern "C" int vgt_decode_matmul_residual(
    const void* x, long long ldx, const void* w, const void* scale,
    const void* res, long long ldr, void* out, long long ldo, int M, int N,
    int K, const int* plan, int nplan, void* stream) {
  Args a = make_args(x, ldx, nullptr, M, K, 0.f);
  a.w1 = static_cast<const int8_t*>(w);
  a.s1 = static_cast<const float*>(scale);
  a.res = static_cast<const __nv_bfloat16*>(res);
  a.ldr = ldr;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.ldo = ldo;
  a.N = N;
  return launch<MAT_RES>(a, plan, nplan, stream);
}

// wgu: [2I, K] int8 (gate rows, then up rows), sgu: [2I]; wd: [>= D, I] int8,
// sd: [D]; hbuf: [M, I] bf16 scratch -> out [M, D] (D == K: the residual is x).
extern "C" int vgt_decode_mlp(
    const void* x, long long ldx, const void* nw, const void* wgu,
    const void* sgu, const void* wd, const void* sd, void* hbuf, void* out,
    long long ldo, int M, int K, int I, int D, float eps, const int* plan,
    int nplan, void* stream) {
  if (I <= 0 || I % 16 || D != K) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(x, ldx, nw, M, K, eps);
  a.w1 = static_cast<const int8_t*>(wgu);
  a.s1 = static_cast<const float*>(sgu);
  a.w2 = static_cast<const int8_t*>(wd);
  a.s2 = static_cast<const float*>(sd);
  a.h = hbuf;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.ldo = ldo;
  a.I = I;
  a.D = D;
  return launch<MLP>(a, plan, nplan, stream);
}

// hf: [M, I] f32 scratch; slots: [plan ctas, M, I / group] f32 scratch;
// group: the columns of I that share one activation scale (I % group == 0,
// group % 16 == 0). dbg_*: null, or buffers that receive the row codes
// [M, K] int8 and scales [M] f32, the gate/up sums [M, 2I] s32, the
// per-group down sums [I / group, M, D] s32, the codes of h [M, I] int8 and
// their scales [M, I / group] f32.
extern "C" int vgt_decode_mlp_w8a8(
    const void* x, long long ldx, const void* nw, const void* wgu,
    const void* sgu, const void* wd, const void* sd, void* hf, void* slots,
    void* out, long long ldo, int M, int K, int I, int D, int group, float eps,
    void* dbg_xq, void* dbg_xs, void* dbg_gu, void* dbg_down, void* dbg_hq,
    void* dbg_hs, const int* plan, int nplan, void* stream) {
  if (I <= 0 || I % 16 || D != K || group <= 0 || group % 16 || I % group)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(x, ldx, nw, M, K, eps);
  a.w1 = static_cast<const int8_t*>(wgu);
  a.s1 = static_cast<const float*>(sgu);
  a.w2 = static_cast<const int8_t*>(wd);
  a.s2 = static_cast<const float*>(sd);
  a.h = hf;
  a.slots = static_cast<float*>(slots);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.ldo = ldo;
  a.I = I;
  a.D = D;
  a.group = group;
  a.dbg_xq = static_cast<int8_t*>(dbg_xq);
  a.dbg_xs = static_cast<float*>(dbg_xs);
  a.dbg_gu = static_cast<int*>(dbg_gu);
  a.dbg_down = static_cast<int*>(dbg_down);
  a.dbg_hq = static_cast<int8_t*>(dbg_hq);
  a.dbg_hs = static_cast<float*>(dbg_hs);
  return launch<W8A8>(a, plan, nplan, stream);
}
