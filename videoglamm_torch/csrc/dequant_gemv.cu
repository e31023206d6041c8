// K5: dequantising GEMV for decode (small M), for Hopper (sm_90a). Two entry
// points over weights kept in nn.Linear orientation ([N, K] rows, each output
// channel's K values contiguous).
//
//   int8:  y[m,n] = bf16( (sum_k f32(x[m,k]) * f32(w_q[n,k])) * scale[n] )
//   int4:  y[m,n] = bf16( sum_k f32(x[m,k]) * (f32(nibble[n,k]) * s[n,k/group]) )
//
// The int8 entry replaces the Pallas kernel `_kernel` of
// videoglamm_tpu/ops/quant.py (:36, launched by `_dequant_matmul_pallas` :74):
// f32 accumulation, one per-channel scale in the epilogue, one rounding. The
// int4 entry replaces `_kernel4` (:132, launched by `_dequant4_matvec_pallas`
// :191): byte r of a packed row holds k = 2r in its low and k = 2r + 1 in its
// high nibble, sign-extended as `_unpack4` (:112) does. The int4 sum is taken
// over each 32-k slice of a row in f32 and multiplied by the slice's group
// scale once (group % 32 == 0), where the Pallas body scales every weight
// first: the same function with f32 rounding in another order.
//
// What bounds it on the H100: the weight bytes, read once at 3.35 TB/s. Three
// things kept the first design (one warp an output channel, 8 channels a
// block) from that rate: an I2F conversion a weight (16 a clock an SM, which
// co-limits int8 and bounds int4), a fixed cost a launch (x staged and a
// __syncthreads before the first weight load, x restaged by each of N/8
// blocks, a ragged last wave), and M > 1 read in tiles of 4 rows (the weights
// read again for every 4 rows). The design:
//
// - A persistent grid of contiguous row ranges, balanced to within one row
//   (`k5_plan` in videoglamm_torch/ops/quant.py computes it, with the
//   shared-memory layout, and hands it in; the CPU tests check it). No wave
//   is ragged; no split of K.
// - Conversions off the I2F pipe (csrc/sm90_common.cuh, shared with K4).
//   M <= 3 (CUDA cores): int8 codes by the
//   magic number (xor 0x80808080, __byte_perm each byte into the low
//   mantissa of 0x4B000000, one exact FADD of -(2^23 + 128)); nibbles the
//   same way (xor 0x88888888, mask, -(2^23 + 8)), the high nibble left in
//   place as 16 x its code (-(2^23 + 128)) and its sums scaled by 1/16
//   once, exactly. M >= 4 (tensor cores)
//   needs bf16 codes: a byte's low 7 bits go into the mantissa of bf16 128
//   and its sign bit picks 128 or 256 to subtract (one sub.bf16x2 a pair); a
//   nibble into the mantissa of 128, minus 136. Every code is exact. No I2F
//   is left in any K5 kernel (a card test reads the SASS).
// - M <= 3, `gemv_rows_kernel`: 16 warps, two CTAs an SM for one row of x.
//   The CTA's rows are cut into units of 32 lanes x 2 (int8) or 1 (int4)
//   16-byte vectors; warp w takes units w, w + 16, ... two at a time and has
//   the next two in flight (__ldcs into registers) while it computes the
//   current ones. The first loads go out before x is staged. x is staged
//   once a CTA in f32, permuted so that the lanes' loads are conflict-free.
//   A unit's sum meets in a butterfly; a row's units add in order at the end.
// - M >= 4, `gemv_mma_kernel`: all M rows in one pass over the weights (M >
//   8: tiles of 8 on grid.y). A producer warp streams the CTA's rows into a
//   ring of shared-memory stages with 1-D bulk copies completing on
//   mbarriers: a stage is 16 rows x at most 1 KB of each row (one copy a
//   row; rows 16 mod 128 bytes apart, so that the consumers' loads are
//   conflict-free); the first stages are in flight before the consumers stage
//   x and the CTA's scales. 16 consumer warps run mma.sync m16n8k16 with 16
//   weight rows as A and the 8 rows of x as B (f32 accumulators) on
//   alternate 16-byte chunks of a stage, the k order inside a chunk permuted
//   to what the conversions give (x staged the same way), and add in order
//   at the end of a row group. No atomics anywhere: two calls are bit-equal.
// - Both are programmatic dependent launches: a launch is scheduled while the
//   kernel before it on the stream drains, issues its first weight loads (no
//   kernel still running may write the weights or scales: the contract of
//   `dequant_gemv_int8` in ops/quant.py), and waits for that grid
//   (griddepcontrol.wait) only where it reads x. It lets the next launch in
//   at once. Out is written after the wait.
// - No integer division by a runtime value in a kernel: its reciprocal step
//   is an I2F, and in the unit loop it was a large share of the one-row time.
//   `fast_div` multiplies by ceil(2^32 / d) from the plan.
//
// f32 activations (an f32 model's decode, the `_f32` entries): x and y are
// f32, and nothing is rounded, as the Pallas bodies compute in f32
// (quant.py:43, :151-155). One row of x (and fewer than the crossover,
// F32_TC_MIN_M and its variants by the output channels an SM holds) runs on
// the CUDA cores: `gemv_rows_kernel` with x staged from f32 and y stored
// in f32, its conversions and its int4 order (each 32-k slice scaled once)
// unchanged (tiles of up to F32_MT rows on grid.y, which read the weights
// once a tile: the first f32 design took every M so, 16 passes at M = 64).
// From the crossover, `gemv_f32_tc_kernel` runs on the tensor cores with
// one pass over the weights for every TC_MT = 64 rows of x:
// - Exact operands. Every int8 code and int4 nibble is exact in bf16, and
//   each f32 x splits exactly into three bf16 planes, hi = bf16(x), mid =
//   bf16(x - hi), lo = bf16(x - hi - mid): 3 x 8 significant bits hold f32's
//   24, so hi + mid + lo == x for every |x| >= 2^-110 (below that lo falls
//   among bf16's subnormals: such an x adds less than 1e-33 to a sum). A
//   plane times a code is exact in the f32 accumulator; only the f32 sums
//   round. Three bf16 products run at twice the rate of 3xTF32's three.
// - Swap-AB on wgmma: the weights are A (64 output channels of a warpgroup x
//   16 k, converted into registers as the bf16 route's mma.sync fragments),
//   the planes are B, K-major in shared memory with the 128-byte swizzle,
//   each plane W = 8 ceil(rows / 8) rows wide (W = 64 above 32 rows). Up to
//   W = TC_PN_MAX_W the three planes stand side by side along N (one
//   m64n(3W)k16 a k16 step, the planes' sums added in registers); above it
//   they take three m64n64k16 into one accumulator (a third of the
//   registers). The k order inside a 16-byte weight chunk is what the
//   conversions give; the planes are written in the same order.
// - One producer lane streams the CTA's weight rows (128 a stage, two
//   consumer warpgroups of 64) by TMA boxes of 64, 32, 16 and 8 rows (four
//   tensor maps a weight, encoded once and kept; the rows' slice of a stage
//   in 128-byte halves, swizzled), and x's k-slice in f32 by one box a
//   stage, into a ring of stages; the first weight stages go out before the
//   wait for the grid before. Three splitter warps turn each x slice into
//   its planes once; both warpgroups read them. A stage is 256 k up to W =
//   16, 128 up to W = 32 and 64 at W = 64 (the planes' shared memory).
//   Where the card's SMs would hold at most 64 rows each (o_proj and
//   down_proj of Phi-3), the grid is as few CTAs of up to 64 rows, whose two
//   warpgroups take alternate stages, added in order at the end: a
//   warpgroup's products take 64 rows whatever the CTA holds.
// - Each 128-k block of a stage (64 at W = 64) goes into a fresh
//   accumulator that is added to the running sum in f32 registers: the
//   tensor core's f32 accumulation drifts one way along a chain
//   (csrc/attention_f32.cu). int4: a block lies inside one scale group, and
//   its sum is multiplied by the group's scale once; int8: the per-channel
//   scale in the epilogue. No atomics.
// - What sets the pace (a clock64() probe on the card, not kept): first
//   the producer lane's TMA issues (8-row boxes: 32 a stage), then the
//   consumers converting A and issuing wgmma with small N, whose A from
//   registers costs tens of cycles a product. The crossovers are each
//   product's two routes timed at 2 to 5 rows (PERF.md): the tensor cores
//   win from 2 rows where an SM holds more than 96 channels (gate_up,
//   lm_head), from 4 where it holds 65 to 96 (qkv: the CUDA cores still
//   lead at 3), from 5 where it holds at most 64 (o_proj, down_proj: the
//   CUDA-core route takes a second tile of x there).
//
// Measured on the card and not kept: the ring of bulk copies feeding the
// one-row route too, each warp on two rows of a stage (its consumers were
// bound by shared-memory traffic and latency, and lost to direct loads with
// more warps); x read unpermuted (4- to 32-way bank conflicts); rows
// assigned to CTAs strided instead of contiguous (no difference); a CTA's
// first rows bulk-copied to shared memory before the wait (slower). For the
// f32 tensor-core route (experiments/k5_f32_variants.py, PERF.md): one 1-D
// bulk copy a weight row a stage (the copies' issue set the pace, 4x
// slower), 8-row TMA boxes only, the three planes as three products along
// K at every width, 64- or 128-k stages at W = 8, four interleaved
// accumulator chains a stage, the two warpgroups issuing in turn, and a
// software pipeline in the consumers (a stage's second half, and the next
// stage's first, converted while the products before them run: 3-5% slower,
// and 20% slower where ptxas serialised the wgmma around its branches).
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>
#include <unordered_map>

namespace {

#include "sm90_common.cuh"
#include "mma_common.cuh"

constexpr int GROUP_ROWS = 16;         // rows of a stage
constexpr int F32_MT = 4;              // rows of x a pass takes with f32 x (CUDA cores)
constexpr int CONS_BAR = 1;            // named barrier of the consumer warps
// f32 x on the tensor cores from F32_TC_MIN_M rows where the card's SMs
// would hold more than 64 weight rows each, from F32_TC_MIN_M_MANY_ROWS
// where more than F32_TC_MANY_ROWS, from F32_TC_MIN_M_FEW_ROWS where at
// most 64 (a warpgroup's products take 64 rows whatever the CTA holds,
// while the CUDA-core route's work grows with the rows an SM holds); the
// crossovers measured on the card (PERF.md), read by `k5_plan`
constexpr int F32_TC_MIN_M = 4;
constexpr int F32_TC_MIN_M_MANY_ROWS = 2;
constexpr int F32_TC_MANY_ROWS = 96;
constexpr int F32_TC_MIN_M_FEW_ROWS = 5;
static_assert(2 <= F32_TC_MIN_M_MANY_ROWS && F32_TC_MIN_M_MANY_ROWS <= F32_TC_MIN_M &&
              F32_TC_MIN_M <= F32_TC_MIN_M_FEW_ROWS && F32_TC_MANY_ROWS > 64,
              "the tensor-core route takes 2 rows or more");
constexpr int TC_MT = 64;              // rows of x a pass on the tensor cores
constexpr int TC_NARROW_MAX = 32;      // planes W = 8 ceil(rows / 8) wide up to
                                       // this many rows, TC_MT wide above
constexpr int TC_PN_MAX_W = 32;        // planes side by side along N up to this width
// k a stage: 256 for planes up to TC_SMALL_MAX wide, 128 up to
// TC_NARROW_MAX, 64 above (a stage's planes take shared memory as x's rows
// do); a fresh accumulator sums at most TC_BK of them (int4: inside one
// scale group)
constexpr int TC_SMALL_MAX = 16;
constexpr int TC_KS_SMALL = 256;
constexpr int TC_KS_NARROW = 128;
constexpr int TC_KS_WIDE = 64;
constexpr int TC_BK = 128;

__host__ __device__ constexpr int tc_ks(int W) {
  return W <= TC_SMALL_MAX ? TC_KS_SMALL : W <= TC_NARROW_MAX ? TC_KS_NARROW : TC_KS_WIDE;
}
__host__ __device__ constexpr int tc_bk(int W) {   // k a fresh accumulator sums
  return tc_ks(W) < TC_BK ? tc_ks(W) : TC_BK;
}
__host__ __device__ constexpr int ilog2(int v) { return v > 1 ? 1 + ilog2(v / 2) : 0; }

// the plan's fields, in the order of `k5_plan(...).fields()`
struct Plan {
  int ctas, mt, m_tiles, kseg, nseg, stages, rstride, xstride;
  int x_off, s_off, red_off, ring_off, smem;
  int base, extra;                     // N = ctas * base + extra
  int vpr, vpr_mul;                    // 512-byte units a row (CUDA cores)
  int gdiv, gdiv_mul;                  // 32-k slices a scale group (int4)
  int per_sm;                          // CTAs an SM (the kernels' launch bounds)
  int xw, slot, ksplit;                // f32 tensor cores: plane width W, bytes
                                       // a ring slot, k-slices split by warpgroup
};
constexpr int PLAN_FIELDS = 23;

// Stage x rows m0 .. m0+MT-1 (zeros past M) into shared memory, NT threads;
// x is XT (bf16, or f32 on the CUDA-core route).
// CUDA-core route (MT <= 3): f32, each block of 32 chunks of 16 weight bytes
// permuted so that the lanes' 16-byte loads of one quarter-chunk q are
// consecutive (no bank conflicts): x[k], k = 4 q + e of chunk ca, lives at
// (ca / 32) * 32 KPC + 128 q + 4 (ca % 32) + e. Tensor-core route: bf16 rows
// xstride bytes apart, each group of 4 k (int8) or 8 k (int4) in the order
// the conversions give the weights: (0,2,1,3) or (0,4,1,5,2,6,3,7).
template <bool INT4, int MT, int NT, typename XT>
__device__ __forceinline__ void stage_x(unsigned char* smem, const Plan& p,
                                        const XT* x, long long ldx,
                                        int m0, int M, int K) {
  constexpr bool XF32 = std::is_same<XT, float>::value;
  const int kv8 = K / 8;
  for (int mi = 0; mi < MT; ++mi)
  for (int c = threadIdx.x; c < kv8; c += NT) {
    uint4 v = make_uint4(0, 0, 0, 0), v2 = make_uint4(0, 0, 0, 0);
    if (m0 + mi < M) {
      const uint4* src = reinterpret_cast<const uint4*>(x + (long long)(m0 + mi) * ldx + c * 8);
      v = src[0];
      if (XF32) v2 = src[1];
    }
    if constexpr (MT < 8) {
      constexpr int KPC = INT4 ? 32 : 16;       // k a 16-byte chunk holds
      float* xr = reinterpret_cast<float*>(smem + p.x_off + (long long)mi * p.xstride);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = c * 8 + 4 * h, ca = k / KPC, q = (k % KPC) / 4;
        const uint32_t lo = h ? v.z : v.x, hi = h ? v.w : v.y;
        const uint4 f = h ? v2 : v;
        *reinterpret_cast<float4*>(xr + (ca / 32) * 32 * KPC + 128 * q + 4 * (ca % 32)) =
            XF32 ? make_float4(__uint_as_float(f.x), __uint_as_float(f.y),
                               __uint_as_float(f.z), __uint_as_float(f.w))
                 : make_float4(bf16_lo(lo), bf16_hi(lo), bf16_lo(hi), bf16_hi(hi));
      }
    } else {
      uint4 o;
      if (INT4) {
        o.x = __byte_perm(v.x, v.z, 0x5410); o.y = __byte_perm(v.x, v.z, 0x7632);
        o.z = __byte_perm(v.y, v.w, 0x5410); o.w = __byte_perm(v.y, v.w, 0x7632);
      } else {
        o.x = __byte_perm(v.x, v.y, 0x5410); o.y = __byte_perm(v.x, v.y, 0x7632);
        o.z = __byte_perm(v.z, v.w, 0x5410); o.w = __byte_perm(v.z, v.w, 0x7632);
      }
      *reinterpret_cast<uint4*>(smem + p.x_off + (long long)mi * p.xstride + c * 16) = o;
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA-core route, M <= 3. The CTA's rows are cut into units of 32 lanes x
// VPL vectors of 16 bytes (1 KB of an int8 row, 512 bytes of an int4 row);
// warp w takes units w, w + W, ... in batches of UNROLL, loads the next
// batch while it computes the current one, and sums each unit across its
// lanes; the units' sums of a row add in order at the end.
// ---------------------------------------------------------------------------
constexpr int ROW_WARPS = 16;
constexpr int ROW_CTAS = 2;              // CTAs an SM with one row of x (k5_plan)
constexpr int UNROLL = 2;                // units a batch; two batches in flight

template <bool INT4, int MT, typename XT>
__global__ void __launch_bounds__(ROW_WARPS * 32, MT == 1 ? ROW_CTAS : 1)
gemv_rows_kernel(const XT* __restrict__ x, long long ldx,
                 const unsigned char* __restrict__ w,
                 const float* __restrict__ scale,
                 XT* __restrict__ out, long long ldo,
                 int M, int N, int K, int group, Plan p) {
  constexpr int W = ROW_WARPS;
  constexpr int KPC = INT4 ? 32 : 16;    // k a vector holds
  constexpr int VPL = INT4 ? 1 : 2;      // vectors a lane takes of a unit
  extern __shared__ __align__(128) unsigned char smem[];
  const int bx = blockIdx.x;
  const int r0 = bx * p.base + min(bx, p.extra);
  const int nrows = p.base + (bx < p.extra ? 1 : 0);
  if (nrows == 0) return;                // the whole CTA leaves together
  const int m0 = blockIdx.y * MT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = (INT4 ? K / 2 : K) / 16;   // 16-byte vectors a row
  const int vpr = p.vpr;                      // units a row
  const int units = nrows * vpr;
  const int scols = INT4 ? fast_div(K / 32, p.gdiv, p.gdiv_mul) : 1;  // K / group
  const uint4* wv = reinterpret_cast<const uint4*>(w) + (long long)r0 * nvec;

  // a batch in flight: the vectors, the group scales (int4), and each
  // unit's first vector, worked out once
  uint4 q[UNROLL][VPL];
  float sg[UNROLL][VPL];
  int qv0[UNROLL];
  auto load = [&](int b) {
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int u = warp + W * (b * UNROLL + j);
      const int row = fast_div(u, vpr, p.vpr_mul);
      const int v0 = (u - row * vpr) * 32 * VPL + lane;
      qv0[j] = v0;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int v = v0 + 32 * i;
        const bool live = u < units && v < nvec;
        q[j][i] = live ? __ldcs(wv + (long long)row * nvec + v) : make_uint4(0, 0, 0, 0);
        if (INT4)                        // a vector's 32 k lie in one group
          sg[j][i] = live ? __ldg(scale + (long long)(r0 + row) * scols +
                                  fast_div(v, p.gdiv, p.gdiv_mul)) : 0.f;
      }
    }
  };
  load(0);                               // weights first, then x
  allow_next_grid();
  wait_prior_grid();
  stage_x<INT4, MT, W * 32>(smem, p, x, ldx, m0, M, K);
  __syncthreads();

  const float* xs = reinterpret_cast<const float*>(smem + p.x_off);
  const int xrow = p.xstride / 4;
  float* part = reinterpret_cast<float*>(smem + p.s_off);
  // unit u's sums of its VPL vectors of the row, across the lanes
  auto unit_sum = [&](int u, int v0, const uint4 (&vec)[VPL], const float (&sc)[VPL]) {
    float acc[MT];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) acc[mi] = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = v0 + 32 * i;
      if (v >= nvec) continue;
      const float* xc = xs + (v / 32) * 32 * KPC + 4 * (v % 32);
      const uint32_t wd[4] = {vec[i].x, vec[i].y, vec[i].z, vec[i].w};
      if (!INT4) {
        // 16 k; each word's 4 products summed apart (short FMA chains)
        float f[4][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) int8_to_f32(wd[e], f[e]);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          float t4[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 xv = *reinterpret_cast<const float4*>(xc + mi * xrow + 128 * e);
            t4[e] = xv.x * f[e][0];
            t4[e] = fmaf(xv.y, f[e][1], t4[e]);
            t4[e] = fmaf(xv.z, f[e][2], t4[e]);
            t4[e] = fmaf(xv.w, f[e][3], t4[e]);
          }
          acc[mi] += (t4[0] + t4[1]) + (t4[2] + t4[3]);
        }
      } else {
        // 32 k in one group: the lane's sum times the group scale once;
        // even k (low nibbles) and odd k (16 x the high ones) summed apart
        float fl[4][4], fh[4][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) int4_to_f32(wd[e], fl[e], fh[e]);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          float tl[4], th[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 x0 = *reinterpret_cast<const float4*>(xc + mi * xrow + 256 * e);
            const float4 x1 = *reinterpret_cast<const float4*>(xc + mi * xrow + 256 * e + 128);
            tl[e] = x0.x * fl[e][0];
            tl[e] = fmaf(x0.z, fl[e][1], tl[e]);
            tl[e] = fmaf(x1.x, fl[e][2], tl[e]);
            tl[e] = fmaf(x1.z, fl[e][3], tl[e]);
            th[e] = x0.y * fh[e][0];
            th[e] = fmaf(x0.w, fh[e][1], th[e]);
            th[e] = fmaf(x1.y, fh[e][2], th[e]);
            th[e] = fmaf(x1.w, fh[e][3], th[e]);
          }
          const float t = fmaf((th[0] + th[1]) + (th[2] + th[3]), 0.0625f,
                               (tl[0] + tl[1]) + (tl[2] + tl[3]));
          acc[mi] = fmaf(t, sc[i], acc[mi]);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const float t = warp_sum(acc[mi]);
      if (lane == 0) part[u * MT + mi] = t;
    }
  };

  for (int b = 0; warp + W * b * UNROLL < units; ++b) {
    uint4 cur[UNROLL][VPL];
    float scur[UNROLL][VPL];
    int cv0[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      cv0[j] = qv0[j];
#pragma unroll
      for (int i = 0; i < VPL; ++i) { cur[j][i] = q[j][i]; scur[j][i] = sg[j][i]; }
    }
    load(b + 1);
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int u = warp + W * (b * UNROLL + j);
      if (u >= units) break;             // the same for the whole warp
      unit_sum(u, cv0[j], cur[j], scur[j]);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nrows * MT; t += W * 32) {
    const int row = t / MT, mi = t - row * MT;
    if (m0 + mi >= M) continue;
    float v = 0.f;
    for (int k = 0; k < vpr; ++k) v += part[(row * vpr + k) * MT + mi];
    const float y = INT4 ? v : v * scale[r0 + row];
    if constexpr (std::is_same<XT, float>::value)
      out[(long long)(m0 + mi) * ldo + r0 + row] = y;
    else
      out[(long long)(m0 + mi) * ldo + r0 + row] = __float2bfloat16(y);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core route, M >= 4: 16 consumer warps and a producer warp that
// streams the CTA's rows through the ring; D[16 rows][8 x rows] += A
// (weights) . B (x). The warps take alternate 16-byte chunks of a stage,
// lane (g, t) word t of rows g and g + 8, and add in order at the end of a
// row group.
// ---------------------------------------------------------------------------
constexpr int MMA_WARPS = 16;

template <bool INT4>
__global__ void __launch_bounds__(MMA_WARPS * 32 + 32, 1)
gemv_mma_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                const unsigned char* __restrict__ w,
                const float* __restrict__ scale,
                __nv_bfloat16* __restrict__ out, long long ldo,
                int M, int N, int K, int group, Plan p) {
  constexpr int W = MMA_WARPS, NCONS = W * 32, MT = 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int bx = blockIdx.x;
  const int r0 = bx * p.base + min(bx, p.extra);
  const int nrows = p.base + (bx < p.extra ? 1 : 0);
  if (nrows == 0) return;                // the whole CTA leaves together
  const int m0 = blockIdx.y * MT;
  const int rowbytes = INT4 ? K / 2 : K;
  const int scols = INT4 ? fast_div(K / 32, p.gdiv, p.gdiv_mul) : 1;  // K / group
  const int ngroups = (nrows + GROUP_ROWS - 1) / GROUP_ROWS;   // a shift
  const int total = ngroups * p.nseg;
  const int S = p.stages;
  const int stage_bytes = GROUP_ROWS * p.rstride;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  unsigned char* ring = smem + p.ring_off;
  float* red = reinterpret_cast<float*>(smem + p.red_off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W);
    }
    mbar_fence_init();
  }
  __syncthreads();

  allow_next_grid();
  if (warp == W) {                       // producer: weights first
    // stage i = grp * nseg + seg sits in slot i % S, lap i / S
    for (int i = 0, slot = 0, lap = 0, grp = 0, seg = 0; i < total; ++i) {
      if (lap > 0) mbar_wait(&empty[slot], (lap - 1) & 1);
      const int rows = min(GROUP_ROWS, nrows - grp * GROUP_ROWS);
      const int segoff = seg * p.kseg, seglen = min(p.kseg, rowbytes - segoff);
      if (lane == 0) mbar_expect_tx(&full[slot], (uint32_t)(rows * seglen));
      __syncwarp();
      if (lane < rows)
        bulk_load_1d(ring + (long long)slot * stage_bytes + lane * p.rstride,
                     w + (long long)(r0 + grp * GROUP_ROWS + lane) * rowbytes + segoff,
                     (uint32_t)seglen, &full[slot]);
      if (++slot == S) slot = 0, ++lap;
      if (++seg == p.nseg) seg = 0, ++grp;
    }
    return;
  }

  // x, and the scales of the CTA's rows, while the first stages fly
  wait_prior_grid();
  stage_x<INT4, MT, NCONS>(smem, p, x, ldx, m0, M, K);
  float* ss = reinterpret_cast<float*>(smem + p.s_off);
  const float* src = scale + (long long)r0 * scols;
  for (int i = threadIdx.x; i < nrows * scols; i += NCONS) ss[i] = src[i];
  named_bar_sync(CONS_BAR, NCONS);

  const int g = lane >> 2, t = lane & 3;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const unsigned char* xg = smem + p.x_off + g * p.xstride;
  int done = 0;                          // row groups finished
  for (int i = 0, slot = 0, lap = 0, grp = 0, seg = 0; i < total; ++i) {
    const int segoff = seg * p.kseg, seglen = min(p.kseg, rowbytes - segoff);
    mbar_wait(&full[slot], lap & 1);
    const unsigned char* st = ring + (long long)slot * stage_bytes + 4 * t;
    const unsigned char* wg = st + g * p.rstride;
    const unsigned char* wg8 = wg + 8 * p.rstride;
    const int rg = grp * GROUP_ROWS + g;  // CTA-local rows g, g + 8
#pragma unroll 4
    for (int c = warp; c < seglen / 16; c += W) {
      const uint32_t qa = lds32(wg + c * 16), qb = lds32(wg8 + c * 16);
      if (!INT4) {
        const int k0 = segoff + c * 16 + 4 * t;
        const uint2 b = lds64(xg + 2 * k0);
        uint32_t a[4];
        int8_to_bf16x2(qa, a[0], a[2]);
        int8_to_bf16x2(qb, a[1], a[3]);
        mma_bf16(acc, a, b.x, b.y);
      } else {
        const int kc = 2 * (segoff + c * 16);  // the chunk's 32 k
        const uint4 b = lds128(xg + 2 * (kc + 8 * t));
        uint32_t pa[4], pb[4];
        int4_to_bf16x2(qa, pa);
        int4_to_bf16x2(qb, pb);
        float tmp[4] = {0.f, 0.f, 0.f, 0.f};
        const uint32_t a0[4] = {pa[0], pb[0], pa[1], pb[1]};
        const uint32_t a1[4] = {pa[2], pb[2], pa[3], pb[3]};
        mma_bf16(tmp, a0, b.x, b.y);
        mma_bf16(tmp, a1, b.z, b.w);
        const int gcol = fast_div(kc / 32, p.gdiv, p.gdiv_mul);
        const float sg = rg < nrows ? ss[rg * scols + gcol] : 0.f;
        const float sg8 = rg + 8 < nrows ? ss[(rg + 8) * scols + gcol] : 0.f;
        acc[0] = fmaf(tmp[0], sg, acc[0]);
        acc[1] = fmaf(tmp[1], sg, acc[1]);
        acc[2] = fmaf(tmp[2], sg8, acc[2]);
        acc[3] = fmaf(tmp[3], sg8, acc[3]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    if (seg == p.nseg - 1) {             // the row group is complete
      float* rb = red + (done & 1) * (W * 128);
      *reinterpret_cast<float4*>(rb + warp * 128 + lane * 4) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
      acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
      named_bar_sync(CONS_BAR, NCONS);
      if (threadIdx.x < 128) {
        // D[row][col]: lane = 4 (row % 8) + col / 2, register 2 (row / 8) + col % 2
        const int row = threadIdx.x >> 3, col = threadIdx.x & 7;
        const int idx = ((row & 7) * 4 + (col >> 1)) * 4 + (row >> 3) * 2 + (col & 1);
        float v = 0.f;
#pragma unroll
        for (int ww = 0; ww < W; ++ww) v += rb[ww * 128 + idx];
        const int lrow = grp * GROUP_ROWS + row;
        if (lrow < nrows && m0 + col < M)
          out[(long long)(m0 + col) * ldo + r0 + lrow] =
              __float2bfloat16(INT4 ? v : v * ss[lrow]);
      }
      ++done;
    }
    if (++slot == S) slot = 0, ++lap;
    if (++seg == p.nseg) seg = 0, ++grp;
  }
}

// ---------------------------------------------------------------------------
// f32 x on the tensor cores (M >= F32_TC_MIN_M): warpgroups 0 and 1 consume,
// warp 8 streams the weights and x's k-slices, warps 9 to 11 split x into
// its bf16 planes. A ring slot holds the planes [W rows hi | W mid | W lo] x
// the stage's k (chunks of 64 k, 128-byte swizzle), then x's slice in f32
// [mt][ks], then the weight rows `rstride` bytes apart.
// ---------------------------------------------------------------------------
// The weights' tensor maps: boxes of 8 << l rows (l = 0..3) x the stage's
// row bytes (at most 128: a 256-byte slice in two halves), so that a
// stage's rows, rounded up to 8, take at most four boxes a half (one TMA
// issue costs the producer lane some 50 cycles)
struct WeightMaps {
  CUtensorMap m[4];
};

constexpr int TC_CONS = 256;           // two consumer warpgroups
constexpr int TC_SPLIT = 96;           // splitter threads
constexpr int TC_THREADS = TC_CONS + 32 + TC_SPLIT;
constexpr int TC_RED_BAR = 1;          // named barriers of the consumers
constexpr int TC_SCALE_BAR = 2;

// the three bf16 planes of (a, b), each a pair with a in the low half
// (mma_common.cuh's pack_bf16 rounds to nearest even): h + m + l == x
// exactly for |x| >= 2^-110
__device__ __forceinline__ void split3(float a, float b, uint32_t& h, uint32_t& m,
                                       uint32_t& l) {
  h = pack_bf16(a, b);
  const float ra = a - bf16_lo(h), rb = b - bf16_hi(h);
  m = pack_bf16(ra, rb);
  l = pack_bf16(ra - bf16_lo(m), rb - bf16_hi(m));
}

template <bool INT4, int W>
__global__ void __launch_bounds__(TC_THREADS, 1)
gemv_f32_tc_kernel(const __grid_constant__ WeightMaps tw,
                   const __grid_constant__ CUtensorMap tx,
                   const float* __restrict__ scale,
                   float* __restrict__ out, long long ldo,
                   int M, int N, int K, Plan p) {
  constexpr bool PN = W <= TC_PN_MAX_W;            // planes side by side along N
  constexpr int NACC = PN ? 3 * W / 2 : W / 2;     // accumulators a thread
  constexpr int UK = INT4 ? 32 : 16;               // k of a 16-byte weight chunk
  constexpr int Q = UK / 8;                        // 16-byte plane units a chunk
  constexpr int KS = tc_ks(W);                     // k a stage
  constexpr int STEPS = KS / 16;                   // k16 steps of a stage
  constexpr int BK = tc_bk(W);                     // k a fresh accumulator sums
  constexpr int NB = KS / BK;                      // blocks a stage
  constexpr int BSTEPS = BK / 16;
  constexpr int KSEG = INT4 ? KS / 2 : KS;         // weight bytes of a row a stage
  constexpr int SPAN = KSEG < 128 ? KSEG : 128;    // bytes of a TMA box row (its swizzle)
  constexpr int HALVES = KSEG / SPAN;
  constexpr int PLANE_CHUNK = 3 * W * 128;         // the planes of 64 k
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // aligned to the swizzle's period by an offset from the __shared__ array,
  // so that the pointers below stay known as shared
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int bx = blockIdx.x;
  const int r0 = bx * p.base + min(bx, p.extra);
  const int nrows = p.base + (bx < p.extra ? 1 : 0);
  if (nrows == 0) return;                // the whole CTA leaves together
  const int m0 = blockIdx.y * p.mt;
  const int mrows = min(p.mt, M - m0);
  constexpr int ks = KS;
  const int R = p.ksplit ? 64 : 128;               // weight rows a stage
  const int ngroups = p.ksplit ? 1 : (nrows + 127) >> 7;
  const int total = ngroups * p.nseg;
  const int S = p.stages;
  const int w_off = p.x_off + ((p.mt * ks * 4 + 1023) & ~1023);   // the weights in a slot
  uint64_t* xfull = reinterpret_cast<uint64_t*>(smem);   // x's slice landed
  uint64_t* full = xfull + S;            // weights landed and planes written
  uint64_t* empty = full + S;            // the consumers are done with a slot
  unsigned char* ring = smem + p.ring_off;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&xfull[s], 1);
      mbar_init(&full[s], 1 + TC_SPLIT);
      mbar_init(&empty[s], p.ksplit ? 128 : 256);
    }
    mbar_fence_init();
  }
  __syncthreads();
  allow_next_grid();

  if (warp == TC_CONS / 32) {
    // ---------------- producer (one lane): stage i = grp * nseg + seg in
    // slot i % S; the stage's rows, rounded up to 8, in TMA boxes of 64, 32,
    // 16 and 8 rows x SPAN bytes (swizzled over SPAN, whole swizzle periods;
    // zeros past K and N), x's slice in one box of mt rows x ks f32 (zeros
    // past M and K)
    if (lane != 0) return;
    auto load_w = [&](int slot, int grp, int seg) {
      const int n8 = (min(R, nrows - grp * R) + 7) >> 3;   // 8-row units
      mbar_expect_tx(&full[slot], (uint32_t)(n8 * 8 * KSEG));
      unsigned char* dst = ring + (long long)slot * p.slot + w_off;
      for (int h = 0; h < HALVES; ++h)
        for (int l = 3, u = 0; l >= 0; --l)
          for (; n8 - u >= (1 << l); u += 1 << l)
            tma_load_2d(dst + (h * R + 8 * u) * SPAN, &tw.m[l], &full[slot],
                        seg * KSEG + h * SPAN, r0 + grp * R + 8 * u);
    };
    // the first lap's weights go out before the wait for the grid before
    for (int i = 0, grp = 0, seg = 0; i < min(S, total); ++i) {
      load_w(i, grp, seg);
      if (++seg == p.nseg) seg = 0, ++grp;
    }
    wait_prior_grid();
    for (int i = 0, slot = 0, lap = 0, grp = 0, seg = 0; i < total; ++i) {
      if (lap > 0) {
        mbar_wait(&empty[slot], (lap - 1) & 1);
        load_w(slot, grp, seg);
      }
      mbar_expect_tx(&xfull[slot], (uint32_t)(p.mt * ks * 4));
      tma_load_2d(ring + (long long)slot * p.slot + p.x_off, &tx, &xfull[slot],
                  seg * ks, m0);
      if (++slot == S) slot = 0, ++lap;
      if (++seg == p.nseg) seg = 0, ++grp;
    }
    return;
  }

  if (warp > TC_CONS / 32) {
    // ---------------- splitters: x's slice -> three planes, a job being
    // one row's UK k (Q units of 8 k a plane, in the k order of a weight
    // chunk's conversion: unit q holds k = Q j + q, j = 0..7)
    const int st = tid - TC_CONS - 32;
    constexpr int gshift = ilog2(KS / UK);           // chunks a stage, a power of two
    static_assert(KS / UK == 1 << gshift, "chunks a stage");
    for (int i = 0, slot = 0, lap = 0, seg = 0; i < total; ++i) {
      mbar_wait(&xfull[slot], lap & 1);
      const unsigned char* xs = ring + (long long)slot * p.slot + p.x_off;
      unsigned char* pl = ring + (long long)slot * p.slot;
      // past K (the last stage's tail) TMA filled zeros: zero planes, so
      // that every stage issues the same products
      for (int job = st; job < (mrows << gshift); job += TC_SPLIT) {
        const int m = job >> gshift, G = job & ((1 << gshift) - 1);
        float f[UK];
#pragma unroll
        for (int c = 0; c < UK / 4; ++c)
          *reinterpret_cast<float4*>(f + 4 * c) =
              *reinterpret_cast<const float4*>(xs + (m * ks + G * UK + 4 * c) * 4);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          uint4 h, md, l;
          split3(f[q], f[Q + q], h.x, md.x, l.x);
          split3(f[2 * Q + q], f[3 * Q + q], h.y, md.y, l.y);
          split3(f[4 * Q + q], f[5 * Q + q], h.z, md.z, l.z);
          split3(f[6 * Q + q], f[7 * Q + q], h.w, md.w, l.w);
          const int u = Q * G + q;                 // the unit within the stage
          unsigned char* ck = pl + (u >> 3) * PLANE_CHUNK;
          const int n0 = m, n1 = W + m, n2 = 2 * W + m;
          *reinterpret_cast<uint4*>(ck + n0 * 128 + (((u & 7) ^ (n0 & 7)) << 4)) = h;
          *reinterpret_cast<uint4*>(ck + n1 * 128 + (((u & 7) ^ (n1 & 7)) << 4)) = md;
          *reinterpret_cast<uint4*>(ck + n2 * 128 + (((u & 7) ^ (n2 & 7)) << 4)) = l;
        }
      }
      fence_proxy_async();                         // the planes -> wgmma
      mbar_arrive(&full[slot]);
      if (++slot == S) slot = 0, ++lap;
      if (++seg == p.nseg) seg = 0;
    }
    return;
  }

  // ---------------- consumers: warpgroup wg, warp wl of it; lane (g, t)
  // holds rows g and g + 8 of the warp's 16 and, of each 8 columns i,
  // columns 8i + 2t, +1 (x rows, or plane-major in PN)
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int scols = INT4 ? fast_div(K / 32, p.gdiv, p.gdiv_mul) : 1;  // K / group
  const float* ss = reinterpret_cast<const float*>(smem + p.s_off);
  if (INT4) {                            // the CTA's group scales (weights: before the wait)
    float* dst = reinterpret_cast<float*>(smem + p.s_off);
    const float* src = scale + (long long)r0 * scols;
    for (int i = tid; i < nrows * scols; i += TC_CONS) dst[i] = src[i];
    named_bar_sync(TC_SCALE_BAR, TC_CONS);
  }
  wait_prior_grid();                     // out is written after it
  const int rbase = p.ksplit ? 0 : 64 * wg;        // the warpgroup's rows in a stage
  float tot[W / 2];
#pragma unroll
  for (int j = 0; j < W / 2; ++j) tot[j] = 0.f;

  // y of the rows lrow0 + 16 wl + g (+ 8) from the running sums
  auto store = [&](int lrow0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lrow = lrow0 + 16 * wl + g + 8 * h;
      if (lrow >= nrows) continue;
      const float sc = INT4 ? 1.f : __ldg(scale + r0 + lrow);
#pragma unroll
      for (int i = 0; i < W / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 8 * i + 2 * t + e;
          if (m < mrows)
            out[(long long)(m0 + m) * ldo + r0 + lrow] =
                INT4 ? tot[4 * i + 2 * h + e] : tot[4 * i + 2 * h + e] * sc;
        }
    }
  };

  // with ksplit a warpgroup takes the stages of its own parity; `stages` is
  // then even, so that a slot serves one warpgroup, which waits on every
  // phase of the full barriers it reads (skipping a phase, a wait for lap &
  // 1 would match the phase before it and return before the stage landed)
  for (int i = 0, slot = 0, lap = 0, grp = 0, seg = 0; i < total; ++i) {
    if (!p.ksplit || (seg & 1) == wg) {
      mbar_wait(&full[slot], lap & 1);
      const int lrow0 = grp * R + rbase;           // the warpgroup's first row
      if (lrow0 < nrows) {
        const unsigned char* sl = ring + (long long)slot * p.slot;
        // rows rr and rr + 8 in each SPAN-byte half of the stage's row
        // bytes, their 16-byte units swizzled by TMA (unit c of a row at
        // c ^ the row start's address bits 7 and up)
        const int rr = rbase + 16 * wl + g;
        const int sw = ((rr * SPAN) >> 7) & (SPAN / 16 - 1);
        const unsigned char* wr = sl + w_off + rr * SPAN + 4 * t;
        const int k0 = seg * ks;
        // A: the weights of rows g, g + 8, converted to bf16 pairs (zeros
        // past K)
        uint32_t a[STEPS][4];
#pragma unroll
        for (int c = 0; c < KS / UK; ++c) {
          constexpr int UH = SPAN / 16;            // units a half
          const int u = (c / UH) * R * SPAN + (((c % UH) ^ sw) << 4);
          const uint32_t qa = lds32(wr + u), qb = lds32(wr + 8 * SPAN + u);
          if (!INT4) {
            int8_to_bf16x2(qa, a[c][0], a[c][2]);
            int8_to_bf16x2(qb, a[c][1], a[c][3]);
          } else {
            uint32_t pa[4], pb[4];
            int4_to_bf16x2(qa, pa);
            int4_to_bf16x2(qb, pb);
            a[2 * c][0] = pa[0]; a[2 * c][1] = pb[0]; a[2 * c][2] = pa[1]; a[2 * c][3] = pb[1];
            a[2 * c + 1][0] = pa[2]; a[2 * c + 1][1] = pb[2];
            a[2 * c + 1][2] = pa[3]; a[2 * c + 1][3] = pb[3];
          }
        }
        // the conversions (register-only) stay ahead of the fence
#pragma unroll
        for (int j = 0; j < STEPS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e]) :: "memory");
        // each block of BSTEPS k16 steps into a fresh accumulator of its own
        float acc[NB][NACC];
#pragma unroll
        for (int bl = 0; bl < NB; ++bl)
#pragma unroll
          for (int j = 0; j < NACC; ++j) acc[bl][j] = 0.f;
#pragma unroll
        for (int bl = 0; bl < NB; ++bl) fence_regs<NACC>(acc[bl]);
        wgmma_fence();
#pragma unroll
        for (int st = 0; st < BSTEPS; ++st)
#pragma unroll
          for (int pl = 0; pl < (PN ? 1 : 3); ++pl)
#pragma unroll
            for (int bl = 0; bl < NB; ++bl) {
              const int j = bl * BSTEPS + st;      // the k16 step
              const unsigned char* b = sl + (j >> 2) * PLANE_CHUNK + 32 * (j & 3);
              if constexpr (PN)
                Wgmma<3 * W>::rs(acc[bl], a[j], desc_sw128(b, 0, 1024), st > 0);
              else
                Wgmma<W>::rs(acc[bl], a[j], desc_sw128(b + pl * W * 128, 0, 1024),
                             st > 0 || pl > 0);
            }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int bl = 0; bl < NB; ++bl) fence_regs<NACC>(acc[bl]);
        // the blocks' sums into the running sums in order: the planes
        // (lo + mid) + hi, times the block's group scale once (int4)
#pragma unroll
        for (int bl = 0; bl < NB; ++bl) {
          float sg[2] = {1.f, 1.f};
          if (INT4) {
            const int gcol = fast_div((k0 + bl * BK) / 32, p.gdiv, p.gdiv_mul);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int lrow = lrow0 + 16 * wl + g + 8 * h;
              sg[h] = lrow < nrows ? ss[lrow * scols + gcol] : 0.f;
            }
          }
#pragma unroll
          for (int j = 0; j < W / 2; ++j) {
            const float* v3 = acc[bl];
            const float v = PN ? (v3[j + W] + v3[j + W / 2]) + v3[j] : v3[j];
            tot[j] = INT4 ? fmaf(v, sg[(j >> 1) & 1], tot[j]) : tot[j] + v;
          }
        }
      }
      mbar_arrive(&empty[slot]);
    }
    if (!p.ksplit && seg == p.nseg - 1) {  // a row group is complete
      store(grp * R + rbase);
#pragma unroll
      for (int j = 0; j < W / 2; ++j) tot[j] = 0.f;
    }
    if (++slot == S) slot = 0, ++lap;
    if (++seg == p.nseg) seg = 0, ++grp;
  }
  if (p.ksplit) {                        // warpgroup 0's k-slices + warpgroup 1's
    float* red = reinterpret_cast<float*>(smem + p.red_off) + (tid & 127) * (W / 2);
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < W / 2; ++j) red[j] = tot[j];
    }
    named_bar_sync(TC_RED_BAR, TC_CONS);
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < W / 2; ++j) tot[j] += red[j];
      store(0);
    }
  }
}

constexpr int kMaxSmem = 232448;       // dynamic shared memory a block can use
constexpr int kSmemSM = 233472;        // shared memory of an SM
constexpr int kSmemCTA = 1024;         // of which the system reserves a CTA

template <typename XT, typename Kernel>
int launch_k(Kernel kernel, int threads, const void* x, long long ldx,
             const void* w, const void* scale, void* out, long long ldo, int M,
             int N, int K, int group, const Plan& p, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ctas, p.m_tiles);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const XT*>(x), ldx,
                         static_cast<const unsigned char*>(w),
                         static_cast<const float*>(scale),
                         static_cast<XT*>(out), ldo, M, N, K, group, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The weights as 2-D u8 tensor maps, [N rows, rowbytes], boxes of 8, 16, 32
// and 64 rows x `kseg` bytes (32, 64 or 128) with the swizzle of that span
// (each box whole swizzle periods). Encoded once per (base, geometry) and
// kept: a model's weights are read at every decode step.
bool weight_maps(WeightMaps* out, const void* base, int N, int rowbytes, int kseg) {
  struct Key {
    const void* base;
    int N, rowbytes, kseg;
    bool operator==(const Key& o) const {
      return base == o.base && N == o.N && rowbytes == o.rowbytes && kseg == o.kseg;
    }
  };
  struct Hash {
    size_t operator()(const Key& k) const {
      return std::hash<const void*>()(k.base) ^ (static_cast<size_t>(k.N) << 21) ^
             (static_cast<size_t>(k.rowbytes) << 42) ^ static_cast<size_t>(k.kseg);
    }
  };
  static std::mutex mu;
  static std::unordered_map<Key, WeightMaps, Hash> maps;
  const Key key{base, N, rowbytes, kseg};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = maps.find(key);
  if (it != maps.end()) {
    *out = it->second;
    return true;
  }
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(rowbytes), static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(rowbytes)};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapSwizzle sw = kseg == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : kseg == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
  for (int l = 0; l < 4; ++l) {
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(kseg), 8u << l};
    if (fn(&out->m[l], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
           strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return false;
  }
  if (maps.size() >= 4096) maps.clear();
  maps.emplace(key, *out);
  return true;
}

template <bool INT4>
int launch_tc(const void* x, long long ldx, const void* w, const void* scale,
              void* out, long long ldo, int M, int N, int K, const Plan& p,
              cudaStream_t st) {
  cudaError_t e = use_device_of(x);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ks = INT4 ? 2 * p.kseg : p.kseg;
  // x as a 2-D f32 map, [M rows ldx apart, K], one box of mt rows x ks a stage
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldx) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(ks), static_cast<cuuint32_t>(p.mt)};
  WeightMaps tw;
  CUtensorMap tx;
  if (!weight_maps(&tw, w, N, INT4 ? K / 2 : K, p.rstride) ||
      !encode_map(&tx, x, 2, dims, strides, box, false, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gemv_f32_tc_kernel<INT4, TC_MT>;
  switch (p.xw) {
    case 8: kernel = gemv_f32_tc_kernel<INT4, 8>; break;
    case 16: kernel = gemv_f32_tc_kernel<INT4, 16>; break;
    case 24: kernel = gemv_f32_tc_kernel<INT4, 24>; break;
    case 32: kernel = gemv_f32_tc_kernel<INT4, 32>; break;
    default: break;
  }
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ctas, p.m_tiles);
  cfg.blockDim = dim3(TC_THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, tw, tx, static_cast<const float*>(scale),
                         static_cast<float*>(out), ldo, M, N, K, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// the planes' width W for `mt` rows of x on the f32 tensor-core route
__host__ __device__ constexpr int tc_width(int mt) {
  return mt > TC_NARROW_MAX ? TC_MT : (mt + 7) / 8 * 8;
}

// F32: x and out f32; the plan's `xw` names the tensor-core route (else the
// CUDA-core route in tiles of up to F32_MT rows)
template <bool INT4, bool F32>
int launch(const void* x, long long ldx, const void* w, const void* scale,
           void* out, long long ldo, int M, int N, int K, int group,
           const int* fields, int nfields, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (nfields != PLAN_FIELDS) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < PLAN_FIELDS; ++i) dst[i] = fields[i];
  const int rowbytes = INT4 ? K / 2 : K;
  const bool tc = F32 && p.xw != 0;
  const bool mma = !F32 && M > 3;
  const int mt = tc ? (M < TC_MT ? M : TC_MT) : mma ? 8 : F32 ? (M < F32_MT ? M : F32_MT) : M;
  // the plan's invariants that the kernels rely on, each region of shared
  // memory against the constants of the kernel that uses it
  bool bad = K <= 0 || K % (INT4 ? 32 : 16) || (INT4 && (group <= 0 || group % 32 || K % group))
      || p.ctas <= 0 || p.ctas > N || p.mt != mt || p.m_tiles != (M + p.mt - 1) / p.mt
      || p.m_tiles > 65535 || p.smem > kMaxSmem || p.x_off % 16 || p.s_off % 16
      || p.xstride % 16 || p.base != N / p.ctas || p.extra != N % p.ctas
      || (INT4 && p.gdiv * 32 != group)
      || p.per_sm != (M == 1 ? ROW_CTAS : 1)
      || (long long)p.per_sm * (p.smem + kSmemCTA) > kSmemSM;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const long long max_rows = p.base + (p.extra ? 1 : 0);
  const long long scols = INT4 ? K / group : 1;
  if (!tc && (p.xw || p.slot || p.ksplit)) return static_cast<int>(cudaErrorInvalidValue);
  if (tc) {
    // [planes | x's f32 slice | weight rows, TMA-swizzled] a slot, each
    // 1024-aligned, the barriers below the ring, then the CTA's group scales
    // (int4) and the warpgroups' k-split sums
    const int W = tc_width(mt), KS = tc_ks(W), BK = tc_bk(W);
    const int R = p.ksplit ? 64 : 128;
    bad = M < 2 || ldx % 4 || p.xw != W || p.kseg != (INT4 ? KS / 2 : KS)
        || (INT4 && group % BK) || p.nseg != (rowbytes + p.kseg - 1) / p.kseg
        || p.stages < 2 || p.stages > 8
        || p.rstride != (p.kseg < 128 ? p.kseg : 128)     // a TMA box row (its swizzle span)
        || p.xstride != 6 * W * KS || p.x_off != p.xstride || p.x_off % 1024
        || p.slot % 1024
        || p.slot < p.x_off + (4LL * mt * KS + 1023) / 1024 * 1024 + (long long)R * p.kseg
        || p.ring_off % 1024 || p.ring_off < 24 * p.stages
        || p.s_off < p.ring_off + (long long)p.stages * p.slot
        || p.red_off % 16 || p.red_off < p.s_off + (INT4 ? max_rows * scols * 4 : 0)
        || p.ksplit != (max_rows <= 64 ? 1 : 0) || (p.ksplit && p.stages % 2)
        || p.smem < p.red_off + (p.ksplit ? 128LL * W / 2 * 4 : 0) + 1024;
  } else if (!mma) {
    // x in f32, blocks of 32 chunks of KPC k each; then a sum a unit
    const int block = 32 * (INT4 ? 32 : 16);
    const long long units = (long long)p.vpr * max_rows;
    bad = p.vpr != (rowbytes + (INT4 ? 511 : 1023)) / (INT4 ? 512 : 1024)
        || p.x_off != 0 || p.xstride < 4LL * ((K + block - 1) / block) * block
        || p.s_off < (long long)mt * p.xstride || p.smem < p.s_off + units * mt * 4;
  } else {
    bad = p.kseg <= 0 || p.kseg % 16 || p.nseg != (rowbytes + p.kseg - 1) / p.kseg
        || p.stages < 2 || p.stages > 8 || p.rstride < p.kseg || p.rstride % 16
        || p.xstride < 2 * K || p.x_off < 16 * p.stages || p.red_off % 16 || p.ring_off % 128
        || p.s_off < p.x_off + 8LL * p.xstride          // 8 rows of x
        || p.red_off < p.s_off + max_rows * scols * 4    // the CTA's scales
        || p.ring_off < p.red_off + 2LL * 4 * MMA_WARPS * 128   // two 16 x 8 sums a warp
        || p.smem < p.ring_off + (long long)p.stages * GROUP_ROWS * p.rstride;
  }
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tr = ROW_WARPS * 32, tm = MMA_WARPS * 32 + 32;
  if constexpr (F32) {
    if (tc) return launch_tc<INT4>(x, ldx, w, scale, out, ldo, M, N, K, p, st);
    switch (p.mt) {
      case 1: return launch_k<float>(gemv_rows_kernel<INT4, 1, float>, tr, x, ldx, w, scale, out, ldo, M, N, K, group, p, st);
      case 2: return launch_k<float>(gemv_rows_kernel<INT4, 2, float>, tr, x, ldx, w, scale, out, ldo, M, N, K, group, p, st);
      case 3: return launch_k<float>(gemv_rows_kernel<INT4, 3, float>, tr, x, ldx, w, scale, out, ldo, M, N, K, group, p, st);
      default: return launch_k<float>(gemv_rows_kernel<INT4, F32_MT, float>, tr, x, ldx, w, scale, out, ldo, M, N, K, group, p, st);
    }
  }
  using BF = __nv_bfloat16;
  switch (p.mt) {
    case 1: return launch_k<BF>(gemv_rows_kernel<INT4, 1, BF>, tr, x, ldx, w, scale, out, ldo, M, N, K, group, p, st);
    case 2: return launch_k<BF>(gemv_rows_kernel<INT4, 2, BF>, tr, x, ldx, w, scale, out, ldo, M, N, K, group, p, st);
    case 3: return launch_k<BF>(gemv_rows_kernel<INT4, 3, BF>, tr, x, ldx, w, scale, out, ldo, M, N, K, group, p, st);
    default: return launch_k<BF>(gemv_mma_kernel<INT4>, tm, x, ldx, w, scale, out, ldo, M, N, K, group, p, st);
  }
}

}  // namespace

// Plain C entries (bound with ctypes). Each returns a cudaError_t code,
// 0 = ok. x: [M, K] bf16 (f32 for the `_f32` entries) with row stride ldx
// (elements, a multiple of 8), out: [M, N] of x's type with row stride ldo;
// pointers 16-byte aligned (checked in Python). plan: the PLAN_FIELDS
// integers of `k5_plan(...).fields()` (with f32=True for the `_f32` entries).

// w: [>= N, K] int8 rows, K % 16 == 0; scale: [N] f32.
extern "C" int vgt_dequant_gemv_int8(
    const void* x, long long ldx, const void* w, const void* scale,
    void* out, long long ldo, int M, int N, int K, const int* plan,
    int nplan, void* stream) {
  return launch<false, false>(x, ldx, w, scale, out, ldo, M, N, K, 1, plan, nplan, stream);
}

extern "C" int vgt_dequant_gemv_int8_f32(
    const void* x, long long ldx, const void* w, const void* scale,
    void* out, long long ldo, int M, int N, int K, const int* plan,
    int nplan, void* stream) {
  return launch<false, true>(x, ldx, w, scale, out, ldo, M, N, K, 1, plan, nplan, stream);
}

// packed: [N, K/2] int8 bytes, K % 32 == 0; scales: [N, K/group] f32,
// group % 32 == 0 and K % group == 0.
extern "C" int vgt_dequant_gemv_int4(
    const void* x, long long ldx, const void* packed, const void* scales,
    void* out, long long ldo, int M, int N, int K, int group,
    const int* plan, int nplan, void* stream) {
  return launch<true, false>(x, ldx, packed, scales, out, ldo, M, N, K, group, plan,
                             nplan, stream);
}

extern "C" int vgt_dequant_gemv_int4_f32(
    const void* x, long long ldx, const void* packed, const void* scales,
    void* out, long long ldo, int M, int N, int K, int group,
    const int* plan, int nplan, void* stream) {
  return launch<true, true>(x, ldx, packed, scales, out, ldo, M, N, K, group, plan,
                            nplan, stream);
}
