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
// f32, and nothing is rounded to bf16, as the Pallas bodies compute in f32
// (quant.py:43, :151-155). The tensor-core route would round x to bf16, so
// f32 runs on the CUDA cores at every M: `gemv_rows_kernel` with x staged
// from f32 and y stored in f32, its conversions and its int4 order (each
// 32-k slice scaled once) unchanged, one pass over the weights for every
// tile of up to F32_MT rows of x (tiles on grid.y). The Pallas kernels take
// 8-row tiles of x against blocks of weight columns; here a tile is 4 rows
// (x in f32 for 4 rows of K = 8192 is 128 KB of shared memory), so M = 64
// reads the weights 16 times.
//
// Measured on the card and not kept: the ring of bulk copies feeding the
// one-row route too, each warp on two rows of a stage (its consumers were
// bound by shared-memory traffic and latency, and lost to direct loads with
// more warps); x read unpermuted (4- to 32-way bank conflicts); rows
// assigned to CTAs strided instead of contiguous (no difference); a CTA's
// first rows bulk-copied to shared memory before the wait (slower).
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

#include "sm90_common.cuh"
#include "mma_common.cuh"

constexpr int GROUP_ROWS = 16;         // rows of a stage
constexpr int F32_MT = 4;              // rows of x a pass takes with f32 x
constexpr int CONS_BAR = 1;            // named barrier of the consumer warps

// the plan's fields, in the order of `k5_plan(...).fields()`
struct Plan {
  int ctas, mt, m_tiles, kseg, nseg, stages, rstride, xstride;
  int x_off, s_off, red_off, ring_off, smem;
  int base, extra;                     // N = ctas * base + extra
  int vpr, vpr_mul;                    // 512-byte units a row (CUDA cores)
  int gdiv, gdiv_mul;                  // 32-k slices a scale group (int4)
  int per_sm;                          // CTAs an SM (the kernels' launch bounds)
};
constexpr int PLAN_FIELDS = 20;

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

// F32: x and out f32, the CUDA-core route in tiles of up to F32_MT rows
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
  const bool mma = !F32 && M > 3;
  const int mt = mma ? 8 : F32 ? (M < F32_MT ? M : F32_MT) : M;
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
  if (!mma) {
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
