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
// memory rate. Design, from K5 (dequant_gemv.cu): one warp per output
// channel streams that channel's contiguous row as 16-byte vectors with the
// streaming hint, the rows of x sit in shared memory, and the 32 lanes'
// partial sums meet in a shuffle reduction. Each entry is ONE launch of a
// persistent grid (as many blocks as the card holds at once) whose warps
// stride over the output channels; every block recomputes the RMS norm of
// the few rows of x from L2, which is cheaper than a launch of its own.
//
// The TPU grid walks the I-blocks one after the other on one core and adds
// into one accumulator. Here the sum over I crosses thread blocks, and the
// two MLP entries solve that with a cooperative launch and grid barriers,
// not with partial sums or atomics: phase 1 (all blocks) computes h for
// every column of I into a small global buffer, a grid barrier follows, and
// phase 2 (all blocks) is a row dot per output channel d over the whole of I.
// So every output element is summed by one warp in a fixed order: the result
// is the same from run to run. mlp_w8a8 has one phase more between the two:
// a warp per (row, group) takes the group's maximum and writes hq and hs, so
// that a group may span the columns of many blocks. Its integer sums are
// exact (s8 x s8 -> s32 through __dp4a), and its f32 epilogue is written with
// unfused multiplies and adds in the twin's order.
//
// Buffers (h, hq, hs) come from the caller, the launch goes to the caller's
// stream, and nothing synchronises: each entry captures into a CUDA graph.
// Later work: tensor cores for M = 8, a split of a row over warps where D is
// not a multiple of the warp count, cp.async staging.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;
constexpr int NTHREADS = WARPS * 32;

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float sigmoidf(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Sum / maximum over the block; every thread gets the result, summed in the
// same order in every block.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t += red[w];
  __syncthreads();
  return t;
}
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t = fmaxf(t, red[w]);
  __syncthreads();
  return t;
}

// 1 / sqrt(mean(x[m]^2) + eps) of row m (0 for a row past M), `_rmsnorm_block`
// (:71) in f32.
__device__ __forceinline__ float row_rstd(const __nv_bfloat16* x, long long ldx,
                                          int m, int M, int K, float eps,
                                          float* red) {
  float ss = 0.f;
  if (m < M) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + (long long)m * ldx);
    for (int c = threadIdx.x; c < K / 8; c += NTHREADS) {
      const uint4 v = xv[c];
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = bf16_lo(w[i]), b = bf16_hi(w[i]);
        ss = fmaf(a, a, ss);
        ss = fmaf(b, b, ss);
      }
    }
  }
  ss = block_sum(ss, red);
  return rsqrtf(ss / static_cast<float>(K) + eps);
}

// rmsnorm(x) * nw of rows 0 .. MT-1, rounded to bf16, into shared memory
// [MT][K] (zeros past M).
template <int MT>
__device__ __forceinline__ void stage_norm_bf16(
    __nv_bfloat16* sx, const __nv_bfloat16* x, long long ldx, const float* nw,
    int M, int K, float eps, float* red) {
  for (int m = 0; m < MT; ++m) {
    const float r = row_rstd(x, ldx, m, M, K, eps, red);
    for (int k = threadIdx.x; k < K; k += NTHREADS) {
      float v = 0.f;
      if (m < M)
        v = __bfloat162float(x[(long long)m * ldx + k]) * r * nw[k];
      sx[(long long)m * K + k] = __float2bfloat16(v);
    }
  }
  __syncthreads();
}

// rows 0 .. MT-1 of a bf16 matrix (row stride ld elements, width W, W % 8 ==
// 0) -> shared memory [MT][W], zeros past M. `Coherent` reads through L2:
// for data that other blocks of this launch wrote before a grid barrier.
template <int MT, bool Coherent>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* sx,
                                           const __nv_bfloat16* src,
                                           long long ld, int M, int W) {
  const int wv = W / 8;
  for (int i = threadIdx.x; i < MT * wv; i += NTHREADS) {
    const int mi = i / wv, c = i - mi * wv;
    int4 v = make_int4(0, 0, 0, 0);
    if (mi < M) {
      const int4* p = reinterpret_cast<const int4*>(src + (long long)mi * ld) + c;
      v = Coherent ? __ldcg(p) : *p;
    }
    *reinterpret_cast<int4*>(sx + (long long)mi * W + c * 8) = v;
  }
  __syncthreads();
}

// acc[r][m] += sum_k f32(w_r[k]) * f32(sx[m][k]) over this lane's share of
// the NR int8 rows' 16-byte vectors; sx: [MT][K] bf16 in shared memory.
template <int MT, int NR, int UNROLL>
__device__ __forceinline__ void dot_bf16(const int4* const (&rows)[NR],
                                         const __nv_bfloat16* sx, int K,
                                         int lane, float (&acc)[NR][MT]) {
  const int nvec = K / 16;
  for (int v0 = lane; v0 < nvec; v0 += 32 * UNROLL) {
    int4 wv[UNROLL][NR];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * 32;
#pragma unroll
      for (int r = 0; r < NR; ++r)
        wv[u][r] = v < nvec ? __ldcs(rows[r] + v) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * 32;
      if (v >= nvec) continue;
      float wf[NR][16];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const int words[4] = {wv[u][r].x, wv[u][r].y, wv[u][r].z, wv[u][r].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            wf[r][4 * i + b] = static_cast<float>(
                static_cast<int8_t>((words[i] >> (8 * b)) & 0xff));
        }
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int4* xs =
            reinterpret_cast<const int4*>(sx + (long long)mi * K + v * 16);
        const int4 xa = xs[0], xb = xs[1];
        const uint32_t xw[8] = {(uint32_t)xa.x, (uint32_t)xa.y, (uint32_t)xa.z,
                                (uint32_t)xa.w, (uint32_t)xb.x, (uint32_t)xb.y,
                                (uint32_t)xb.z, (uint32_t)xb.w};
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          float a = acc[r][mi];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            a = fmaf(bf16_lo(xw[i]), wf[r][2 * i], a);
            a = fmaf(bf16_hi(xw[i]), wf[r][2 * i + 1], a);
          }
          acc[r][mi] = a;
        }
      }
    }
  }
}

// acc[r][m] += sum_k s32(w_r[k]) * s32(sq[m][k]) over this lane's share of
// vectors [v_lo, v_hi) of the NR int8 rows; sq: [MT][ldq] int8 in shared
// memory. Exact.
template <int MT, int NR>
__device__ __forceinline__ void dot_s8(const int4* const (&rows)[NR],
                                       const int8_t* sq, int ldq, int v_lo,
                                       int v_hi, int lane,
                                       int (&acc)[NR][MT]) {
  for (int v0 = v_lo + lane; v0 < v_hi; v0 += 64) {
    int4 wv[2][NR];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int v = v0 + u * 32;
#pragma unroll
      for (int r = 0; r < NR; ++r)
        wv[u][r] = v < v_hi ? __ldcs(rows[r] + v) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int v = v0 + u * 32;
      if (v >= v_hi) continue;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int4 xq = *reinterpret_cast<const int4*>(
            sq + (long long)mi * ldq + v * 16);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          int a = acc[r][mi];
          a = __dp4a(wv[u][r].x, xq.x, a);
          a = __dp4a(wv[u][r].y, xq.y, a);
          a = __dp4a(wv[u][r].z, xq.z, a);
          a = __dp4a(wv[u][r].w, xq.w, a);
          acc[r][mi] = a;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// norm_matmul and matmul_residual: no barrier, warps stride over N
// ---------------------------------------------------------------------------
template <int MT, bool NORM>
__global__ void __launch_bounds__(NTHREADS, 1)
row_matmul_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                  const float* __restrict__ nw, const int8_t* __restrict__ w,
                  const float* __restrict__ scale,
                  const __nv_bfloat16* __restrict__ res, long long ldr,
                  __nv_bfloat16* __restrict__ out, long long ldo, int M, int N,
                  int K, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[WARPS];
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  if (NORM)
    stage_norm_bf16<MT>(sx, x, ldx, nw, M, K, eps, red);
  else
    stage_rows<MT, false>(sx, x, ldx, M, K);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int n = blockIdx.x * WARPS + warp; n < N; n += gridDim.x * WARPS) {
    const int4* const rows[1] = {
        reinterpret_cast<const int4*>(w + (long long)n * K)};
    float acc[1][MT];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) acc[0][mi] = 0.f;
    dot_bf16<MT, 1, 4>(rows, sx, K, lane, acc);
    const float s = scale[n];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const float total = warp_sum(acc[0][mi]);
      if (lane == 0 && mi < M) {
        float y = total * s;
        if (!NORM) y += __bfloat162float(res[(long long)mi * ldr + n]);
        out[(long long)mi * ldo + n] = __float2bfloat16(y);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// mlp: norm -> gate/up -> GLU | grid barrier | down + residual
// ---------------------------------------------------------------------------
template <int MT>
__global__ void __launch_bounds__(NTHREADS, 1)
mlp_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
           const float* __restrict__ nw, const int8_t* __restrict__ wgu,
           const float* __restrict__ sgu, const int8_t* __restrict__ wd,
           const float* __restrict__ sd, __nv_bfloat16* hbuf,
           __nv_bfloat16* __restrict__ out, long long ldo, int M, int K, int I,
           int D, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[WARPS];
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = blockIdx.x * WARPS + warp, nw_all = gridDim.x * WARPS;

  stage_norm_bf16<MT>(sx, x, ldx, nw, M, K, eps, red);
  for (int i = gw; i < I; i += nw_all) {
    const int4* const rows[2] = {
        reinterpret_cast<const int4*>(wgu + (long long)i * K),
        reinterpret_cast<const int4*>(wgu + (long long)(I + i) * K)};
    float acc[2][MT];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) acc[0][mi] = acc[1][mi] = 0.f;
    dot_bf16<MT, 2, (MT == 8 ? 1 : 2)>(rows, sx, K, lane, acc);
    const float sg = sgu[i], su = sgu[I + i];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      // the projections land in bf16 before the GLU (:96-100)
      const float g = round_bf16(warp_sum(acc[0][mi]) * sg);
      const float u = round_bf16(warp_sum(acc[1][mi]) * su);
      if (lane == 0 && mi < M)
        hbuf[(long long)mi * I + i] = __float2bfloat16(g * sigmoidf(g) * u);
    }
  }
  grid.sync();

  stage_rows<MT, true>(sx, hbuf, I, M, I);
  for (int d = gw; d < D; d += nw_all) {
    const int4* const rows[1] = {
        reinterpret_cast<const int4*>(wd + (long long)d * I)};
    float acc[1][MT];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) acc[0][mi] = 0.f;
    dot_bf16<MT, 1, 4>(rows, sx, I, lane, acc);
    const float s = sd[d];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const float total = warp_sum(acc[0][mi]);
      if (lane == 0 && mi < M)
        out[(long long)mi * ldo + d] = __float2bfloat16(
            total * s + __bfloat162float(x[(long long)mi * ldx + d]));
    }
  }
}

// ---------------------------------------------------------------------------
// mlp_w8a8: norm + row quant -> s8 gate/up -> GLU in f32 | barrier | group
// quant of h | barrier | s8 down per group, f32 epilogue + residual
// ---------------------------------------------------------------------------
__device__ __forceinline__ float quant_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-6f), 1.0f / 127.0f);
}
__device__ __forceinline__ int quant_code(float v, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f));
}

template <int MT>
__global__ void __launch_bounds__(NTHREADS, 1)
mlp_w8a8_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                const float* __restrict__ nw, const int8_t* __restrict__ wgu,
                const float* __restrict__ sgu, const int8_t* __restrict__ wd,
                const float* __restrict__ sd, float* hf, int8_t* hq, float* hs,
                __nv_bfloat16* __restrict__ out, long long ldo, int M, int K,
                int I, int D, int group, float eps, int8_t* dbg_xq,
                float* dbg_xs, int* dbg_gu, int* dbg_down) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[WARPS];
  __shared__ float xs[MT];
  int8_t* sq = reinterpret_cast<int8_t*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = blockIdx.x * WARPS + warp, nw_all = gridDim.x * WARPS;
  const int G = I / group;

  // the normalised row in f32, quantised once: amax first, then the codes
  // from the same expression (bit-equal in every block)
  for (int m = 0; m < MT; ++m) {
    const float r = row_rstd(x, ldx, m, M, K, eps, red);
    float amax = 0.f;
    if (m < M)
      for (int k = threadIdx.x; k < K; k += NTHREADS)
        amax = fmaxf(amax, fabsf(__fmul_rn(
            __fmul_rn(__bfloat162float(x[(long long)m * ldx + k]), r), nw[k])));
    amax = block_max(amax, red);
    const float s = quant_scale(amax);
    if (threadIdx.x == 0) xs[m] = s;
    for (int k = threadIdx.x; k < K; k += NTHREADS) {
      int q = 0;
      if (m < M)
        q = quant_code(__fmul_rn(__fmul_rn(
            __bfloat162float(x[(long long)m * ldx + k]), r), nw[k]), s);
      sq[(long long)m * K + k] = static_cast<int8_t>(q);
      if (dbg_xq != nullptr && blockIdx.x == 0 && m < M)
        dbg_xq[(long long)m * K + k] = static_cast<int8_t>(q);
    }
    if (dbg_xs != nullptr && blockIdx.x == 0 && threadIdx.x == 0 && m < M)
      dbg_xs[m] = s;
  }
  __syncthreads();

  for (int i = gw; i < I; i += nw_all) {
    const int4* const rows[2] = {
        reinterpret_cast<const int4*>(wgu + (long long)i * K),
        reinterpret_cast<const int4*>(wgu + (long long)(I + i) * K)};
    int acc[2][MT];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) acc[0][mi] = acc[1][mi] = 0;
    dot_s8<MT, 2>(rows, sq, K, 0, K / 16, lane, acc);
    const float sg = sgu[i], su = sgu[I + i];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int gi = warp_sum(acc[0][mi]), ui = warp_sum(acc[1][mi]);
      if (lane == 0 && mi < M) {
        const float g = __fmul_rn(static_cast<float>(gi), __fmul_rn(xs[mi], sg));
        const float u = __fmul_rn(static_cast<float>(ui), __fmul_rn(xs[mi], su));
        hf[(long long)mi * I + i] = __fmul_rn(__fmul_rn(g, sigmoidf(g)), u);
        if (dbg_gu != nullptr) {
          dbg_gu[(long long)mi * 2 * I + i] = gi;
          dbg_gu[(long long)mi * 2 * I + I + i] = ui;
        }
      }
    }
  }
  grid.sync();

  // one warp per (row, group): the group's maximum, its scale and its codes
  for (int unit = gw; unit < M * G; unit += nw_all) {
    const int m = unit / G, g = unit - m * G;
    const float* hrow = hf + (long long)m * I + (long long)g * group;
    float amax = 0.f;
    for (int c = lane; c < group; c += 32) amax = fmaxf(amax, fabsf(__ldcg(hrow + c)));
    amax = warp_max(amax);
    const float s = quant_scale(amax);
    if (lane == 0) hs[m * G + g] = s;
    for (int c = lane; c < group; c += 32)
      hq[(long long)m * I + (long long)g * group + c] =
          static_cast<int8_t>(quant_code(__ldcg(hrow + c), s));
  }
  grid.sync();

  // hq rows -> shared memory [MT][I] int8 (zeros past M)
  for (int i = threadIdx.x; i < MT * (I / 16); i += NTHREADS) {
    const int mi = i / (I / 16), c = i - mi * (I / 16);
    int4 v = make_int4(0, 0, 0, 0);
    if (mi < M)
      v = __ldcg(reinterpret_cast<const int4*>(hq + (long long)mi * I) + c);
    *reinterpret_cast<int4*>(sq + (long long)mi * I + c * 16) = v;
  }
  __syncthreads();
  for (int d = gw; d < D; d += nw_all) {
    const int4* const rows[1] = {
        reinterpret_cast<const int4*>(wd + (long long)d * I)};
    float acc[MT];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) acc[mi] = 0.f;
    for (int g = 0; g < G; ++g) {
      int part[1][MT];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) part[0][mi] = 0;
      dot_s8<MT, 1>(rows, sq, I, g * (group / 16), (g + 1) * (group / 16), lane,
                    part);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int total = warp_sum(part[0][mi]);
        if (mi < M) {
          acc[mi] = __fadd_rn(acc[mi], __fmul_rn(static_cast<float>(total),
                                                 __ldcg(hs + mi * G + g)));
          if (dbg_down != nullptr && lane == 0)
            dbg_down[((long long)g * M + mi) * D + d] = total;
        }
      }
    }
    const float s = sd[d];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
      if (lane == 0 && mi < M)
        out[(long long)mi * ldo + d] = __float2bfloat16(__fadd_rn(
            __fmul_rn(acc[mi], s),
            __bfloat162float(x[(long long)mi * ldx + d])));
  }
}

constexpr size_t kMaxSmem = 232448;    // dynamic shared memory a block can use

// Raise the kernel's shared-memory limit where needed and return the number
// of blocks the card holds at once (0 and an error code on failure).
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem, int* blocks) {
  *blocks = 0;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  // the kernels also hold a few static words, so the default limit of 48 KB
  // is passed a little below 48 KB of dynamic memory
  if (smem > 47 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, NTHREADS, smem)) != cudaSuccess)
    return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  *blocks = sms * per_sm;
  return 0;
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
inline int row_tile(int M) { return M == 1 ? 1 : M == 2 ? 2 : M <= 4 ? 4 : 8; }

template <int MT, bool NORM>
int launch_row_matmul(const void* x, long long ldx, const void* nw,
                      const void* w, const void* scale, const void* res,
                      long long ldr, void* out, long long ldo, int M, int N,
                      int K, float eps, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(MT) * K * sizeof(__nv_bfloat16);
  int blocks = 0;
  if (int err = resident_blocks(row_matmul_kernel<MT, NORM>, smem, &blocks))
    return err;
  const int grid = blocks < ceil_div(N, WARPS) ? blocks : ceil_div(N, WARPS);
  row_matmul_kernel<MT, NORM><<<grid, NTHREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), ldx, static_cast<const float*>(nw),
      static_cast<const int8_t*>(w), static_cast<const float*>(scale),
      static_cast<const __nv_bfloat16*>(res), ldr,
      static_cast<__nv_bfloat16*>(out), ldo, M, N, K, eps);
  return static_cast<int>(cudaGetLastError());
}

template <bool NORM>
int dispatch_row_matmul(const void* x, long long ldx, const void* nw,
                        const void* w, const void* scale, const void* res,
                        long long ldr, void* out, long long ldo, int M, int N,
                        int K, float eps, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (M > 8 || K <= 0 || K % 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (row_tile(M)) {
    case 1: return launch_row_matmul<1, NORM>(x, ldx, nw, w, scale, res, ldr, out, ldo, M, N, K, eps, st);
    case 2: return launch_row_matmul<2, NORM>(x, ldx, nw, w, scale, res, ldr, out, ldo, M, N, K, eps, st);
    case 4: return launch_row_matmul<4, NORM>(x, ldx, nw, w, scale, res, ldr, out, ldo, M, N, K, eps, st);
    default: return launch_row_matmul<8, NORM>(x, ldx, nw, w, scale, res, ldr, out, ldo, M, N, K, eps, st);
  }
}

template <int MT>
int launch_mlp(const void* x, long long ldx, const void* nw, const void* wgu,
               const void* sgu, const void* wd, const void* sd, void* hbuf,
               void* out, long long ldo, int M, int K, int I, int D, float eps,
               cudaStream_t st) {
  const size_t smem =
      static_cast<size_t>(MT) * (K > I ? K : I) * sizeof(__nv_bfloat16);
  int blocks = 0;
  if (int err = resident_blocks(mlp_kernel<MT>, smem, &blocks)) return err;
  const int most = ceil_div(I > D ? I : D, WARPS);
  const int grid = blocks < most ? blocks : most;
  void* args[] = {&x, &ldx, &nw, &wgu, &sgu, &wd, &sd, &hbuf,
                  &out, &ldo, &M, &K, &I, &D, &eps};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(mlp_kernel<MT>), dim3(grid), dim3(NTHREADS), args,
      smem, st));
}

template <int MT>
int launch_mlp_w8a8(const void* x, long long ldx, const void* nw,
                    const void* wgu, const void* sgu, const void* wd,
                    const void* sd, void* hf, void* hq, void* hs, void* out,
                    long long ldo, int M, int K, int I, int D, int group,
                    float eps, void* dbg_xq, void* dbg_xs, void* dbg_gu,
                    void* dbg_down, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(MT) * (K > I ? K : I);
  int blocks = 0;
  if (int err = resident_blocks(mlp_w8a8_kernel<MT>, smem, &blocks)) return err;
  const int most = ceil_div(I > D ? I : D, WARPS);
  const int grid = blocks < most ? blocks : most;
  void* args[] = {&x, &ldx, &nw, &wgu, &sgu, &wd, &sd, &hf, &hq, &hs, &out,
                  &ldo, &M, &K, &I, &D, &group, &eps, &dbg_xq, &dbg_xs, &dbg_gu,
                  &dbg_down};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(mlp_w8a8_kernel<MT>), dim3(grid), dim3(NTHREADS),
      args, smem, st));
}

}  // namespace

// Plain C entries (bound with ctypes). Each returns a cudaError_t code,
// 0 = ok. x: [M, K] bf16 with row stride ldx (elements, a multiple of 8),
// M <= 8; out: bf16 with row stride ldo; weights int8 rows of K (resp. I)
// contiguous bytes, a multiple of 16; pointers 16-byte aligned (checked in
// Python).

// w: [>= N, K] int8; scale: [N] f32; nw: [K] f32 -> out [M, N].
extern "C" int vgt_decode_norm_matmul(
    const void* x, long long ldx, const void* nw, const void* w,
    const void* scale, void* out, long long ldo, int M, int N, int K, float eps,
    void* stream) {
  return dispatch_row_matmul<true>(x, ldx, nw, w, scale, nullptr, 0, out, ldo,
                                   M, N, K, eps, stream);
}

// res: [M, N] bf16 with row stride ldr -> out [M, N].
extern "C" int vgt_decode_matmul_residual(
    const void* x, long long ldx, const void* w, const void* scale,
    const void* res, long long ldr, void* out, long long ldo, int M, int N,
    int K, void* stream) {
  return dispatch_row_matmul<false>(x, ldx, nullptr, w, scale, res, ldr, out,
                                    ldo, M, N, K, 0.f, stream);
}

// wgu: [2I, K] int8 (gate rows, then up rows), sgu: [2I]; wd: [>= D, I] int8,
// sd: [D]; hbuf: [M, I] bf16 scratch -> out [M, D] (D == K: the residual is x).
extern "C" int vgt_decode_mlp(
    const void* x, long long ldx, const void* nw, const void* wgu,
    const void* sgu, const void* wd, const void* sd, void* hbuf, void* out,
    long long ldo, int M, int K, int I, int D, float eps, void* stream) {
  if (M <= 0) return 0;
  if (M > 8 || K <= 0 || K % 16 || I <= 0 || I % 16 || D != K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (row_tile(M)) {
    case 1: return launch_mlp<1>(x, ldx, nw, wgu, sgu, wd, sd, hbuf, out, ldo, M, K, I, D, eps, st);
    case 2: return launch_mlp<2>(x, ldx, nw, wgu, sgu, wd, sd, hbuf, out, ldo, M, K, I, D, eps, st);
    case 4: return launch_mlp<4>(x, ldx, nw, wgu, sgu, wd, sd, hbuf, out, ldo, M, K, I, D, eps, st);
    default: return launch_mlp<8>(x, ldx, nw, wgu, sgu, wd, sd, hbuf, out, ldo, M, K, I, D, eps, st);
  }
}

// hf: [M, I] f32, hq: [M, I] int8, hs: [M, I / group] f32 scratch; group: the
// columns of I that share one activation scale (I % group == 0, group % 16 ==
// 0). dbg_*: null, or buffers that receive the row codes [M, K] int8 and
// scales [M] f32, the gate/up sums [M, 2I] s32 and the per-group down sums
// [I / group, M, D] s32.
extern "C" int vgt_decode_mlp_w8a8(
    const void* x, long long ldx, const void* nw, const void* wgu,
    const void* sgu, const void* wd, const void* sd, void* hf, void* hq,
    void* hs, void* out, long long ldo, int M, int K, int I, int D, int group,
    float eps, void* dbg_xq, void* dbg_xs, void* dbg_gu, void* dbg_down,
    void* stream) {
  if (M <= 0) return 0;
  if (M > 8 || K <= 0 || K % 16 || I <= 0 || I % 16 || D != K || group <= 0 ||
      group % 16 || I % group)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (row_tile(M)) {
    case 1: return launch_mlp_w8a8<1>(x, ldx, nw, wgu, sgu, wd, sd, hf, hq, hs, out, ldo, M, K, I, D, group, eps, dbg_xq, dbg_xs, dbg_gu, dbg_down, st);
    case 2: return launch_mlp_w8a8<2>(x, ldx, nw, wgu, sgu, wd, sd, hf, hq, hs, out, ldo, M, K, I, D, group, eps, dbg_xq, dbg_xs, dbg_gu, dbg_down, st);
    case 4: return launch_mlp_w8a8<4>(x, ldx, nw, wgu, sgu, wd, sd, hf, hq, hs, out, ldo, M, K, I, D, group, eps, dbg_xq, dbg_xs, dbg_gu, dbg_down, st);
    default: return launch_mlp_w8a8<8>(x, ldx, nw, wgu, sgu, wd, sd, hf, hq, hs, out, ldo, M, K, I, D, group, eps, dbg_xq, dbg_xs, dbg_gu, dbg_down, st);
  }
}
