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
// high nibble; the nibbles are sign-extended as `_unpack4` (:112) does
// (hi = arithmetic shift of the byte, lo = ((b & 15) ^ 8) - 8) and multiplied
// by their group scale before the product with x.
//
// What bounds it on the H100: bytes. At M = 1 every weight byte is read once
// and used once, so the least time is the weight's size over the memory
// rate; the arithmetic (one convert and one FMA per weight) is far below the
// card's rate. Design: one warp per output channel, so a warp streams one
// contiguous row as 16-byte vectors (512 bytes per warp per load, four loads
// in flight per lane, read with the streaming hint since no byte is reused);
// x is staged once per block in shared memory as bf16; the 32 lanes' partial
// sums meet in a shuffle reduction; rows of x are taken in tiles of MT so
// that a weight vector loaded once serves MT rows. N needs no alignment
// (the lm_head has 32065 rows): rows are independent and K alone is
// vectorised.
// Later work: several channels per warp for short rows, the byte-permute
// int8 -> f32 conversion, and a split over K for the narrow projections.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;               // output channels per block
constexpr int NTHREADS = WARPS * 32;
constexpr int UNROLL = 4;              // weight vectors in flight per lane

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// x rows m0 .. m0+MT-1 -> shared memory [MT][K] bf16 (zeros past M)
template <int MT>
__device__ __forceinline__ void stage_x(__nv_bfloat16* sx,
                                        const __nv_bfloat16* x, long long ldx,
                                        int m0, int M, int K) {
  const int kv8 = K / 8;
  for (int i = threadIdx.x; i < MT * kv8; i += NTHREADS) {
    const int mi = i / kv8, c = i - mi * kv8;
    int4 v = make_int4(0, 0, 0, 0);
    if (m0 + mi < M)
      v = *reinterpret_cast<const int4*>(x + (long long)(m0 + mi) * ldx + c * 8);
    *reinterpret_cast<int4*>(sx + (long long)mi * K + c * 8) = v;
  }
  __syncthreads();
}

template <int MT>
__global__ void __launch_bounds__(NTHREADS)
gemv_int8_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                 const int8_t* __restrict__ w, const float* __restrict__ scale,
                 __nv_bfloat16* __restrict__ out, long long ldo,
                 int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int m0 = blockIdx.y * MT;
  stage_x<MT>(sx, x, ldx, m0, M, K);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + warp;
  if (n >= N) return;                   // whole warps leave together
  const int4* wrow = reinterpret_cast<const int4*>(w + (long long)n * K);
  const int nvec = K / 16;              // 16 int8 weights per vector

  float acc[MT];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) acc[mi] = 0.f;

  for (int v0 = lane; v0 < nvec; v0 += 32 * UNROLL) {
    int4 wv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * 32;
      wv[u] = v < nvec ? __ldcs(wrow + v) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * 32;
      if (v >= nvec) continue;
      const int words[4] = {wv[u].x, wv[u].y, wv[u].z, wv[u].w};
      float wf[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          wf[4 * i + b] = static_cast<float>(
              static_cast<int8_t>((words[i] >> (8 * b)) & 0xff));
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int4* xs = reinterpret_cast<const int4*>(sx + (long long)mi * K + v * 16);
        const int4 xa = xs[0], xb = xs[1];
        const uint32_t xw[8] = {(uint32_t)xa.x, (uint32_t)xa.y, (uint32_t)xa.z,
                                (uint32_t)xa.w, (uint32_t)xb.x, (uint32_t)xb.y,
                                (uint32_t)xb.z, (uint32_t)xb.w};
        float a = acc[mi];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          a = fmaf(bf16_lo(xw[i]), wf[2 * i], a);
          a = fmaf(bf16_hi(xw[i]), wf[2 * i + 1], a);
        }
        acc[mi] = a;
      }
    }
  }

  const float s = scale[n];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    const float total = warp_sum(acc[mi]);
    if (lane == 0 && m0 + mi < M)
      out[(long long)(m0 + mi) * ldo + n] = __float2bfloat16(total * s);
  }
}

template <int MT>
__global__ void __launch_bounds__(NTHREADS)
gemv_int4_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                 const int8_t* __restrict__ packed,
                 const float* __restrict__ scales,
                 __nv_bfloat16* __restrict__ out, long long ldo,
                 int M, int N, int K, int group) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int m0 = blockIdx.y * MT;
  stage_x<MT>(sx, x, ldx, m0, M, K);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + warp;
  if (n >= N) return;
  const int4* wrow = reinterpret_cast<const int4*>(packed + (long long)n * (K / 2));
  const float* srow = scales + (long long)n * (K / group);
  const int nvec = K / 32;              // 16 bytes = 32 weights per vector

  float acc[MT];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) acc[mi] = 0.f;

  for (int v0 = lane; v0 < nvec; v0 += 32 * UNROLL) {
    int4 wv[UNROLL];
    float sg[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * 32;
      const bool live = v < nvec;
      wv[u] = live ? __ldcs(wrow + v) : make_int4(0, 0, 0, 0);
      // a vector's 32 weights lie in one group (group % 32 == 0)
      sg[u] = live ? __ldg(srow + (v * 32) / group) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * 32;
      if (v >= nvec) continue;
      const int words[4] = {wv[u].x, wv[u].y, wv[u].z, wv[u].w};
      float wl[16], wh[16];             // even k (low nibble), odd k (high)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int byte = static_cast<int8_t>((words[i] >> (8 * b)) & 0xff);
          wl[4 * i + b] = static_cast<float>(((byte & 15) ^ 8) - 8) * sg[u];
          wh[4 * i + b] = static_cast<float>(byte >> 4) * sg[u];
        }
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int4* xs = reinterpret_cast<const int4*>(sx + (long long)mi * K + v * 32);
        float a = acc[mi];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int4 xv = xs[j];
          const uint32_t xw[4] = {(uint32_t)xv.x, (uint32_t)xv.y,
                                  (uint32_t)xv.z, (uint32_t)xv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // word 4j+i holds x[k0 + 2r] (low half) and x[k0 + 2r + 1]
            a = fmaf(bf16_lo(xw[i]), wl[4 * j + i], a);
            a = fmaf(bf16_hi(xw[i]), wh[4 * j + i], a);
          }
        }
        acc[mi] = a;
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    const float total = warp_sum(acc[mi]);
    if (lane == 0 && m0 + mi < M)
      out[(long long)(m0 + mi) * ldo + n] = __float2bfloat16(total);
  }
}

constexpr size_t kMaxSmem = 232448;    // dynamic shared memory a block can use

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

// Plain C entries (bound with ctypes). Each returns a cudaError_t code,
// 0 = ok. x: [M, K] bf16 with row stride ldx (elements, a multiple of 8),
// out: [M, N] bf16 with row stride ldo; pointers 16-byte aligned (checked in
// Python).

// w: [>= N, K] int8 rows, K % 16 == 0; scale: [N] f32.
extern "C" int vgt_dequant_gemv_int8(
    const void* x, long long ldx, const void* w, const void* scale,
    void* out, long long ldo, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 16) return static_cast<int>(cudaErrorInvalidValue);
  const int mt = M == 1 ? 1 : 4;
  const size_t smem = static_cast<size_t>(mt) * K * sizeof(__nv_bfloat16);
  dim3 grid((N + WARPS - 1) / WARPS, (M + mt - 1) / mt);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto wp = static_cast<const int8_t*>(w);
  auto sp = static_cast<const float*>(scale);
  auto op = static_cast<__nv_bfloat16*>(out);
  int err;
  if (mt == 1) {
    if ((err = prepare(gemv_int8_kernel<1>, smem))) return err;
    gemv_int8_kernel<1><<<grid, NTHREADS, smem, st>>>(xp, ldx, wp, sp, op, ldo, M, N, K);
  } else {
    if ((err = prepare(gemv_int8_kernel<4>, smem))) return err;
    gemv_int8_kernel<4><<<grid, NTHREADS, smem, st>>>(xp, ldx, wp, sp, op, ldo, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// packed: [N, K/2] int8 bytes, K % 32 == 0; scales: [N, K/group] f32,
// group % 32 == 0 and K % group == 0.
extern "C" int vgt_dequant_gemv_int4(
    const void* x, long long ldx, const void* packed, const void* scales,
    void* out, long long ldo, int M, int N, int K, int group, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 32 || group <= 0 || group % 32 || K % group)
    return static_cast<int>(cudaErrorInvalidValue);
  const int mt = M == 1 ? 1 : 4;
  const size_t smem = static_cast<size_t>(mt) * K * sizeof(__nv_bfloat16);
  dim3 grid((N + WARPS - 1) / WARPS, (M + mt - 1) / mt);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto wp = static_cast<const int8_t*>(packed);
  auto sp = static_cast<const float*>(scales);
  auto op = static_cast<__nv_bfloat16*>(out);
  int err;
  if (mt == 1) {
    if ((err = prepare(gemv_int4_kernel<1>, smem))) return err;
    gemv_int4_kernel<1><<<grid, NTHREADS, smem, st>>>(xp, ldx, wp, sp, op, ldo, M, N, K, group);
  } else {
    if ((err = prepare(gemv_int4_kernel<4>, smem))) return err;
    gemv_int4_kernel<4><<<grid, NTHREADS, smem, st>>>(xp, ldx, wp, sp, op, ldo, M, N, K, group);
  }
  return static_cast<int>(cudaGetLastError());
}
