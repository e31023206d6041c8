// K2: tiled bf16 GEMM with f32 accumulation and a fused epilogue, for
// Hopper (sm_90a), mma.sync m16n8k16 tensor-core tiles.
//
//   out[M,N] = act(round(round(A[M,K] @ W[N,K]^T) + bias[N])) (+ residual)
//
// Replaces the matmul stages of the fused Hiera window-block Pallas kernel
// (videoglamm_tpu/ops/fused_block.py `_kernel` :108, launched by
// `_fused_block_fwd` :203): the qkv projection + bias, the output
// projection + bias + residual, fc1 + bias + GELU and fc2 + bias +
// residual. Rounding follows the TPU kernel and its reference
// (fused_block.py:83-105): the f32 product is rounded to bf16, the bias is
// added and rounded, GELU (tanh form, the bf16 rule of fused_block.py:54-59)
// is applied and rounded, then the residual is added and rounded.
//
// What bounds it on the H100: at the Hiera shapes (M = 8 frames x tokens
// up to 524,288 rows, K and N from 144 to 4608) the products are
// tensor-core bound, and the epilogue (bias, GELU, residual) is memory
// traffic that an unfused version would pay as separate passes over
// [M,N]. Design: 128x128 CTA tiles, 8 warps of 64x32, BK=32, a two-stage
// cp.async pipeline that zero-fills ragged edges, and the whole epilogue
// applied from registers so each output element is written once.
// Later work: fuse the whole block into one launch (ROADMAP.md), wgmma/TMA.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int LDT = BK + 8;     // padded shared row stride (elements)
constexpr int NTHREADS = 256;   // 8 warps: 2 (M) x 4 (N), 64x32 each

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16-byte async copy global -> shared; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;   // sqrt(2/pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

struct Params {
  const __nv_bfloat16* a; long long lda;
  const __nv_bfloat16* w;               // [N, K], rows contiguous (nn.Linear)
  const __nv_bfloat16* bias;            // [N] or null
  const __nv_bfloat16* res; long long ldr;   // [M, N] or null
  __nv_bfloat16* out; long long ldo;
  int M, N, K, act;
};

__global__ void __launch_bounds__(NTHREADS) gemm_kernel(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 sA[2][BM * LDT];
  __shared__ __align__(16) __nv_bfloat16 sB[2][BN * LDT];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;

  auto load_tile = [&](int kt, int stage) {
    const int k0 = kt * BK;
    // 128 rows x 4 chunks of 8 elements per operand: 2 chunks per thread
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * NTHREADS;
      const int r = idx >> 2, c = (idx & 3) * 8;
      const int kk = k0 + c;
      const int ar = m0 + r, br = n0 + r;
      const bool a_ok = ar < p.M && kk < p.K;
      const bool b_ok = br < p.N && kk < p.K;
      cp_async16(&sA[stage][r * LDT + c],
                 a_ok ? p.a + ar * p.lda + kk : p.a, a_ok ? 16 : 0);
      cp_async16(&sB[stage][r * LDT + c],
                 b_ok ? p.w + (long long)br * p.K + kk : p.w, b_ok ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int nk = (p.K + BK - 1) / BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_tile(kt + 1, (kt + 1) & 1);
    cp_async_commit();   // possibly empty group keeps the count uniform
    cp_async_wait1();    // tile kt has landed
    __syncthreads();
    const __nv_bfloat16* A = sA[kt & 1];
    const __nv_bfloat16* Bt = sB[kt & 1];
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const __nv_bfloat16* base = A + (wm * 64 + mi * 16 + g) * LDT + ks * 16 + 2 * t;
        af[mi][0] = ld32(base);
        af[mi][1] = ld32(base + 8 * LDT);
        af[mi][2] = ld32(base + 8);
        af[mi][3] = ld32(base + 8 * LDT + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* base = Bt + (wn * 32 + ni * 8 + g) * LDT + ks * 16 + 2 * t;
        bf[ni][0] = ld32(base);
        bf[ni][1] = ld32(base + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
    __syncthreads();   // the stage is free for the load two tiles ahead
  }

  // fused epilogue from registers; N % 8 == 0 so column pairs stay in range
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t;
      if (col >= p.N) continue;
      float b0 = 0.f, b1 = 0.f;
      if (p.bias) {
        const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(p.bias + col);
        b0 = __low2float(bb);
        b1 = __high2float(bb);
      }
#pragma unroll
      for (int hrow = 0; hrow < 2; ++hrow) {
        const int row = m0 + wm * 64 + mi * 16 + g + hrow * 8;
        if (row >= p.M) continue;
        float y0 = bf16_round(acc[mi][ni][2 * hrow]);
        float y1 = bf16_round(acc[mi][ni][2 * hrow + 1]);
        if (p.bias) {
          y0 = bf16_round(y0 + b0);
          y1 = bf16_round(y1 + b1);
        }
        if (p.act == 1) {
          y0 = bf16_round(gelu_tanh(y0));
          y1 = bf16_round(gelu_tanh(y1));
        }
        if (p.res) {
          const __nv_bfloat162 rr =
              *reinterpret_cast<const __nv_bfloat162*>(p.res + row * p.ldr + col);
          y0 += __low2float(rr);
          y1 += __high2float(rr);
        }
        *reinterpret_cast<__nv_bfloat162*>(p.out + row * p.ldo + col) =
            __floats2bfloat162_rn(y0, y1);
      }
    }
  }
}

}  // namespace

// Plain C entry (bound with ctypes). Returns a cudaError_t code, 0 = ok.
// act: 0 = none, 1 = tanh GELU. Requires K % 8 == 0, N % 8 == 0, lda, ldr
// and ldo multiples of 8, 16-byte aligned pointers (checked in Python).
extern "C" int vgt_gemm_epilogue(
    const void* a, long long lda, const void* w, const void* bias,
    const void* res, long long ldr, void* out, long long ldo,
    int M, int N, int K, int act, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  Params p;
  p.a = static_cast<const __nv_bfloat16*>(a); p.lda = lda;
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.res = static_cast<const __nv_bfloat16*>(res); p.ldr = ldr;
  p.out = static_cast<__nv_bfloat16*>(out); p.ldo = ldo;
  p.M = M; p.N = N; p.K = K; p.act = act;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  gemm_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
