// K2 in full f32: the GEMM with a fused epilogue for a model whose compute
// dtype is f32.
//
//   out[M,N] = act(A[M,K] @ W[N,K]^T + bias[N]) (+ residual[M,N])
//
// Replaces, for f32 operands, the matmul stages of the fused Hiera
// window-block Pallas kernel (videoglamm_tpu/ops/fused_block.py `_kernel`
// :108, launched by `_fused_block_fwd` :203), as K2 (csrc/gemm_epilogue.cu)
// does in bf16: the qkv projection + bias, the output projection + bias +
// residual, fc1 + bias + GELU and fc2 + bias + residual. In f32 nothing is
// rounded between the stages (fused_block.py:83-105 rounds to the working
// dtype, which is f32 here), and GELU is the erf form through the
// Abramowitz & Stegun 7.1.26 polynomial of fused_block.py:39-59 (not
// erff), as the port's `_erf_as` computes it.
//
// Bound: operations. Every product is an f32 FFMA on the CUDA cores, whose
// peak is 67 TFLOP/s; at Hiera's widths (K = 144 to 4608) a tile does 2 * K
// operations per output against 4 * K bytes read once per tile row, so the
// bytes are not the limit.
//
// Design (a simple kernel that is right first): the classic register-blocked
// SIMT GEMM. A CTA of 256 threads owns a 128 x 128 output tile and walks K
// in chunks of 8. A's and W's chunks (both K-major in memory: one 16-byte
// load a thread each) are stored transposed, k-major, in shared memory, so
// each thread reads four 16-byte vectors a step (rows ty*4 and 64 + ty*4,
// columns tx*4 and 64 + tx*4) and does 64 FFMA on its 8 x 8 outputs. The
// next chunk is loaded into registers while the current one is multiplied,
// into the other of two shared-memory buffers (one barrier a chunk). Rows
// past M and columns past N are loaded as zeros and not stored; K must be a
// multiple of 8 and N of 8 (the wrapper checks both, as for K2).
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 8;
constexpr int THREADS = 256;
constexpr int PAD = 4;                 // row pitch BM + 4 floats: the transposed
                                       // stores of a warp hit 32 banks
constexpr int PITCH = BM + PAD;

inline cudaError_t use_device_of(const void* p) {
  cudaPointerAttributes a;
  const cudaError_t e = cudaPointerGetAttributes(&a, p);
  return e != cudaSuccess ? e : cudaSetDevice(a.device);
}

// Abramowitz & Stegun 7.1.26 (fused_block.py:39-51)
__device__ __forceinline__ float erf_as(float x) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f,
              a4 = -1.453152027f, a5 = 1.061405429f;
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * ax);
  const float poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t;
  return s * (1.0f - poly * expf(-ax * ax));
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erf_as(x * 0.7071067811865476f));
}

struct Params {
  const float* a; long long lda;
  const float* w;
  const float* bias;
  const float* res; long long ldr;
  float* out; long long ldo;
  int M, N, K, act;
};

__global__ void __launch_bounds__(THREADS) gemm_f32_kernel(const Params p) {
  __shared__ __align__(16) float sA[2][BK][PITCH];
  __shared__ __align__(16) float sW[2][BK][PITCH];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  // the chunk a thread loads: row tid / 2, columns (tid % 2) * 4 .. + 4
  const int lr = tid >> 1, lk = (tid & 1) * 4;
  const bool a_ok = m0 + lr < p.M, w_ok = n0 + lr < p.N;
  const float* ag = p.a + (m0 + lr) * p.lda + lk;
  const float* wg = p.w + static_cast<long long>(n0 + lr) * p.K + lk;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 ra = a_ok ? *reinterpret_cast<const float4*>(ag) : zero;
  float4 rw = w_ok ? *reinterpret_cast<const float4*>(wg) : zero;
  auto stash = [&](int buf) {
    sA[buf][lk + 0][lr] = ra.x; sA[buf][lk + 1][lr] = ra.y;
    sA[buf][lk + 2][lr] = ra.z; sA[buf][lk + 3][lr] = ra.w;
    sW[buf][lk + 0][lr] = rw.x; sW[buf][lk + 1][lr] = rw.y;
    sW[buf][lk + 2][lr] = rw.z; sW[buf][lk + 3][lr] = rw.w;
  };
  stash(0);
  __syncthreads();

  const int nk = p.K / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      ra = a_ok ? *reinterpret_cast<const float4*>(ag + (kt + 1) * BK) : zero;
      rw = w_ok ? *reinterpret_cast<const float4*>(wg + (kt + 1) * BK) : zero;
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sA[buf][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sA[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sW[buf][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sW[buf][k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) stash(buf ^ 1);
    __syncthreads();
  }

  // epilogue: rows ty*4 + i (+ 64), columns tx*4 .. + 4 (+ 64); N % 8 == 0,
  // so a group of four columns is inside N or wholly past it
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= p.M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = n0 + half * 64 + tx * 4;
      if (col >= p.N) continue;
      float y[4] = {acc[i][half * 4 + 0], acc[i][half * 4 + 1],
                    acc[i][half * 4 + 2], acc[i][half * 4 + 3]};
      if (p.bias != nullptr) {
        const float4 bb = *reinterpret_cast<const float4*>(p.bias + col);
        y[0] += bb.x; y[1] += bb.y; y[2] += bb.z; y[3] += bb.w;
      }
      if (p.act) {
#pragma unroll
        for (int c = 0; c < 4; ++c) y[c] = gelu_erf(y[c]);
      }
      if (p.res != nullptr) {
        const float4 r = *reinterpret_cast<const float4*>(p.res + row * p.ldr + col);
        y[0] = r.x + y[0]; y[1] = r.y + y[1]; y[2] = r.z + y[2]; y[3] = r.w + y[3];
      }
      *reinterpret_cast<float4*>(p.out + row * p.ldo + col) =
          make_float4(y[0], y[1], y[2], y[3]);
    }
  }
}

}  // namespace

// The signature of vgt_gemm_epilogue (csrc/gemm_epilogue.cu), on f32
// tensors: a [M,K] rows lda apart; w contiguous [N,K]; bias [N] or null;
// res [M,N] rows ldr apart or null; out [M,N] rows ldo apart; act 1 = GELU.
// K and N multiples of 8, every row 16-byte aligned.
extern "C" int vgt_gemm_f32(
    const void* a, long long lda, const void* w, const void* bias,
    const void* res, long long ldr, void* out, long long ldo,
    int M, int N, int K, int act, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % BK || N % 8) return cudaErrorInvalidValue;
  Params p;
  p.a = static_cast<const float*>(a); p.lda = lda;
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.res = static_cast<const float*>(res); p.ldr = ldr;
  p.out = static_cast<float*>(out); p.ldo = ldo;
  p.M = M; p.N = N; p.K = K; p.act = act;
  const cudaError_t e = use_device_of(a);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((N + BN - 1) / BN));
  gemm_f32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
