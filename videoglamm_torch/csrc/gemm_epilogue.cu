// K2: bf16 GEMM with f32 accumulation and a fused epilogue, for Hopper
// (sm_90a): TMA, an mbarrier ring, warp specialisation and wgmma.
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
// is applied and rounded, then the residual is added and rounded. The tanh
// is the hardware's `tanh.approx.f32` (relative error about 2^-11, below the
// bf16 rounding that follows it); at stage 1 the accurate tanhf alone would
// take longer than the whole byte bound. Each rounding converts a pair of
// values at once (the conversion unit, like tanh, issues at a quarter of the
// FMA rate, and at stage 1 the epilogue, not the product, is the work).
//
// What bounds it on the H100: Hiera's widths are 144 * 2^s. At stage 1
// (M = 8 frames x 65,536 tokens = 524,288 rows, K = 144) the products are
// memory-bound: A is read once and the output written once (fc1: 604 MB
// out); at stages 3 and 4 (K and N up to 4608) they are tensor-core bound.
// Design: a persistent grid, one CTA of three warpgroups an SM, walks the
// output tiles of 128 rows x BN columns with the column tiles of one row
// tile next to each other, so that the CTAs running together share their A
// tile through L2 and A is read from memory about once. BN = 144 wherever
// N is a multiple of 144 (every Hiera width), else 128. Warpgroup 2 is the
// producer: one thread keeps TMA loads of 64-column chunks of A [128 x 64]
// and W [BN x 64] (both K-major, 128-byte swizzle; the ragged K = 144 ends
// in a chunk that TMA fills with zeros) in flight into a 4-stage ring,
// across tile boundaries, so the next tile's loads overlap this tile's
// epilogue. Warpgroups 0 and 1 each own 64 rows and issue wgmma m64nBNk16
// chains, releasing a stage as soon as the chain that read it retires. The
// epilogue runs from the accumulators: the residual tile arrives by TMA into
// the output staging buffer during the main loop, the result is written
// over it in place and leaves by one TMA store a warpgroup (coalesced,
// clipped at M and N), which overlaps the next tile's main loop.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "sm90_common.cuh"

constexpr int BM = 128;          // rows a tile: two consumer warpgroups of 64
constexpr int BK = 64;           // reduction chunk: 128 bytes of bf16
constexpr int STAGES = 4;
constexpr int NTHREADS = 384;    // warpgroups 0, 1: consumers; 2: producer
constexpr int CHUNK_A = BM * 128;

template <int BN> struct Layout {
  static constexpr int CHUNK_W = BN * 128;           // a multiple of 1024
  static constexpr int STAGE = CHUNK_A + CHUNK_W;    // A, then W
  static constexpr int OUT = STAGES * STAGE;         // [BM][BN] bf16, rows dense
  static constexpr int BAR = OUT + BM * BN * 2;
  static constexpr int BYTES = BAR + 8 * (2 * STAGES + 2);
};

struct Params {
  const __nv_bfloat16* bias;   // [N] or null
  int M, N, K, act, has_res;
};

// Round two f32 values to bf16 with one packed conversion (the conversion
// unit issues a quarter as fast as the FMA pipes, and the epilogue rounds
// up to three times an element); back to f32 is a shift.
__device__ __forceinline__ __nv_bfloat162 round2(float& a, float& b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  a = __low2float(h);
  b = __high2float(h);
  return h;
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;   // sqrt(2/pi)
  return 0.5f * x * (1.f + tanh_approx(c * (x + 0.044715f * x * x * x)));
}

template <int BN>
__global__ void __launch_bounds__(NTHREADS, 1) gemm_sm90(
    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
    const __grid_constant__ CUtensorMap tout, const __grid_constant__ CUtensorMap tres,
    const Params p) {
  using L = Layout<BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* res_full = empty + STAGES;   // one a consumer warpgroup

  const int ntn = (p.N + BN - 1) / BN;
  const int ntiles = ((p.M + BM - 1) / BM) * ntn;
  const int nk = (p.K + BK - 1) / BK;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);
    }
    mbar_init(res_full, 1);
    mbar_init(res_full + 1, 1);
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = tid / 128;

  if (wg == 2) {
    // ---------------- producer: one thread issues every load
    reg_dealloc<40>();
    if (tid == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int m0 = (tile / ntn) * BM, n0 = (tile % ntn) * BN;
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full + s, L::STAGE);
          tma_load_2d(smem + s * L::STAGE, &ta, full + s, kc * BK, m0);
          tma_load_2d(smem + s * L::STAGE + CHUNK_A, &tw, full + s, kc * BK, n0);
        }
      }
    }
  } else {
    // ---------------- consumers: warpgroup wg owns rows m0 + 64 wg ..
    reg_alloc<232>();
    const int lt = tid % 128;
    const int warp = lt / 32, lane = lt % 32;
    const int g = lane / 4, t = lane % 4;
    unsigned char* sOut = smem + L::OUT + wg * 64 * BN * 2;
    int it = 0, ti = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++ti) {
      const int m0w = (tile / ntn) * BM + 64 * wg, n0 = (tile % ntn) * BN;
      if (lt == 0) {
        bulk_wait_read();   // the last tile's store has read the staging rows
        if (p.has_res) {
          mbar_expect_tx(res_full + wg, 64 * BN * 2);
          tma_load_2d(sOut, &tres, res_full + wg, n0, m0w);
        }
      }

      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = 0;
      for (int kc = 0; kc < nk; ++kc, ++it) {
        const int s = it % STAGES;
        mbar_wait(full + s, (it / STAGES) & 1);
        const unsigned char* sA = smem + s * L::STAGE + wg * 64 * 128;
        const unsigned char* sW = smem + s * L::STAGE + CHUNK_A;
        fence_regs<BN / 2>(acc);
        wgmma_fence();
        // all four k16 steps of a chunk: past K, TMA has filled zeros
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          Wgmma<BN>::ss(acc, desc_sw128(sA + ks * 32, 0, 1024),
                        desc_sw128(sW + ks * 32, 0, 1024), kc > 0 || ks > 0);
        wgmma_commit();
        wgmma_wait<1>();   // the previous chunk's chain has retired
        fence_regs<BN / 2>(acc);
        if (kc > 0) mbar_arrive(empty + prev);
        prev = s;
      }
      wgmma_wait<0>();
      fence_regs<BN / 2>(acc);
      mbar_arrive(empty + prev);

      // epilogue: the staging rows hold the residual (or are free)
      if (p.has_res) mbar_wait(res_full + wg, ti & 1);
      named_bar_sync(2 + wg, 128);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int cl = 8 * i + 2 * t;
        const int col = n0 + cl;
        float b0 = 0.f, b1 = 0.f;
        if (p.bias != nullptr && col < p.N) {
          const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(p.bias + col);
          b0 = __low2float(bb);
          b1 = __high2float(bb);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float y0 = acc[4 * i + 2 * r], y1 = acc[4 * i + 2 * r + 1];
          __nv_bfloat162 h = round2(y0, y1);
          if (p.bias != nullptr) {
            y0 += b0;
            y1 += b1;
            h = round2(y0, y1);
          }
          if (p.act == 1) {
            y0 = gelu_tanh(y0);
            y1 = gelu_tanh(y1);
            h = round2(y0, y1);
          }
          __nv_bfloat162* slot = reinterpret_cast<__nv_bfloat162*>(
              sOut + ((warp * 16 + g + 8 * r) * BN + cl) * 2);
          if (p.has_res) {
            const __nv_bfloat162 rr = *slot;
            h = __floats2bfloat162_rn(y0 + __low2float(rr), y1 + __high2float(rr));
          }
          *slot = h;
        }
      }
      fence_proxy_async();
      named_bar_sync(2 + wg, 128);
      if (lt == 0) {
        tma_store_2d(&tout, sOut, n0, m0w);
        bulk_commit();
      }
    }
    if (lt == 0) bulk_wait_all();
  }
}

// row-major [rows, cols] bf16 with a row stride of `ld` elements
bool map_2d(CUtensorMap* map, const void* base, long long ld, int rows,
            int cols, int box_cols, int box_rows, bool swizzle128) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  return encode_map(map, base, 2, dims, strides, box, swizzle128);
}

template <int BN>
cudaError_t launch(const void* a, long long lda, const void* w, const void* res,
                   long long ldr, void* out, long long ldo, const Params& p,
                   cudaStream_t stream) {
  constexpr int smem = Layout<BN>::BYTES + 1024;   // + alignment slack
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        gemm_sm90<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap ta, tw, tout, tres;
  if (!map_2d(&ta, a, lda, p.M, p.K, BK, BM, true) ||
      !map_2d(&tw, w, p.K, p.N, p.K, BK, BN, true) ||
      !map_2d(&tout, out, ldo, p.M, p.N, BN, 64, false) ||
      !map_2d(&tres, res ? res : out, res ? ldr : ldo, p.M, p.N, BN, 64, false))
    return cudaErrorInvalidValue;
  const long long ntiles =
      static_cast<long long>((p.M + BM - 1) / BM) * ((p.N + BN - 1) / BN);
  if (ntiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int grid = static_cast<int>(ntiles < sm_count() ? ntiles : sm_count());
  gemm_sm90<BN><<<grid, NTHREADS, smem, stream>>>(ta, tw, tout, tres, p);
  return cudaGetLastError();
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
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.M = M; p.N = N; p.K = K; p.act = act; p.has_res = res != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = use_device_of(a);
  if (e == cudaSuccess)
    e = N % 144 == 0 ? launch<144>(a, lda, w, res, ldr, out, ldo, p, s)
                     : launch<128>(a, lda, w, res, ldr, out, ldo, p, s);
  return static_cast<int>(e);
}
