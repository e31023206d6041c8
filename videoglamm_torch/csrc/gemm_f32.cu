// K2 in full f32: the GEMM with a fused epilogue for a model whose compute
// dtype is f32 (counted as "gemm:simt_f32"; the name is kept for the
// counters, the products run on the tensor cores).
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
// Bound: operations or bytes, at f32 accuracy. Every product is 3xTF32 on
// wgmma (sm90_common.cuh): each f32 operand is split into a TF32 big part
// and a TF32 small remainder, and big.small + small.big + big.big,
// accumulated in f32, keeps f32 accuracy. Three TF32 products at 495
// TFLOP/s give 165 TFLOP/s of f32-accurate products; at Hiera-L's stage 1
// (M = 524,288 rows, K = 144) proj and fc2 are bound by their bytes.
//
// Design: K2's shape (gemm_epilogue.cu) in f32. A persistent grid, one CTA
// of three warpgroups an SM, walks output tiles of BM = 128 rows x BN = 144
// columns, a row band's column tiles one after another, so that the CTAs
// running together share their A band through L2. 144 divides every N of
// Hiera-L's products (C = 144 * 2^s: qkv 3C, proj C, fc1 4C, fc2 C), so no
// column of a tile is wasted there; any other N (a multiple of 8) ends in
// a tile that TMA clips.
//   - Warp 8 issues TMA loads of K-chunks of 32 f32 (128 bytes, one
//     128-byte swizzle row) of A [128 x 32] and W [144 x 32] into a ring of
//     STAGES stages. Both operands are K-major in memory (A [M,K] rows lda
//     apart, W [N,K] in nn.Linear layout), as wgmma .tf32 wants them; every
//     view the wrapper admits (16-byte aligned, rows a multiple of 8 f32
//     apart) has a tensor map. Past M, N and K (K = 144 is 4.5 chunks) TMA
//     fills zeros, which the products add as zeros.
//   - Warps 9 to 11 split each W chunk once for the CTA's 128 rows: big
//     written in place over the raw chunk, small into a ring of
//     SPLIT_STAGES planes, at the same swizzled offsets (16 bytes a thread,
//     consecutive threads on consecutive units: no bank conflict), a batch
//     of loads ahead of their stores. This split, through shared memory
//     that the products' operand reads keep busy, is what sets the pace of
//     a chunk.
//   - Warpgroups 0 and 1 each own 64 rows. A thread reads its A fragment
//     (the m16n8k8 tf32 one: rows g and g + 8, columns t and t + 4 of each
//     k8 step; 4-byte loads, conflict-free across the swizzle) from the
//     stage, splits it in registers, and issues wgmma m64n144k8 with A from
//     registers: per k8 step big.small, small.big, big.big (the cross terms
//     first, as CUTLASS's OpMultiplyAddFastF32), all four k8 steps of a
//     chunk. The two warpgroups issue a chunk in turn (named barriers), so
//     that one loads and splits its next fragments while the other's
//     products run.
//   - The tensor core's f32 accumulation drifts one way with the chain
//     (about 2e-8 of the sum a k8 step, measured on the H100: see
//     attention_f32.cu), and K reaches 4,608 here, so the products of each
//     k-block of KBLOCK columns go into a fresh accumulator that is then
//     added to the running sum in f32 registers (64 measured faster than
//     32: experiments/k2_f32_variants.py).
//   - Epilogue from the running sum: + bias, GELU, then the residual, which
//     arrives by TMA into the warpgroup's output staging rows during the
//     main loop; the result is written over it in place and leaves by one
//     TMA store a warpgroup (coalesced, clipped at M and N), which overlaps
//     the next tile's main loop. No split-K and no atomics: two calls give
//     the same bits.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "sm90_common.cuh"

// the tile plan (`k2_f32_plan` in ops/fused_block.py reads these lines)
constexpr int BM = 128;          // rows a tile: two consumer warpgroups of 64
constexpr int BN = 144;          // columns a tile
constexpr int BK = 32;           // K-chunk: 128 bytes of f32
constexpr int KBLOCK = 64;       // K columns a fresh accumulator sums
constexpr int STAGES = 3;        // ring of A and W chunks
constexpr int SPLIT_STAGES = 2;  // ring of W's small planes
constexpr int SPLITTERS = 96;    // warps 9 to 11
constexpr int SPLIT_BATCH = 4;   // 16-byte units a splitter loads before it stores
constexpr int NTHREADS = 384;    // warpgroups 0, 1: consumers; 2: producer
// setmaxnreg: the consumers take only what the producer gives back of the
// 168 registers a thread that the launch allocates (65,536 / 384)
constexpr int ENTRY_REGS = 168;
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;
constexpr int SMEM_MAX = 232448;
constexpr int SMEM_ALIGN = 1024;   // slack to align the base to the swizzle period

constexpr int CHUNK_A = BM * BK * 4;
constexpr int CHUNK_W = BN * BK * 4;
constexpr int STAGE = CHUNK_A + CHUNK_W;           // A, then W (big after the split)
constexpr int SMALL = STAGES * STAGE;              // W's small planes
constexpr int OUT = SMALL + SPLIT_STAGES * CHUNK_W;
constexpr int OUT_WG = 64 * BN * 4;                // [64][BN] f32 a warpgroup, rows dense
constexpr int BAR = OUT + 2 * OUT_WG;
constexpr int NBAR = 3 * STAGES + SPLIT_STAGES + 2;
constexpr int BYTES = BAR + 8 * NBAR;
constexpr int KSTEPS = BK / 8;
constexpr int KB_CHUNKS = KBLOCK / BK;
static_assert(KBLOCK % BK == 0, "a k-block is whole chunks");
static_assert(CHUNK_A % 1024 == 0 && CHUNK_W % 1024 == 0, "swizzle period");
static_assert((CHUNK_W / 16) % (SPLIT_BATCH * SPLITTERS) == 0, "whole rounds of the split");
static_assert(BYTES + SMEM_ALIGN <= SMEM_MAX, "a CTA's shared memory");
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= NTHREADS * ENTRY_REGS,
              "the registers the launch allocates");

struct Params {
  const float* bias;   // [N] or null
  int M, N, K, act, has_res;
};

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

// a chunk's KSTEPS k8 steps (past K, TMA has filled zeros), each as
// big.small + small.big, then big.big; `fresh` starts the accumulator over
// (a k-block's first chunk)
__device__ __forceinline__ void chunk_products(float* acc, uint32_t (*ab)[4],
                                               uint32_t (*as)[4],
                                               const unsigned char* wbig,
                                               const unsigned char* wsmall,
                                               bool fresh) {
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const uint64_t db = desc_sw128(wbig + 32 * ks, 0, 1024);
    WgmmaTf32<BN>::rs(acc, ab[ks], desc_sw128(wsmall + 32 * ks, 0, 1024),
                      fresh && ks == 0 ? 0 : 1);
    WgmmaTf32<BN>::rs(acc, as[ks], db, 1);
    WgmmaTf32<BN>::rs(acc, ab[ks], db, 1);
  }
}

__global__ void __launch_bounds__(NTHREADS, 1) gemm_f32_tf32x3(
    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
    const __grid_constant__ CUtensorMap tout, const __grid_constant__ CUtensorMap tres,
    const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // aligned by an offset from the __shared__ array, so that every pointer
  // below stays known as shared (LDS / STS, not generic loads and stores)
  unsigned char* smem =
      smem_raw + ((SMEM_ALIGN - (smem_u32(smem_raw) & (SMEM_ALIGN - 1))) & (SMEM_ALIGN - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR);   // TMA landed
  uint64_t* ready = full + STAGES;                            // W split
  uint64_t* empty = ready + STAGES;                           // stage consumed
  uint64_t* small_empty = empty + STAGES;                     // small plane consumed
  uint64_t* res_full = small_empty + SPLIT_STAGES;            // one a consumer warpgroup

  const int ntn = (p.N + BN - 1) / BN;
  const int ntiles = ((p.M + BM - 1) / BM) * ntn;
  const int nk = (p.K + BK - 1) / BK;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(ready + s, SPLITTERS);
      mbar_init(empty + s, 256);
    }
    for (int j = 0; j < SPLIT_STAGES; ++j) mbar_init(small_empty + j, 256);
    mbar_init(res_full, 1);
    mbar_init(res_full + 1, 1);
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = tid / 128;

  if (wg == 2) {
    reg_dealloc<PRODUCER_REGS>();
    if (tid == 256) {
      // ---------------- warp 8: one thread issues every load
      int it = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int m0 = (tile / ntn) * BM, n0 = (tile % ntn) * BN;
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full + s, STAGE);
          tma_load_2d(smem + s * STAGE, &ta, full + s, kc * BK, m0);
          tma_load_2d(smem + s * STAGE + CHUNK_A, &tw, full + s, kc * BK, n0);
        }
      }
    } else if (tid >= 288) {
      // ---------------- warps 9 to 11: split W once a chunk
      const int st = tid - 288;
      int it = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int s = it % STAGES, j = it % SPLIT_STAGES;
          mbar_wait(full + s, (it / STAGES) & 1);
          mbar_wait(small_empty + j, ((it / SPLIT_STAGES) & 1) ^ 1);
          unsigned char* wraw = smem + s * STAGE + CHUNK_A;
          unsigned char* wsm = smem + SMALL + j * CHUNK_W;
          // a batch of loads ahead of its stores (the stores go back over
          // the raw units: loads and stores one unit at a time serialise)
          for (int u0 = st; u0 < CHUNK_W / 16; u0 += SPLIT_BATCH * SPLITTERS) {
            float4 x[SPLIT_BATCH];
#pragma unroll
            for (int i = 0; i < SPLIT_BATCH; ++i)
              x[i] = *reinterpret_cast<const float4*>(wraw + 16 * (u0 + i * SPLITTERS));
#pragma unroll
            for (int i = 0; i < SPLIT_BATCH; ++i) {
              uint4 b, sm;
              split_tf32(x[i].x, b.x, sm.x);
              split_tf32(x[i].y, b.y, sm.y);
              split_tf32(x[i].z, b.z, sm.z);
              split_tf32(x[i].w, b.w, sm.w);
              const int u = u0 + i * SPLITTERS;
              *reinterpret_cast<uint4*>(wraw + 16 * u) = b;
              *reinterpret_cast<uint4*>(wsm + 16 * u) = sm;
            }
          }
          fence_proxy_async();   // the planes -> wgmma
          mbar_arrive(ready + s);
        }
      }
    }
  } else {
    // ---------------- consumers: warpgroup wg owns rows m0 + 64 wg ..
    reg_alloc<CONSUMER_REGS>();
    const int lt = tid % 128;
    const int warp = lt / 32, lane = lt % 32;
    const int g = lane / 4, t = lane % 4;
    unsigned char* sOut = smem + OUT + wg * OUT_WG;
    // this thread's A rows (g and g + 8 of its warp's 16) inside a stage
    const int arow = (64 * wg + 16 * warp + g) * 128 + 4 * t;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int it = 0, ti = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++ti) {
      const int m0w = (tile / ntn) * BM + 64 * wg, n0 = (tile % ntn) * BN;
      if (lt == 0) {
        bulk_wait_read();   // the last tile's store has read the staging rows
        if (p.has_res) {
          mbar_expect_tx(res_full + wg, OUT_WG);
          tma_load_2d(sOut, &tres, res_full + wg, n0, m0w);
        }
      }
      float run[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) run[i] = 0.f;

      for (int kc = 0; kc < nk; ++kc, ++it) {
        const int s = it % STAGES, j = it % SPLIT_STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        mbar_wait(full + s, ph);
        const unsigned char* sA = smem + s * STAGE + arow;
        uint32_t ab[KSTEPS][4], as[KSTEPS][4];
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          const int u0 = ((2 * ks) ^ g) << 4, u1 = ((2 * ks + 1) ^ g) << 4;
          split_tf32(*reinterpret_cast<const float*>(sA + u0), ab[ks][0], as[ks][0]);
          split_tf32(*reinterpret_cast<const float*>(sA + 1024 + u0), ab[ks][1], as[ks][1]);
          split_tf32(*reinterpret_cast<const float*>(sA + u1), ab[ks][2], as[ks][2]);
          split_tf32(*reinterpret_cast<const float*>(sA + 1024 + u1), ab[ks][3], as[ks][3]);
        }
        // the splits (register-only asm) stay ahead of the fence: no
        // warpgroup.arrive injected before the products
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            asm volatile("" : "+r"(ab[ks][e]), "+r"(as[ks][e]) :: "memory");
        mbar_wait(ready + s, ph);
        const unsigned char* wbig = smem + s * STAGE + CHUNK_A;
        const unsigned char* wsmall = smem + SMALL + j * CHUNK_W;
        const bool fresh = kc % KB_CHUNKS == 0;
        // the warpgroups take the tensor cores in turn, a chunk each: one
        // loads and splits its next A fragments while the other's products
        // run (issued together, both chains would end together and leave
        // the tensor cores idle while both load)
        if (wg == 1) named_bar_sync(5, 256);
        else if (kc > 0) named_bar_sync(4, 256);
        fence_regs<BN / 2>(acc);
        wgmma_fence();
        chunk_products(acc, ab, as, wbig, wsmall, fresh);
        wgmma_commit();
        if (wg == 0) named_bar_arrive(5, 256);
        else if (kc + 1 < nk) named_bar_arrive(4, 256);
        wgmma_wait<0>();
        fence_regs<BN / 2>(acc);
        mbar_arrive(empty + s);
        mbar_arrive(small_empty + j);
        if (kc % KB_CHUNKS == KB_CHUNKS - 1 || kc == nk - 1) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) run[i] += acc[i];
        }
      }

      // epilogue: the staging rows hold the residual (or are free)
      if (p.has_res) mbar_wait(res_full + wg, ti & 1);
      named_bar_sync(2 + wg, 128);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int cl = 8 * i + 2 * t;
        const int col = n0 + cl;
        float2 bb = make_float2(0.f, 0.f);
        if (p.bias != nullptr && col < p.N)
          bb = *reinterpret_cast<const float2*>(p.bias + col);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float y0 = run[4 * i + 2 * r], y1 = run[4 * i + 2 * r + 1];
          if (p.bias != nullptr) {
            y0 += bb.x;
            y1 += bb.y;
          }
          if (p.act == 1) {
            y0 = gelu_erf(y0);
            y1 = gelu_erf(y1);
          }
          float2* slot = reinterpret_cast<float2*>(
              sOut + ((warp * 16 + g + 8 * r) * BN + cl) * 4);
          if (p.has_res) {
            const float2 rr = *slot;
            y0 = rr.x + y0;
            y1 = rr.y + y1;
          }
          *slot = make_float2(y0, y1);
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

// row-major [rows, cols] f32 with a row stride of `ld` elements
bool map_2d(CUtensorMap* map, const void* base, long long ld, int rows,
            int cols, int box_cols, int box_rows, bool swizzle128) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  return encode_map(map, base, 2, dims, strides, box, swizzle128,
                    CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

}  // namespace

// The signature of vgt_gemm_epilogue (csrc/gemm_epilogue.cu), on f32
// tensors: a [M,K] rows lda apart; w contiguous [N,K]; bias [N] or null;
// res [M,N] rows ldr apart or null; out [M,N] rows ldo apart; act 1 = erf
// GELU. K and N multiples of 8; lda, ldr, ldo multiples of 8 (any for
// one row) and every pointer 16-byte aligned (checked in Python, with
// `k2_f32_plan`).
extern "C" int vgt_gemm_f32(
    const void* a, long long lda, const void* w, const void* bias,
    const void* res, long long ldr, void* out, long long ldo,
    int M, int N, int K, int act, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 8 || N % 8) return cudaErrorInvalidValue;
  Params p;
  p.bias = static_cast<const float*>(bias);
  p.M = M; p.N = N; p.K = K; p.act = act; p.has_res = res != nullptr;
  cudaError_t e = use_device_of(a);
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int smem = BYTES + SMEM_ALIGN;
  static bool configured = false;
  if (!configured) {
    e = cudaFuncSetAttribute(gemm_f32_tf32x3,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  // a single row's stride is never read: a one-row view may have any
  if (M == 1) { lda = K; ldr = N; ldo = N; }
  CUtensorMap ta, tw, tout, tres;
  if (!map_2d(&ta, a, lda, M, K, BK, BM, true) ||
      !map_2d(&tw, w, K, N, K, BK, BN, true) ||
      !map_2d(&tout, out, ldo, M, N, BN, 64, false) ||
      !map_2d(&tres, res ? res : out, res ? ldr : ldo, M, N, BN, 64, false))
    return cudaErrorInvalidValue;
  const long long ntiles =
      static_cast<long long>((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (ntiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int grid = static_cast<int>(ntiles < sm_count() ? ntiles : sm_count());
  gemm_f32_tf32x3<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      ta, tw, tout, tres, p);
  return static_cast<int>(cudaGetLastError());
}

// The tile plan the kernel was built with: out = (BM, BN, BK, KBLOCK,
// STAGES, SPLIT_STAGES, dynamic shared memory bytes). ops/fused_block.py's
// k2_f32_plan must agree (held on the card).
extern "C" int vgt_gemm_f32_plan(int* out) {
  out[0] = BM; out[1] = BN; out[2] = BK; out[3] = KBLOCK;
  out[4] = STAGES; out[5] = SPLIT_STAGES; out[6] = BYTES + SMEM_ALIGN;
  return 0;
}
