// K7: whole-row-softmax self-attention for medium sequences on Hopper
// (sm_90a): bf16 or f32 in/out, f32 accumulation, mma.sync m16n8k16 bf16
// tensor-core tiles.
//
// Replaces the Pallas TPU kernel _window_kernel of
// videoglamm_tpu/ops/attention.py (:523, launched by _window_attention_fwd
// :567): non-causal full self-attention over [B,H,S,D] with Sq == Sk,
// 512 < S <= 1536, no kv_lens, for each (batch, head) row
// softmax(q k^T * scale) v with the exact row maximum and row sum taken
// before any p v product, so no accumulator is ever rescaled. The callers
// are the SAM-2 memory self-attention at the 32x32 grid ([4,1,1024,256]
// f32) and the medium towers ([4,16,1025,88], [16,16,577,64] bf16).
//
// The TPU kernel holds one [Sp,Sp] f32 logits block per (batch, head) in
// VMEM and groups G rows a program. Neither carries over: a 64 x 1025 f32
// logits tile is 262 KB, above the 227 KB of shared memory a CTA can have.
// Of the two shapes a CTA can hold, a 32-query tile with its whole logits
// row in shared memory (32 x 1536 x 4 B = 192 KB) would leave 35 KB for the
// Q, K and V tiles (one 64-key K tile at head dim 256 is 33 KB) and one CTA
// per SM. This kernel takes the other one, two passes over the key tiles:
//   pass 1  q k^T alone, tile by tile: the row maximum m and the row sum
//           l = sum exp(s - m) (a scalar per row; V is not read);
//   pass 2  q k^T again, p = exp(s - m) / l rounded to bf16, o += p v.
// Shared memory stays at K1's size (a Q tile, one K and one V^T tile), so
// several CTAs share an SM; the price is the second q k^T (1.5x the
// products of a single pass). The normalised probabilities are rounded to
// bf16 exactly where the plain twin rounds them.
//
// What bounds it on the H100: operations (bf16 tensor cores) at every
// caller's shape; at [4,1,1024,256] the grid is small (64 tiles of 64
// queries), so the launcher halves the query tile to 32 rows when 64-row
// tiles would not cover the SMs. A CTA always has 4 warps: with a 32-row
// tile two of them only help to stage the K and V tiles. The staging loop
// starts several rows' global loads before the first shared-memory store,
// because a small grid is bound by load latency, not by the products.
// f32 operands are rounded to bf16 on the way into shared memory, as K1
// (attention_fwd.cu) does and for the same reason. Head dim 256 takes 32-key
// tiles so that the logits and the 256-wide accumulator fit the registers;
// Q fragments are read from the resident shared-memory tile at every K step.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "mma_common.cuh"

constexpr int MAX_THREADS = 128;   // 4 warps x 16 query rows

struct Params {
  const void* q;        // bf16 or f32 (the kernel's T), strides in elements
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int B, H, S, D;
  int bm;               // query rows a CTA: 64, or 32 (two computing warps)
  float scale_log2;     // sm_scale * log2(e): the softmax runs on exp2
};

// s[n][e] <- scaled logits of a warp's 16 query rows (A fragments read from
// the resident Q tile at `qbase`) against the K tile in shared memory; key
// columns >= S get -inf.
template <int DP, int BN>
__device__ __forceinline__ void tile_logits(
    float (&s)[BN / 8][4], const __nv_bfloat16* qbase, const __nv_bfloat16* sK,
    int g, int t, int k0, int S, float scale_log2) {
  constexpr int LDS = DP + 8, KS = DP / 16, NT = BN / 8;
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const __nv_bfloat16* base = qbase + ks * 16;
    uint32_t a[4];
    a[0] = ld32(base);
    a[1] = ld32(base + 8 * LDS);
    a[2] = ld32(base + 8);
    a[3] = ld32(base + 8 * LDS + 8);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const __nv_bfloat16* kbase = sK + (n * 8 + g) * LDS + ks * 16 + 2 * t;
      mma_bf16(s[n], a, ld32(kbase), ld32(kbase + 8));
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + n * 8 + 2 * t + (e & 1);
      s[n][e] = key < S ? s[n][e] * scale_log2 : -INFINITY;
    }
  }
}

// Stage one K tile (and, WITH_V, the V tile transposed) of BN keys from k0
// on: every thread starts U chunks' global loads before the first store.
// Rows past S and head-dim chunks past D are staged as zeros.
template <int DP, int BN, int U, bool WITH_V, typename T>
__device__ __forceinline__ void stage_tile(
    __nv_bfloat16* sK, __nv_bfloat16* sVt, const T* kb, const T* vb,
    long long k_ss, long long v_ss, int k0, int S, int D, int tid) {
  constexpr int LDS = DP + 8, LDV = BN + 8, CH = DP / 8;
  for (int base = tid; base < BN * CH; base += MAX_THREADS * U) {
    uint4 kk[U], vv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * MAX_THREADS;
      const int r = idx / CH, d0 = (idx % CH) * 8;
      kk[u] = make_uint4(0u, 0u, 0u, 0u);
      vv[u] = kk[u];
      if (idx < BN * CH && k0 + r < S && d0 < D) {
        kk[u] = Io<T>::load8(kb + (k0 + r) * k_ss + d0);
        if constexpr (WITH_V) vv[u] = Io<T>::load8(vb + (k0 + r) * v_ss + d0);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * MAX_THREADS;
      if (idx >= BN * CH) continue;
      const int r = idx / CH, d0 = (idx % CH) * 8;
      *reinterpret_cast<uint4*>(sK + r * LDS + d0) = kk[u];
      if constexpr (WITH_V) {
        const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv[u]);
#pragma unroll
        for (int i = 0; i < 8; ++i) sVt[(d0 + i) * LDV + r] = ve[i];
      }
    }
  }
}

// DP: padded head dim; BN: keys per shared-memory tile. The query tile is
// p.bm rows, 16 to each of the first p.bm / 16 warps.
template <int DP, int BN, typename T>
__global__ void __launch_bounds__(MAX_THREADS) window_attn_kernel(const Params p) {
  constexpr int LDS = DP + 8;   // padded row stride (elements): no bank conflicts
  constexpr int LDV = BN + 8;
  constexpr int CH = DP / 8;    // 16-byte chunks per row
  constexpr int NT = BN / 8;    // mma N tiles over a key tile
  constexpr int DT = DP / 8;    // mma N tiles over the head dim

  constexpr int nthreads = MAX_THREADS;
  // loads in flight a thread while staging: fewer where the 256-wide
  // accumulator already fills the registers
  constexpr int U1 = 4, U2 = DP > 128 ? 2 : 4;
  const int BM = p.bm;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BM * LDS;
  __nv_bfloat16* sVt = sK + BN * LDS;   // V transposed: [DP][BN]

  const int nmt = (p.S + BM - 1) / BM;
  const int mt = blockIdx.x % nmt;
  const int bh = blockIdx.x / nmt;
  const int h = bh % p.H;
  const int b = bh / p.H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = mt * BM;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int idx = tid; idx < BM * CH; idx += nthreads) {
    const int r = idx / CH, d0 = (idx % CH) * 8;
    const int row = m0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < p.S && d0 < p.D) val = Io<T>::load8(qb + row * p.q_ss + d0);
    *reinterpret_cast<uint4*>(sQ + r * LDS + d0) = val;
  }

  const bool computes = warp * 16 < BM;   // else this warp only stages tiles
  const __nv_bfloat16* qbase = sQ + (warp * 16 + g) * LDS + 2 * t;
  const int r0 = m0 + warp * 16 + g;   // this thread's two query rows
  const int r1 = r0 + 8;
  const int ntiles = (p.S + BN - 1) / BN;

  // ---- pass 1: exact row maximum and row sum from q k^T alone ----
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};
  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();   // Q staged (j == 0); every warp done with the last tile
    stage_tile<DP, BN, U1, false, T>(sK, sVt, kb, vb, p.k_ss, p.v_ss, k0, p.S,
                                     p.D, tid);
    __syncthreads();
    if (!computes) continue;
    float s[NT][4];
    tile_logits<DP, BN>(s, qbase, sK, g, t, k0, p.S, p.scale_log2);
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    // every tile holds at least one key < S, so mx is finite
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      rs[0] += exp2f(s[n][0] - mx[0]) + exp2f(s[n][1] - mx[0]);
      rs[1] += exp2f(s[n][2] - mx[1]) + exp2f(s[n][3] - mx[1]);
    }
    l_i[0] = l_i[0] * exp2f(m_i[0] - mx[0]) + rs[0];   // per-thread partials
    l_i[1] = l_i[1] * exp2f(m_i[1] - mx[1]) + rs[1];
    m_i[0] = mx[0];
    m_i[1] = mx[1];
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
    inv[r] = 1.f / l_i[r];
  }

  // ---- pass 2: p = exp(s - m) / l, o += p v; nothing is rescaled ----
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();
    stage_tile<DP, BN, U2, true, T>(sK, sVt, kb, vb, p.k_ss, p.v_ss, k0, p.S,
                                    p.D, tid);
    __syncthreads();
    if (!computes) continue;
    float s[NT][4];
    tile_logits<DP, BN>(s, qbase, sK, g, t, k0, p.S, p.scale_log2);
#pragma unroll
    for (int n = 0; n < NT; ++n) {   // exp2(-inf) = 0 on the padded columns
      s[n][0] = exp2f(s[n][0] - m_i[0]) * inv[0];
      s[n][1] = exp2f(s[n][1] - m_i[0]) * inv[0];
      s[n][2] = exp2f(s[n][2] - m_i[1]) * inv[1];
      s[n][3] = exp2f(s[n][3] - m_i[1]) * inv[1];
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        const __nv_bfloat16* vbase = sVt + (dn * 8 + g) * LDV + kk * 16 + 2 * t;
        mma_bf16(acc[dn], a, ld32(vbase), ld32(vbase + 8));
      }
    }
  }

  if (!computes) return;
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (col < p.D) {
      if (r0 < p.S) Io<T>::store2(ob + r0 * p.o_ss + col, acc[dn][0], acc[dn][1]);
      if (r1 < p.S) Io<T>::store2(ob + r1 * p.o_ss + col, acc[dn][2], acc[dn][3]);
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

template <int DP, int BN, typename T>
cudaError_t launch(Params p, cudaStream_t stream) {
  constexpr int smem_max = (64 * (DP + 8) + BN * (DP + 8) + DP * (BN + 8)) * 2;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        window_attn_kernel<DP, BN, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  // 64-query tiles (4 warps) unless they would leave SMs idle
  const long long bh = (long long)p.B * p.H;
  p.bm = ((p.S + 63) / 64) * bh < sm_count() ? 32 : 64;
  const long long blocks = ((p.S + p.bm - 1) / p.bm) * bh;
  const int smem = (p.bm * (DP + 8) + BN * (DP + 8) + DP * (BN + 8)) * 2;
  window_attn_kernel<DP, BN, T><<<(unsigned)blocks, MAX_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t s) {
  const int D = p.D;
  if (D <= 64) return launch<64, 64, T>(p, s);
  if (D <= 80) return launch<80, 64, T>(p, s);
  if (D <= 96) return launch<96, 64, T>(p, s);
  if (D <= 128) return launch<128, 64, T>(p, s);
  if (D <= 256) return launch<256, 32, T>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry (bound with ctypes). Returns a cudaError_t code, 0 = ok.
// q, k, v and o are [B,H,S,D] views, bf16, or f32 when `is_f32` is set.
// Strides are in elements; the head dim must be contiguous, D % 8 == 0,
// D <= 256, every stride a multiple of 8 and every pointer 16-byte aligned
// (checked by the Python wrapper).
extern "C" int vgt_window_attention(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int B, int H, int S, int D, float sm_scale, int is_f32, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.B = B; p.H = H; p.S = S; p.D = D;
  p.scale_log2 = sm_scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_f32 ? dispatch<float>(p, s)
                                : dispatch<__nv_bfloat16>(p, s));
}
