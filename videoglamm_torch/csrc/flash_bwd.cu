// K6: flash-attention backward for Hopper (sm_90a), bf16 in/out, f32
// accumulation, mma.sync m16n8k16 tensor-core tiles.
//
// Replaces the two Pallas TPU kernels of videoglamm_tpu/ops/attention.py
// that `_flash_bwd` (:377) launches: `_flash_bwd_dq_kernel` (:302) and
// `_flash_bwd_dkv_kernel` (:336), with the tile math of `_bwd_common`
// (:281). It is the backward of K1 (attention_fwd.cu) and recomputes the
// probabilities from the row log-sum-exp that K1 wrote:
//   s  = q k^T * sm_scale
//   p  = mask ? exp(s - lse) : 0          mask: key < kv_len, and for causal
//                                         key <= q_start + row
//   dp = dO v^T
//   ds = p * (dp - delta) * sm_scale      delta = rowsum(dO * out)
//   dq = ds k,  dk = ds^T q,  dv = p^T dO
// p and ds are rounded to bf16 before the last three products, which
// accumulate in f32 (:327-329, :364-369).
//
// What bounds it on the H100: operations. At the training shape
// [2,32,3456,96] causal the five products are 0.73 TFLOP against some 0.3 GB
// of operands, far above the card's 295 operations a byte.
// Design: three __global__ kernels, no atomics, so the result does not
// depend on the order the blocks run in.
//   * delta: one warp per query row, f32 [B,H,Sq].
//   * dq: one CTA of 4 warps per (batch, head, 64-query tile). Q and dO live
//     in registers as mma A fragments; the CTA loops over 64-key tiles of K
//     (row-major and transposed) and V in shared memory and keeps the dq
//     tile in f32 registers.
//   * dk/dv: one CTA per (batch, head, 64-key tile), the transposed problem:
//     K and V live in registers as A fragments, the CTA loops over 64-query
//     tiles of Q and dO (row-major and transposed) with their lse and delta
//     rows, computes s^T and dp^T, and keeps dk and dv in f32 registers.
// The TPU kernels carry their sums across sequential grid steps in scratch
// memory; here the loop inside the CTA takes that place. Tiles that causal
// order or kv_len leave empty are skipped (:316-319, :351-354). The mask is
// applied by selection, never by multiplication, so a row with no valid key
// (lse = -1e30, exp overflows) gives exact zeros. The head dim is
// zero-padded in shared memory to the mma K step, as in K1. Every operand
// is read through element strides (batch, head, token) with a contiguous
// head dim. S, dP are each computed twice (once per kernel): seven products
// where five are needed; sharing them needs atomics or a second pass.
// Later work: wgmma, TMA double buffering, one fused kernel.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // queries per tile
constexpr int BN = 64;        // keys per tile
constexpr int NTHREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const float* lse;     // [B,H,Sq]
  float* delta;         // [B,H,Sq] scratch
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  const int* kv_lens;   // [B] or null (= Sk)
  const int* q_start;   // [B] absolute key position of query 0, or null (= 0)
  int B, H, Sq, Sk, D;
  int causal;
  float sm_scale;
  float scale_log2;     // sm_scale * log2(e)
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 64 rows x D of a strided bf16 operand -> shared memory [64][DP+8], rows at
// or past `limit` and columns past D as zeros; with `tr` also its transpose
// [DP][64+8].
template <int DP>
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* base,
                                           long long stride, int row0,
                                           int limit, int D,
                                           __nv_bfloat16* dst,
                                           __nv_bfloat16* tr) {
  constexpr int LDS = DP + 8, LDT = 64 + 8, CH = DP / 8;
  for (int idx = threadIdx.x; idx < 64 * CH; idx += NTHREADS) {
    const int r = idx / CH, d0 = (idx % CH) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < limit && d0 < D)
      val = *reinterpret_cast<const uint4*>(base + row * stride + d0);
    *reinterpret_cast<uint4*>(dst + r * LDS + d0) = val;
    if (tr != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) tr[(d0 + i) * LDT + r] = e[i];
    }
  }
}

// this warp's 16 rows of a staged tile -> mma A fragments
template <int DP>
__device__ __forceinline__ void load_a_frags(const __nv_bfloat16* tile,
                                             int row, int t,
                                             uint32_t (*f)[4]) {
  constexpr int LDS = DP + 8, KS = DP / 16;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const __nv_bfloat16* base = tile + row * LDS + ks * 16 + 2 * t;
    f[ks][0] = ld32(base);
    f[ks][1] = ld32(base + 8 * LDS);
    f[ks][2] = ld32(base + 8);
    f[ks][3] = ld32(base + 8 * LDS + 8);
  }
}

// delta[b,h,row] = sum_d dO * out, one warp per row
__global__ void __launch_bounds__(NTHREADS) flash_bwd_delta_kernel(const Params p) {
  const long long row_id =
      (long long)blockIdx.x * (NTHREADS / 32) + (threadIdx.x >> 5);
  const long long rows = (long long)p.B * p.H * p.Sq;
  if (row_id >= rows) return;
  const int lane = threadIdx.x & 31;
  const int s = (int)(row_id % p.Sq);
  const int h = (int)((row_id / p.Sq) % p.H);
  const int b = (int)(row_id / ((long long)p.Sq * p.H));
  const __nv_bfloat16* o = p.o + b * p.o_sb + h * p.o_sh + s * p.o_ss;
  const __nv_bfloat16* g = p.dout + b * p.do_sb + h * p.do_sh + s * p.do_ss;
  float acc = 0.f;
  for (int d = 2 * lane; d < p.D; d += 64) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + d));
    const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g + d));
    acc += a.x * c.x + a.y * c.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row_id] = acc;
}

template <int DP>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(const Params p) {
  constexpr int LDS = DP + 8;
  constexpr int LDT = BN + 8;
  constexpr int KS = DP / 16;   // mma K steps over the head dim
  constexpr int DT = DP / 8;    // mma N tiles over the head dim

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + BN * LDS;
  __nv_bfloat16* sKt = sV + BN * LDS;   // K transposed: [DP][BN]

  const int nmt = (p.Sq + BM - 1) / BM;
  const int mt = blockIdx.x % nmt;
  const int bh = blockIdx.x / nmt;
  const int h = bh % p.H;
  const int b = bh / p.H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = mt * BM;

  const int kv_len = p.kv_lens ? min(p.kv_lens[b], p.Sk) : p.Sk;
  const int q_off = p.q_start ? p.q_start[b] : 0;

  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;

  // live key range of this query tile
  const int last_row = min(m0 + BM, p.Sq) - 1;
  int k_hi = kv_len;
  if (p.causal) k_hi = min(k_hi, q_off + last_row + 1);
  const int j_hi = k_hi > 0 ? (k_hi + BN - 1) / BN : 0;

  // Q and dO tiles -> A fragments (staged through the K and V buffers)
  stage_tile<DP>(p.q + b * p.q_sb + h * p.q_sh, p.q_ss, m0, p.Sq, p.D, sK, nullptr);
  stage_tile<DP>(p.dout + b * p.do_sb + h * p.do_sh, p.do_ss, m0, p.Sq, p.D, sV, nullptr);
  __syncthreads();
  uint32_t qf[KS][4], gf[KS][4];
  load_a_frags<DP>(sK, warp * 16 + g, t, qf);
  load_a_frags<DP>(sV, warp * 16 + g, t, gf);

  const int r0 = m0 + warp * 16 + g;   // this thread's two query rows
  const int r1 = r0 + 8;
  const long long row_base = ((long long)b * p.H + h) * p.Sq;
  float lse2[2], dl[2];
  lse2[0] = r0 < p.Sq ? p.lse[row_base + r0] * LOG2E : 0.f;
  lse2[1] = r1 < p.Sq ? p.lse[row_base + r1] * LOG2E : 0.f;
  dl[0] = r0 < p.Sq ? p.delta[row_base + r0] : 0.f;
  dl[1] = r1 < p.Sq ? p.delta[row_base + r1] : 0.f;

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = 0; j < j_hi; ++j) {
    const int k0 = j * BN;
    __syncthreads();   // every warp is done with the previous tiles
    stage_tile<DP>(kb, p.k_ss, k0, kv_len, p.D, sK, sKt);
    stage_tile<DP>(vb, p.v_ss, k0, kv_len, p.D, sV, nullptr);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {   // 16 keys at a time
      float s[2][4], dp[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = 2 * kk + hf;
        s[hf][0] = s[hf][1] = s[hf][2] = s[hf][3] = 0.f;
        dp[hf][0] = dp[hf][1] = dp[hf][2] = dp[hf][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int off = (n * 8 + g) * LDS + ks * 16 + 2 * t;
          mma_bf16(s[hf], qf[ks], ld32(sK + off), ld32(sK + off + 8));
          mma_bf16(dp[hf], gf[ks], ld32(sV + off), ld32(sV + off + 8));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          const int rr = e >> 1;
          const int row = rr ? r1 : r0;
          bool ok = key < kv_len && row < p.Sq;
          if (p.causal) ok = ok && key <= q_off + row;
          const float pe = ok ? exp2f(s[hf][e] * p.scale_log2 - lse2[rr]) : 0.f;
          s[hf][e] = ok ? pe * (dp[hf][e] - dl[rr]) * p.sm_scale : 0.f;   // ds
        }
      }
      uint32_t a[4];
      a[0] = pack_bf16(s[0][0], s[0][1]);
      a[1] = pack_bf16(s[0][2], s[0][3]);
      a[2] = pack_bf16(s[1][0], s[1][1]);
      a[3] = pack_bf16(s[1][2], s[1][3]);
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        const __nv_bfloat16* kt = sKt + (dn * 8 + g) * LDT + kk * 16 + 2 * t;
        mma_bf16(acc[dn], a, ld32(kt), ld32(kt + 8));
      }
    }
  }

  __nv_bfloat16* ob = p.dq + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (col < p.D) {
      if (r0 < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * p.dq_ss + col) =
            __floats2bfloat162_rn(acc[dn][0], acc[dn][1]);
      if (r1 < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r1 * p.dq_ss + col) =
            __floats2bfloat162_rn(acc[dn][2], acc[dn][3]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(const Params p) {
  constexpr int LDS = DP + 8;
  constexpr int LDT = BM + 8;
  constexpr int KS = DP / 16;
  constexpr int DT = DP / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sG = sQ + BM * LDS;     // dO
  __nv_bfloat16* sQt = sG + BM * LDS;    // Q transposed: [DP][BM]
  __nv_bfloat16* sGt = sQt + DP * LDT;   // dO transposed
  float* sL = reinterpret_cast<float*>(sGt + DP * LDT);   // lse * log2(e)
  float* sD = sL + BM;                                    // delta

  const int nnt = (p.Sk + BN - 1) / BN;
  const int nt = blockIdx.x % nnt;
  const int bh = blockIdx.x / nnt;
  const int h = bh % p.H;
  const int b = bh / p.H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = nt * BN;

  const int kv_len = p.kv_lens ? min(p.kv_lens[b], p.Sk) : p.Sk;
  const int q_off = p.q_start ? p.q_start[b] : 0;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* gb = p.dout + b * p.do_sb + h * p.do_sh;
  const long long row_base = ((long long)b * p.H + h) * p.Sq;

  // K and V tiles -> A fragments (staged through the Q and dO buffers)
  stage_tile<DP>(p.k + b * p.k_sb + h * p.k_sh, p.k_ss, n0, kv_len, p.D, sQ, nullptr);
  stage_tile<DP>(p.v + b * p.v_sb + h * p.v_sh, p.v_ss, n0, kv_len, p.D, sG, nullptr);
  __syncthreads();
  uint32_t kf[KS][4], vf[KS][4];
  load_a_frags<DP>(sQ, warp * 16 + g, t, kf);
  load_a_frags<DP>(sG, warp * 16 + g, t, vf);

  const int key0 = n0 + warp * 16 + g;   // this thread's two keys
  const int key1 = key0 + 8;

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  // live query tiles: all of them, or for causal those with a row at or
  // after this key tile's first key; none if the tile lies past kv_len
  const int nmt = (p.Sq + BM - 1) / BM;
  int i_lo = 0;
  if (p.causal) i_lo = max(0, n0 - q_off) / BM;
  const int i_hi = n0 < kv_len ? nmt : 0;

  for (int i = i_lo; i < i_hi; ++i) {
    const int m0 = i * BM;
    __syncthreads();   // every warp is done with the previous tiles
    stage_tile<DP>(qb, p.q_ss, m0, p.Sq, p.D, sQ, sQt);
    stage_tile<DP>(gb, p.do_ss, m0, p.Sq, p.D, sG, sGt);
    if (tid < BM) {
      const int row = m0 + tid;
      sL[tid] = row < p.Sq ? p.lse[row_base + row] * LOG2E : 0.f;
      sD[tid] = row < p.Sq ? p.delta[row_base + row] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {   // 16 queries at a time
      float st[2][4], dpt[2][4];   // s^T and dp^T: rows are keys
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = 2 * kk + hf;
        st[hf][0] = st[hf][1] = st[hf][2] = st[hf][3] = 0.f;
        dpt[hf][0] = dpt[hf][1] = dpt[hf][2] = dpt[hf][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int off = (n * 8 + g) * LDS + ks * 16 + 2 * t;
          mma_bf16(st[hf], kf[ks], ld32(sQ + off), ld32(sQ + off + 8));
          mma_bf16(dpt[hf], vf[ks], ld32(sG + off), ld32(sG + off + 8));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = n * 8 + 2 * t + (e & 1);
          const int row = m0 + ql;
          const int key = (e >> 1) ? key1 : key0;
          bool ok = key < kv_len && row < p.Sq;
          if (p.causal) ok = ok && key <= q_off + row;
          const float pe = ok ? exp2f(st[hf][e] * p.scale_log2 - sL[ql]) : 0.f;
          st[hf][e] = pe;
          dpt[hf][e] = ok ? pe * (dpt[hf][e] - sD[ql]) * p.sm_scale : 0.f;   // ds^T
        }
      }
      uint32_t ap[4], ads[4];
      ap[0] = pack_bf16(st[0][0], st[0][1]);
      ap[1] = pack_bf16(st[0][2], st[0][3]);
      ap[2] = pack_bf16(st[1][0], st[1][1]);
      ap[3] = pack_bf16(st[1][2], st[1][3]);
      ads[0] = pack_bf16(dpt[0][0], dpt[0][1]);
      ads[1] = pack_bf16(dpt[0][2], dpt[0][3]);
      ads[2] = pack_bf16(dpt[1][0], dpt[1][1]);
      ads[3] = pack_bf16(dpt[1][2], dpt[1][3]);
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        const int off = (dn * 8 + g) * LDT + kk * 16 + 2 * t;
        mma_bf16(dv[dn], ap, ld32(sGt + off), ld32(sGt + off + 8));
        mma_bf16(dk[dn], ads, ld32(sQt + off), ld32(sQt + off + 8));
      }
    }
  }

  __nv_bfloat16* dkb = p.dk + b * p.dk_sb + h * p.dk_sh;
  __nv_bfloat16* dvb = p.dv + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (col < p.D) {
      if (key0 < p.Sk) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + key0 * p.dk_ss + col) =
            __floats2bfloat162_rn(dk[dn][0], dk[dn][1]);
        *reinterpret_cast<__nv_bfloat162*>(dvb + key0 * p.dv_ss + col) =
            __floats2bfloat162_rn(dv[dn][0], dv[dn][1]);
      }
      if (key1 < p.Sk) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + key1 * p.dk_ss + col) =
            __floats2bfloat162_rn(dk[dn][2], dk[dn][3]);
        *reinterpret_cast<__nv_bfloat162*>(dvb + key1 * p.dv_ss + col) =
            __floats2bfloat162_rn(dv[dn][2], dv[dn][3]);
      }
    }
  }
}

template <int DP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem_dq = (2 * BN * (DP + 8) + DP * (BN + 8)) * 2;
  constexpr int smem_dkv = (2 * BM * (DP + 8) + 2 * DP * (BM + 8)) * 2 + 2 * BM * 4;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkv);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const long long rows = (long long)p.B * p.H * p.Sq;
  const long long delta_blocks = (rows + NTHREADS / 32 - 1) / (NTHREADS / 32);
  flash_bwd_delta_kernel<<<(unsigned)delta_blocks, NTHREADS, 0, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long nmt = (p.Sq + BM - 1) / BM;
  flash_bwd_dq_kernel<DP><<<(unsigned)(nmt * p.H * p.B), NTHREADS, smem_dq, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long nnt = (p.Sk + BN - 1) / BN;
  flash_bwd_dkv_kernel<DP><<<(unsigned)(nnt * p.H * p.B), NTHREADS, smem_dkv, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry (bound with ctypes). Returns a cudaError_t code, 0 = ok.
// ptrs: q, k, v, o, dO, dq, dk, dv (bf16), in that order; strides: their
// (batch, head, token) element strides, three each in the same order. The
// head dim must be contiguous, D % 8 == 0, D <= 128, every stride a
// multiple of 8 and every pointer 16-byte aligned (checked by the Python
// wrapper). lse and delta are contiguous f32 [B,H,Sq]; delta is scratch
// that the call fills.
extern "C" int vgt_flash_bwd(
    const void* const* ptrs, const long long* strides,
    const void* lse, void* delta, const void* kv_lens, const void* q_start,
    int B, int H, int Sq, int Sk, int D, int causal, float sm_scale,
    void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(ptrs[0]);
  p.k = static_cast<const __nv_bfloat16*>(ptrs[1]);
  p.v = static_cast<const __nv_bfloat16*>(ptrs[2]);
  p.o = static_cast<const __nv_bfloat16*>(ptrs[3]);
  p.dout = static_cast<const __nv_bfloat16*>(ptrs[4]);
  p.dq = static_cast<__nv_bfloat16*>(const_cast<void*>(ptrs[5]));
  p.dk = static_cast<__nv_bfloat16*>(const_cast<void*>(ptrs[6]));
  p.dv = static_cast<__nv_bfloat16*>(const_cast<void*>(ptrs[7]));
  const long long* s = strides;
  p.q_sb = s[0]; p.q_sh = s[1]; p.q_ss = s[2];
  p.k_sb = s[3]; p.k_sh = s[4]; p.k_ss = s[5];
  p.v_sb = s[6]; p.v_sh = s[7]; p.v_ss = s[8];
  p.o_sb = s[9]; p.o_sh = s[10]; p.o_ss = s[11];
  p.do_sb = s[12]; p.do_sh = s[13]; p.do_ss = s[14];
  p.dq_sb = s[15]; p.dq_sh = s[16]; p.dq_ss = s[17];
  p.dk_sb = s[18]; p.dk_sh = s[19]; p.dk_ss = s[20];
  p.dv_sb = s[21]; p.dv_sh = s[22]; p.dv_ss = s[23];
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.q_start = static_cast<const int*>(q_start);
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk; p.D = D;
  p.causal = causal;
  p.sm_scale = sm_scale;
  p.scale_log2 = sm_scale * LOG2E;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (D <= 64) e = launch<64>(p, st);
  else if (D <= 80) e = launch<80>(p, st);
  else if (D <= 96) e = launch<96>(p, st);
  else if (D <= 128) e = launch<128>(p, st);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
