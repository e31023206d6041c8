// K1: online-softmax attention forward for Hopper (sm_90a), bf16 or f32
// in/out, f32 accumulation.
//
// Replaces two Pallas TPU kernels of videoglamm_tpu/ops/attention.py:
//   * _flash_kernel (:93, launched by _flash_fwd :245): blockwise
//     online-softmax attention over [B,H,S,D] with a per-batch kv_len and
//     causal offset q_start (Phi-3 prefill, Hiera global blocks);
//   * _bshd_kernel (:738, launched by _bshd_fwd :802 and
//     _packed_padded_fwd :924): non-causal self-attention reading heads in
//     place from [B,S,H*D] or a fused qkv, optionally block-diagonal over
//     `win`-token windows (CLIP, InternVideo2, Hiera window attention).
//
// One entry serves both: q, k, v and o are addressed through element
// strides (batch, head, token; the head dim is contiguous), so [B,H,S,D],
// [B,S,H,D] and the fused [B,S,3,H,D] qkv are read with no copy or pad.
// Rows with no valid key write 0 (attention.py:170-174); with an `lse`
// pointer each row's log-sum-exp of the scaled logits is written too
// (:176-180), NEG_INF (-1e30) for a row with no key, which training saves
// for the backward (flash_bwd.cu).
//
// What bounds it on the H100: at the path's shapes (S from 64 to 4096, head
// dim 64..128) attention is compute-bound on QK^T and PV (bf16 tensor cores,
// 989 TFLOP/s dense) plus the f32 exp2 of the softmax.
//
// Two routes, chosen by storage type and head dim (ops/attention.py
// `k1_route` states the same rule; each route has its own launch counter):
//
// * "wgmma" (bf16, D <= 128: every serving and training call of the main
//   path: causal prefill, flash, bshd, window, causal with LSE, Llama-3.1 at
//   D = 128). A CTA of three warpgroups owns 128 queries of one (batch,
//   head). Warpgroup 2 is the producer: one thread loads the Q tile, then
//   K and V tiles of 128 keys with TMA into a two-stage ring of shared
//   memory, each stage on mbarriers (full: expect_tx bytes; empty: the
//   consumers' arrivals); it gives its registers to the consumers
//   (setmaxnreg). Warpgroups 0 and 1 each own 64 query rows: S = Q K^T is
//   one wgmma m64n128k16 chain with Q and K from shared memory (the K tile
//   [keys, D] is K-major for B); the online softmax runs on exp2 in f32
//   registers; P, packed to bf16 straight from the S accumulators (the
//   accumulator layout of an m64 wgmma is the A-register layout of the
//   next), multiplies V from shared memory as an MN-major B (the
//   descriptor's transpose bit), so V is never transposed by hand. The
//   head dim pads to DP (a multiple of 16) for QK^T and is the N of PV; TMA
//   fills the columns past D with zeros, also in a fused-qkv view where the
//   next head's data lies behind them, and the store clips at D. Tiles are
//   128-byte swizzled chunks of 64 columns (D = 80, 96, 128 load as two).
//   The mask is applied only on tiles that cross kv_len, the causal
//   diagonal or a window edge; tiles wholly masked are never loaded. Keys
//   at or past kv_len but below Sk are real memory (a KV cache's slack,
//   possibly NaN): the consumers zero those V rows of the last live tile in
//   shared memory before PV, since 0 * NaN is NaN. Query tiles are handed
//   out longest first (reverse order), so a causal grid does not end on
//   its longest tiles. The output goes through shared memory and a TMA
//   store.
// * "mma_sync" (f32 storage, or D up to 256: the SAM-2 memory self-attention
//   [4,1,4096,256] f32): one CTA of 4 warps per 64-query tile, mma.sync
//   m16n8k16, Q in registers as A fragments, K and V^T staged in shared
//   memory by plain loads. At head dim 256 Q is reloaded from shared memory
//   per K step and key tiles are 32 wide (registers). f32 operands are
//   rounded to bf16 on the way into shared memory; accumulation, softmax and
//   the output stay f32 (bf16-class error against the f32 twin).
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "mma_common.cuh"
#include "sm90_common.cuh"

constexpr int BM = 64;        // queries per CTA (4 warps x 16 rows)
constexpr int NTHREADS = 128;

struct Params {
  const void* q;        // bf16 or f32 (the kernel's T), strides in elements
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  const int* kv_lens;   // [B] or null (= Sk)
  const int* q_start;   // [B] absolute key position of query 0, or null (= 0)
  float* lse;           // [B,H,Sq] f32 row log-sum-exp of the scaled logits, or
                        // null: what the backward (flash_bwd.cu) recomputes from
  int B, H, Sq, Sk, D;
  int causal, win;
  float scale_log2;     // sm_scale * log2(e): the softmax runs on exp2
};

// DP: padded head dim; BN: keys per shared-memory tile; QREG: Q fragments
// live in registers (else reloaded from shared memory per K step).
template <int DP, int BN, bool QREG, typename T>
__global__ void __launch_bounds__(NTHREADS) attn_fwd_kernel(const Params p) {
  constexpr int LDS = DP + 8;   // padded row stride (elements): no bank conflicts
  constexpr int LDV = BN + 8;
  constexpr int CH = DP / 8;    // 16-byte chunks per row
  constexpr int KS = DP / 16;   // mma K steps over the head dim
  constexpr int NT = BN / 8;    // mma N tiles over a key tile
  constexpr int DT = DP / 8;    // mma N tiles over the head dim

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BM * LDS;
  __nv_bfloat16* sVt = sK + BN * LDS;   // V transposed: [DP][BN]

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

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  // live key range of this query tile (tiles outside it are skipped)
  const int last_row = min(m0 + BM, p.Sq) - 1;
  int k_lo = 0, k_hi = kv_len;
  if (p.causal) k_hi = min(k_hi, q_off + last_row + 1);
  if (p.win > 0) {
    k_lo = (m0 / p.win) * p.win;
    k_hi = min(k_hi, (last_row / p.win + 1) * p.win);
  }
  const int j_lo = k_lo / BN;
  const int j_hi = k_hi > k_lo ? (k_hi + BN - 1) / BN : j_lo;

  // Q tile -> shared memory -> per-warp A fragments in registers
  for (int idx = tid; idx < BM * CH; idx += NTHREADS) {
    const int r = idx / CH, d0 = (idx % CH) * 8;
    const int row = m0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < p.Sq && d0 < p.D) val = Io<T>::load8(qb + row * p.q_ss + d0);
    *reinterpret_cast<uint4*>(sQ + r * LDS + d0) = val;
  }
  __syncthreads();

  const int qr = warp * 16;
  const __nv_bfloat16* qbase = sQ + (qr + g) * LDS + 2 * t;
  uint32_t qf[QREG ? KS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const __nv_bfloat16* base = qbase + ks * 16;
      qf[ks][0] = ld32(base);
      qf[ks][1] = ld32(base + 8 * LDS);
      qf[ks][2] = ld32(base + 8);
      qf[ks][3] = ld32(base + 8 * LDS + 8);
    }
  }

  const int r0 = m0 + qr + g;   // this thread's two query rows
  const int r1 = r0 + 8;

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};

  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * BN;
    __syncthreads();   // every warp is done with the previous K/V tile
    for (int idx = tid; idx < BN * CH; idx += NTHREADS) {
      const int r = idx / CH, d0 = (idx % CH) * 8;
      const int key = k0 + r;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (key < kv_len && d0 < p.D) {   // rows past kv_len read as zeros
        kv4 = Io<T>::load8(kb + key * p.k_ss + d0);
        vv4 = Io<T>::load8(vb + key * p.v_ss + d0);
      }
      *reinterpret_cast<uint4*>(sK + r * LDS + d0) = kv4;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int i = 0; i < 8; ++i) sVt[(d0 + i) * LDV + r] = ve[i];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BN keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      if constexpr (QREG) {
        a[0] = qf[ks][0]; a[1] = qf[ks][1]; a[2] = qf[ks][2]; a[3] = qf[ks][3];
      } else {
        const __nv_bfloat16* base = qbase + ks * 16;
        a[0] = ld32(base);
        a[1] = ld32(base + 8 * LDS);
        a[2] = ld32(base + 8);
        a[3] = ld32(base + 8 * LDS + 8);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* kbase = sK + (n * 8 + g) * LDS + ks * 16 + 2 * t;
        mma_bf16(s[n], a, ld32(kbase), ld32(kbase + 8));
      }
    }

    // scale + mask (kv_len, causal offset, block-diagonal window)
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r1;
        bool ok = key < kv_len;
        if (p.causal) ok = ok && key <= q_off + row;
        if (p.win > 0) ok = ok && (key / p.win == row / p.win);
        s[n][e] = ok ? s[n][e] * p.scale_log2 : -INFINITY;
      }
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = exp2f(m_i[r] - base[r]);
      m_i[r] = mx[r];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = exp2f(s[n][0] - base[0]);
      s[n][1] = exp2f(s[n][1] - base[0]);
      s[n][2] = exp2f(s[n][2] - base[1]);
      s[n][3] = exp2f(s[n][3] - base[1]);
      rs[0] += s[n][0] + s[n][1];
      rs[1] += s[n][2] + s[n][3];
    }
    l_i[0] = l_i[0] * alpha[0] + rs[0];   // per-thread partial row sums
    l_i[1] = l_i[1] * alpha[1] + rs[1];
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      acc[i][0] *= alpha[0]; acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1]; acc[i][3] *= alpha[1];
    }

    // O += P V: the S accumulators are reused as bf16 A fragments
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

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
    inv[r] = l_i[r] > 0.f ? 1.f / l_i[r] : 0.f;
  }
  if (p.lse != nullptr && t == 0) {
    // m_i is in log2 units; a row with no valid key gets -1e30, as the TPU
    // kernel writes it (attention.py:178)
    float* lb = p.lse + ((long long)b * p.H + h) * p.Sq;
    if (r0 < p.Sq)
      lb[r0] = l_i[0] > 0.f ? m_i[0] * 0.6931471805599453f + logf(l_i[0]) : -1e30f;
    if (r1 < p.Sq)
      lb[r1] = l_i[1] > 0.f ? m_i[1] * 0.6931471805599453f + logf(l_i[1]) : -1e30f;
  }
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (col < p.D) {
      if (r0 < p.Sq)
        Io<T>::store2(ob + r0 * p.o_ss + col, acc[dn][0] * inv[0], acc[dn][1] * inv[0]);
      if (r1 < p.Sq)
        Io<T>::store2(ob + r1 * p.o_ss + col, acc[dn][2] * inv[1], acc[dn][3] * inv[1]);
    }
  }
}

template <int DP, int BN, bool QREG, typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = (BM * (DP + 8) + BN * (DP + 8) + DP * (BN + 8)) * 2;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_kernel<DP, BN, QREG, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const long long nmt = (p.Sq + BM - 1) / BM;
  const long long blocks = nmt * p.H * p.B;
  attn_fwd_kernel<DP, BN, QREG, T><<<(unsigned)blocks, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// route "mma_sync": every head dim for f32 storage, head dim 256 for bf16
cudaError_t dispatch_f32(const Params& p, cudaStream_t s) {
  const int D = p.D;
  if (D <= 32) return launch<32, 64, true, float>(p, s);
  if (D <= 64) return launch<64, 64, true, float>(p, s);
  if (D <= 80) return launch<80, 64, true, float>(p, s);
  if (D <= 96) return launch<96, 64, true, float>(p, s);
  if (D <= 128) return launch<128, 64, true, float>(p, s);
  if (D <= 256) return launch<256, 32, false, float>(p, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// route "wgmma": bf16, D <= 128
// ---------------------------------------------------------------------------
namespace sm90 {

constexpr int BM = 128;         // queries a CTA: two consumer warpgroups of 64
constexpr int BN = 128;         // keys a tile
constexpr int STAGES = 2;       // K/V ring depth
constexpr int NTHREADS = 384;   // warpgroups 0, 1: consumers; 2: producer
constexpr int CHUNK_Q = BM * 128;    // bytes of one 64-column chunk of Q
constexpr int CHUNK_KV = BN * 128;

template <int DP> struct Layout {
  static constexpr int NCH = (DP + 63) / 64;   // 64-column chunks a row
  static constexpr int Q = 0;
  static constexpr int K = Q + NCH * CHUNK_Q;
  static constexpr int V = K + STAGES * NCH * CHUNK_KV;
  static constexpr int BAR = V + STAGES * NCH * CHUNK_KV;
  static constexpr int BYTES = BAR + 8 * (1 + 3 * STAGES);
};

// DP: the padded head dim, a multiple of 16: the depth of QK^T and the N of
// PV.
template <int DP>
__global__ void __launch_bounds__(NTHREADS, 1) attn_fwd_sm90(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
    const Params p) {
  using L = Layout<DP>;
  constexpr int NCH = L::NCH;
  constexpr int KSTEPS = DP / 16;
  extern __shared__ __align__(1024) unsigned char smem_sm90[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_sm90) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* kv_empty = v_full + STAGES;

  const int BH = p.B * p.H;
  const int nmt = (p.Sq + BM - 1) / BM;
  const int mt = nmt - 1 - static_cast<int>(blockIdx.x) / BH;   // longest first
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int h = bh % p.H, b = bh / p.H;
  const int m0 = mt * BM;
  const int kv_len = p.kv_lens ? min(p.kv_lens[b], p.Sk) : p.Sk;
  const int q_off = p.q_start ? p.q_start[b] : 0;

  // live key range of the CTA's query rows; tiles outside it are skipped
  const int last_row = min(m0 + BM, p.Sq) - 1;
  int k_lo = 0, k_hi = kv_len;
  if (p.causal) k_hi = min(k_hi, q_off + last_row + 1);
  if (p.win > 0) {
    k_lo = (m0 / p.win) * p.win;
    k_hi = min(k_hi, (last_row / p.win + 1) * p.win);
  }
  const int j_lo = k_lo / BN;
  const int ntiles = k_hi > k_lo ? (k_hi + BN - 1) / BN - j_lo : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(kv_empty + s, 256);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = tid / 128;

  if (wg == 2) {
    // ---------------- producer: one thread issues every TMA load
    reg_dealloc<40>();
    if (tid == 256) {
      mbar_expect_tx(q_full, NCH * CHUNK_Q);
      for (int c = 0; c < NCH; ++c)
        tma_load_4d(smem + L::Q + c * CHUNK_Q, &tq, q_full, 64 * c, m0, h, b);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const int k0 = (j_lo + it) * BN;
        mbar_wait(kv_empty + s, ph ^ 1);
        mbar_expect_tx(k_full + s, NCH * CHUNK_KV);
        for (int c = 0; c < NCH; ++c)
          tma_load_4d(smem + L::K + (s * NCH + c) * CHUNK_KV, &tk, k_full + s,
                      64 * c, k0, h, b);
        mbar_expect_tx(v_full + s, NCH * CHUNK_KV);
        for (int c = 0; c < NCH; ++c)
          tma_load_4d(smem + L::V + (s * NCH + c) * CHUNK_KV, &tv, v_full + s,
                      64 * c, k0, h, b);
      }
    }
  } else {
    // ---------------- consumers: warpgroup wg owns query rows m0w .. m0w+63
    reg_alloc<232>();
    const int lt = tid % 128;
    const int warp = lt / 32, lane = lt % 32;
    const int g = lane / 4, t = lane % 4;
    const int m0w = m0 + 64 * wg;
    const int r0 = m0w + warp * 16 + g;   // this thread's two query rows
    const int r1 = r0 + 8;
    unsigned char* sQw = smem + L::Q + wg * 64 * 128;

    // each row's attendable keys are one interval [lo, hi)
    int lo[2] = {0, 0}, hi[2] = {kv_len, kv_len};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? r1 : r0;
      if (p.causal) hi[r] = min(hi[r], q_off + row + 1);
      if (p.win > 0) {
        lo[r] = (row / p.win) * p.win;
        hi[r] = min(hi[r], lo[r] + p.win);
      }
    }

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m_i[2] = {-INFINITY, -INFINITY};
    float l_i[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % STAGES;
      const uint32_t ph = (it / STAGES) & 1;
      const int k0 = (j_lo + it) * BN;
      const unsigned char* sK = smem + L::K + s * NCH * CHUNK_KV;
      unsigned char* sV = smem + L::V + s * NCH * CHUNK_KV;

      // S = Q K^T (64 x 128), both operands K-major in shared memory
      mbar_wait(k_full + s, ph);
      float sc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
      fence_regs<BN / 2>(sc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const int off = (ks / 4) * CHUNK_Q + (ks % 4) * 32;
        const int offk = (ks / 4) * CHUNK_KV + (ks % 4) * 32;
        Wgmma<BN>::ss(sc, desc_sw128(sQw + off, 0, 1024),
                      desc_sw128(sK + offk, 0, 1024), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BN / 2>(sc);

      // scale; mask only a tile that crosses kv_len, the diagonal or a window
      const bool edge = k0 + BN > kv_len ||
                        (p.causal && k0 + BN - 1 > q_off + m0w) || p.win > 0;
      if (edge) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * i + 2 * t + (e & 1);
            const int r = e >> 1;
            sc[4 * i + e] = key >= lo[r] && key < hi[r]
                                ? sc[4 * i + e] * p.scale_log2 : -INFINITY;
          }
      } else {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sc[i] *= p.scale_log2;
      }

      // online softmax on exp2 (two rows a thread, a row over a quad)
      float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * i], sc[4 * i + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
      }
      float alpha[2], base[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
        alpha[r] = exp2f(m_i[r] - base[r]);
        m_i[r] = mx[r];
      }
      float rs[2] = {0.f, 0.f};
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const float p0 = exp2f(sc[4 * i] - base[0]);
        const float p1 = exp2f(sc[4 * i + 1] - base[0]);
        const float p2 = exp2f(sc[4 * i + 2] - base[1]);
        const float p3 = exp2f(sc[4 * i + 3] - base[1]);
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        pa[i / 2][(i % 2) * 2] = pack_bf16(p0, p1);
        pa[i / 2][(i % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
      l_i[0] = l_i[0] * alpha[0] + rs[0];   // per-thread partial row sums
      l_i[1] = l_i[1] * alpha[1] + rs[1];
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        o[4 * i] *= alpha[0]; o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1]; o[4 * i + 3] *= alpha[1];
      }

      mbar_wait(v_full + s, ph);
      // keys in [kv_len, Sk) of this tile are real memory: zero their V rows
      // (the whole CTA sees the same tiles, so both warpgroups come here)
      const int vrow = kv_len - k0;
      if (vrow < BN && kv_len < p.Sk) {
        const int vend = min(BN, p.Sk - k0);
        const int per = (vend - vrow) * 8;   // 16-byte pieces a chunk
        for (int i = tid; i < per * NCH; i += 256) {
          const int c = i / per, rem = i % per;
          *reinterpret_cast<uint4*>(sV + c * CHUNK_KV + (vrow + rem / 8) * 128 +
                                    (rem % 8) * 16) = make_uint4(0u, 0u, 0u, 0u);
        }
        fence_proxy_async();
        named_bar_sync(1, 256);
      }

      // O += P V: P from registers, V [keys, D] as an MN-major B
      fence_regs<DP / 2>(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        Wgmma<DP>::rs_t(o, pa[kk], desc_sw128(sV + kk * 16 * 128, CHUNK_KV, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<DP / 2>(o);
      mbar_arrive(kv_empty + s);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
      inv[r] = l_i[r] > 0.f ? 1.f / l_i[r] : 0.f;
    }
    if (p.lse != nullptr && t == 0) {
      float* lb = p.lse + (static_cast<long long>(b) * p.H + h) * p.Sq;
      if (r0 < p.Sq)
        lb[r0] = l_i[0] > 0.f ? m_i[0] * 0.6931471805599453f + logf(l_i[0]) : -1e30f;
      if (r1 < p.Sq)
        lb[r1] = l_i[1] > 0.f ? m_i[1] * 0.6931471805599453f + logf(l_i[1]) : -1e30f;
    }
    // O -> bf16 into this warpgroup's Q rows (its own, no longer read), in
    // the 128-byte swizzle that the store's map expects, then one TMA store
    // a chunk (rows past Sq and columns past D are clipped)
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int col = 8 * i + 2 * t;
      const int c = col / 64, cc = col % 64;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;
        *reinterpret_cast<uint32_t*>(sQw + c * CHUNK_Q + row * 128 +
                                     (((cc / 8) ^ (row % 8)) * 16) + (cc % 8) * 2) =
            pack_bf16(o[4 * i + 2 * r] * inv[r], o[4 * i + 2 * r + 1] * inv[r]);
      }
    }
    fence_proxy_async();
    named_bar_sync(2 + wg, 128);
    if (lt == 0) {
      for (int c = 0; c < NCH; ++c)
        tma_store_4d(&to, sQw + c * CHUNK_Q, 64 * c, m0w, h, b);
      bulk_commit();
      bulk_wait_all();
    }
  }
}

template <int DP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = Layout<DP>::BYTES + 1024;   // + alignment slack
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_sm90<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap tq, tk, tv, to;
  if (!map_bhsd(&tq, p.q, p.q_sb, p.q_sh, p.q_ss, p.B, p.H, p.Sq, p.D, BM) ||
      !map_bhsd(&tk, p.k, p.k_sb, p.k_sh, p.k_ss, p.B, p.H, p.Sk, p.D, BN) ||
      !map_bhsd(&tv, p.v, p.v_sb, p.v_sh, p.v_ss, p.B, p.H, p.Sk, p.D, BN) ||
      !map_bhsd(&to, p.o, p.o_sb, p.o_sh, p.o_ss, p.B, p.H, p.Sq, p.D, 64))
    return cudaErrorInvalidValue;
  const long long blocks =
      static_cast<long long>((p.Sq + BM - 1) / BM) * p.H * p.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  attn_fwd_sm90<DP><<<static_cast<unsigned>(blocks), NTHREADS, smem, stream>>>(
      tq, tk, tv, to, p);
  return cudaGetLastError();
}

cudaError_t dispatch(const Params& p, cudaStream_t s) {
  const int D = p.D;
  if (D <= 32) return launch<32>(p, s);
  if (D <= 64) return launch<64>(p, s);
  if (D <= 80) return launch<80>(p, s);
  if (D <= 96) return launch<96>(p, s);
  if (D <= 128) return launch<128>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace sm90


}  // namespace

// Plain C entry (bound with ctypes). Returns a cudaError_t code, 0 = ok.
// q, k, v and o are bf16, or f32 when `is_f32` is set. Strides are in
// elements; the head dim must be contiguous, D % 8 == 0, D <= 256, every
// stride a multiple of 8 and every pointer 16-byte aligned (checked by the
// Python wrapper). `lse` is null or a contiguous f32 [B,H,Sq].
extern "C" int vgt_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    const void* kv_lens, const void* q_start,
    int B, int H, int Sq, int Sk, int D, int causal, int win,
    float sm_scale, void* lse, int is_f32, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.q_start = static_cast<const int*>(q_start);
  p.lse = static_cast<float*>(lse);
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk; p.D = D;
  p.causal = causal; p.win = win;
  p.scale_log2 = sm_scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (is_f32)
    e = dispatch_f32(p, s);
  else if (D <= 128 && (e = use_device_of(q)) == cudaSuccess)
    e = sm90::dispatch(p, s);   // route "wgmma"
  else if (D <= 256)
    e = launch<256, 32, false, __nv_bfloat16>(p, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
