// K6: flash-attention backward for Hopper (sm_90a), bf16 in/out, f32
// accumulation, on wgmma, TMA and an mbarrier ring.
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
//   ds = mask ? p * (dp - delta) * sm_scale : 0     delta = rowsum(dO * out)
//   dq = ds k,  dk = ds^T q,  dv = p^T dO
// p and ds are rounded to bf16 before the last three products, which
// accumulate in f32 (:327-329, :364-369).
//
// What bounds it on the H100: operations. At the training shape
// [2,32,3456,96] causal the five products are 0.37 TFLOP (0.37 ms at the
// bf16 peak) against some 0.34 GB of operands, far above the card's 295
// operations a byte. The design keeps the tensor cores fed from shared
// memory that TMA fills ahead of them.
//
// Three __global__ kernels, no atomics, so two calls on the same inputs give
// bit-equal results whatever order the blocks run in:
//   * delta prepass: one warp per query row, f32 [B,H,Sq].
//   * dk/dv (`flash_bwd_dkv`), the counterpart of `_flash_bwd_dkv_kernel`:
//     one CTA of three warpgroups per (batch, head, 128-key tile), key tiles
//     from the start of the sequence first (in causal order they see the
//     most queries). Warpgroup 2 is the producer: one thread loads the K and
//     V tiles once by TMA, then 64-query tiles of Q and dO into a ring of
//     STAGES stages; another warp of it writes each tile's 64 lse (times
//     log2 e) and delta values beside them, so a stage's full barrier counts
//     that warp's 32 arrivals, the TMA thread's and the TMA bytes; the empty
//     barriers count the consumers' arrivals. The producer gives its
//     registers to the consumers (setmaxnreg). Warpgroups 0 and 1 own 64
//     keys each:
//     S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, both operands K-major
//     in shared memory), P^T and dS^T in f32 registers, then
//     dV += bf16(P^T) dO and dK += bf16(dS^T) Q with the A operand packed
//     from the accumulators (the accumulator layout of an m64 wgmma is the
//     A-register layout of the next) and dO, Q read as MN-major B (the
//     descriptor's transpose bit), so nothing is transposed by hand. The
//     loop starts at the first query tile that causal order and the batch
//     row's q_start (possibly negative) let see the key tile; a key tile
//     wholly past kv_len does no product. dK and dV leave through the K and
//     V tiles in shared memory and a TMA store that clips at Sk and D.
//   * dq (`flash_bwd_dq`), the counterpart of `_flash_bwd_dq_kernel`: one
//     CTA per (batch, head, 128-query tile), the longest tiles first.
//     Q and dO are loaded once; 64-key tiles of K and V come through the
//     ring up to the CTA's last live key (causal order, kv_len). Each
//     consumer warpgroup owns 64 queries and keeps their lse and delta in
//     registers: S = Q K^T, dP = dO V^T (ss), dS, then dQ += bf16(dS) K with
//     K as MN-major B. Keys in [kv_len, Sk) are real memory (possibly NaN)
//     and 0 * NaN is NaN in dS K, so both warpgroups zero those K rows of
//     the one tile that holds them in shared memory (a named barrier and a
//     proxy fence) before the products. dQ leaves through the Q tile and a
//     TMA store; a row with no valid key writes zeros.
// The mask is applied only on tiles that cross kv_len or the causal
// diagonal, and always by selection, never by multiplication: a row with
// lse = -1e30 (no valid key) overflows exp and is still an exact 0, and
// NaN in the K/V slack never reaches a product. The head dim pads to DP (a
// multiple of 16, as K1's wgmma route: D 72 -> 80, 88 -> 96): TMA fills the
// columns past D and the rows past S with zeros, the stores clip at D and
// S. Tiles are 128-byte swizzled boxes of 64 rows and 64 columns; a row of
// DP = 80 to 128 is two of them. S and dP are computed in both kernels:
// seven products where five are needed; sharing them needs atomics or an
// ordered reduction of dq.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "sm90_common.cuh"

constexpr float LOG2E = 1.4426950408889634f;
constexpr int ROWS = 128;       // keys (dk/dv) or queries (dq) a CTA owns
constexpr int TILE = 64;        // queries (dk/dv) or keys (dq) a ring stage holds
constexpr int STAGES = 2;       // ring depth
constexpr int NTHREADS = 384;   // warpgroups 0, 1: consumers; 2: producer
constexpr int BOX = TILE * 128; // bytes of a TMA box: 64 rows x 64 bf16
constexpr int DELTA_THREADS = 128;

struct Params {
  const __nv_bfloat16* o;      // read by the delta prepass only
  const __nv_bfloat16* dout;
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  const float* lse;     // [B,H,Sq]
  float* delta;         // [B,H,Sq] scratch
  const int* kv_lens;   // [B] or null (= Sk)
  const int* q_start;   // [B] absolute key position of query 0, or null (= 0)
  int B, H, Sq, Sk, D;
  int causal;
  float sm_scale;
  float scale_log2;     // sm_scale * log2(e)
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the byte offset of (row, col) in a 128-byte-swizzled box of 64 columns
__device__ __forceinline__ int swz(int row, int col) {
  return row * 128 + (((col / 8) ^ (row % 8)) * 16) + (col % 8) * 2;
}

// the m64 accumulators of `acc` (DP / 2 a thread) -> bf16 into the
// warpgroup's boxes `dst` (one a 64-column chunk), as a TMA store reads them
template <int DP>
__device__ __forceinline__ void stage_out(unsigned char* dst, const float* acc,
                                          int warp, int g, int t) {
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int col = 8 * i + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      *reinterpret_cast<uint32_t*>(dst + (col / 64) * BOX + swz(row, col % 64)) =
          pack_bf16(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
    }
  }
}

// delta[b,h,row] = sum_d dO * out, one warp per row
__global__ void __launch_bounds__(DELTA_THREADS) flash_bwd_delta(const Params p) {
  const long long row_id =
      (long long)blockIdx.x * (DELTA_THREADS / 32) + (threadIdx.x >> 5);
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

// ---------------------------------------------------------------------------
// dk/dv
// ---------------------------------------------------------------------------
template <int DP> struct DkvLayout {
  static constexpr int NCH = (DP + 63) / 64;   // 64-column chunks a row
  static constexpr int K = 0;                  // [warpgroup][chunk] boxes
  static constexpr int V = K + 2 * NCH * BOX;
  static constexpr int Q = V + 2 * NCH * BOX;  // [stage][chunk] boxes
  static constexpr int G = Q + STAGES * NCH * BOX;   // dO
  static constexpr int L = G + STAGES * NCH * BOX;   // [stage][64] lse * log2 e
  static constexpr int DL = L + STAGES * TILE * 4;   // [stage][64] delta
  static constexpr int BAR = DL + STAGES * TILE * 4;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES);
};

template <int DP>
__global__ void __launch_bounds__(NTHREADS, 1) flash_bwd_dkv(
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tdk, const __grid_constant__ CUtensorMap tdv,
    const Params p) {
  using L = DkvLayout<DP>;
  constexpr int NCH = L::NCH;
  constexpr int KSTEPS = DP / 16;
  extern __shared__ __align__(1024) unsigned char smem_dkv[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_dkv) + 1023) & ~uintptr_t(1023));
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int BH = p.B * p.H;
  const int nt = static_cast<int>(blockIdx.x) / BH;   // key tile 0 first
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int h = bh % p.H, b = bh / p.H;
  const int n0 = nt * ROWS;
  const int kv_len = p.kv_lens ? min(p.kv_lens[b], p.Sk) : p.Sk;
  const int q_off = p.q_start ? p.q_start[b] : 0;

  // live query tiles: from the first that sees the key tile; none past kv_len
  const int nmt = (p.Sq + TILE - 1) / TILE;
  const int i_lo = p.causal ? max(0, n0 - q_off) / TILE : 0;
  const int n_it = n0 < kv_len ? max(0, nmt - i_lo) : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 33);     // the TMA thread and the lse / delta warp
      mbar_init(empty + s, 256);   // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = tid / 128;

  if (wg == 2) {
    // ---------------- producer: one thread of warp 0 issues every TMA
    // load, warp 1 writes the lse and delta rows of each query tile
    reg_dealloc<40>();
    const int pw = (tid - 256) / 32, lane = tid % 32;
    if (n_it > 0 && pw == 0 && lane == 0) {
      mbar_expect_tx(kv_full, 2 * 2 * NCH * BOX);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < NCH; ++c) {
          tma_load_4d(smem + L::K + (w * NCH + c) * BOX, &tk, kv_full, 64 * c,
                      n0 + TILE * w, h, b);
          tma_load_4d(smem + L::V + (w * NCH + c) * BOX, &tv, kv_full, 64 * c,
                      n0 + TILE * w, h, b);
        }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES;
        const int m0 = (i_lo + it) * TILE;
        mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, 2 * NCH * BOX);
        for (int c = 0; c < NCH; ++c) {
          tma_load_4d(smem + L::Q + (s * NCH + c) * BOX, &tq, full + s, 64 * c,
                      m0, h, b);
          tma_load_4d(smem + L::G + (s * NCH + c) * BOX, &tdo, full + s, 64 * c,
                      m0, h, b);
        }
      }
    } else if (n_it > 0 && pw == 1) {
      const float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Sq;
      const float* delta = p.delta + (static_cast<long long>(b) * p.H + h) * p.Sq;
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES;
        const int m0 = (i_lo + it) * TILE;
        // read before the wait, so the latency overlaps the consumers' work
        float lv[TILE / 32], dl[TILE / 32];
#pragma unroll
        for (int j = 0; j < TILE / 32; ++j) {
          const int row = m0 + lane + 32 * j;
          lv[j] = row < p.Sq ? lse[row] * LOG2E : 0.f;
          dl[j] = row < p.Sq ? delta[row] : 0.f;
        }
        mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);
        float* sl = reinterpret_cast<float*>(smem + L::L) + s * TILE;
        float* sd = reinterpret_cast<float*>(smem + L::DL) + s * TILE;
#pragma unroll
        for (int j = 0; j < TILE / 32; ++j) {
          sl[lane + 32 * j] = lv[j];
          sd[lane + 32 * j] = dl[j];
        }
        mbar_arrive(full + s);
      }
    }
  } else {
    // ---------------- consumers: warpgroup wg owns keys key0w .. key0w+63
    reg_alloc<232>();
    const int lt = tid % 128;
    const int warp = lt / 32, lane = lt % 32;
    const int g = lane / 4, t = lane % 4;
    const int key0w = n0 + TILE * wg;
    const int kr0 = key0w + warp * 16 + g;   // this thread's two keys
    const int kr1 = kr0 + 8;
    unsigned char* sK = smem + L::K + wg * NCH * BOX;
    unsigned char* sV = smem + L::V + wg * NCH * BOX;

    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;

    if (n_it > 0) mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % STAGES;
      const uint32_t ph = (it / STAGES) & 1;
      const int m0 = (i_lo + it) * TILE;
      const unsigned char* sQ = smem + L::Q + s * NCH * BOX;
      const unsigned char* sG = smem + L::G + s * NCH * BOX;
      const float* sl = reinterpret_cast<const float*>(smem + L::L) + s * TILE;
      const float* sd = reinterpret_cast<const float*>(smem + L::DL) + s * TILE;
      mbar_wait(full + s, ph);

      // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries), K-major operands
      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      fence_regs<32>(st);
      fence_regs<32>(dpt);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const int off = (ks / 4) * BOX + (ks % 4) * 32;
        Wgmma<64>::ss(st, desc_sw128(sK + off, 0, 1024),
                      desc_sw128(sQ + off, 0, 1024), ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const int off = (ks / 4) * BOX + (ks % 4) * 32;
        Wgmma<64>::ss(dpt, desc_sw128(sV + off, 0, 1024),
                      desc_sw128(sG + off, 0, 1024), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(st);
      fence_regs<32>(dpt);

      // P^T and dS^T by selection, only on a tile that crosses kv_len or
      // the causal diagonal; packed to bf16 as A fragments as they come
      const bool edge = key0w + TILE > kv_len ||
                        (p.causal && key0w + TILE - 1 > q_off + m0);
      uint32_t pa[TILE / 16][4], da[TILE / 16][4];
#pragma unroll
      for (int i = 0; i < TILE / 8; ++i) {
        float pv[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = 8 * i + 2 * t + (e & 1);
          float pe = exp2f(fmaf(st[4 * i + e], p.scale_log2, -sl[ql]));
          float ds = pe * (dpt[4 * i + e] - sd[ql]) * p.sm_scale;
          if (edge) {
            const int key = (e >> 1) ? kr1 : kr0;
            const bool ok = key < kv_len && (!p.causal || key <= q_off + m0 + ql);
            pe = ok ? pe : 0.f;
            ds = ok ? ds : 0.f;
          }
          pv[e] = pe;
          dsv[e] = ds;
        }
        pa[i / 2][(i % 2) * 2] = pack_bf16(pv[0], pv[1]);
        pa[i / 2][(i % 2) * 2 + 1] = pack_bf16(pv[2], pv[3]);
        da[i / 2][(i % 2) * 2] = pack_bf16(dsv[0], dsv[1]);
        da[i / 2][(i % 2) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
      }

      // dV += P^T dO and dK += dS^T Q: dO and Q [queries, D] as MN-major B
      fence_regs<DP / 2>(dv);
      fence_regs<DP / 2>(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)
        Wgmma<DP>::rs_t(dv, pa[kk], desc_sw128(sG + kk * 16 * 128, BOX, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)
        Wgmma<DP>::rs_t(dk, da[kk], desc_sw128(sQ + kk * 16 * 128, BOX, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<DP / 2>(dv);
      fence_regs<DP / 2>(dk);
      mbar_arrive(empty + s);
    }

    // dK, dV -> bf16 over this warpgroup's own K and V rows (no longer
    // read; never loaded when n_it == 0), then one TMA store a chunk
    stage_out<DP>(sK, dk, warp, g, t);
    stage_out<DP>(sV, dv, warp, g, t);
    fence_proxy_async();
    named_bar_sync(2 + wg, 128);
    if (lt == 0 && key0w < p.Sk) {
      for (int c = 0; c < NCH; ++c) {
        tma_store_4d(&tdk, sK + c * BOX, 64 * c, key0w, h, b);
        tma_store_4d(&tdv, sV + c * BOX, 64 * c, key0w, h, b);
      }
      bulk_commit();
      bulk_wait_all();
    }
  }
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------
template <int DP> struct DqLayout {
  static constexpr int NCH = (DP + 63) / 64;
  static constexpr int Q = 0;                  // [warpgroup][chunk] boxes
  static constexpr int G = Q + 2 * NCH * BOX;  // dO
  static constexpr int K = G + 2 * NCH * BOX;  // [stage][chunk] boxes
  static constexpr int V = K + STAGES * NCH * BOX;
  static constexpr int BAR = V + STAGES * NCH * BOX;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES);
};

template <int DP>
__global__ void __launch_bounds__(NTHREADS, 1) flash_bwd_dq(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdq, const Params p) {
  using L = DqLayout<DP>;
  constexpr int NCH = L::NCH;
  constexpr int KSTEPS = DP / 16;
  extern __shared__ __align__(1024) unsigned char smem_dq[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_dq) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int BH = p.B * p.H;
  const int nmt = (p.Sq + ROWS - 1) / ROWS;
  const int mt = nmt - 1 - static_cast<int>(blockIdx.x) / BH;   // longest first
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int h = bh % p.H, b = bh / p.H;
  const int m0 = mt * ROWS;
  const int kv_len = p.kv_lens ? min(p.kv_lens[b], p.Sk) : p.Sk;
  const int q_off = p.q_start ? p.q_start[b] : 0;

  // live key range of the CTA's query rows: [0, k_hi)
  const int last_row = min(m0 + ROWS, p.Sq) - 1;
  int k_hi = kv_len;
  if (p.causal) k_hi = min(k_hi, q_off + last_row + 1);
  const int ntiles = k_hi > 0 ? (k_hi + TILE - 1) / TILE : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = tid / 128;

  if (wg == 2) {
    // ---------------- producer: one thread issues every TMA load
    reg_dealloc<40>();
    if (tid == 256) {
      mbar_expect_tx(q_full, 2 * 2 * NCH * BOX);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < NCH; ++c) {
          tma_load_4d(smem + L::Q + (w * NCH + c) * BOX, &tq, q_full, 64 * c,
                      m0 + TILE * w, h, b);
          tma_load_4d(smem + L::G + (w * NCH + c) * BOX, &tdo, q_full, 64 * c,
                      m0 + TILE * w, h, b);
        }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        mbar_wait(empty + s, ph ^ 1);
        mbar_expect_tx(full + s, 2 * NCH * BOX);
        for (int c = 0; c < NCH; ++c) {
          tma_load_4d(smem + L::K + (s * NCH + c) * BOX, &tk, full + s, 64 * c,
                      it * TILE, h, b);
          tma_load_4d(smem + L::V + (s * NCH + c) * BOX, &tv, full + s, 64 * c,
                      it * TILE, h, b);
        }
      }
    }
  } else {
    // ---------------- consumers: warpgroup wg owns queries q0w .. q0w+63
    reg_alloc<232>();
    const int lt = tid % 128;
    const int warp = lt / 32, lane = lt % 32;
    const int g = lane / 4, t = lane % 4;
    const int q0w = m0 + TILE * wg;
    unsigned char* sQ = smem + L::Q + wg * NCH * BOX;
    const unsigned char* sG = smem + L::G + wg * NCH * BOX;

    // this thread's two query rows: lse * log2 e, delta, attendable keys
    const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Sq;
    float lse2[2], dl[2];
    int hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0w + warp * 16 + g + 8 * r;
      lse2[r] = row < p.Sq ? p.lse[row_base + row] * LOG2E : 0.f;
      dl[r] = row < p.Sq ? p.delta[row_base + row] : 0.f;
      hi[r] = p.causal ? min(kv_len, q_off + row + 1) : kv_len;
    }

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    mbar_wait(q_full, 0);
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % STAGES;
      const uint32_t ph = (it / STAGES) & 1;
      const int k0 = it * TILE;
      unsigned char* sK = smem + L::K + s * NCH * BOX;
      const unsigned char* sV = smem + L::V + s * NCH * BOX;
      mbar_wait(full + s, ph);

      // keys in [kv_len, Sk) of this tile are real memory: zero their K
      // rows (B of dQ += dS K). Both warpgroups walk the same tiles.
      const int krow = kv_len - k0;
      if (krow < TILE && kv_len < p.Sk) {
        const int per = (min(TILE, p.Sk - k0) - krow) * 8;   // 16-byte pieces a chunk
        for (int i = tid; i < per * NCH; i += 256) {
          const int c = i / per, rem = i % per;
          *reinterpret_cast<uint4*>(sK + c * BOX + (krow + rem / 8) * 128 +
                                    (rem % 8) * 16) = make_uint4(0u, 0u, 0u, 0u);
        }
        fence_proxy_async();
        named_bar_sync(1, 256);
      }

      // S = Q K^T and dP = dO V^T (64 queries x 64 keys), K-major operands
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      fence_regs<32>(sc);
      fence_regs<32>(dp);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const int off = (ks / 4) * BOX + (ks % 4) * 32;
        Wgmma<64>::ss(sc, desc_sw128(sQ + off, 0, 1024),
                      desc_sw128(sK + off, 0, 1024), ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const int off = (ks / 4) * BOX + (ks % 4) * 32;
        Wgmma<64>::ss(dp, desc_sw128(sG + off, 0, 1024),
                      desc_sw128(sV + off, 0, 1024), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(sc);
      fence_regs<32>(dp);

      // dS by selection on an edge tile, packed to bf16 A fragments
      const bool edge = k0 + TILE > kv_len ||
                        (p.causal && k0 + TILE - 1 > q_off + q0w);
      uint32_t da[TILE / 16][4];
#pragma unroll
      for (int i = 0; i < TILE / 8; ++i) {
        float dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float pe = exp2f(fmaf(sc[4 * i + e], p.scale_log2, -lse2[r]));
          float ds = pe * (dp[4 * i + e] - dl[r]) * p.sm_scale;
          if (edge) {
            const int key = k0 + 8 * i + 2 * t + (e & 1);
            ds = key < hi[r] ? ds : 0.f;
          }
          dsv[e] = ds;
        }
        da[i / 2][(i % 2) * 2] = pack_bf16(dsv[0], dsv[1]);
        da[i / 2][(i % 2) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
      }

      // dQ += dS K: K [keys, D] as an MN-major B
      fence_regs<DP / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)
        Wgmma<DP>::rs_t(acc, da[kk], desc_sw128(sK + kk * 16 * 128, BOX, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<DP / 2>(acc);
      mbar_arrive(empty + s);
    }

    // dQ -> bf16 over this warpgroup's own Q rows, one TMA store a chunk
    stage_out<DP>(sQ, acc, warp, g, t);
    fence_proxy_async();
    named_bar_sync(2 + wg, 128);
    if (lt == 0 && q0w < p.Sq) {
      for (int c = 0; c < NCH; ++c)
        tma_store_4d(&tdq, sQ + c * BOX, 64 * c, q0w, h, b);
      bulk_commit();
      bulk_wait_all();
    }
  }
}

// the seven tensor maps: loads of q, k, v, dO and stores of dq, dk, dv
struct Maps {
  CUtensorMap q, k, v, dout, dq, dk, dv;
};

template <int DP>
cudaError_t launch(const Params& p, const Maps& m, cudaStream_t stream) {
  constexpr int smem_dq = DqLayout<DP>::BYTES + 1024;   // + alignment slack
  constexpr int smem_dkv = DkvLayout<DP>::BYTES + 1024;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(
        flash_bwd_dkv<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkv);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const long long rows = static_cast<long long>(p.B) * p.H * p.Sq;
  const long long delta_blocks = (rows + DELTA_THREADS / 32 - 1) / (DELTA_THREADS / 32);
  const long long BH = static_cast<long long>(p.B) * p.H;
  const long long dq_blocks = (p.Sq + ROWS - 1) / ROWS * BH;
  const long long dkv_blocks = (p.Sk + ROWS - 1) / ROWS * BH;
  if (delta_blocks > 0x7fffffffLL || dq_blocks > 0x7fffffffLL ||
      dkv_blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  flash_bwd_delta<<<static_cast<unsigned>(delta_blocks), DELTA_THREADS, 0, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq<DP><<<static_cast<unsigned>(dq_blocks), NTHREADS, smem_dq, stream>>>(
      m.q, m.dout, m.k, m.v, m.dq, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkv<DP><<<static_cast<unsigned>(dkv_blocks), NTHREADS, smem_dkv, stream>>>(
      m.k, m.v, m.q, m.dout, m.dk, m.dv, p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry (bound with ctypes). Returns a cudaError_t code, 0 = ok.
// ptrs: q, k, v, o, dO, dq, dk, dv (bf16), in that order; strides: their
// (batch, head, token) element strides, three each in the same order. The
// head dim must be contiguous, D % 8 == 0, D <= 128, every stride of a dim
// longer than 1 a positive multiple of 8 and every pointer 16-byte aligned
// (the Python wrapper checks this and the TMA plan). lse and delta are
// contiguous f32 [B,H,Sq]; delta is scratch that the call fills.
extern "C" int vgt_flash_bwd(
    const void* const* ptrs, const long long* strides,
    const void* lse, void* delta, const void* kv_lens, const void* q_start,
    int B, int H, int Sq, int Sk, int D, int causal, float sm_scale,
    void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (D <= 0 || D % 8 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  const long long* s = strides;
  Params p;
  p.o = static_cast<const __nv_bfloat16*>(ptrs[3]);
  p.dout = static_cast<const __nv_bfloat16*>(ptrs[4]);
  p.o_sb = s[9]; p.o_sh = s[10]; p.o_ss = s[11];
  p.do_sb = s[12]; p.do_sh = s[13]; p.do_ss = s[14];
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.q_start = static_cast<const int*>(q_start);
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk; p.D = D;
  p.causal = causal;
  p.sm_scale = sm_scale;
  p.scale_log2 = sm_scale * LOG2E;
  cudaError_t e = use_device_of(ptrs[0]);
  if (e != cudaSuccess) return static_cast<int>(e);
  // operand i of ptrs -> its map; q, dO, dq run over Sq, k, v, dk, dv over Sk
  Maps m;
  CUtensorMap* const maps[8] = {&m.q, &m.k, &m.v, nullptr, &m.dout, &m.dq, &m.dk, &m.dv};
  for (int i = 0; i < 8; ++i) {
    if (maps[i] == nullptr) continue;
    const int S = (i == 1 || i == 2 || i == 6 || i == 7) ? Sk : Sq;
    if (!map_bhsd(maps[i], ptrs[i], s[3 * i], s[3 * i + 1], s[3 * i + 2], B, H,
                  S, D, TILE))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32) e = launch<32>(p, m, st);
  else if (D <= 64) e = launch<64>(p, m, st);
  else if (D <= 80) e = launch<80>(p, m, st);
  else if (D <= 96) e = launch<96>(p, m, st);
  else e = launch<128>(p, m, st);
  return static_cast<int>(e);
}
