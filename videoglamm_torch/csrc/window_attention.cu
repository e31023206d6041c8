// K7: whole-row-softmax self-attention for medium sequences on Hopper
// (sm_90a), on wgmma, TMA and an mbarrier ring: bf16 operands, f32
// accumulation, bf16 or f32 out.
//
// Replaces the Pallas TPU kernel _window_kernel of
// videoglamm_tpu/ops/attention.py (:523, launched by _window_attention_fwd
// :567): non-causal full self-attention over [B,H,S,D] with Sq == Sk <=
// 1536, no kv_lens, for each (batch, head) row softmax(q k^T * scale) v
// with the exact row maximum and row sum taken before any p v product, so
// no accumulator is ever rescaled. The callers are the SAM-2 memory
// self-attention at the 32x32 grid ([4,1,1024,256] f32) and the medium
// towers ([4,16,1025,88], [16,16,577,64] bf16).
//
// The TPU kernel holds one [Sp,Sp] f32 logits block per (batch, head) in
// VMEM. A 64 x 1025 f32 logits tile is 262 KB, above the 227 KB of shared
// memory a CTA can have, so this kernel walks the key tiles twice:
//   pass 1  S = Q K^T alone, tile by tile: the row maximum m and the row
//           sum l = sum exp(s - m) in registers (V is not read);
//   pass 2  S = Q K^T again, p = exp(s - m) / l rounded to bf16, O += P V.
// The normalised probabilities are rounded to bf16 exactly where the plain
// twin rounds them, which a one-pass online softmax (rounding the
// unnormalised p) would not do. The price is the second Q K^T: 1.5x the
// products of a single pass.
//
// The design is K1's (attention_fwd.cu, csrc/attn_sm90.cuh): a producer
// warpgroup whose one thread loads the Q tile once, then K tiles (pass 1)
// and K and V tiles (pass 2) with TMA into a two-stage ring on mbarriers,
// and consumer warpgroups of 64 query rows each on wgmma: Q K^T with both
// operands K-major in shared memory, P from registers against V as an
// MN-major B. Q stays in shared memory across both passes. The ring's
// stages turn over once a tile of either pass, so K's full barrier counts
// its phases over both passes; V's full barrier completes a phase only in
// pass 2 and counts its own. Ragged S: TMA fills K and V rows past S with
// zeros, and the consumers mask the key columns past S on the last tile.
// Head dims pad as in K1 (72 -> 80, 88 -> 96, 136..256 -> 256); head dim
// 256 takes 64-key tiles.
//
// What bounds it on the H100: operations (bf16 tensor cores) at every
// caller's shape. The memory self-attention [4,1,1024,256] has only 4
// (batch, head) rows: 128-query tiles would give 32 CTAs on 132 SMs, so
// when 128-row tiles would leave more than half the SMs idle the launcher
// takes 64-row tiles with one consumer warpgroup (64 CTAs). f32 operands
// go through K1's staging pass first (the wrapper launches it), and O is
// stored in f32 from the accumulators.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "sm90_common.cuh"
#include "attn_sm90.cuh"

using attn::Geo;

struct Params {
  void* o;              // bf16, or f32 when o_f32
  long long o_sb, o_sh, o_ss;
  int B, H, S, D;
  int nc;               // consumer warpgroups a CTA: 2 (128 queries) or 1 (64)
  int o_f32;
  float scale_log2;     // sm_scale * log2(e): the softmax runs on exp2
};

constexpr int STAGES = attn::STAGES;
using attn::exp2_ftz;

// the logits of key columns >= S (TMA's zero rows past the sequence) -> -inf
template <int N>
__device__ __forceinline__ void mask_past(float* sc, int k0, int t, int S) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (k0 + 8 * i + 2 * t + (e & 1) >= S) sc[4 * i + e] = -INFINITY;
}

template <int DP>
__global__ void __launch_bounds__(attn::NTHREADS, 1) window_attn_sm90(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
    const Params p) {
  using L = Geo<DP>;
  constexpr int BN = L::BN;
  constexpr int NCH = L::NCH;
  extern __shared__ __align__(1024) unsigned char smem_win[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_win) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* kv_empty = v_full + STAGES;

  const int nc = p.nc;
  const int bm = 64 * nc;
  const int BH = p.B * p.H;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int h = bh % p.H, b = bh / p.H;
  const int m0 = (static_cast<int>(blockIdx.x) / BH) * bm;
  const int ntiles = (p.S + BN - 1) / BN;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(kv_empty + s, 128 * nc);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = tid / 128;
  const int lt = tid % 128;

  if (wg == nc) {
    // ---------------- producer: one thread issues every TMA load. Ring
    // step `it` runs over both passes: tiles 0 .. ntiles-1 of pass 1 (K),
    // then of pass 2 (K and V).
    reg_dealloc<40>();
    if (lt == 0) {
      mbar_expect_tx(q_full, NCH * bm * 128);
      for (int c = 0; c < NCH; ++c)
        tma_load_4d(smem + L::Q + c * L::CHUNK_Q, &tq, q_full, 64 * c, m0, h, b);
      for (int it = 0; it < 2 * ntiles; ++it) {
        const int s = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const bool pass2 = it >= ntiles;
        const int k0 = (pass2 ? it - ntiles : it) * BN;
        mbar_wait(kv_empty + s, ph ^ 1);
        mbar_expect_tx(k_full + s, NCH * L::CHUNK_KV);
        for (int c = 0; c < NCH; ++c)
          tma_load_4d(smem + L::K + (s * NCH + c) * L::CHUNK_KV, &tk, k_full + s,
                      64 * c, k0, h, b);
        if (pass2) {
          mbar_expect_tx(v_full + s, NCH * L::CHUNK_KV);
          for (int c = 0; c < NCH; ++c)
            tma_load_4d(smem + L::V + (s * NCH + c) * L::CHUNK_KV, &tv, v_full + s,
                        64 * c, k0, h, b);
        }
      }
    }
  } else {
    // ---------------- consumers: warpgroup wg owns query rows m0w .. m0w+63
    reg_alloc<232>();
    const int warp = lt / 32, lane = lt % 32;
    const int t = lane % 4;
    const int m0w = m0 + 64 * wg;
    const int r0 = m0w + warp * 16 + lane / 4;   // this thread's two rows
    unsigned char* sQw = smem + L::Q + wg * 64 * 128;
    mbar_wait(q_full, 0);

    // ---- pass 1: exact row maximum and row sum from Q K^T alone. The
    // maximum is taken on the raw logits (the scale is positive) and kept
    // in log2 units; a logit enters the sum as one FMA and one exp2.
    float m_i[2] = {-INFINITY, -INFINITY};
    float l_i[2] = {0.f, 0.f};
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % STAGES;
      const int k0 = j * BN;
      mbar_wait(k_full + s, (j / STAGES) & 1);
      float sc[BN / 2];
      attn::qk_tile<DP>(sc, sQw, smem + L::K + s * NCH * L::CHUNK_KV);
      mbar_arrive(kv_empty + s);
      if (k0 + BN > p.S) mask_past<BN>(sc, k0, t, p.S);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * i], sc[4 * i + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
      }
      float nm[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // every tile holds at least one key < S, so the maximum is finite
        nm[r] = -fmaxf(m_i[r], mx[r] * p.scale_log2);
      }
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        rs[0] += exp2_ftz(fmaf(sc[4 * i], p.scale_log2, nm[0])) +
                 exp2_ftz(fmaf(sc[4 * i + 1], p.scale_log2, nm[0]));
        rs[1] += exp2_ftz(fmaf(sc[4 * i + 2], p.scale_log2, nm[1])) +
                 exp2_ftz(fmaf(sc[4 * i + 3], p.scale_log2, nm[1]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {   // per-thread partial sums
        l_i[r] = l_i[r] * exp2_ftz(m_i[r] + nm[r]) + rs[r];
        m_i[r] = -nm[r];
      }
    }
    // p = 2^(s * scale - m) / l = 2^(s * scale + c), c = -(m + log2 l)
    float c[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
      c[r] = -(m_i[r] + log2f(l_i[r]));
    }

    // ---- pass 2: the normalised p rounded to bf16, O += P V; nothing is
    // rescaled
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    for (int j = 0; j < ntiles; ++j) {
      const int it = ntiles + j;
      const int s = it % STAGES;
      const int k0 = j * BN;
      mbar_wait(k_full + s, (it / STAGES) & 1);
      float sc[BN / 2];
      attn::qk_tile<DP>(sc, sQw, smem + L::K + s * NCH * L::CHUNK_KV);
      if (k0 + BN > p.S) mask_past<BN>(sc, k0, t, p.S);   // exp2(-inf) = 0
      // P packed to bf16 an 8-column group at a time, so S dies as P grows
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        pa[i / 2][(i % 2) * 2] = attn::pack_bf16(
            exp2_ftz(fmaf(sc[4 * i], p.scale_log2, c[0])),
            exp2_ftz(fmaf(sc[4 * i + 1], p.scale_log2, c[0])));
        pa[i / 2][(i % 2) * 2 + 1] = attn::pack_bf16(
            exp2_ftz(fmaf(sc[4 * i + 2], p.scale_log2, c[1])),
            exp2_ftz(fmaf(sc[4 * i + 3], p.scale_log2, c[1])));
      }
      // V's full barrier completes a phase in pass 2 only
      mbar_wait(v_full + s, (j / STAGES) & 1);
      attn::pv_tile<DP>(o, pa, smem + L::V + s * NCH * L::CHUNK_KV);
      mbar_arrive(kv_empty + s);
    }

    const float one[2] = {1.f, 1.f};
    if (p.o_f32) {
      float* ob = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
      attn::store_o_f32<DP>(ob, p.o_ss, o, one, r0, p.S, p.D, t);
    } else {
      attn::store_o_bf16<DP>(&to, sQw, o, one, lt, 2 + wg, m0w, h, b);
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const long long* st, Params p, cudaStream_t stream) {
  constexpr int smem = Geo<DP>::BYTES + 1024;   // + alignment slack
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        window_attn_sm90<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  // 128-query tiles (two consumer warpgroups) unless they would leave more
  // than half the SMs idle
  const long long bh = static_cast<long long>(p.B) * p.H;
  p.nc = 2 * ((p.S + 127) / 128) * bh < sm_count() ? 1 : 2;
  const int bm = 64 * p.nc;
  CUtensorMap tq, tk, tv, to;
  if (!map_bhsd(&tq, q, st[0], st[1], st[2], p.B, p.H, p.S, p.D, bm) ||
      !map_bhsd(&tk, k, st[3], st[4], st[5], p.B, p.H, p.S, p.D, Geo<DP>::BN) ||
      !map_bhsd(&tv, v, st[6], st[7], st[8], p.B, p.H, p.S, p.D, Geo<DP>::BN))
    return cudaErrorInvalidValue;
  if (p.o_f32)
    to = tq;   // unused: an f32 output is stored from the registers
  else if (!map_bhsd(&to, p.o, p.o_sb, p.o_sh, p.o_ss, p.B, p.H, p.S, p.D, 64))
    return cudaErrorInvalidValue;
  const long long blocks = ((p.S + bm - 1) / bm) * bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  window_attn_sm90<DP><<<static_cast<unsigned>(blocks), 128 * (p.nc + 1), smem,
                         stream>>>(tq, tk, tv, to, p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry (bound with ctypes). Returns a cudaError_t code, 0 = ok.
// q, k and v are bf16 [B,H,S,D] views (the f32 route hands in K1's staging
// copies); o is bf16, or f32 when `o_f32` is set. Strides are in elements;
// the head dim must be contiguous, D % 8 == 0, D <= 256, every stride a
// multiple of 8 and every pointer 16-byte aligned (checked by the Python
// wrapper, which also checks the TMA plan). A head dim above 256 is refused.
extern "C" int vgt_window_attention(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int B, int H, int S, int D, float sm_scale, int o_f32, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  Params p;
  p.o = o;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.B = B; p.H = H; p.S = S; p.D = D;
  p.o_f32 = o_f32;
  p.scale_log2 = sm_scale * 1.4426950408889634f;
  const long long st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = use_device_of(q);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (D <= 32) e = launch<32>(q, k, v, st, p, s);
  else if (D <= 64) e = launch<64>(q, k, v, st, p, s);
  else if (D <= 80) e = launch<80>(q, k, v, st, p, s);
  else if (D <= 96) e = launch<96>(q, k, v, st, p, s);
  else if (D <= 128) e = launch<128>(q, k, v, st, p, s);
  else if (D <= 256) e = launch<256>(q, k, v, st, p, s);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
