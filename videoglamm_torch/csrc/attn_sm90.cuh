// Pieces that the two attention forward kernels on wgmma share: K1
// (attention_fwd.cu) and K7 (window_attention.cu). A CTA holds a tile of up
// to 128 queries (64 rows a consumer warpgroup) in shared memory and walks
// the keys through a two-stage ring of K and V tiles that one producer
// thread fills with TMA. Here: that layout, a consumer warpgroup's two
// products (S = Q K^T and O += P V), the bf16 packing of P, and the two
// ways out for O (bf16 through shared memory and a TMA store, or f32 by
// direct stores from the accumulators). Included inside each source's
// anonymous namespace, after sm90_common.cuh.
//
// Head dims up to 128 take 128-key tiles. Head dim 256 takes 64-key tiles:
// Q (64 KB) and two stages of K and V (2 x (32 + 32) KB) then fit the 227
// KB of shared memory, and a consumer thread holds O (128 f32), S (32) and
// the packed P (16) within the 232 registers that setmaxnreg gives it.
#pragma once

namespace attn {

constexpr int BM = 128;        // queries a CTA at most: two consumer warpgroups
constexpr int STAGES = 2;      // K/V ring depth
constexpr int NTHREADS = 384;  // at most two consumer warpgroups + the producer

template <int DP> struct Geo {
  static constexpr int BN = DP > 128 ? 64 : 128;   // keys a ring tile
  static constexpr int NCH = (DP + 63) / 64;       // 64-column chunks a row
  static constexpr int CHUNK_Q = BM * 128;         // bytes of a chunk of Q
  static constexpr int CHUNK_KV = BN * 128;
  static constexpr int Q = 0;
  static constexpr int K = Q + NCH * CHUNK_Q;
  static constexpr int V = K + STAGES * NCH * CHUNK_KV;
  static constexpr int BAR = V + STAGES * NCH * CHUNK_KV;
  static constexpr int BYTES = BAR + 8 * (1 + 3 * STAGES);
  static_assert(BYTES + 1024 <= 232448, "a CTA's shared memory");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x in one SFU instruction (exp2f adds a range fix-up for results below
// 2^-126, which this flushes to 0: terms that vanish beside a row sum >= 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// sc (64 x BN, BN / 2 f32 a thread) = Q K^T of the warpgroup's 64 query rows
// `sQw` against the key tile `sK`, both K-major: DP / 16 k-steps, four to a
// 64-column chunk
template <int DP>
__device__ __forceinline__ void qk_tile(float* sc, const unsigned char* sQw,
                                        const unsigned char* sK) {
  using G = Geo<DP>;
#pragma unroll
  for (int i = 0; i < G::BN / 2; ++i) sc[i] = 0.f;
  fence_regs<G::BN / 2>(sc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const int off = (ks / 4) * G::CHUNK_Q + (ks % 4) * 32;
    const int offk = (ks / 4) * G::CHUNK_KV + (ks % 4) * 32;
    Wgmma<G::BN>::ss(sc, desc_sw128(sQw + off, 0, 1024),
                     desc_sw128(sK + offk, 0, 1024), ks > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<G::BN / 2>(sc);
}

// o (64 x DP) += P V: P from registers (pa, one A fragment a 16 keys), V
// [keys, DP] in shared memory as an MN-major B (the descriptor's transpose
// bit). At DP = 256 the N of 256 is two products of 128 against V's two
// halves; the accumulators of the second follow those of the first, as one
// m64n256 product would lay them out.
template <int DP>
__device__ __forceinline__ void pv_tile(float* o, uint32_t (*pa)[4],
                                        const unsigned char* sV) {
  using G = Geo<DP>;
  fence_regs<DP / 2>(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < G::BN / 16; ++kk) {
    if constexpr (DP > 128) {
      Wgmma<128>::rs_t(o, pa[kk],
                       desc_sw128(sV + kk * 16 * 128, G::CHUNK_KV, 1024), 1);
      Wgmma<128>::rs_t(o + 64, pa[kk],
                       desc_sw128(sV + 2 * G::CHUNK_KV + kk * 16 * 128,
                                  G::CHUNK_KV, 1024), 1);
    } else {
      Wgmma<DP>::rs_t(o, pa[kk], desc_sw128(sV + kk * 16 * 128, G::CHUNK_KV, 1024), 1);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<DP / 2>(o);
}

// O * inv[r] -> bf16 into the warpgroup's own Q rows `sQw` (no longer
// read), in the 128-byte swizzle that the store's map expects, then one TMA
// store a chunk of 64 rows x 64 columns by one thread (rows past S and
// columns past D are clipped). `bar` is a named barrier of the warpgroup.
template <int DP>
__device__ __forceinline__ void store_o_bf16(const CUtensorMap* to,
                                             unsigned char* sQw, const float* o,
                                             const float* inv, int lt, int bar,
                                             int row0, int h, int b) {
  using G = Geo<DP>;
  const int warp = lt / 32, lane = lt % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int col = 8 * i + 2 * t;
    const int c = col / 64, cc = col % 64;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      *reinterpret_cast<uint32_t*>(sQw + c * G::CHUNK_Q + row * 128 +
                                   (((cc / 8) ^ (row % 8)) * 16) + (cc % 8) * 2) =
          pack_bf16(o[4 * i + 2 * r] * inv[r], o[4 * i + 2 * r + 1] * inv[r]);
    }
  }
  fence_proxy_async();
  named_bar_sync(bar, 128);
  if (lt == 0) {
    for (int c = 0; c < G::NCH; ++c)
      tma_store_4d(to, sQw + c * G::CHUNK_Q, 64 * c, row0, h, b);
    bulk_commit();
    bulk_wait_all();
  }
}

// O * inv[r] -> f32 rows r0 and r0 + 8 of `ob` (token stride o_ss elements),
// straight from the accumulators: a quad writes 32 contiguous bytes of a row
template <int DP>
__device__ __forceinline__ void store_o_f32(float* ob, long long o_ss,
                                            const float* o, const float* inv,
                                            int r0, int S, int D, int t) {
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int col = 8 * i + 2 * t;
    if (col < D) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row < S)
          *reinterpret_cast<float2*>(ob + row * o_ss + col) =
              make_float2(o[4 * i + 2 * r] * inv[r], o[4 * i + 2 * r + 1] * inv[r]);
      }
    }
  }
}

}  // namespace attn
