// K1 and K6 in full f32: the attention forward and its backward for a model
// whose compute dtype is f32 (the route "simt_f32" of ops/attention.py; the
// name is kept for the counters, the products run on the tensor cores).
//
// Replaces, for f32 operands, the Pallas kernels that K1, K7, K8 and K6
// replace in bf16: `_flash_kernel` (videoglamm_tpu/ops/attention.py:93),
// `_bshd_kernel` (:738), `_window_kernel` (:523), `_smallwin_kernel` (:605),
// the window attention inside the fused block's body
// (videoglamm_tpu/ops/fused_block.py:108), and the flash backward
// `_flash_bwd_dq_kernel` (:302) and `_flash_bwd_dkv_kernel` (:336). On the
// TPU those kernels read f32 operands themselves; K1's "wgmma_f32" route
// rounds q, k and v to bf16 first, which is no f32 control.
//
// Bound: operations, at f32 accuracy. Every product is 3xTF32 on wgmma
// (sm90_common.cuh): each f32 operand is split into a TF32 big part and a
// TF32 small remainder, and big.small + small.big + big.big, accumulated in
// f32, keeps f32 accuracy (the dropped small.small term is 2^-22 of the
// product). Three TF32 products at 495 TFLOP/s give 165 TFLOP/s of
// f32-accurate products, 2.5 times the CUDA cores' 67; the bytes (4 * D a
// row of q, k, v, o) are never the limit at these shapes.
//
// Design. wgmma .tf32 takes its shared-memory operands K-major only, so
// every operand that a product reduces over keys or queries is transposed
// on its way into shared memory:
//   - tiles land with cp.async (16 bytes a copy) into one raw f32 tile (a
//     CTA's fixed rows, Q or K and V, into a plane buffer not yet in use);
//     a copy past kv_len (a KV cache's slack, possibly NaN), past S or past
//     D reads nothing and fills zeros, and any view whose rows are 16-byte
//     aligned goes in (BSHD, fused qkv) with no copy. The next tile's
//     copies are issued as soon as the raw tile has been split, so they
//     run under the products;
//   - a split pass turns the raw tile into two TF32 planes (big, small),
//     128-byte swizzled chunks of 32 f32 columns, either K-major as it is
//     (K for S = Q K^T; Q, K, V, dO as the A or B of S and dP) or
//     transposed (V^T for O = P V; K^T for dQ = dS K; Q^T and dO^T for
//     dK = dS^T Q and dV = P^T dO). Both passes are free of bank
//     conflicts: a warp takes 4 groups of 8 rows by 8 column quads in the
//     transposed one;
//   - P (and dS, P^T, dS^T) is the register A operand of the next product.
//     Its accumulator layout holds columns 2t and 2t + 1 of each 8, the
//     m64nNk8 .tf32 A fragment wants columns t and t + 4. The transposed
//     split permutes the reduction index inside each group of 8 instead
//     (column 8m + s of a transposed plane holds row 8m + 2s for s < 4 and
//     8m + 2(s - 4) + 1 else), which leaves the sum unchanged: P goes from
//     the accumulators to the A fragment by renaming registers, and never
//     through memory;
//   - the products that do not reduce over keys or queries take the
//     fixed tile (Q in the forward and the dq kernel, K and V in the dk/dv
//     kernel) as the shared-memory A operand: no product needs mma.sync;
//   - the tensor core's f32 accumulation drifts by about 2e-8 of the sum a
//     k8 step, one way (measured on the H100: O over 4,096 keys in one
//     accumulator came out 2.9e-5 off in relative L2), so O, dQ, dK and dV
//     are summed a tile at a time: each tile's product runs in a fresh
//     accumulator of 32 to 64 columns and is added in f32 registers.
// Forward (`attn_fwd_tf32`): a CTA of two warpgroups holds Q's planes for
// 128 query rows (64 each) and walks its key tiles, K then V through the
// one plane buffer and the one raw tile: split K, S = Q K^T, online softmax
// on exp2 in f32, split V^T, O += P V. Rows with no valid key write 0 and
// LSE -1e30, as K1 (attention.py:170-180). Query tiles are handed out
// longest first. Tiles by padded head dim (FWD_* below; `k1_f32_plan` in
// ops/attention.py reads them): 128 query rows and 128 keys at 32 and 64,
// 128 and 64 at 80 to 128, 64 and 32 at 256, where Q's planes alone take
// 128 KB; there both warpgroups work on the 64 rows, splitting S's depth
// (the halves meet through the K planes once S has read them) and O's
// columns. On a grid of query tiles that fills less than half of the card
// (K7's memory self-attention: 64 CTAs), the key tiles of each query tile
// are dealt to up to 4 CTAs (`k1_f32_splits`), each writing its normalised
// O and LSE to scratch, and `combine_splits` folds them by their LSEs.
// Backward: the dq kernel (64 queries a CTA; it also takes delta =
// rowsum(dO * O) for its rows, for itself and the dk/dv kernel) walks key
// tiles: split K and K^T, S; split V, dP; dQ += dS K. The dk/dv kernel (64
// keys a CTA) walks query tiles: split Q and Q^T, S^T; split dO^T, dV +=
// P^T dO; split dO, dP^T; dK += dS^T Q. Its warpgroup 0 holds dK and
// warpgroup 1 dV, each computing S^T itself: one accumulator a thread.
// Both recompute P from the forward's LSE. Head dims up to 128 (BWD_BN_*:
// 64 keys or queries a tile, 32 at 128). Each kernel's second warpgroup
// otherwise only loads and splits.
// Masks as K1: key < kv_len, and key <= q_start + row when causal, and
// key / win == row / win with a window.
#include <cuda.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

#include "sm90_common.cuh"

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// tile plans: query rows (FWD_BM) and keys a tile (FWD_BN) of the forward,
// keys (dq) or queries (dk/dv) a tile of the backward (BWD_BN), by padded
// head dim; a CTA's dynamic shared memory stays within SMEM_MAX
constexpr int FWD_BM_32 = 128;
constexpr int FWD_BN_32 = 128;
constexpr int FWD_BM_64 = 128;
constexpr int FWD_BN_64 = 128;
constexpr int FWD_BM_80 = 128;
constexpr int FWD_BN_80 = 64;
constexpr int FWD_BM_96 = 128;
constexpr int FWD_BN_96 = 64;
constexpr int FWD_BM_128 = 128;
constexpr int FWD_BN_128 = 64;
constexpr int FWD_BM_256 = 64;
constexpr int FWD_BN_256 = 32;
constexpr int BWD_BN_32 = 64;
constexpr int BWD_BN_64 = 64;
constexpr int BWD_BN_80 = 64;
constexpr int BWD_BN_96 = 64;
constexpr int BWD_BN_128 = 32;
constexpr int SMEM_MAX = 232448;
constexpr int SMEM_ALIGN = 1024;   // slack to align the base to the swizzle period

template <int DP> struct FwdTiles;
template <> struct FwdTiles<32> { static constexpr int BM = FWD_BM_32, BN = FWD_BN_32; };
template <> struct FwdTiles<64> { static constexpr int BM = FWD_BM_64, BN = FWD_BN_64; };
template <> struct FwdTiles<80> { static constexpr int BM = FWD_BM_80, BN = FWD_BN_80; };
template <> struct FwdTiles<96> { static constexpr int BM = FWD_BM_96, BN = FWD_BN_96; };
template <> struct FwdTiles<128> { static constexpr int BM = FWD_BM_128, BN = FWD_BN_128; };
template <> struct FwdTiles<256> { static constexpr int BM = FWD_BM_256, BN = FWD_BN_256; };
template <int DP> struct BwdTiles;
template <> struct BwdTiles<32> { static constexpr int BN = BWD_BN_32; };
template <> struct BwdTiles<64> { static constexpr int BN = BWD_BN_64; };
template <> struct BwdTiles<80> { static constexpr int BN = BWD_BN_80; };
template <> struct BwdTiles<96> { static constexpr int BN = BWD_BN_96; };
template <> struct BwdTiles<128> { static constexpr int BN = BWD_BN_128; };

// the forward's shared memory: Q's two planes (BM x DPK), one plane pair
// of a streamed tile (K: BN x DPK, or V^T: DPK x BN; first Q's raw rows)
// and the raw f32 tile. Two warpgroups load, split and run products
template <int DP> struct FwdGeo {
  static constexpr int DPK = (DP + 31) / 32 * 32;   // columns of the K-major planes
  static constexpr int BM = FwdTiles<DP>::BM, BN = FwdTiles<DP>::BN;
  // at 64 query rows (head dim 256) the two warpgroups split S's depth and
  // O's columns: a thread holds 64 of O's 128 columns a row pair
  static constexpr bool SPLIT = BM == 64;
  static constexpr int DW = SPLIT ? DP / 2 : DP;     // O columns a warpgroup
  static constexpr int PVN = DW == 32 ? 32 : DW <= 96 ? DW / 2 : 64;   // P V's column chunk
  static constexpr int NT = 256;                     // all load and split (two warpgroups)
  static constexpr int QPLANE = BM * DPK * 4;
  static constexpr int PLANE = BN * DPK * 4;
  static constexpr int Q = 0, P = 2 * QPLANE, RAW = P + 2 * PLANE;
  static constexpr int BYTES = RAW + PLANE;
  static_assert(2 * BN >= BM, "Q's raw rows land in the plane buffer");
  static_assert(BYTES + SMEM_ALIGN <= SMEM_MAX, "a CTA's shared memory");
};

// the backward's: two fixed plane pairs of the CTA's 64 rows (Q and dO, or
// K and V), two plane pairs of a streamed tile (first the fixed rows raw),
// the raw tile, and the lse and delta of the tile's rows
template <int DP> struct BwdGeo {
  static constexpr int DPK = (DP + 31) / 32 * 32;
  static constexpr int BN = BwdTiles<DP>::BN;
  static constexpr int NT = 256;       // two warpgroups load and split
  static constexpr int CN = DP == 32 ? 32 : DP / 2;   // column chunk of dQ, dK and dV
  static constexpr int FPLANE = 64 * DPK * 4;
  static constexpr int PLANE = BN * DPK * 4;
  static constexpr int F0 = 0, F1 = 2 * FPLANE, A = 4 * FPLANE, B = A + 2 * PLANE;
  static constexpr int RAW = B + 2 * PLANE, VEC = RAW + PLANE;
  static constexpr int BYTES = VEC + 8 * (BN > 64 ? BN : 64);
  static_assert(BYTES + SMEM_ALIGN <= SMEM_MAX, "a CTA's shared memory");
  static_assert(2 * BN >= 64, "the fixed tiles' raw rows land in the A and B buffers");
};

struct Params {
  const float *q, *k, *v, *o, *dout;
  float *out, *dq, *dk, *dv;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss, g_sb, g_sh, g_ss;
  long long dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  const int* kv_lens;   // [B] or null (= Sk)
  const int* q_start;   // [B] absolute key position of query 0, or null (= 0)
  float* lse;           // [B,H,Sq] natural log-sum-exp of the scaled logits
  float* delta;         // [B,H,Sq] rowsum(dO * O) (backward)
  int B, H, Sq, Sk, D, causal, win;
  float scale, scale_log2;
  // forward on a grid too small for the card: the key tiles of each query
  // tile are dealt to `ksplit` CTAs, each writing its normalised O and LSE
  // to part_o [ksplit,B,H,Sq,D] and part_lse [ksplit,B,H,Sq];
  // `combine_splits` then folds them into out and lse
  int ksplit;
  float* part_o;
  float* part_lse;
};

// ---------------------------------------------------------------------------
// loads and the split pass
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// all but the newest N committed groups have landed
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows [r0, r0 + ROWS) of a [S, D] slice (`base` its row 0, rows `ss`
// floats apart) into the raw tile [ROWS][DPK]; rows at or past `nvalid`
// and columns at or past D are zeros, read from nowhere
template <int ROWS, int DPK, int NT>
__device__ __forceinline__ void load_raw(float* raw, const float* base, long long ss,
                                         int r0, int nvalid, int D, int tid) {
  constexpr int U = DPK / 4;
#pragma unroll 1
  for (int i = tid; i < ROWS * U; i += NT) {
    const int r = i / U, c = (i % U) * 4;
    const bool ok = r0 + r < nvalid && c < D;
    cp_async16(raw + r * DPK + c, ok ? base + (r0 + r) * ss + c : base, ok ? 16u : 0u);
  }
  cp_async_commit();
}

__device__ __forceinline__ void split4(const float4& x, uint4& b, uint4& s) {
  split_tf32(x.x, b.x, s.x);
  split_tf32(x.y, b.y, s.y);
  split_tf32(x.z, b.z, s.z);
  split_tf32(x.w, b.w, s.w);
}

// byte offset of the 16-byte unit u (4 columns) of row r in a K-major plane
// of `rows` rows: chunks of 32 columns, 128-byte swizzle
__device__ __forceinline__ int km_off(int rows, int r, int u) {
  return (u >> 3) * rows * 128 + r * 128 + (((u & 7) ^ (r & 7)) << 4);
}

// raw [ROWS][DPK] -> K-major planes (big at `planes`, small one plane on)
template <int ROWS, int DPK, int NT>
__device__ __forceinline__ void split_km(unsigned char* planes, const float* raw, int tid) {
  constexpr int U = DPK / 4, PL = ROWS * DPK * 4;
#pragma unroll 1
  for (int i = tid; i < ROWS * U; i += NT) {
    const int r = i / U, u = i % U;
    uint4 b, s;
    split4(*reinterpret_cast<const float4*>(raw + r * DPK + 4 * u), b, s);
    const int off = km_off(ROWS, r, u);
    *reinterpret_cast<uint4*>(planes + off) = b;
    *reinterpret_cast<uint4*>(planes + PL + off) = s;
  }
}

// raw [ROWS][DPK] -> transposed planes [DPK rows][ROWS columns], K-major over
// the raw rows, each group of 8 raw rows permuted: column 8m + s holds raw
// row 8m + 2s (s < 4) or 8m + 2(s - 4) + 1 (s >= 4), so that a register A
// fragment taken from accumulators (columns 2t, 2t + 1) meets it. A warp
// takes 4 row groups (lane & 3) by 8 column quads (lane >> 2): its loads
// and its stores take the fewest wavefronts (4 for 32 lanes of 16 bytes).
template <int ROWS, int DPK, int NT>
__device__ __forceinline__ void split_t(unsigned char* planes, const float* raw, int tid) {
  constexpr int PL = ROWS * DPK * 4, NM4 = ROWS / 32, ITEMS = (ROWS / 8) * (DPK / 4);
  static_assert(ROWS % 32 == 0 && DPK % 32 == 0, "whole warps of items");
#pragma unroll 1
  for (int i = tid; i < ITEMS; i += NT) {
    const int hi = i >> 5;
    const int m = (hi % NM4) * 4 + (i & 3);
    const int c = (hi / NM4) * 8 + ((i >> 2) & 7);
    const int unit = 2 * (m & 3);
    unsigned char* chunk = planes + (m >> 2) * DPK * 128;
    // rows 8m + half, + 2, + 4, + 6 -> columns 8m + 4 half .. + 3: one
    // 16-byte unit of each of the 4 rows d = 4c .. 4c + 3
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float4 x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[e] = *reinterpret_cast<const float4*>(raw + (8 * m + 2 * e + half) * DPK + 4 * c);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // lanes write their 4 rows d in rotated orders, so that one store
        // instruction meets rows of both parities: all 8 bank groups
        const int j = (k + c) & 3;
        auto at = [&](const float4& f) { return j == 0 ? f.x : j == 1 ? f.y : j == 2 ? f.z : f.w; };
        uint4 bg, sm;
        split4(make_float4(at(x[0]), at(x[1]), at(x[2]), at(x[3])), bg, sm);
        const int d = 4 * c + j;
        const int off = d * 128 + (((unit + half) ^ (d & 7)) << 4);
        *reinterpret_cast<uint4*>(chunk + off) = bg;
        *reinterpret_cast<uint4*>(chunk + PL + off) = sm;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the products: 3xTF32, cross terms first
// ---------------------------------------------------------------------------
// The descriptor of a K-major plane (sbo 1024, 128-byte swizzle), and the
// descriptor `byte_off` bytes on. The add is volatile, so each descriptor
// is formed where its wgmma issues: the compiler neither hoists a product's
// 50-odd descriptors out of the tile loop nor computes them all ahead of
// the chain, both of which hold them in registers (the start field, addr
// >> 4, cannot carry: shared addresses stay below 2^18).
__device__ __forceinline__ uint64_t plane_desc(const unsigned char* plane) {
  return desc_sw128(plane, 0, 1024);
}
__device__ __forceinline__ uint64_t desc_at(uint64_t base, uint32_t byte_off) {
  uint64_t d;
  asm volatile("add.s64 %0, %1, %2;\n"
               : "=l"(d) : "l"(base), "l"(static_cast<uint64_t>(byte_off >> 4)));
  return d;
}
// byte offset of rows [row0, ...) at k8 step ks of a K-major plane of `rows` rows
__device__ __forceinline__ uint32_t k_off(int rows, int row0, int ks) {
  return (ks >> 2) * rows * 128 + row0 * 128 + (ks & 3) * 32;
}

template <int N> __device__ __forceinline__ void keep_regs(uint32_t (*r)[4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e]) :: "memory");
}

// acc (64 x N) = A B^T over KS k8 steps from step ks0: A rows [a_row0, +64)
// of K-major planes of a_rows rows (small one `a_plane` bytes on), B the N
// rows of K-major planes (small `b_plane` on)
template <int N, int KS>
__device__ __forceinline__ void prod3_ss(float* acc, const unsigned char* a_ptr, int a_rows,
                                         int a_row0, int a_plane,
                                         const unsigned char* b_ptr, int b_plane,
                                         int ks0 = 0) {
  const uint64_t Ab = plane_desc(a_ptr), As = plane_desc(a_ptr + a_plane);
  const uint64_t Bb = plane_desc(b_ptr), Bs = plane_desc(b_ptr + b_plane);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  fence_regs<N / 2>(acc);
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < KS; ++i)
    WgmmaTf32<N>::ss(acc, desc_at(Ab, k_off(a_rows, a_row0, ks0 + i)),
                     desc_at(Bs, k_off(N, 0, ks0 + i)), 1);
#pragma unroll
  for (int i = 0; i < KS; ++i)
    WgmmaTf32<N>::ss(acc, desc_at(As, k_off(a_rows, a_row0, ks0 + i)),
                     desc_at(Bb, k_off(N, 0, ks0 + i)), 1);
#pragma unroll
  for (int i = 0; i < KS; ++i)
    WgmmaTf32<N>::ss(acc, desc_at(Ab, k_off(a_rows, a_row0, ks0 + i)),
                     desc_at(Bb, k_off(N, 0, ks0 + i)), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<N / 2>(acc);
}

// dst (64 x NTOT, NTOT / 2 a thread) += A B^T over KK k8 steps: A from registers (ab / as: the big and small fragments, one a k8
// step), B rows [b_row0, + NTOT) of the transposed planes of b_rows rows
// (small `b_plane` on). The tensor core's f32 accumulation drifts by about
// 2e-8 of the sum a k8 step (biased: it grows with the chain), so a product
// that reduces over keys or queries never accumulates across tiles on the
// tensor core: each column chunk of NC runs in a fresh accumulator and is
// added to dst here, in f32.
template <int NTOT, int NC, int KK>
__device__ __forceinline__ void prod3_rs_add(float* dst, uint32_t (*ab)[4], uint32_t (*as)[4],
                                             const unsigned char* b_ptr, int b_rows,
                                             int b_plane, int b_row0 = 0) {
  static_assert(NTOT % NC == 0, "whole column chunks");
  const uint64_t Bb = plane_desc(b_ptr), Bs = plane_desc(b_ptr + b_plane);
#pragma unroll
  for (int c = 0; c < NTOT / NC; ++c) {
    float acc[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
    fence_regs<NC / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < KK; ++i)
      WgmmaTf32<NC>::rs(acc, ab[i], desc_at(Bs, k_off(b_rows, b_row0 + c * NC, i)), 1);
#pragma unroll
    for (int i = 0; i < KK; ++i)
      WgmmaTf32<NC>::rs(acc, as[i], desc_at(Bb, k_off(b_rows, b_row0 + c * NC, i)), 1);
#pragma unroll
    for (int i = 0; i < KK; ++i)
      WgmmaTf32<NC>::rs(acc, ab[i], desc_at(Bb, k_off(b_rows, b_row0 + c * NC, i)), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NC / 2>(acc);
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) dst[c * (NC / 2) + i] += acc[i];
  }
  keep_regs<KK>(ab);
  keep_regs<KK>(as);
}

// accumulator values x (4 per 8 columns: (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1)) -> big / small A fragments, one per 8 columns, in the
// order the transposed planes' permutation gives them: (g, t) = column 2t,
// (g + 8, t), (g, t + 4) = column 2t + 1, (g + 8, t + 4)
template <int NX>
__device__ __forceinline__ void to_frags(const float* x, uint32_t (*b)[4], uint32_t (*s)[4]) {
#pragma unroll
  for (int i = 0; i < NX / 4; ++i) {
    split_tf32(x[4 * i], b[i][0], s[i][0]);
    split_tf32(x[4 * i + 2], b[i][1], s[i][1]);
    split_tf32(x[4 * i + 1], b[i][2], s[i][2]);
    split_tf32(x[4 * i + 3], b[i][3], s[i][3]);
  }
}

// O = acc * inv[r] (DP columns from col0) -> f32 rows r0 and r0 + 8 of `ob`
// (row stride ss), columns < D
template <int DP>
__device__ __forceinline__ void store_rows(float* ob, long long ss, const float* acc,
                                           const float* inv, int r0, int S, int D, int t,
                                           int col0 = 0) {
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int col = col0 + 8 * i + 2 * t;
    if (col < D) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row < S)
          *reinterpret_cast<float2*>(ob + row * ss + col) =
              make_float2(acc[4 * i + 2 * r] * inv[r], acc[4 * i + 2 * r + 1] * inv[r]);
      }
    }
  }
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + SMEM_ALIGN - 1) & ~uintptr_t(SMEM_ALIGN - 1));
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(FwdGeo<DP>::NT, 1) attn_fwd_tf32(const Params p) {
  using G = FwdGeo<DP>;
  constexpr int BM = G::BM, BN = G::BN, DPK = G::DPK, NT = G::NT;
  constexpr int KS = DP / 8;   // k8 steps of S: columns past DP are zeros
  extern __shared__ __align__(1024) unsigned char smem_f32[];
  unsigned char* smem = aligned_smem(smem_f32);
  unsigned char* sQ = smem + G::Q;
  unsigned char* sP = smem + G::P;
  float* raw = reinterpret_cast<float*>(smem + G::RAW);

  const int BH = p.B * p.H;
  const int nmt = (p.Sq + BM - 1) / BM;
  const int split = static_cast<int>(blockIdx.x / (nmt * BH));
  const int cta = static_cast<int>(blockIdx.x % (nmt * BH));
  const int mt = nmt - 1 - cta / BH;   // longest first
  const int bh = cta % BH;
  const int h = bh % p.H, b = bh / p.H;
  const int m0 = mt * BM;
  const int kv_len = p.kv_lens ? min(p.kv_lens[b], p.Sk) : p.Sk;
  const int q_off = p.q_start ? p.q_start[b] : 0;
  const int last_row = min(m0 + BM, p.Sq) - 1;
  int k_lo = 0, k_hi = kv_len;
  if (p.causal) k_hi = min(k_hi, q_off + last_row + 1);
  if (p.win > 0) {
    k_lo = (m0 / p.win) * p.win;
    k_hi = min(k_hi, (last_row / p.win + 1) * p.win);
  }
  int j_lo = k_lo / BN;
  int ntiles = k_hi > k_lo ? (k_hi + BN - 1) / BN - j_lo : 0;
  if (p.ksplit > 1) {   // this CTA's share of the key tiles
    const int share = (ntiles + p.ksplit - 1) / p.ksplit;
    const int skip = min(ntiles, split * share);
    j_lo += skip;
    ntiles = min(ntiles - skip, share);
  }

  const int tid = threadIdx.x;
  const int wg = tid / 128, lt = tid % 128;
  const int warp = lt / 32, lane = lt % 32, g = lane / 4, t = lane % 4;
  const int qrow0 = G::SPLIT ? 0 : 64 * wg;      // the warpgroup's rows in the tile
  const int r0 = m0 + qrow0 + warp * 16 + g;     // this thread's rows r0, r0 + 8
  constexpr int KSW = G::SPLIT ? KS / 2 : KS;    // S's k8 steps a warpgroup

  int lo[2] = {0, 0}, hi[2] = {kv_len, kv_len};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (p.causal) hi[r] = min(hi[r], q_off + row + 1);
    if (p.win > 0) {
      lo[r] = (row / p.win) * p.win;
      hi[r] = min(hi[r], lo[r] + p.win);
    }
  }
  // the keys this warpgroup's rows attend: a tile outside them (a window of
  // the other warpgroup's rows, the causal tail) is split for the other
  // warpgroup but costs this one no product (the same for both at SPLIT)
  const int wrow0 = m0 + qrow0, wrow1 = min(wrow0 + 64, p.Sq) - 1;
  int w_lo = 0, w_hi = wrow0 < p.Sq ? kv_len : 0;
  if (p.causal) w_hi = min(w_hi, q_off + wrow1 + 1);
  if (p.win > 0) {
    w_lo = (wrow0 / p.win) * p.win;
    w_hi = min(w_hi, (wrow1 / p.win + 1) * p.win);
  }

  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  // Q's rows land in the plane buffer beside the first K tile, then split
  load_raw<BM, DPK, NT>(reinterpret_cast<float*>(sP), p.q + b * p.q_sb + h * p.q_sh,
                        p.q_ss, m0, p.Sq, p.D, tid);
  if (ntiles > 0) load_raw<BN, DPK, NT>(raw, kb, p.k_ss, j_lo * BN, kv_len, p.D, tid);
  else cp_async_commit();   // an empty group: the wait below counts two
  cp_async_wait<1>();
  __syncthreads();
  split_km<BM, DPK, NT>(sQ, reinterpret_cast<const float*>(sP), tid);

  float o[G::DW / 2];   // O's columns [wg DW, + DW) with SPLIT, else all
#pragma unroll
  for (int i = 0; i < G::DW / 2; ++i) o[i] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = (j_lo + it) * BN;
    // K: the raw tile has landed, and the last P V (or Q's split) has read
    // the plane buffer
    cp_async_wait_all();
    __syncthreads();
    split_km<BN, DPK, NT>(sP, raw, tid);
    fence_proxy_async();
    __syncthreads();
    load_raw<BN, DPK, NT>(raw, vb, p.v_ss, k0, kv_len, p.D, tid);

    const bool live = k0 < w_hi && k0 + BN > w_lo;
    uint32_t pb[BN / 8][4], ps[BN / 8][4];
    float sc[BN / 2];
    if (live)
      prod3_ss<BN, KSW>(sc, sQ, BM, qrow0, G::QPLANE, sP, G::PLANE,
                        G::SPLIT ? wg * KSW : 0);
    if constexpr (G::SPLIT) {
      // the two halves of the depth meet in the K planes, read by now:
      // each warpgroup adds the other's partial (s0 + s1 both ways)
      float* xch = reinterpret_cast<float*>(sP);
      __syncthreads();
      if (live) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) xch[(i * 256 + tid)] = sc[i];
      }
      __syncthreads();
      if (live) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sc[i] += xch[i * 256 + (tid ^ 128)];
      }
    }
    if (live) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * i + 2 * t + (e & 1);
          const int r = e >> 1;
          sc[4 * i + e] = key >= lo[r] && key < hi[r] ? sc[4 * i + e] * p.scale_log2
                                                      : -INFINITY;
        }
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
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        sc[4 * i] = exp2f(sc[4 * i] - base[0]);
        sc[4 * i + 1] = exp2f(sc[4 * i + 1] - base[0]);
        sc[4 * i + 2] = exp2f(sc[4 * i + 2] - base[1]);
        sc[4 * i + 3] = exp2f(sc[4 * i + 3] - base[1]);
        rs[0] += sc[4 * i] + sc[4 * i + 1];
        rs[1] += sc[4 * i + 2] + sc[4 * i + 3];
      }
      l_i[0] = l_i[0] * alpha[0] + rs[0];   // per-thread partial row sums
      l_i[1] = l_i[1] * alpha[1] + rs[1];
#pragma unroll
      for (int i = 0; i < G::DW / 8; ++i) {
        o[4 * i] *= alpha[0]; o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1]; o[4 * i + 3] *= alpha[1];
      }
      to_frags<BN / 2>(sc, pb, ps);
    }

    // V^T: the raw tile has landed, and every warpgroup's S has read the planes
    cp_async_wait_all();
    __syncthreads();
    split_t<BN, DPK, NT>(sP, raw, tid);
    fence_proxy_async();
    __syncthreads();
    if (it + 1 < ntiles)
      load_raw<BN, DPK, NT>(raw, kb, p.k_ss, k0 + BN, kv_len, p.D, tid);
    if (live)
      prod3_rs_add<G::DW, G::PVN, BN / 8>(o, pb, ps, sP, DPK, G::PLANE,
                                         G::SPLIT ? wg * G::DW : 0);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
    inv[r] = l_i[r] > 0.f ? 1.f / l_i[r] : 0.f;
  }
  const long long rows = static_cast<long long>(BH) * p.Sq;
  float* lse = p.ksplit > 1 ? p.part_lse + split * rows : p.lse;
  if (lse != nullptr && t == 0 && !(G::SPLIT && wg == 1)) {
    // m_i is in log2 units; a row with no valid key gets -1e30, as the TPU
    // kernel writes it (attention.py:178)
    float* lb = lse + static_cast<long long>(bh) * p.Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (r0 + 8 * r < p.Sq)
        lb[r0 + 8 * r] = l_i[r] > 0.f ? m_i[r] * LN2 + logf(l_i[r]) : -1e30f;
  }
  if (p.ksplit > 1)
    store_rows<G::DW>(p.part_o + (split * rows + static_cast<long long>(bh) * p.Sq) * p.D,
                      p.D, o, inv, r0, p.Sq, p.D, t, G::SPLIT ? wg * G::DW : 0);
  else
    store_rows<G::DW>(p.out + b * p.o_sb + h * p.o_sh, p.o_ss, o, inv, r0, p.Sq, p.D, t,
                      G::SPLIT ? wg * G::DW : 0);
}

// the key splits' partial outputs -> out and lse: O = sum_s w_s O_s / sum_s
// w_s with w_s = exp(lse_s - max lse); a split that saw no valid key (lse
// -1e30) weighs 0. A thread takes 4 columns of a row.
__global__ void __launch_bounds__(256) combine_splits(const Params p) {
  const long long rows = static_cast<long long>(p.B) * p.H * p.Sq;
  const int U = p.D / 4;
  for (long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x; i < rows * U;
       i += static_cast<long long>(gridDim.x) * 256) {
    const long long r = i / U;
    const int c = static_cast<int>(i % U) * 4;
    float mx = -INFINITY;
    for (int s = 0; s < p.ksplit; ++s) mx = fmaxf(mx, p.part_lse[s * rows + r]);
    float den = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < p.ksplit; ++s) {
      const float l = p.part_lse[s * rows + r];
      const float w = l > -1e29f ? expf(l - mx) : 0.f;
      const float4 x = *reinterpret_cast<const float4*>(p.part_o + (s * rows + r) * p.D + c);
      den += w;
      acc.x = fmaf(w, x.x, acc.x);
      acc.y = fmaf(w, x.y, acc.y);
      acc.z = fmaf(w, x.z, acc.z);
      acc.w = fmaf(w, x.w, acc.w);
    }
    const float inv = den > 0.f ? 1.f / den : 0.f;
    const int row = static_cast<int>(r % p.Sq);
    const int bh = static_cast<int>(r / p.Sq);
    const int h = bh % p.H, b = bh / p.H;
    *reinterpret_cast<float4*>(p.out + b * p.o_sb + h * p.o_sh + row * p.o_ss + c) =
        make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
    if (p.lse != nullptr && c == 0) p.lse[r] = den > 0.f ? mx + logf(den) : -1e30f;
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
// dq for a tile of 64 queries over the key tiles it attends; first delta =
// rowsum(dO * O) of its rows (f32 FFMA), written for the dk/dv kernel
template <int DP>
__global__ void __launch_bounds__(BwdGeo<DP>::NT, 1) attn_dq_tf32(const Params p) {
  using G = BwdGeo<DP>;
  constexpr int BN = G::BN, DPK = G::DPK, NT = G::NT, KS = DP / 8;
  extern __shared__ __align__(1024) unsigned char smem_f32[];
  unsigned char* smem = aligned_smem(smem_f32);
  unsigned char* sQ = smem + G::F0;
  unsigned char* sG = smem + G::F1;
  unsigned char* sA = smem + G::A;
  unsigned char* sB = smem + G::B;
  float* raw = reinterpret_cast<float*>(smem + G::RAW);
  float* sDel = reinterpret_cast<float*>(smem + G::VEC);

  const int BH = p.B * p.H;
  const int nmt = (p.Sq + 63) / 64;
  const int mt = nmt - 1 - static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int h = bh % p.H, b = bh / p.H;
  const int m0 = mt * 64;
  const int kv_len = p.kv_lens ? min(p.kv_lens[b], p.Sk) : p.Sk;
  const int q_off = p.q_start ? p.q_start[b] : 0;
  const int last_row = min(m0 + 64, p.Sq) - 1;
  int k_hi = kv_len;
  if (p.causal) k_hi = min(k_hi, q_off + last_row + 1);
  const int ntiles = k_hi > 0 ? (k_hi + BN - 1) / BN : 0;

  const int tid = threadIdx.x;
  const bool mma = tid < 128;           // the warpgroup that runs the products
  const int warp = (tid % 128) / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int r0 = m0 + warp * 16 + g;

  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* gb = p.dout + b * p.g_sb + h * p.g_sh;
  // Q's and dO's rows land in the A and B buffers beside the first K tile
  load_raw<64, DPK, NT>(reinterpret_cast<float*>(sA), qb, p.q_ss, m0, p.Sq, p.D, tid);
  load_raw<64, DPK, NT>(reinterpret_cast<float*>(sB), gb, p.g_ss, m0, p.Sq, p.D, tid);
  if (ntiles > 0) load_raw<BN, DPK, NT>(raw, kb, p.k_ss, 0, kv_len, p.D, tid);
  else cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  split_km<64, DPK, NT>(sQ, reinterpret_cast<const float*>(sA), tid);
  split_km<64, DPK, NT>(sG, reinterpret_cast<const float*>(sB), tid);
  if (mma) {
    // two threads a row, interleaved 16-byte pieces
    const int row = m0 + tid / 2, half = tid & 1;
    float acc = 0.f;
    if (row < p.Sq) {
      const float* orow = p.o + b * p.o_sb + h * p.o_sh + row * p.o_ss;
      const float* grow = gb + row * p.g_ss;
      for (int c = 4 * half; c < p.D; c += 8) {
        const float4 x = *reinterpret_cast<const float4*>(orow + c);
        const float4 y = *reinterpret_cast<const float4*>(grow + c);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
        acc = fmaf(x.z, y.z, acc);
        acc = fmaf(x.w, y.w, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      sDel[tid / 2] = acc;
      if (row < p.Sq) p.delta[static_cast<long long>(bh) * p.Sq + row] = acc;
    }
  }
  __syncthreads();
  float lse2[2], dlt[2];
  int hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const bool live = row < p.Sq;
    lse2[r] = live ? p.lse[static_cast<long long>(bh) * p.Sq + row] * LOG2E : 0.f;
    dlt[r] = sDel[warp * 16 + g + 8 * r];
    hi[r] = live ? (p.causal ? min(kv_len, q_off + row + 1) : kv_len) : 0;
  }

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BN;
    // K and K^T: the raw tile has landed, the last dQ product (or the
    // fixed tiles' split) has read sA and sB
    cp_async_wait_all();
    __syncthreads();
    split_km<BN, DPK, NT>(sA, raw, tid);
    split_t<BN, DPK, NT>(sB, raw, tid);
    fence_proxy_async();
    __syncthreads();
    load_raw<BN, DPK, NT>(raw, vb, p.v_ss, k0, kv_len, p.D, tid);
    float s[BN / 2];
    if (mma) {
      prod3_ss<BN, KS>(s, sQ, 64, 0, G::FPLANE, sA, G::PLANE);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * i + 2 * t + (e & 1);
          const int r = e >> 1;
          s[4 * i + e] = key < hi[r] ? exp2f(s[4 * i + e] * p.scale_log2 - lse2[r]) : 0.f;
        }
    }
    // V
    cp_async_wait_all();
    __syncthreads();
    split_km<BN, DPK, NT>(sA, raw, tid);
    fence_proxy_async();
    __syncthreads();
    if (it + 1 < ntiles) load_raw<BN, DPK, NT>(raw, kb, p.k_ss, k0 + BN, kv_len, p.D, tid);
    if (!mma) continue;
    float dp[BN / 2];
    prod3_ss<BN, KS>(dp, sG, 64, 0, G::FPLANE, sA, G::PLANE);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) dp[i] = s[i] * (dp[i] - dlt[(i >> 1) & 1]) * p.scale;
    uint32_t db[BN / 8][4], ds[BN / 8][4];
    to_frags<BN / 2>(dp, db, ds);
    prod3_rs_add<DP, G::CN, BN / 8>(dq, db, ds, sB, DPK, G::PLANE);
  }

  if (!mma) return;
  const float one[2] = {1.f, 1.f};
  store_rows<DP>(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_ss, dq, one, r0, p.Sq, p.D, t);
}

// dk and dv for a tile of 64 keys over the query tiles that attend it:
// warpgroup 0 accumulates dK, warpgroup 1 dV (one accumulator a thread),
// each from its own S^T
template <int DP>
__global__ void __launch_bounds__(BwdGeo<DP>::NT, 1) attn_dkv_tf32(const Params p) {
  using G = BwdGeo<DP>;
  constexpr int BN = G::BN, DPK = G::DPK, NT = G::NT, KS = DP / 8;
  extern __shared__ __align__(1024) unsigned char smem_f32[];
  unsigned char* smem = aligned_smem(smem_f32);
  unsigned char* sK = smem + G::F0;
  unsigned char* sV = smem + G::F1;
  unsigned char* sA = smem + G::A;
  unsigned char* sB = smem + G::B;
  float* raw = reinterpret_cast<float*>(smem + G::RAW);
  float* sL = reinterpret_cast<float*>(smem + G::VEC);   // lse * log2(e) of the tile
  float* sD = sL + BN;                                   // delta of the tile

  const int BH = p.B * p.H;
  const int kt = static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int h = bh % p.H, b = bh / p.H;
  const int k0 = kt * 64;
  const int kv_len = p.kv_lens ? min(p.kv_lens[b], p.Sk) : p.Sk;
  const int q_off = p.q_start ? p.q_start[b] : 0;
  // the first query that can see a key of the tile
  const int q_lo = p.causal ? max(0, k0 - q_off) : 0;
  const int q_end = k0 < kv_len ? p.Sq : 0;
  const int j_lo = q_lo / BN;
  const int ntiles = q_end > q_lo ? (q_end + BN - 1) / BN - j_lo : 0;

  const int tid = threadIdx.x;
  const bool kwg = tid < 128;           // warpgroup 0: dK; warpgroup 1: dV
  const int warp = (tid % 128) / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int kr0 = k0 + warp * 16 + g;   // this thread's keys kr0, kr0 + 8

  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* gb = p.dout + b * p.g_sb + h * p.g_sh;
  // K's and V's rows land in the A and B buffers beside the first Q tile
  load_raw<64, DPK, NT>(reinterpret_cast<float*>(sA), p.k + b * p.k_sb + h * p.k_sh, p.k_ss,
                        k0, kv_len, p.D, tid);
  load_raw<64, DPK, NT>(reinterpret_cast<float*>(sB), p.v + b * p.v_sb + h * p.v_sh, p.v_ss,
                        k0, kv_len, p.D, tid);
  if (ntiles > 0) load_raw<BN, DPK, NT>(raw, qb, p.q_ss, j_lo * BN, p.Sq, p.D, tid);
  else cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  split_km<64, DPK, NT>(sK, reinterpret_cast<const float*>(sA), tid);
  split_km<64, DPK, NT>(sV, reinterpret_cast<const float*>(sB), tid);

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int q0 = (j_lo + it) * BN;
    // Q and Q^T: the raw tile has landed, the last dK product (or the
    // fixed tiles' split) has read sA and sB, and the last tile's dS^T has
    // read sL and sD
    cp_async_wait_all();
    __syncthreads();
    for (int i = tid; i < BN; i += NT) {
      const int row = q0 + i;
      const long long at = static_cast<long long>(bh) * p.Sq + row;
      sL[i] = row < p.Sq ? p.lse[at] * LOG2E : 0.f;
      sD[i] = row < p.Sq ? p.delta[at] : 0.f;
    }
    split_km<BN, DPK, NT>(sA, raw, tid);
    split_t<BN, DPK, NT>(sB, raw, tid);
    fence_proxy_async();
    __syncthreads();
    load_raw<BN, DPK, NT>(raw, gb, p.g_ss, q0, p.Sq, p.D, tid);
    // P^T: rows are keys, columns queries (both warpgroups)
    float s[BN / 2];
    prod3_ss<BN, KS>(s, sK, 64, 0, G::FPLANE, sA, G::PLANE);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = 8 * i + 2 * t + (e & 1), row = q0 + q;
        const int key = kr0 + 8 * (e >> 1);
        const bool ok = row < p.Sq && key < kv_len && (!p.causal || key <= q_off + row);
        s[4 * i + e] = ok ? exp2f(s[4 * i + e] * p.scale_log2 - sL[q]) : 0.f;
      }
    // dO^T: dV += P^T dO
    cp_async_wait_all();
    __syncthreads();
    split_t<BN, DPK, NT>(sA, raw, tid);
    fence_proxy_async();
    __syncthreads();
    if (!kwg) {
      uint32_t pb[BN / 8][4], ps[BN / 8][4];
      to_frags<BN / 2>(s, pb, ps);
      prod3_rs_add<DP, G::CN, BN / 8>(acc, pb, ps, sA, DPK, G::PLANE);
    }
    // dO: dP^T = V dO^T, dK += dS^T Q
    __syncthreads();
    split_km<BN, DPK, NT>(sA, raw, tid);
    fence_proxy_async();
    __syncthreads();
    if (it + 1 < ntiles) load_raw<BN, DPK, NT>(raw, qb, p.q_ss, q0 + BN, p.Sq, p.D, tid);
    if (!kwg) continue;
    float dp[BN / 2];
    prod3_ss<BN, KS>(dp, sV, 64, 0, G::FPLANE, sA, G::PLANE);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = 8 * i + 2 * t + (e & 1);
        dp[4 * i + e] = s[4 * i + e] * (dp[4 * i + e] - sD[q]) * p.scale;
      }
    uint32_t db[BN / 8][4], ds[BN / 8][4];
    to_frags<BN / 2>(dp, db, ds);
    prod3_rs_add<DP, G::CN, BN / 8>(acc, db, ds, sB, DPK, G::PLANE);
  }

  const float one[2] = {1.f, 1.f};
  if (kwg)
    store_rows<DP>(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_ss, acc, one, kr0, p.Sk, p.D, t);
  else
    store_rows<DP>(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_ss, acc, one, kr0, p.Sk, p.D, t);
}

template <typename K>
cudaError_t launch_with(K kernel, int threads, int smem, long long blocks,
                        const Params& p, cudaStream_t stream) {
  if (blocks <= 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t forward(const Params& p, cudaStream_t s) {
  using G = FwdGeo<DP>;
  const long long blocks =
      static_cast<long long>((p.Sq + G::BM - 1) / G::BM) * p.B * p.H * p.ksplit;
  cudaError_t e = launch_with(attn_fwd_tf32<DP>, G::NT, G::BYTES + SMEM_ALIGN, blocks, p, s);
  if (e != cudaSuccess || p.ksplit == 1) return e;
  const long long work = static_cast<long long>(p.B) * p.H * p.Sq * (p.D / 4);
  const long long want = (work + 255) / 256;
  combine_splits<<<static_cast<unsigned>(want < 8LL * sm_count() ? want : 8LL * sm_count()),
                   256, 0, s>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t backward(const Params& p, cudaStream_t s) {
  using G = BwdGeo<DP>;
  const long long qblocks = static_cast<long long>((p.Sq + 63) / 64) * p.B * p.H;
  cudaError_t e = launch_with(attn_dq_tf32<DP>, G::NT, G::BYTES + SMEM_ALIGN, qblocks, p, s);
  if (e != cudaSuccess) return e;
  const long long kblocks = static_cast<long long>((p.Sk + 63) / 64) * p.B * p.H;
  return launch_with(attn_dkv_tf32<DP>, G::NT, G::BYTES + SMEM_ALIGN, kblocks, p, s);
}

template <int DP> void plan_of(int* out, bool fwd) {
  if (fwd) {
    using G = FwdGeo<DP>;
    out[0] = G::BM; out[1] = G::BN; out[2] = G::BYTES + SMEM_ALIGN;
  } else if constexpr (DP <= 128) {
    using G = BwdGeo<DP>;
    out[0] = 64; out[1] = G::BN; out[2] = G::BYTES + SMEM_ALIGN;
  }
}

}  // namespace

namespace {

int forward_entry(const void* q, const void* k, const void* v, void* o,
                  long long q_sb, long long q_sh, long long q_ss,
                  long long k_sb, long long k_sh, long long k_ss,
                  long long v_sb, long long v_sh, long long v_ss,
                  long long o_sb, long long o_sh, long long o_ss,
                  const void* kv_lens, const void* q_start,
                  int B, int H, int Sq, int Sk, int D, int causal, int win,
                  float sm_scale, void* lse, int ksplit, void* part_o,
                  void* part_lse, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (D <= 0 || D % 8 || D > 256) return cudaErrorInvalidValue;
  if (ksplit < 1 || ksplit > 8 || (ksplit > 1 && (part_o == nullptr || part_lse == nullptr)))
    return cudaErrorInvalidValue;
  Params p = {};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.out = static_cast<float*>(o);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.q_start = static_cast<const int*>(q_start);
  p.lse = static_cast<float*>(lse);
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk; p.D = D;
  p.causal = causal; p.win = win;
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * LOG2E;
  p.ksplit = ksplit;
  p.part_o = static_cast<float*>(part_o);
  p.part_lse = static_cast<float*>(part_lse);
  cudaError_t e = use_device_of(q);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) e = forward<32>(p, s);
  else if (D <= 64) e = forward<64>(p, s);
  else if (D <= 80) e = forward<80>(p, s);
  else if (D <= 96) e = forward<96>(p, s);
  else if (D <= 128) e = forward<128>(p, s);
  else e = forward<256>(p, s);
  return static_cast<int>(e);
}

}  // namespace

// Padded head dims: 32, 64, 80, 96, 128 and (forward only) 256, as K1 and K6.
// q, k, v, o: f32 [B,H,S,D] views through element strides (the head dim
// contiguous, D % 8 == 0, rows 16-byte aligned). `lse` is null or a
// contiguous f32 [B,H,Sq].
extern "C" int vgt_attention_fwd_f32(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    const void* kv_lens, const void* q_start,
    int B, int H, int Sq, int Sk, int D, int causal, int win,
    float sm_scale, void* lse, void* stream) {
  return forward_entry(q, k, v, o, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                       o_sb, o_sh, o_ss, kv_lens, q_start, B, H, Sq, Sk, D, causal, win,
                       sm_scale, lse, 1, nullptr, nullptr, stream);
}

// The same with the key tiles of each query tile dealt to `ksplit` CTAs (2
// to 8; a grid of query tiles too small for the card): part_o, contiguous
// f32 [ksplit,B,H,Sq,D], and part_lse, [ksplit,B,H,Sq], are scratch that the
// caller allocates; a second launch folds them into o (and lse).
extern "C" int vgt_attention_fwd_f32_split(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    const void* kv_lens, const void* q_start,
    int B, int H, int Sq, int Sk, int D, int causal, int win,
    float sm_scale, void* lse, int ksplit, void* part_o, void* part_lse,
    void* stream) {
  return forward_entry(q, k, v, o, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                       o_sb, o_sh, o_ss, kv_lens, q_start, B, H, Sq, Sk, D, causal, win,
                       sm_scale, lse, ksplit, part_o, part_lse, stream);
}

// ptrs: q, k, v, out, dout, dq, dk, dv; strides: (batch, head, token) of each
// in that order; lse: [B,H,Sq] as the forward wrote it; delta: [B,H,Sq]
// scratch. The signature of vgt_flash_bwd (csrc/flash_bwd.cu). Two launches:
// the dq kernel (which writes delta), then the dk/dv kernel.
extern "C" int vgt_flash_bwd_f32(const void* const* ptrs, const long long* st,
                                 const void* lse, void* delta,
                                 const void* kv_lens, const void* q_start,
                                 int B, int H, int Sq, int Sk, int D, int causal,
                                 float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (D <= 0 || D % 8 || D > 128) return cudaErrorInvalidValue;
  Params p = {};
  p.q = static_cast<const float*>(ptrs[0]);
  p.k = static_cast<const float*>(ptrs[1]);
  p.v = static_cast<const float*>(ptrs[2]);
  p.o = static_cast<const float*>(ptrs[3]);
  p.dout = static_cast<const float*>(ptrs[4]);
  p.dq = static_cast<float*>(const_cast<void*>(ptrs[5]));
  p.dk = static_cast<float*>(const_cast<void*>(ptrs[6]));
  p.dv = static_cast<float*>(const_cast<void*>(ptrs[7]));
  p.q_sb = st[0]; p.q_sh = st[1]; p.q_ss = st[2];
  p.k_sb = st[3]; p.k_sh = st[4]; p.k_ss = st[5];
  p.v_sb = st[6]; p.v_sh = st[7]; p.v_ss = st[8];
  p.o_sb = st[9]; p.o_sh = st[10]; p.o_ss = st[11];
  p.g_sb = st[12]; p.g_sh = st[13]; p.g_ss = st[14];
  p.dq_sb = st[15]; p.dq_sh = st[16]; p.dq_ss = st[17];
  p.dk_sb = st[18]; p.dk_sh = st[19]; p.dk_ss = st[20];
  p.dv_sb = st[21]; p.dv_sh = st[22]; p.dv_ss = st[23];
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.q_start = static_cast<const int*>(q_start);
  p.lse = static_cast<float*>(const_cast<void*>(lse));
  p.delta = static_cast<float*>(delta);
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk; p.D = D;
  p.causal = causal; p.win = 0;
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * LOG2E;
  p.ksplit = 1;
  cudaError_t e = use_device_of(ptrs[0]);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) e = backward<32>(p, s);
  else if (D <= 64) e = backward<64>(p, s);
  else if (D <= 80) e = backward<80>(p, s);
  else if (D <= 96) e = backward<96>(p, s);
  else e = backward<128>(p, s);
  return static_cast<int>(e);
}

// The tile plan the kernels were built with at padded head dim `dp`:
// out = (rows a CTA, keys or queries a streamed tile, dynamic shared memory
// bytes) of the forward (fwd != 0) or of each backward kernel; returns -1
// for a head dim the kernel does not build. ops/attention.py's
// k1_f32_plan / k6_f32_plan must agree (held on the card).
extern "C" int vgt_attention_f32_plan(int dp, int fwd, int* out) {
  switch (dp) {
    case 32: plan_of<32>(out, fwd); return 0;
    case 64: plan_of<64>(out, fwd); return 0;
    case 80: plan_of<80>(out, fwd); return 0;
    case 96: plan_of<96>(out, fwd); return 0;
    case 128: plan_of<128>(out, fwd); return 0;
    case 256: if (!fwd) return -1; plan_of<256>(out, fwd); return 0;
    default: return -1;
  }
}
