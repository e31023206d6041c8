// K1: online-softmax attention forward for Hopper (sm_90a) on wgmma, TMA
// and an mbarrier ring: bf16 operands, f32 accumulation, bf16 or f32 out.
//
// Replaces two Pallas TPU kernels of videoglamm_tpu/ops/attention.py:
//   * _flash_kernel (:93, launched by _flash_fwd :245): blockwise
//     online-softmax attention over [B,H,S,D] with a per-batch kv_len and
//     causal offset q_start (Phi-3 prefill, Hiera global blocks, the SAM-2
//     memory self-attention [4,1,4096,256] f32);
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
// dim 64 to 256) attention is compute-bound on QK^T and PV (bf16 tensor
// cores, 989 TFLOP/s dense) plus the f32 exp2 of the softmax.
//
// One body, `attn_fwd_sm90<DP>` (ops/attention.py `k1_route` states the
// rule; each route name has its own launch counter):
// * "wgmma": bf16 operands, head dim up to 256. A CTA of three warpgroups
//   owns 128 queries of one (batch, head). Warpgroup 2 is the producer:
//   one thread loads the Q tile, then K and V tiles with TMA into a
//   two-stage ring of shared memory, each stage on mbarriers (full:
//   expect_tx bytes; empty: the consumers' arrivals); it gives its
//   registers to the consumers (setmaxnreg). Warpgroups 0 and 1 each own
//   64 query rows: S = Q K^T is one wgmma chain with Q and K from shared
//   memory (the K tile [keys, D] is K-major for B); the online softmax runs
//   on exp2 in f32 registers; P, packed to bf16 straight from the S
//   accumulators (the accumulator layout of an m64 wgmma is the
//   A-register layout of the next), multiplies V from shared memory as an
//   MN-major B (the descriptor's transpose bit), so V is never transposed
//   by hand. The head dim pads to DP (32, 64, 80, 96, 128 or 256) for QK^T
//   and is the N of PV; TMA fills the columns past D with zeros, also in a
//   fused-qkv view where the next head's data lies behind them, and the
//   store clips at D. Tiles are 128-byte swizzled chunks of 64 columns.
//   Key tiles are 128 keys up to DP = 128 and 64 at DP = 256
//   (csrc/attn_sm90.cuh: what fits the shared memory and the registers).
//   The mask is applied only on tiles that cross kv_len, the causal
//   diagonal or a window edge; tiles wholly masked are never loaded. Keys
//   at or past kv_len but below Sk are real memory (a KV cache's slack,
//   possibly NaN): the consumers zero those V rows of the last live tile in
//   shared memory before PV, since 0 * NaN is NaN. Query tiles are handed
//   out longest first (reverse order), so a causal grid does not end on
//   its longest tiles. A bf16 output goes through shared memory and a TMA
//   store.
// * "wgmma_f32": f32 storage (the SAM-2 memory self-attention). TMA copies
//   bytes and does not convert, and tf32 wgmma would want V K-major, so a
//   staging pass (`stage_bf16_kernel`, its own launch and counter) first
//   writes contiguous bf16 copies of q, k and v, rounded to nearest even,
//   into scratch that the wrapper allocates; the same body then runs on
//   them and stores O in f32, normalised in f32, straight from the
//   accumulators. The products see the bf16 operands that the earlier
//   mma.sync body of this kernel rounded on its way into shared memory.
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
using attn::pack_bf16;

struct Params {
  const void* q;        // bf16, strides in elements
  const void* k;
  const void* v;
  void* o;              // bf16, or f32 when o_f32
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
  int o_f32;            // o is f32: direct stores, no output map
  float scale_log2;     // sm_scale * log2(e): the softmax runs on exp2
};

constexpr int BM = attn::BM;
constexpr int STAGES = attn::STAGES;
constexpr int NTHREADS = attn::NTHREADS;   // warpgroups 0, 1: consumers; 2: producer

// DP: the padded head dim: the depth of QK^T and the N of PV.
template <int DP>
__global__ void __launch_bounds__(NTHREADS, 1) attn_fwd_sm90(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
    const Params p) {
  using L = Geo<DP>;
  constexpr int BN = L::BN;
  constexpr int NCH = L::NCH;
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
      mbar_expect_tx(q_full, NCH * L::CHUNK_Q);
      for (int c = 0; c < NCH; ++c)
        tma_load_4d(smem + L::Q + c * L::CHUNK_Q, &tq, q_full, 64 * c, m0, h, b);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const int k0 = (j_lo + it) * BN;
        mbar_wait(kv_empty + s, ph ^ 1);
        mbar_expect_tx(k_full + s, NCH * L::CHUNK_KV);
        for (int c = 0; c < NCH; ++c)
          tma_load_4d(smem + L::K + (s * NCH + c) * L::CHUNK_KV, &tk, k_full + s,
                      64 * c, k0, h, b);
        mbar_expect_tx(v_full + s, NCH * L::CHUNK_KV);
        for (int c = 0; c < NCH; ++c)
          tma_load_4d(smem + L::V + (s * NCH + c) * L::CHUNK_KV, &tv, v_full + s,
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
      unsigned char* sV = smem + L::V + s * NCH * L::CHUNK_KV;

      // S = Q K^T (64 x BN), both operands K-major in shared memory
      mbar_wait(k_full + s, ph);
      float sc[BN / 2];
      attn::qk_tile<DP>(sc, sQw, smem + L::K + s * NCH * L::CHUNK_KV);

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
      // P packed to bf16 an 8-column group at a time, so S dies as P grows
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
          *reinterpret_cast<uint4*>(sV + c * L::CHUNK_KV + (vrow + rem / 8) * 128 +
                                    (rem % 8) * 16) = make_uint4(0u, 0u, 0u, 0u);
        }
        fence_proxy_async();
        named_bar_sync(1, 256);
      }

      // O += P V: P from registers, V [keys, D] as an MN-major B
      attn::pv_tile<DP>(o, pa, sV);
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
      // m_i is in log2 units; a row with no valid key gets -1e30, as the TPU
      // kernel writes it (attention.py:178)
      float* lb = p.lse + (static_cast<long long>(b) * p.H + h) * p.Sq;
      if (r0 < p.Sq)
        lb[r0] = l_i[0] > 0.f ? m_i[0] * 0.6931471805599453f + logf(l_i[0]) : -1e30f;
      if (r1 < p.Sq)
        lb[r1] = l_i[1] > 0.f ? m_i[1] * 0.6931471805599453f + logf(l_i[1]) : -1e30f;
    }
    if (p.o_f32) {
      float* ob = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
      attn::store_o_f32<DP>(ob, p.o_ss, o, inv, r0, p.Sq, p.D, t);
    } else {
      attn::store_o_bf16<DP>(&to, sQw, o, inv, lt, 2 + wg, m0w, h, b);
    }
  }
}

template <int DP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = Geo<DP>::BYTES + 1024;   // + alignment slack
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_sm90<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  constexpr int BN = Geo<DP>::BN;
  CUtensorMap tq, tk, tv, to;
  if (!map_bhsd(&tq, p.q, p.q_sb, p.q_sh, p.q_ss, p.B, p.H, p.Sq, p.D, BM) ||
      !map_bhsd(&tk, p.k, p.k_sb, p.k_sh, p.k_ss, p.B, p.H, p.Sk, p.D, BN) ||
      !map_bhsd(&tv, p.v, p.v_sb, p.v_sh, p.v_ss, p.B, p.H, p.Sk, p.D, BN))
    return cudaErrorInvalidValue;
  if (p.o_f32)
    to = tq;   // unused: an f32 output is stored from the registers
  else if (!map_bhsd(&to, p.o, p.o_sb, p.o_sh, p.o_ss, p.B, p.H, p.Sq, p.D, 64))
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
  if (D <= 256) return launch<256>(p, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// the staging pass of route "wgmma_f32": f32 [B,H,S_i,D] views (element
// strides, contiguous head dim) -> contiguous bf16 [B,H,S_i,D] copies,
// rounded to nearest even. A thread moves 8 elements (32 bytes in, 16 out)
// a step of a grid-stride loop over the tensors' 8-element groups, which it
// takes in the destination's order, so neighbouring threads write
// neighbouring 16 bytes. Bound by bytes.
// ---------------------------------------------------------------------------
constexpr int STAGE_MAX = 3;
constexpr int STAGE_THREADS = 256;

struct StageArgs {
  const float* src[STAGE_MAX];
  __nv_bfloat16* dst[STAGE_MAX];
  long long sb[STAGE_MAX], sh[STAGE_MAX], ss[STAGE_MAX];
  int S[STAGE_MAX];
  long long start[STAGE_MAX + 1];   // first group of each tensor; start[n]: all
  int n, H, D;
};

__global__ void __launch_bounds__(STAGE_THREADS) stage_bf16_kernel(const StageArgs a) {
  const int groups = a.D / 8;   // 8-element groups a row
  const long long total = a.start[a.n];
  const long long step = static_cast<long long>(gridDim.x) * STAGE_THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * STAGE_THREADS + threadIdx.x;
       i < total; i += step) {
    int t = 0;
#pragma unroll
    for (int u = 1; u < STAGE_MAX; ++u)
      if (u < a.n && i >= a.start[u]) t = u;
    const long long j = i - a.start[t];
    const long long row = j / groups;   // (b, h, s) in order
    const int d0 = static_cast<int>(j - row * groups) * 8;
    const int s = static_cast<int>(row % a.S[t]);
    const long long bh = row / a.S[t];
    const int h = static_cast<int>(bh % a.H), b = static_cast<int>(bh / a.H);
    const float* src = a.src[t] + b * a.sb[t] + h * a.sh[t] + s * a.ss[t] + d0;
    const float4 x = *reinterpret_cast<const float4*>(src);
    const float4 y = *reinterpret_cast<const float4*>(src + 4);
    *reinterpret_cast<uint4*>(a.dst[t] + j * 8) =
        make_uint4(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w),
                   pack_bf16(y.x, y.y), pack_bf16(y.z, y.w));
  }
}

}  // namespace

// Plain C entries (bound with ctypes). Each returns a cudaError_t code, 0 = ok.
//
// vgt_attention_fwd: q, k and v are bf16 (the f32 route hands in the
// staging pass's copies); o is bf16, or f32 when `o_f32` is set. Strides
// are in elements; the head dim must be contiguous, D % 8 == 0, D <= 256,
// every stride a multiple of 8 and every pointer 16-byte aligned (checked
// by the Python wrapper, which also checks the TMA plan). `lse` is null or
// a contiguous f32 [B,H,Sq]. Every launch takes the one body; a head dim
// above 256 is refused.
extern "C" int vgt_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    const void* kv_lens, const void* q_start,
    int B, int H, int Sq, int Sk, int D, int causal, int win,
    float sm_scale, void* lse, int o_f32, void* stream) {
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
  p.causal = causal; p.win = win; p.o_f32 = o_f32;
  p.scale_log2 = sm_scale * 1.4426950408889634f;
  cudaError_t e = use_device_of(q);
  if (e == cudaSuccess) e = dispatch(p, static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}

// vgt_stage_bf16: n (1 to 3) f32 tensors [B,H,S[i],D] at src[i] with element
// strides sb[i], sh[i], ss[i] (head dim contiguous, D % 8 == 0, 16-byte
// aligned) -> contiguous bf16 [B,H,S[i],D] at dst[i].
extern "C" int vgt_stage_bf16(const void* const* src, void* const* dst,
                              const long long* strides, const int* S, int n,
                              int B, int H, int D, void* stream) {
  if (n < 1 || n > STAGE_MAX || D % 8 || D <= 0) return cudaErrorInvalidValue;
  StageArgs a;
  a.n = n; a.H = H; a.D = D;
  a.start[0] = 0;
  for (int i = 0; i < STAGE_MAX; ++i) {
    const bool live = i < n;
    a.src[i] = live ? static_cast<const float*>(src[i]) : nullptr;
    a.dst[i] = live ? static_cast<__nv_bfloat16*>(dst[i]) : nullptr;
    a.sb[i] = live ? strides[3 * i] : 0;
    a.sh[i] = live ? strides[3 * i + 1] : 0;
    a.ss[i] = live ? strides[3 * i + 2] : 0;
    a.S[i] = live ? S[i] : 1;
    if (live)
      a.start[i + 1] = a.start[i] + static_cast<long long>(B) * H * S[i] * (D / 8);
  }
  if (a.start[n] == 0) return 0;
  const cudaError_t e = use_device_of(src[0]);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long want = (a.start[n] + STAGE_THREADS - 1) / STAGE_THREADS;
  const long long blocks = want < 8LL * sm_count() ? want : 8LL * sm_count();
  stage_bf16_kernel<<<static_cast<unsigned>(blocks), STAGE_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
