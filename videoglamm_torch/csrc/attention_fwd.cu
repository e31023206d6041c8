// K1: online-softmax attention forward for Hopper (sm_90a), bf16 or f32
// in/out, f32 accumulation, mma.sync m16n8k16 bf16 tensor-core tiles.
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
// One kernel serves both: q, k, v and o are addressed through element
// strides (batch, head, token; the head dim is contiguous), so [B,H,S,D],
// [B,S,H,D] and the fused [B,S,3,H,D] qkv are read with no copy or pad.
//
// What bounds it on the H100: at the path's shapes (S from 64 to 4096,
// head dim 64..96) attention is compute-bound on QK^T and PV (bf16 tensor
// cores, 989 TFLOP/s dense) plus the f32 exp/max/sum of the softmax.
// Design: one CTA of 4 warps per (batch, head, 64-query tile); Q lives in
// registers as mma A fragments, K and V^T tiles of 64 keys are staged in
// shared memory, the softmax is online (running max and sum per row), so
// no [S,S] logits block ever exists: Pallas' single full-row softmax in
// _bshd_kernel does not fit a CTA (a 64 x 1025 f32 row block is 262 KB,
// above the 227 KB limit). Key tiles fully masked by causal order, kv_len
// or the window are skipped, as attention.py:113-117 skips blocks. The
// head dim is zero-padded in shared memory up to the mma K step (16).
// Rows with no valid key write 0, as the TPU kernel does (:170-174).
// With an `lse` pointer it also writes each row's log-sum-exp of the scaled
// logits (:176-180), which training saves for the backward; serving passes
// none.
// Head dim 256 (one 256-wide head: SAM-2 memory self-attention). With Q held
// as A fragments (DP/16 x 4 registers) and the output accumulator (DP/8 x 4
// floats) a thread would need 64 + 128 registers before anything else, over
// the 255 limit. The 256 instantiation therefore reloads each Q fragment
// from shared memory at the K step that uses it (the Q tile stays resident
// there anyway) and takes 32-key tiles, which halves the logits registers;
// narrower heads keep Q in registers and 64-key tiles.
// f32 operands (the f32 memory modules of SAM-2): q, k and v are rounded to
// bf16 on the way into shared memory, which is what the bf16 model does at
// every other product; accumulation, softmax and the output stay f32. Against
// the f32 plain twin that costs bf16-class error (a few 2^-9 of the output
// scale); TF32 tiles or a bf16 hi/lo split would cost a second fragment
// layout resp. three products for one, and are left for when a caller needs
// them.
// Later work: cp.async/TMA double buffering and wgmma (see ROADMAP.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "mma_common.cuh"

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

template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t s) {
  const int D = p.D;
  if (D <= 32) return launch<32, 64, true, T>(p, s);
  if (D <= 64) return launch<64, 64, true, T>(p, s);
  if (D <= 80) return launch<80, 64, true, T>(p, s);
  if (D <= 96) return launch<96, 64, true, T>(p, s);
  if (D <= 128) return launch<128, 64, true, T>(p, s);
  if (D <= 256) return launch<256, 32, false, T>(p, s);
  return cudaErrorInvalidValue;
}

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
  return static_cast<int>(is_f32 ? dispatch<float>(p, s)
                                : dispatch<__nv_bfloat16>(p, s));
}
