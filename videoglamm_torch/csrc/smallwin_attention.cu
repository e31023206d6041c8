// K8: self-attention inside tiny fixed windows, straight from the fused qkv
// projection, for Hopper (sm_90a): bf16 in/out, f32 accumulation, mma.sync
// m16n8k16 tensor-core tiles.
//
// Replaces the Pallas TPU kernel _smallwin_kernel of
// videoglamm_tpu/ops/attention.py (:605, launched by _smallwin_fwd :677):
// qkv [NW, S, 3*H*hd] with S in {16, 32, 64} tokens a window -> [NW, S, H*hd],
// heads read at their natural offsets of the fused projection and written at
// their natural offsets of the output, so no head-major or padded copy of
// the activations ever exists (Hiera stage 1: S 64, H 2, hd 72; stage 2:
// S 16, H 4, hd 72).
//
// The TPU kernel packs tile/S windows into one 128- or 256-row MXU tile
// under a block-diagonal mask and throws away tile/S of the products. Here
// a (window, head) pair is one unit of S/16 warps, each owning 16 query
// rows; a CTA of 4 warps holds 4, 2 or 1 units (S = 16, 32, 64). A window's
// keys are one tile, so there is no packing, no mask and no key loop: the
// logits of a row live in registers, the softmax is a single pass with the
// exact row maximum and sum, and the normalised probabilities go straight
// into the p v product as bf16 A fragments.
//
// What bounds it on the H100: bytes. Per token it reads 3*hd and writes hd
// values against 4*S*hd operations, 4 to 16 operations a byte, far under the
// card's 295. The design therefore reads each q, k, v row once with 16-byte
// loads into shared memory (head dims that are no multiple of 16, 72 and 88,
// are zero-padded there up to the mma K step) and writes each output once.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "mma_common.cuh"

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;

// S: tokens a window; DP: head dim padded to the mma K step.
template <int S, int DP>
__global__ void __launch_bounds__(NTHREADS) smallwin_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ o,
    int NW, int H, int hd, float scale_log2) {
  constexpr int WPU = S / 16;          // warps a (window, head) unit
  constexpr int UNITS = NWARPS / WPU;  // units a CTA
  constexpr int UT = WPU * 32;         // threads a unit
  constexpr int LDS = DP + 8;          // padded row stride: no bank conflicts
  constexpr int LDV = S + 8;
  constexpr int CH = DP / 8;           // 16-byte chunks per row
  constexpr int KS = DP / 16;          // mma K steps over the head dim
  constexpr int NT = S / 8;            // mma N tiles over the window's keys
  constexpr int DT = DP / 8;           // mma N tiles over the head dim

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int unit = warp / WPU;         // unit of this warp inside the CTA
  const int ut = tid - unit * UT;      // thread index inside the unit

  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw)
      + unit * (2 * S * LDS + DP * LDV);
  __nv_bfloat16* sK = sQ + S * LDS;
  __nv_bfloat16* sVt = sK + S * LDS;   // V transposed: [DP][S]

  const long long u = (long long)blockIdx.x * UNITS + unit;
  const bool live = u < (long long)NW * H;
  const int h = live ? (int)(u % H) : 0;
  const long long w = live ? u / H : 0;
  const int C = H * hd;
  const __nv_bfloat16* xb = x + w * S * 3 * C + h * hd;

  if (live) {
    for (int idx = ut; idx < S * CH; idx += UT) {
      const int r = idx / CH, d0 = (idx % CH) * 8;
      uint4 q4 = make_uint4(0u, 0u, 0u, 0u), k4 = q4, v4 = q4;
      if (d0 < hd) {
        const __nv_bfloat16* row = xb + (long long)r * 3 * C + d0;
        q4 = *reinterpret_cast<const uint4*>(row);
        k4 = *reinterpret_cast<const uint4*>(row + C);
        v4 = *reinterpret_cast<const uint4*>(row + 2 * C);
      }
      *reinterpret_cast<uint4*>(sQ + r * LDS + d0) = q4;
      *reinterpret_cast<uint4*>(sK + r * LDS + d0) = k4;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&v4);
#pragma unroll
      for (int i = 0; i < 8; ++i) sVt[(d0 + i) * LDV + r] = ve[i];
    }
  }
  __syncthreads();
  if (!live) return;

  // logits of this warp's 16 query rows against all S keys of the window
  const int qr = (warp % WPU) * 16;
  const __nv_bfloat16* qbase = sQ + (qr + g) * LDS + 2 * t;
  float s[NT][4];
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

  // single-pass softmax in registers: exact row maximum, then row sum
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] *= scale_log2;
    mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
  }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    s[n][0] = exp2f(s[n][0] - mx[0]);
    s[n][1] = exp2f(s[n][1] - mx[0]);
    s[n][2] = exp2f(s[n][2] - mx[1]);
    s[n][3] = exp2f(s[n][3] - mx[1]);
    l[0] += s[n][0] + s[n][1];
    l[1] += s[n][2] + s[n][3];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / l[r];
  }

  // o = p v with the normalised probabilities as bf16 A fragments
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < S / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(s[2 * kk][0] * l[0], s[2 * kk][1] * l[0]);
    a[1] = pack_bf16(s[2 * kk][2] * l[1], s[2 * kk][3] * l[1]);
    a[2] = pack_bf16(s[2 * kk + 1][0] * l[0], s[2 * kk + 1][1] * l[0]);
    a[3] = pack_bf16(s[2 * kk + 1][2] * l[1], s[2 * kk + 1][3] * l[1]);
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      const __nv_bfloat16* vbase = sVt + (dn * 8 + g) * LDV + kk * 16 + 2 * t;
      mma_bf16(acc[dn], a, ld32(vbase), ld32(vbase + 8));
    }
  }

  __nv_bfloat16* ob = o + w * S * C + h * hd;
  const int r0 = qr + g, r1 = r0 + 8;
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (col < hd) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r0 * C + col) =
          __floats2bfloat162_rn(acc[dn][0], acc[dn][1]);
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r1 * C + col) =
          __floats2bfloat162_rn(acc[dn][2], acc[dn][3]);
    }
  }
}

template <int S, int DP>
cudaError_t launch(const void* x, void* o, int NW, int H, int hd,
                   float scale_log2, cudaStream_t stream) {
  constexpr int units = NWARPS / (S / 16);
  constexpr int smem = units * (2 * S * (DP + 8) + DP * (S + 8)) * 2;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        smallwin_kernel<S, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const long long blocks = ((long long)NW * H + units - 1) / units;
  smallwin_kernel<S, DP><<<(unsigned)blocks, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(o),
      NW, H, hd, scale_log2);
  return cudaGetLastError();
}

template <int S>
cudaError_t dispatch(const void* x, void* o, int NW, int H, int hd,
                     float scale_log2, cudaStream_t s) {
  if (hd <= 32) return launch<S, 32>(x, o, NW, H, hd, scale_log2, s);
  if (hd <= 64) return launch<S, 64>(x, o, NW, H, hd, scale_log2, s);
  if (hd <= 80) return launch<S, 80>(x, o, NW, H, hd, scale_log2, s);
  if (hd <= 96) return launch<S, 96>(x, o, NW, H, hd, scale_log2, s);
  if (hd <= 128) return launch<S, 128>(x, o, NW, H, hd, scale_log2, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry (bound with ctypes). Returns a cudaError_t code, 0 = ok.
// qkv: contiguous bf16 [NW, S, 3*H*hd]; out: contiguous bf16 [NW, S, H*hd];
// S in {16, 32, 64}, hd % 8 == 0, hd <= 128, both pointers 16-byte aligned
// (checked by the Python wrapper).
extern "C" int vgt_smallwin_attention(
    const void* qkv, void* out, int NW, int S, int H, int hd, float sm_scale,
    void* stream) {
  if (NW <= 0 || H <= 0) return 0;
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (S == 16) e = dispatch<16>(qkv, out, NW, H, hd, scale_log2, s);
  else if (S == 32) e = dispatch<32>(qkv, out, NW, H, hd, scale_log2, s);
  else if (S == 64) e = dispatch<64>(qkv, out, NW, H, hd, scale_log2, s);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
