// K4: single-query (decode) attention over the int8 token-major KV cache, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel `_decode_q_kernel` of
// videoglamm_tpu/ops/attention.py (:1061, launched by `decode_attention_quant`
// :1199). It computes what that kernel computes, per batch row b and kv head
// h, for the G = Hq / Hkv query heads of that kv head:
//
//   s_j  = (q . k_j) * sm_scale * ks[h, j]       f32, k_j = k[b, j, h*hd:(h+1)*hd] int8
//   columns j >= kv_len[b] are left out, softmax over the rest (online)
//   o    = sum_j bf16(p_j * vs[h, j]) * v_j / l   f32 accumulation, l == 0 -> 1
//
// It does not carry over the TPU kernel's block-diagonal query, which exists
// to feed a matrix unit; here the products are FMAs in registers.
//
// The cache is read in place: k and v are [L, B, C, Hkv*hd] int8 and the
// layer is a pointer offset, the scales are [L, B, Hkv, C] f32, kv_len is read
// from device memory (no host sync), and nothing is copied, dequantised into
// memory or repeated for GQA.
//
// What bounds it on the H100: bytes. One layer's live cache (2 * kv_len *
// Hkv*hd bytes) is read once; at batch 1 that is tens of megabytes per
// layer, a few microseconds at the card's memory rate, so the work must be
// spread over all SMs. Design: a split over the C axis. Block (split, b)
// takes a contiguous range of tokens and ALL kv heads, so every load is a
// whole token row: thread `vec` of a row owns one 16-byte vector (16 int8 of
// one head) for the block's lifetime, keeps that slice of q and of the
// output accumulator in registers, and neighbouring threads read neighbouring
// addresses. The hd/16 threads of a head exchange their partial dot products
// through shared memory (double-buffered, one barrier per T tokens), and the
// next T rows are in flight while the current ones are worked on. Narrow
// rows (Hkv*hd/16 < 128 threads) take R tokens in parallel per block. Each
// (split, r) writes an (m, l, acc) partial per query head, and a second, tiny
// kernel combines the partials. Scales are read [Hkv, C]-major, contiguous
// along the token axis.
// Later work: fewer, longer splits per head to shrink the partials, cp.async
// or TMA prefetch of the next rows, and fusing the cache write of the new
// token.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

struct Params {
  const __nv_bfloat16* q; long long q_sb, q_sh;      // [B, Hq, 1, hd]
  const int8_t* k; const int8_t* v;                   // layer slab [B, C, Hkv*hd]
  const float* ks; const float* vs;                   // layer slab [B, Hkv, C]
  const int* kv_lens;                                 // [B]
  float* part_acc;                                    // [B, Hq, NS, hd]
  float* part_ml;                                     // [B, Hq, NS, 2]
  int B, Hq, Hkv, C, hd;
  int nsplit, R, NV, VPT;      // NS = nsplit * R; NV = Hkv*hd/16; VPT = hd/16
  float sm_scale;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void unpack16(const int4& w, float* f) {
  const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[4 * i + b] = static_cast<float>(
          static_cast<int8_t>((words[i] >> (8 * b)) & 0xff));
  }
}

// G query heads per kv head, T tokens per thread between barriers (G*T <= 8;
// T = 4 keeps the G = 1 instantiation at 128 registers without spills)
template <int G, int T>
__global__ void __launch_bounds__(256) decode_partial_kernel(const Params p) {
  extern __shared__ float spart[];                    // [2][T][G][NT]
  const int NT = blockDim.x;
  const int tid = threadIdx.x;
  const int split = blockIdx.x, b = blockIdx.y;
  const int r = tid / p.NV, vec = tid - r * p.NV;
  const int head = vec / p.VPT, part = vec - head * p.VPT;

  int kv_len = p.kv_lens[b];
  kv_len = kv_len < 0 ? 0 : (kv_len > p.C ? p.C : kv_len);
  const int per = (kv_len + p.nsplit - 1) / p.nsplit;
  const int start = split * per;
  const int end = start + per < kv_len ? start + per : kv_len;

  float qf[G][16];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const __nv_bfloat16* qp =
        p.q + (long long)b * p.q_sb + (long long)(head * G + g) * p.q_sh + part * 16;
#pragma unroll
    for (int i = 0; i < 16; ++i) qf[g][i] = __bfloat162float(qp[i]);
  }

  float m[G], l[G], acc[G][16];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[g][i] = 0.f;
  }

  const long long HD = (long long)p.Hkv * p.hd;
  const int8_t* kb = p.k + (long long)b * p.C * HD + vec * 16;
  const int8_t* vb = p.v + (long long)b * p.C * HD + vec * 16;
  const float* ksb = p.ks + ((long long)b * p.Hkv + head) * p.C;
  const float* vsb = p.vs + ((long long)b * p.Hkv + head) * p.C;
  const int lane0 = r * p.NV + head * p.VPT;          // first thread of my head

  // Software pipeline: the rows of the next T tokens are requested while
  // the current ones go through the barrier, the softmax and the V product.
  int4 kv[T], vv[T], nvv[T];
  float ksj[T], vsj[T], nks[T], nvs[T];
  const int step = p.R * T;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int j = start + r + p.R * t;
    const bool live = j < end;
    kv[t] = live ? __ldcs(reinterpret_cast<const int4*>(kb + j * HD))
                 : make_int4(0, 0, 0, 0);
    vv[t] = live ? __ldcs(reinterpret_cast<const int4*>(vb + j * HD))
                 : make_int4(0, 0, 0, 0);
    ksj[t] = live ? ksb[j] : 0.f;
    vsj[t] = live ? vsb[j] : 0.f;
  }

  int buf = 0;
  for (int j0 = start; j0 < end; j0 += step) {
    float* sp = spart + buf * (T * G) * NT;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float kf[16];
      unpack16(kv[t], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};        // four independent chains
#pragma unroll
        for (int i = 0; i < 16; ++i) d[i & 3] = fmaf(qf[g][i], kf[i], d[i & 3]);
        sp[(t * G + g) * NT + tid] = (d[0] + d[1]) + (d[2] + d[3]);
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {        // kv[] is free again: next rows
      const int j = j0 + step + r + p.R * t;
      const bool live = j < end;
      kv[t] = live ? __ldcs(reinterpret_cast<const int4*>(kb + j * HD))
                   : make_int4(0, 0, 0, 0);
      nvv[t] = live ? __ldcs(reinterpret_cast<const int4*>(vb + j * HD))
                    : make_int4(0, 0, 0, 0);
      nks[t] = live ? ksb[j] : 0.f;
      nvs[t] = live ? vsb[j] : 0.f;
    }
    __syncthreads();

    float s[T][G];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const bool live = j0 + r + p.R * t < end;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
        for (int i = 0; i < p.VPT; ++i) d += sp[(t * G + g) * NT + lane0 + i];
        s[t][g] = live ? d * p.sm_scale * ksj[t] : NEG_INF;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int t = 0; t < T; ++t) mx = fmaxf(mx, s[t][g]);
      const float alpha = expf(m[g] - mx);
      m[g] = mx;
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[g][i] *= alpha;
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      if (j0 + r + p.R * t >= end) continue;
      float vf[16];
      unpack16(vv[t], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pj = expf(s[t][g] - m[g]);
        l[g] += pj;
        const float pb = bf16_round(pj * vsj[t]);
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[g][i] = fmaf(pb, vf[i], acc[g][i]);
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      vv[t] = nvv[t];
      ksj[t] = nks[t];
      vsj[t] = nvs[t];
    }
    buf ^= 1;
  }

  const int NS = p.nsplit * p.R;
  const int ns = split * p.R + r;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const long long row = ((long long)b * p.Hq + head * G + g) * NS + ns;
    float4* ap = reinterpret_cast<float4*>(p.part_acc + row * p.hd + part * 16);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ap[i] = make_float4(acc[g][4 * i], acc[g][4 * i + 1], acc[g][4 * i + 2],
                          acc[g][4 * i + 3]);
    if (part == 0) {
      p.part_ml[row * 2] = m[g];
      p.part_ml[row * 2 + 1] = l[g];
    }
  }
}

// out[b, hq, d] = sum_s w_s acc_s[d] / sum_s w_s l_s,  w_s = exp(m_s - max m).
// One block per (query head, batch row): warp w folds the splits s = w, w+8,
// ... (independent loads, so they pipeline), lane d owns output dims d,
// d+32, d+64, d+96; the eight warps' (m, l, o) meet in shared memory.
constexpr int CWARPS = 8;

__global__ void __launch_bounds__(CWARPS * 32) decode_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    __nv_bfloat16* __restrict__ out, long long o_sb, long long o_sh,
    int Hq, int NS, int hd) {
  __shared__ float s_m[CWARPS], s_l[CWARPS], s_o[CWARPS][128];
  const int hq = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = ((long long)b * Hq + hq) * NS;

  float mx = NEG_INF;
  for (int s = warp; s < NS; s += CWARPS)
    mx = fmaxf(mx, part_ml[(base + s) * 2]);
  float l = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int s = warp; s < NS; s += CWARPS) {
    const float w = expf(part_ml[(base + s) * 2] - mx);
    l += w * part_ml[(base + s) * 2 + 1];
    const float* ap = part_acc + (base + s) * hd;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) o[i] += w * ap[d];
    }
  }
  if (lane == 0) {
    s_m[warp] = mx;
    s_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) s_o[warp][lane + 32 * i] = o[i];
  __syncthreads();
  if (warp != 0) return;

  float top = NEG_INF;
#pragma unroll
  for (int w = 0; w < CWARPS; ++w) top = fmaxf(top, s_m[w]);
  float total = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int w = 0; w < CWARPS; ++w) {
    const float f = expf(s_m[w] - top);   // a warp with no split: l = o = 0
    total += f * s_l[w];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += f * s_o[w][lane + 32 * i];
  }
  const float inv = 1.f / (total == 0.f ? 1.f : total);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = lane + 32 * i;
    if (d < hd)
      out[(long long)b * o_sb + (long long)hq * o_sh + d] =
          __float2bfloat16(acc[i] * inv);
  }
}

}  // namespace

// Plain C entry (bound with ctypes). Returns a cudaError_t code, 0 = ok.
// q, out: [B, Hq, 1, hd] bf16 with batch / head strides in elements (head dim
// contiguous, 16-byte aligned rows). k, v: the stacked [L, B, C, Hkv*hd] int8
// cache, contiguous; ks, vs: [L, B, Hkv, C] f32; kv_lens: [B] int32 on the
// device. part_acc: [B, Hq, nsplit*R, hd] f32 and part_ml: [B, Hq, nsplit*R,
// 2] f32 scratch, where R = max(1, 256 / (Hkv*hd/16)). Supports hd % 16 == 0,
// hd <= 128, Hkv*hd <= 4096 and Hq / Hkv in {1, 2, 4}.
extern "C" int vgt_decode_attention_q8(
    const void* q, long long q_sb, long long q_sh,
    const void* k, const void* v, const void* ks, const void* vs,
    const void* kv_lens, void* out, long long o_sb, long long o_sh,
    void* part_acc, void* part_ml, int layer, int B, int Hq, int Hkv, int C,
    int hd, int nsplit, float sm_scale, void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  if (hd <= 0 || hd % 16 || hd > 128 || Hkv <= 0 || Hq % Hkv || C <= 0 ||
      nsplit <= 0 || layer < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  const int NV = Hkv * hd / 16;
  if (NV > 256 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  const long long slab = (long long)B * C * Hkv * hd;
  const long long sslab = (long long)B * Hkv * C;
  p.q = static_cast<const __nv_bfloat16*>(q); p.q_sb = q_sb; p.q_sh = q_sh;
  p.k = static_cast<const int8_t*>(k) + layer * slab;
  p.v = static_cast<const int8_t*>(v) + layer * slab;
  p.ks = static_cast<const float*>(ks) + layer * sslab;
  p.vs = static_cast<const float*>(vs) + layer * sslab;
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.C = C; p.hd = hd;
  p.nsplit = nsplit; p.NV = NV; p.VPT = hd / 16;
  p.R = 256 / NV > 1 ? 256 / NV : 1;
  p.sm_scale = sm_scale;
  const int NT = NV * p.R;
  const size_t smem = 2 * 8 * static_cast<size_t>(NT) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(nsplit, B);
  if (G == 1)
    decode_partial_kernel<1, 4><<<grid, NT, smem, st>>>(p);
  else if (G == 2)
    decode_partial_kernel<2, 4><<<grid, NT, smem, st>>>(p);
  else if (G == 4)
    decode_partial_kernel<4, 2><<<grid, NT, smem, st>>>(p);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<<<dim3(Hq, B), CWARPS * 32, 0, st>>>(
      p.part_acc, p.part_ml, static_cast<__nv_bfloat16*>(out), o_sb, o_sh, Hq,
      nsplit * p.R, hd);
  return static_cast<int>(cudaGetLastError());
}
