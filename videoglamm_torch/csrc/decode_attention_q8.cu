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
//   o    = sum_j bf16(p_j * vs[h, j]) * v_j / l   f32 accumulation, l == 0 -> 0
//
// with p_j unnormalised against a running maximum. The cache is read in
// place: k and v are [L, B, C, Hkv*hd] int8 and the layer is a pointer
// offset, the scales are [L, B, Hkv, C] f32, kv_len is read from device
// memory (no host sync), and nothing is copied, dequantised into memory or
// repeated for GQA.
//
// What bounds it on the H100: bytes. One layer's live cache (2 * kv_len *
// Hkv*hd codes and 8 * kv_len * Hkv bytes of scales) is read once: 21.8 MB,
// 6.5 us, for Phi-3's 32 heads of 96 at kv_len 3400; 7.3 MB, 2.2 us, for
// Llama-3.1-8B's 8 kv heads of 128. What held back the first design (a
// partial kernel of one CTA an SM over all heads, then a combine kernel),
// and what this one does about it:
//
// 1. Two launches, and partials that outweighed the work (8.8 MB for
//    Llama). Now one launch: CTA (split, h, b) takes one kv head over one
//    contiguous range of tokens, `k4_plan` picks the split count (a power
//    of two, up to 16) so that B * Hkv * splits is about one CTA an SM, one
//    wave. Each split leaves one partial (m, l, o) per query head, G * (hd +
//    2) floats (3.7% of the cache's bytes at the Llama shape, 0.2% at
//    Phi-3's); the last CTA of a (b, h) to finish, found by a ticket
//    counter that wraps to 0 on that arrival (atom.inc), folds the splits
//    in split order and writes o. The ticket is the only atomic: repeated
//    calls are bit-equal.
//    (Thread-block clusters folding through distributed shared memory were
//    built and measured first: at one CTA an SM the card held fewer
//    clusters of 4 or 16 at once than the 32 or 8 a flagship call needs,
//    so every such call ran in two waves.)
// 2. Short splits behind block-wide barriers. Now a producer warp streams
//    the split's tokens in stages of 240 (Phi-3) or 60 (Llama) rows: K and
//    V by TMA (a 2-D u8 tensor map over the stacked cache, encoded once per
//    cache and kept; the layer and batch row are coordinates) and the two
//    scale rows by 4-byte copies, into a ring of up to 8 stages behind
//    mbarriers, every stage of a split in flight at once at the flagship
//    shapes. 15 consumer warps: lane v of a segment of `seg` lanes owns DPL
//    dims of the head (24 for Phi-3's 96, 8 for Llama's 4 query heads of
//    128, else 16), its slice of q and of the G accumulators in registers;
//    a segment is a "phase" that takes rows phase, phase + phases, ... of
//    each stage, its dot products meet in warp shuffles, and its online
//    softmax advances once a chunk of CH tokens. The only block barriers
//    are at the end: a warp's phases merge in a butterfly of shuffles, and
//    the 15 warps fold in warp order through shared memory.
// 3. I2F on every code. Now none: a code's image is one PRMT (byte + 128
//    into the low bits of an f32, a denormal); the dot products and the V
//    sums run on these images against q and p pre-scaled by powers of two
//    (products normal and exact, FFMA keeps denormals), and one FFMA a
//    dot product takes the scaling and the 128 off again. Each image is
//    used for the G query heads of its kv head. No integer division by a
//    runtime value either: the plan's counts are powers of two or loop
//    bounds.
// 4. expf with a separate scale. Now the logit scale sm_scale * log2(e) *
//    ks[j] is one product a token and the probability ex2.approx.ftz of one
//    FMA, fma(q.k, scale, -m).
// 5. Host work a call. Python picks the splits, the stage rows' pitch, the
//    TMA box and the ring's depth once per geometry (`k4_plan`, cached); the
//    entry derives the layout from them and refuses choices that do not
//    fit (`layout`); the partials
//    and tickets live in a workspace kept per device and stream; the
//    wrapper allocates only `out`; the tensor maps and the function's
//    shared-memory attribute are made once.
//
// bf16(p * vs) is rounded where the TPU kernel rounds it (:1121), relative
// to the phase's running maximum; the merges and folds rescale in f32.
//
// f32 queries (an f32 model's decode, `vgt_decode_attention_q8_f32`) take
// the same kernel through a template parameter, F32: the same plan, ring,
// walk, workspace, ticket and folds; q is read and o written in f32. The
// TPU kernel in f32 rounds nothing (`pb = (p * vs).astype(qbd.dtype)` is
// f32 there), so neither does this route: pb = p * vs stays f32. The
// denormal images of the bf16 route (exact only because a bf16 q or pb
// times an 8-bit code fits an f32 significand) would make an f32 dot
// product carry 128 * sum(q) and cancel it afterwards, so the f32 route
// turns codes into their signed values by the magic number instead (one
// PRMT and one exact FADD a code, `int8_to_f32`: still no I2F), and its
// dot products and V sums are the plain f32 FMA sums of q . k and pb * v.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

namespace {

#include "sm90_common.cuh"

// The constants below are the only copy: `ops/attention.py` reads each
// `constexpr int NAME = value;` line of this file for `k4_plan`.
constexpr int CWARPS = 15;           // consumer warps; warp 15 is the producer
constexpr int MAX_SPLITS = 16;
constexpr int MAX_STAGES = 8;
constexpr int DYN_SMEM = 231424;     // a CTA's dynamic shared memory: 227 KB less 1 KB
// the instantiations, by query heads a kv head G: dims (codes) a lane owns,
// and tokens a phase takes from a stage between softmax updates (G = 1
// takes the wide lanes at head dims divisible by 24: 48 and 96)
constexpr int DPL_G1 = 16;
constexpr int CHUNK_G1 = 4;
constexpr int DPL_G1_WIDE = 24;
constexpr int CHUNK_G1_WIDE = 2;
constexpr int DPL_G2 = 16;
constexpr int CHUNK_G2 = 2;
constexpr int DPL_G4 = 8;
constexpr int CHUNK_G4 = 2;
constexpr int THREADS = (CWARPS + 1) * 32;
constexpr int CONSUMERS = CWARPS * 32;
constexpr float NEG_INF = -1e30f;

// dims a lane owns, and its chunk, for G query heads a kv head of hd dims
constexpr int dpl_of(int G, int hd) {
  return G == 4 ? DPL_G4 : G == 2 ? DPL_G2 : hd % DPL_G1_WIDE == 0 ? DPL_G1_WIDE : DPL_G1;
}
__host__ __device__ constexpr int chunk_of(int G, int dpl) {
  return G == 4 ? CHUNK_G4 : G == 2 ? CHUNK_G2 : dpl == DPL_G1_WIDE ? CHUNK_G1_WIDE : CHUNK_G1;
}

// a launch's layout: the plan's choices (splits, pitch, box, stages) and
// what follows from them, this head dim and the instantiation (`layout`)
struct Plan {
  int splits, log_splits, seg, log_seg, vph, phases, chunk;
  int tile, pitch, box, nbox, stages, stage_bytes;   // a stage: tokens, row bytes, TMA boxes
  int v_off, ks_off, vs_off;                    // inside a stage (K at 0)
  int part_off, pml_off, bar_off, smem;         // after the ring
  int ws_stride;                                // floats of one split's partial
};
constexpr int PLAN_FIELDS = 21;

struct Params {
  const void* q; long long q_sb, q_sh;                // [B, Hq, 1, hd] bf16 or f32
  const float* ks; const float* vs;                   // layer slab [B, Hkv, C]
  const int* kv_lens;                                 // [B]
  void* out; long long o_sb, o_sh;                    // [B, Hq, 1, hd], q's type
  float* ws;                                          // [B, Hkv, splits, ws_stride]
  unsigned* tickets;                                  // [B, Hkv], 0 between calls
  long long layer_row;                                // layer * B * C: the slab's first row
  int Hkv, C, hd;
  float scale2;                                       // sm_scale * log2(e)
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
// one arrival on `bar` once this thread's cp.async copies have landed,
// counted against the barrier's expected arrivals
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
template <int DPL> __device__ __forceinline__ void lds_codes(const unsigned char* p, uint32_t* w) {
  if constexpr (DPL == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (DPL == 24) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const uint2 v = *reinterpret_cast<const uint2*>(p + 8 * i);
      w[2 * i] = v.x; w[2 * i + 1] = v.y;
    }
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  }
}

// the ticket's old value, taken modulo `splits` (the arrival that finds
// splits - 1 leaves 0 behind: each call leaves its tickets as it found
// them); a release of this thread's (and, after a CTA barrier, the CTA's)
// writes and an acquire of those released before it
__device__ __forceinline__ unsigned ticket_take(unsigned* ticket, unsigned splits) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.inc.u32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(ticket), "r"(splits - 1) : "memory");
  return old;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// g of output o = g * hd + d, G <= 4, without a division
__device__ __forceinline__ int head_of(int o, int hd) {
  return (o >= hd) + (o >= 2 * hd) + (o >= 3 * hd);
}

// CTA (split, h, b): 15 consumer warps, one producer warp. F32: q and out
// are f32 and nothing is rounded to bf16 (the header)
template <int G, int DPL, bool F32>
__global__ void __launch_bounds__(THREADS, 1) decode_q8_kernel(
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const Params p, const Plan pl) {
  constexpr int NW = DPL / 4;                  // the words of my DPL codes
  constexpr int QV = F32 ? DPL / 4 : DPL / 8;  // 16-byte loads of my q slice
  constexpr int CH = chunk_of(G, DPL);
  constexpr float VS_UP = 1237940039285380274899124224.f;   // 2^90
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool consumer = warp < CWARPS;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int phase = tid >> pl.log_seg, lane_v = tid & (pl.seg - 1);
  const bool active = consumer && lane_v < pl.vph;          // seg - vph lanes pad
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + pl.bar_off);
  uint64_t* empty = full + MAX_STAGES;

  if (tid == 0) {
    for (int s = 0; s < pl.stages; ++s) {
      mbar_init(&full[s], 33);                 // the producer's lanes + its expect_tx
      mbar_init(&empty[s], CWARPS);
    }
    mbar_fence_init();
  }
  // my DPL dims of the G query heads (QV 16-byte loads each)
  uint4 qw[G][QV];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < QV; ++j) qw[g][j] = make_uint4(0, 0, 0, 0);
    if (active) {
      const long long at = b * p.q_sb + (static_cast<long long>(h) * G + g) * p.q_sh +
                           lane_v * DPL;
      const uint4* qp = F32 ? reinterpret_cast<const uint4*>(static_cast<const float*>(p.q) + at)
                            : reinterpret_cast<const uint4*>(
                                  static_cast<const __nv_bfloat16*>(p.q) + at);
#pragma unroll
      for (int j = 0; j < QV; ++j) qw[g][j] = __ldg(qp + j);
    }
  }
  int kv_len = __ldg(p.kv_lens + b);
  kv_len = kv_len < 0 ? 0 : (kv_len > p.C ? p.C : kv_len);
  const int per = (kv_len + pl.splits - 1) >> pl.log_splits;
  const int start = split * per;
  const int end = min(start + per, kv_len);                // this split's tokens
  __syncthreads();                                          // the barriers are set

  if (!consumer) {
    // the producer: stage k holds tokens start + k * tile .. + tile - 1; K
    // and V by TMA boxes of `box` rows (lane i < nbox issues box i), the
    // scales of the live ones by 4-byte copies, one a lane
    const long long row = p.layer_row + static_cast<long long>(b) * p.C;
    const float* ksb = p.ks + (static_cast<long long>(b) * p.Hkv + h) * p.C;
    const float* vsb = p.vs + (static_cast<long long>(b) * p.Hkv + h) * p.C;
    const uint32_t tx = 2u * pl.nbox * pl.box * pl.pitch;
    int slot = 0;
    uint32_t parity = 0;
    for (int t0 = start, k = 0; t0 < end; t0 += pl.tile, ++k) {
      if (k >= pl.stages) mbar_wait(&empty[slot], parity ^ 1);
      unsigned char* st = smem + slot * pl.stage_bytes;
      if (lane == 0) mbar_expect_tx(&full[slot], tx);
      __syncwarp();
      if (lane < pl.nbox) {
        const int r = static_cast<int>(row + t0 + lane * pl.box);
        tma_load_2d(st + lane * pl.box * pl.pitch, &tk, &full[slot], h * p.hd, r);
        tma_load_2d(st + pl.v_off + lane * pl.box * pl.pitch, &tv, &full[slot], h * p.hd, r);
      }
      for (int t = lane; t < pl.tile && t0 + t < end; t += 32) {
        cp_async4(st + pl.ks_off + 4 * t, ksb + t0 + t);
        cp_async4(st + pl.vs_off + 4 * t, vsb + t0 + t);
      }
      cp_async_arrive(&full[slot]);
      if (++slot == pl.stages) {
        slot = 0;
        parity ^= 1;
      }
    }
  }

  float qs[G][DPL], qneg[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < QV; ++j) {
      const uint32_t w[4] = {qw[g][j].x, qw[g][j].y, qw[g][j].z, qw[g][j].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (F32) {
          qs[g][4 * j + i] = __uint_as_float(w[i]);
        } else {
          qs[g][8 * j + 2 * i] = bf16_lo(w[i]);
          qs[g][8 * j + 2 * i + 1] = bf16_hi(w[i]);
        }
      }
    }
    qneg[g] = 0.f;
  }
  // bf16: q, scaled by 2^(252 - ef) (ef: the exponent field of my largest
  // |q|, kept in [1, 230]) so that its products with the code images stay
  // normal and below overflow; a lane's dot product is then its image sum
  // times 2^(ef - 103), less 128 * sum(q)
  float down = 1.f;
  if constexpr (!F32) {
    float qmax = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        sum += qs[g][i];
        qmax = fmaxf(qmax, fabsf(qs[g][i]));
      }
      qneg[g] = -128.f * sum;
    }
    const int ef = min(max((__float_as_int(qmax) >> 23) & 0xff, 1), 230);
    const int e_up = 252 - ef;
    const float up1 = pow2(e_up >> 1), up2 = pow2(e_up - (e_up >> 1));
    down = pow2(ef - 103);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < DPL; ++i) qs[g][i] = qs[g][i] * up1 * up2;
  }

  // acc holds sum_j pb_j * image_j with pb scaled by 2^90 (psum: sum_j
  // pb_j); F32: sum_j pb_j * code_j
  float m[G], l[G], psum[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
    psum[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  // a phase takes rows phase, phase + phases, ... (CH of them) of a stage
  if (consumer) {
    int slot = 0;
    uint32_t parity = 0;
    for (int t0 = start; t0 < end; t0 += pl.tile) {
      mbar_wait(&full[slot], parity);
      const unsigned char* st = smem + slot * pl.stage_bytes;
      float dot[CH][G], cks[CH], s[CH][G];
      bool live[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int r = phase + c * pl.phases;
        live[c] = t0 + r < end;
        uint32_t kw[NW] = {};
        float ksv = 0.f;
        if (active && live[c]) {
          lds_codes<DPL>(st + r * pl.pitch + lane_v * DPL, kw);
          ksv = *reinterpret_cast<const float*>(st + pl.ks_off + 4 * r);
        }
        float kf[DPL];
        if constexpr (F32) {
#pragma unroll
          for (int i = 0; i < NW; ++i) int8_to_f32(kw[i], kf + 4 * i);
        } else {
          code_images<NW>(kw, kf);
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};        // four independent chains
#pragma unroll
          for (int i = 0; i < DPL; ++i) d[i & 3] = fmaf(qs[g][i], kf[i], d[i & 3]);
          const float sum = (d[0] + d[1]) + (d[2] + d[3]);
          dot[c][g] = F32 ? sum : fmaf(sum, down, qneg[g]);
        }
        cks[c] = p.scale2 * ksv;
      }
      // the segment's lanes meet (pad lanes add zeros); seg is uniform
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        if (off < pl.seg) {
#pragma unroll
          for (int c = 0; c < CH; ++c)
#pragma unroll
            for (int g = 0; g < G; ++g)
              dot[c][g] += __shfl_xor_sync(0xffffffffu, dot[c][g], off);
        }
      }
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int g = 0; g < G; ++g) s[c][g] = live[c] ? dot[c][g] * cks[c] : NEG_INF;

#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = m[g];
#pragma unroll
        for (int c = 0; c < CH; ++c) mx = fmaxf(mx, s[c][g]);
        if (mx > m[g]) {                          // rescale only on a new maximum
          const float alpha = ex2(m[g] - mx);
          m[g] = mx;
          l[g] *= alpha;
          psum[g] *= alpha;
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
        }
      }

#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (!live[c]) continue;
        const int r = phase + c * pl.phases;
        uint32_t vw[NW] = {};
        float vsv = 0.f;
        if (active) {
          lds_codes<DPL>(st + pl.v_off + r * pl.pitch + lane_v * DPL, vw);
          vsv = *reinterpret_cast<const float*>(st + pl.vs_off + 4 * r) * (F32 ? 1.f : VS_UP);
        }
        float vf[DPL];
        if constexpr (F32) {
#pragma unroll
          for (int i = 0; i < NW; ++i) int8_to_f32(vw[i], vf + 4 * i);
        } else {
          code_images<NW>(vw, vf);
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pj = ex2(fmaf(dot[c][g], cks[c], -m[g]));
          l[g] += pj;
          // bf16: bf16(p * vs) * 2^90, exactly; F32: p * vs
          const float pb = F32 ? pj * vsv : bf16_round(pj * vsv);
          psum[g] += pb;
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[g][i] = fmaf(pb, vf[i], acc[g][i]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);   // this warp is done with the stage
      if (++slot == pl.stages) {
        slot = 0;
        parity ^= 1;
      }
    }
  }
  // bf16: back to sum_j bf16(p_j * vs_j) * code_j: acc * 2^59 - 128 * psum * 2^-90
  if constexpr (!F32) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        acc[g][i] = fmaf(acc[g][i], pow2(59), psum[g] * -pow2(-83));
  }

  // The warp's segments merge in a fixed butterfly (partners `off` lanes
  // apart; the lower lane's state is "a" in both, so both get the same
  // bits): after it every segment holds the warp's state.
  for (int off = pl.seg; off < 32 && consumer; off <<= 1) {
    const bool upper = lane & off;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float wa = ex2((upper ? mo : m[g]) - mx), wb = ex2((upper ? m[g] : mo) - mx);
      l[g] = fmaf(wa, upper ? lo : l[g], wb * (upper ? l[g] : lo));
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][i], off);
        acc[g][i] = fmaf(wa, upper ? ao : acc[g][i], wb * (upper ? acc[g][i] : ao));
      }
      m[g] = mx;
    }
  }
  // the warps' states: part [warps][G][hd], pml [warps][G] (m, l)
  float* part = reinterpret_cast<float*>(smem + pl.part_off);
  float* pml = reinterpret_cast<float*>(smem + pl.pml_off);
  const int total = G * p.hd;
  if (consumer && lane < pl.seg && active) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float4* dst = reinterpret_cast<float4*>(part + warp * total + g * p.hd + lane_v * DPL);
#pragma unroll
      for (int i = 0; i < DPL / 4; ++i)
        dst[i] = make_float4(acc[g][4 * i], acc[g][4 * i + 1], acc[g][4 * i + 2],
                             acc[g][4 * i + 3]);
      if (lane == 0) {
        pml[(warp * G + g) * 2] = m[g];
        pml[(warp * G + g) * 2 + 1] = l[g];
      }
    }
  }
  __syncthreads();

  // this split's partial, four outputs a thread (G * hd <= 4 * THREADS):
  // the warps fold in warp order; o [G][hd], then (m, l) [G]
  constexpr int WARPS = CWARPS;
  float* mine = p.ws + ((static_cast<long long>(b) * p.Hkv + h) * pl.splits + split) * pl.ws_stride;
  const int o4 = 4 * tid;
  if (o4 < total) {
    const int g = head_of(o4, p.hd);
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, pml[(w * G + g) * 2]);
    float ls = 0.f;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = ex2(pml[(w * G + g) * 2] - mx);
      ls = fmaf(wt, pml[(w * G + g) * 2 + 1], ls);
      const float4 v = *reinterpret_cast<const float4*>(part + w * total + o4);
      sum = make_float4(fmaf(wt, v.x, sum.x), fmaf(wt, v.y, sum.y), fmaf(wt, v.z, sum.z),
                        fmaf(wt, v.w, sum.w));
    }
    *reinterpret_cast<float4*>(mine + o4) = sum;
    if (o4 == g * p.hd) {
      mine[total + 2 * g] = mx;
      mine[total + 2 * g + 1] = ls;
    }
  }

  // the last split of (b, h) to get here folds the splits, in split order.
  // The barrier orders the CTA's partial before thread 0's ticket, whose
  // release makes it visible to the device and whose acquire, in the last
  // CTA, makes the others' visible to it (their loads go to L2).
  __syncthreads();
  if (tid == 0)
    s_last = ticket_take(p.tickets + static_cast<long long>(b) * p.Hkv + h, pl.splits) ==
             static_cast<unsigned>(pl.splits - 1);
  __syncthreads();
  if (!s_last) return;
  // K threads share four outputs (K a power of two, at most the split
  // count and as many as the threads allow, so at most 4 splits a thread):
  // thread j folds splits j, j + K, ... in order, and the K partial folds
  // meet in a fixed butterfly
  int lk = 0;
  while ((2 << lk) <= pl.splits && (total >> 2) << (lk + 1) <= THREADS) ++lk;
  const int f4 = (tid >> lk) << 2, j = tid & ((1 << lk) - 1);
  const bool mine4 = f4 < total;
  const int g = mine4 ? head_of(f4, p.hd) : 0;
  const float* all = p.ws + (static_cast<long long>(b) * p.Hkv + h) * pl.splits * pl.ws_stride;
  float mr[4], lr[4];
  float4 ov[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {                  // every load at once
    const int r = j + (k << lk);
    mr[k] = NEG_INF;
    lr[k] = 0.f;
    ov[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (mine4 && r < pl.splits) {
      const float* pr = all + r * pl.ws_stride;
      mr[k] = __ldcg(pr + total + 2 * g);
      lr[k] = __ldcg(pr + total + 2 * g + 1);
      ov[k] = __ldcg(reinterpret_cast<const float4*>(pr + f4));
    }
  }
  float mx = fmaxf(fmaxf(mr[0], mr[1]), fmaxf(mr[2], mr[3]));
  for (int off = 1; off < (1 << lk); off <<= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float ls = 0.f;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float wt = ex2(mr[k] - mx);             // 0 for a split not mine
    ls = fmaf(wt, lr[k], ls);
    sum = make_float4(fmaf(wt, ov[k].x, sum.x), fmaf(wt, ov[k].y, sum.y),
                      fmaf(wt, ov[k].z, sum.z), fmaf(wt, ov[k].w, sum.w));
  }
  for (int off = 1; off < (1 << lk); off <<= 1) {
    ls += __shfl_xor_sync(0xffffffffu, ls, off);
    sum.x += __shfl_xor_sync(0xffffffffu, sum.x, off);
    sum.y += __shfl_xor_sync(0xffffffffu, sum.y, off);
    sum.z += __shfl_xor_sync(0xffffffffu, sum.z, off);
    sum.w += __shfl_xor_sync(0xffffffffu, sum.w, off);
  }
  if (mine4 && j == 0) {
    const float inv = ls == 0.f ? 0.f : 1.f / ls;
    const long long at = b * p.o_sb + (static_cast<long long>(h) * G + g) * p.o_sh + f4 - g * p.hd;
    if constexpr (F32) {
      *reinterpret_cast<float4*>(static_cast<float*>(p.out) + at) =
          make_float4(sum.x * inv, sum.y * inv, sum.z * inv, sum.w * inv);
    } else {
      __nv_bfloat162* dst =
          reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + at);
      dst[0] = __floats2bfloat162_rn(sum.x * inv, sum.y * inv);
      dst[1] = __floats2bfloat162_rn(sum.z * inv, sum.w * inv);
    }
  }
}

constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// the layout of a launch for G query heads a kv head of hd dims, DPL dims a
// lane and `chunk` tokens a phase, from the plan's choices: `splits` (a
// power of two), `pitch` bytes a stage row, TMA boxes of `box` rows, and
// `stages` ring slots. A stage holds the K and V tiles (128-byte aligned),
// then the two scale rows; after the ring, the warps' states and the
// barriers. False where the choices do not fit the kernel.
bool layout(Plan& y, int G, int dpl, int chunk, int hd, int splits, int pitch, int box,
            int stages) {
  if (hd % dpl || hd / dpl > 16 || G * hd > THREADS || splits < 1 || splits > MAX_SPLITS ||
      (splits & (splits - 1)) || stages < 2 || stages > MAX_STAGES || pitch < hd ||
      pitch % 16 || pitch > 256 || box < 1 || box > 256 || (box * pitch) % 128)
    return false;
  y.splits = splits;
  y.log_splits = 0;
  while ((1 << y.log_splits) < splits) ++y.log_splits;
  y.vph = hd / dpl;
  y.log_seg = 0;
  while ((1 << y.log_seg) < y.vph) ++y.log_seg;
  y.seg = 1 << y.log_seg;
  y.phases = CONSUMERS >> y.log_seg;
  y.chunk = chunk;
  y.tile = y.phases * chunk;
  if (y.tile % box || y.tile / box > 32) return false;
  y.pitch = pitch;
  y.box = box;
  y.nbox = y.tile / box;
  y.stages = stages;
  const int T = y.tile;
  y.v_off = round_up(T * pitch, 128);
  y.ks_off = y.v_off + round_up(T * pitch, 128);
  y.vs_off = y.ks_off + round_up(4 * T, 16);
  y.stage_bytes = round_up(y.vs_off + 4 * T, 128);
  y.part_off = stages * y.stage_bytes;
  y.pml_off = y.part_off + round_up(4 * CWARPS * G * hd, 16);
  y.bar_off = y.pml_off + round_up(8 * CWARPS * G, 16);
  y.smem = y.bar_off + 16 * MAX_STAGES;
  y.ws_stride = round_up(G * (hd + 2), 4);
  return y.smem <= DYN_SMEM;
}

// K or V of the stacked cache as a 2-D u8 tensor map: rows of Hkv*hd codes,
// L*B*C of them, a box of `pitch` codes (a head's hd and, where the plan
// pads rows, the next head's first ones; zeros past the last) x `box` rows.
// Encoded once per (base, shape) and kept: the decode loop reads the same
// cache every step.
bool cache_map(CUtensorMap* out, const void* base, long long rows, int HD, int pitch,
               int box) {
  struct Entry { const void* base; long long rows; int HD, pitch, box; CUtensorMap map; };
  static std::mutex mu;
  static Entry entries[16];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = entries[i];
    if (e.base == base && e.rows == rows && e.HD == HD && e.pitch == pitch && e.box == box) {
      *out = e.map;
      return true;
    }
  }
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr || use_device_of(base) != cudaSuccess) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(HD), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(HD)};
  const cuuint32_t boxd[2] = {static_cast<cuuint32_t>(pitch), static_cast<cuuint32_t>(box)};
  const cuuint32_t unit[2] = {1, 1};
  Entry& e = entries[next];
  if (fn(&e.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
         boxd, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  e.base = base; e.rows = rows; e.HD = HD; e.pitch = pitch; e.box = box;
  *out = e.map;
  next = (next + 1) % 16;
  used = used < 16 ? used + 1 : 16;
  return true;
}

template <int G, int DPL, bool F32>
int launch(const Params& p, const Plan& pl, const void* k, const void* v, long long rows,
           int B, cudaStream_t st) {
  CUtensorMap tk, tv;
  if (!cache_map(&tk, k, rows, p.Hkv * p.hd, pl.pitch, pl.box) ||
      !cache_map(&tv, v, rows, p.Hkv * p.hd, pl.pitch, pl.box))
    return static_cast<int>(cudaErrorInvalidValue);
  // the attribute, once a device
  static int ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(decode_q8_kernel<G, DPL, F32>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, DYN_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[dev] = 1;
  }
  decode_q8_kernel<G, DPL, F32><<<dim3(pl.splits, p.Hkv, B), THREADS, pl.smem, st>>>(tk, tv, p, pl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4's layout for G query heads a kv head of hd dims and the plan's choices,
// as the entry below computes it: the PLAN_FIELDS ints of `Plan` into `out`.
// Returns 0, or cudaErrorInvalidValue where the choices do not fit.
extern "C" int vgt_decode_q8_layout(int G, int hd, int splits, int pitch, int box, int stages,
                                    int* out) {
  static_assert(sizeof(Plan) == PLAN_FIELDS * sizeof(int), "Plan is PLAN_FIELDS ints");
  Plan pl;
  if (G != 1 && G != 2 && G != 4) return static_cast<int>(cudaErrorInvalidValue);
  const int dpl = dpl_of(G, hd);
  if (!layout(pl, G, dpl, chunk_of(G, dpl), hd, splits, pitch, box, stages))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < PLAN_FIELDS; ++i) out[i] = reinterpret_cast<const int*>(&pl)[i];
  return 0;
}

// Plain C entries (bound with ctypes). Each returns a cudaError_t code, 0 =
// ok. q, out: [B, Hq, 1, hd] bf16 (`vgt_decode_attention_q8`) or f32
// (`vgt_decode_attention_q8_f32`) with batch / head strides in elements
// (head dim contiguous, 16-byte aligned rows). k, v: the stacked [L, B, C,
// Hkv*hd] int8 cache, contiguous; ks, vs: [L, B, Hkv, C] f32; kv_lens: [B]
// int32 on the device. ws: `ws_floats` f32, at least B * Hkv * splits *
// ws_stride, and tickets: `ntickets` int32, at least B * Hkv, zero before
// the first call (each call leaves them zero), used by one stream at a
// time. splits, pitch, box, stages: the choices of `k4_plan`, refused where
// they do not fit the kernel. Supports hd % 16 == 0, hd <= 128, Hkv*hd <=
// 4096 and Hq / Hkv in {1, 2, 4}.
namespace {

template <bool F32>
int entry(const void* q, long long q_sb, long long q_sh, const void* k, const void* v,
          const void* ks, const void* vs, const void* kv_lens, void* out, long long o_sb,
          long long o_sh, void* ws, long long ws_floats, void* tickets, long long ntickets,
          int layer, int L, int B, int Hq, int Hkv, int C, int hd, float sm_scale, int splits,
          int pitch, int box, int stages, void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  const int G = Hkv > 0 ? Hq / Hkv : 0;
  if (hd <= 0 || hd % 16 || hd > 128 || Hkv <= 0 || Hq != G * Hkv ||
      (G != 1 && G != 2 && G != 4) || C <= 0 || L <= 0 || layer < 0 || layer >= L ||
      B > 65535 || Hkv > 65535 || Hkv * hd > 4096 || ws == nullptr || tickets == nullptr ||
      ntickets < static_cast<long long>(B) * Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dpl = dpl_of(G, hd);
  Plan pl;
  if (!layout(pl, G, dpl, chunk_of(G, dpl), hd, splits, pitch, box, stages) ||
      ws_floats < static_cast<long long>(B) * Hkv * splits * pl.ws_stride)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(L) * B * C;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long sslab = static_cast<long long>(B) * Hkv * C;
  Params p;
  p.q = q; p.q_sb = q_sb; p.q_sh = q_sh;
  p.ks = static_cast<const float*>(ks) + layer * sslab;
  p.vs = static_cast<const float*>(vs) + layer * sslab;
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.out = out; p.o_sb = o_sb; p.o_sh = o_sh;
  p.ws = static_cast<float*>(ws);
  p.tickets = static_cast<unsigned*>(tickets);
  p.layer_row = static_cast<long long>(layer) * B * C;
  p.Hkv = Hkv; p.C = C; p.hd = hd;
  p.scale2 = sm_scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 1:
      return dpl == DPL_G1_WIDE ? launch<1, DPL_G1_WIDE, F32>(p, pl, k, v, rows, B, st)
                                : launch<1, DPL_G1, F32>(p, pl, k, v, rows, B, st);
    case 2: return launch<2, DPL_G2, F32>(p, pl, k, v, rows, B, st);
    default: return launch<4, DPL_G4, F32>(p, pl, k, v, rows, B, st);
  }
}

}  // namespace

extern "C" int vgt_decode_attention_q8(
    const void* q, long long q_sb, long long q_sh, const void* k, const void* v,
    const void* ks, const void* vs, const void* kv_lens, void* out, long long o_sb,
    long long o_sh, void* ws, long long ws_floats, void* tickets, long long ntickets,
    int layer, int L, int B, int Hq, int Hkv, int C, int hd, float sm_scale, int splits,
    int pitch, int box, int stages, void* stream) {
  return entry<false>(q, q_sb, q_sh, k, v, ks, vs, kv_lens, out, o_sb, o_sh, ws, ws_floats,
                     tickets, ntickets, layer, L, B, Hq, Hkv, C, hd, sm_scale, splits, pitch,
                     box, stages, stream);
}

extern "C" int vgt_decode_attention_q8_f32(
    const void* q, long long q_sb, long long q_sh, const void* k, const void* v,
    const void* ks, const void* vs, const void* kv_lens, void* out, long long o_sb,
    long long o_sh, void* ws, long long ws_floats, void* tickets, long long ntickets,
    int layer, int L, int B, int Hq, int Hkv, int C, int hd, float sm_scale, int splits,
    int pitch, int box, int stages, void* stream) {
  return entry<true>(q, q_sb, q_sh, k, v, ks, vs, kv_lens, out, o_sb, o_sh, ws, ws_floats,
                    tickets, ntickets, layer, L, B, Hq, Hkv, C, hd, sm_scale, splits, pitch,
                    box, stages, stream);
}
