// K1 and K6 in full f32: the attention forward and its backward for a model
// whose compute dtype is f32 (the route "simt_f32" of ops/attention.py).
//
// Replaces, for f32 operands, the Pallas kernels that K1 and K6 replace in
// bf16: `_flash_kernel` (videoglamm_tpu/ops/attention.py:93), `_bshd_kernel`
// (:738), the window attention inside the fused block's body
// (videoglamm_tpu/ops/fused_block.py:108), and the flash backward
// `_flash_bwd_dq_kernel` (:302) and `_flash_bwd_dkv_kernel` (:336). On the
// TPU those kernels read f32 operands themselves; K1's "wgmma_f32" route
// rounds q, k and v to bf16 first, which is no f32 control. Here every
// product is an f32 FFMA with f32 accumulation on the CUDA cores: no TF32,
// no bf16.
//
// Bound: operations. f32 outside the tensor cores peaks at 67 TFLOP/s, and
// an attention tile does 2 * D FFMA per logit against 4 * D bytes per row
// of q, k and v, so the bytes are never the limit at these shapes.
//
// Design (a simple kernel first; making it fast is later work):
//   - a CTA of 256 threads as a 16 x 16 grid (ty, tx) owns a tile of 64
//     rows; thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j
//     (i, j < 4) of every 64 x 64 product, and columns tx + 16 c of every
//     64 x DP one, so a row's 16 owners are one half-warp: the row maximum
//     and sum of the online softmax reduce with four shuffles;
//   - operand tiles sit in shared memory row-major with an odd pitch
//     (DP + 1, 65): the 16 rows that a half-warp reads at one depth fall in
//     16 banks, and the two rows of a warp's two ty in two;
//   - forward: Q's tile stays, K and V tiles of 64 keys stream through; the
//     online softmax runs in log2 units; a query row with no valid key
//     writes 0 and LSE -1e30, as K1 does (attention.py:170-180);
//   - backward: a prepass takes delta = rowsum(dO * O); the dq kernel walks
//     key tiles for a tile of queries, the dk/dv kernel query tiles for a
//     tile of keys, each recomputing P from the LSE (K6's structure).
// Masks as K1: key < kv_len, and key <= q_start + row when causal, and
// key / win == row / win with a window; keys at or past kv_len are loaded
// as zeros. Operands are [B,H,S,D] views with element strides (the head
// dim contiguous, 16-byte aligned rows: D % 8 == 0), so BSHD and fused-qkv
// views go in with no copy.
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;              // rows a CTA owns, rows a streamed tile
constexpr int R = TILE / 16;          // rows (and 64-wide columns) a thread
constexpr int PP = TILE + 1;          // pitch of a 64 x 64 tile in shared memory
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

inline int sm_count() {
  int dev = 0, n = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

inline cudaError_t use_device_of(const void* p) {
  cudaPointerAttributes a;
  const cudaError_t e = cudaPointerGetAttributes(&a, p);
  return e != cudaSuccess ? e : cudaSetDevice(a.device);
}

// rows [0, rows) of a [TILE][DP] tile from `g` (rows `ss` floats apart,
// columns [0, D) real) into shared memory at pitch DP + 1; the rest zero
template <int DP>
__device__ __forceinline__ void load_rows(float* s, const float* g, long long ss,
                                          int rows, int D) {
  constexpr int P = DP + 1, V = DP / 4;
  for (int idx = threadIdx.x; idx < TILE * V; idx += THREADS) {
    const int r = idx / V, c = (idx % V) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && c < D) x = *reinterpret_cast<const float4*>(g + r * ss + c);
    float* d = s + r * P + c;
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  }
}

// acc[i][j] += sum_d A[ty + 16 i][d] * B[tx + 16 j][d]  (A, B at pitch DP + 1)
template <int DP>
__device__ __forceinline__ void prod_nt(float (&acc)[R][R], const float* A,
                                        const float* B, int ty, int tx) {
  constexpr int P = DP + 1;
#pragma unroll 4
  for (int d = 0; d < DP; ++d) {
    float a[R], b[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = A[(ty + 16 * i) * P + d];
#pragma unroll
    for (int j = 0; j < R; ++j) b[j] = B[(tx + 16 * j) * P + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][c] += sum_j A[ty + 16 i][j] * B[j][tx + 16 c]  (A: 64 x 64 at pitch
// PP; B: 64 x DP at pitch DP + 1)
template <int DP>
__device__ __forceinline__ void prod_nn(float (&acc)[R][DP / 16], const float* A,
                                        const float* B, int ty, int tx) {
  constexpr int P = DP + 1, NC = DP / 16;
#pragma unroll 2
  for (int j = 0; j < TILE; ++j) {
    float a[R], b[NC];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = A[(ty + 16 * i) * PP + j];
#pragma unroll
    for (int c = 0; c < NC; ++c) b[c] = B[j * P + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
  }
}

// reduce over the 16 lanes of a half-warp (the owners of one row)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

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
};

__device__ __forceinline__ bool attendable(const Params& p, int row, int key,
                                           int kv_len, int q_off) {
  return key < kv_len && (!p.causal || key <= q_off + row) &&
         (p.win == 0 || key / p.win == row / p.win);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(THREADS)
attn_fwd_f32(const Params p) {
  extern __shared__ float smem[];
  constexpr int P = DP + 1, NC = DP / 16;
  float* sQ = smem;
  float* sK = sQ + TILE * P;
  float* sV = sK + TILE * P;
  float* sP = sV + TILE * P;

  const int BH = p.B * p.H;
  const int nmt = (p.Sq + TILE - 1) / TILE;
  const int mt = nmt - 1 - static_cast<int>(blockIdx.x / BH);   // longest first
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int h = bh % p.H, b = bh / p.H;
  const int m0 = mt * TILE;
  const int kv_len = p.kv_lens ? min(p.kv_lens[b], p.Sk) : p.Sk;
  const int q_off = p.q_start ? p.q_start[b] : 0;
  const int last_row = min(m0 + TILE, p.Sq) - 1;
  int k_lo = 0, k_hi = kv_len;
  if (p.causal) k_hi = min(k_hi, q_off + last_row + 1);
  if (p.win > 0) {
    k_lo = (m0 / p.win) * p.win;
    k_hi = min(k_hi, (last_row / p.win + 1) * p.win);
  }
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_rows<DP>(sQ, p.q + b * p.q_sb + h * p.q_sh + m0 * p.q_ss, p.q_ss,
                p.Sq - m0, p.D);
  float o[R][NC], m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c] = 0.f;
  }

  for (int k0 = (k_lo / TILE) * TILE; k0 < k_hi; k0 += TILE) {
    __syncthreads();   // the last tile's reads of sK, sV and sP are done
    load_rows<DP>(sK, p.k + b * p.k_sb + h * p.k_sh + k0 * p.k_ss, p.k_ss,
                  kv_len - k0, p.D);
    load_rows<DP>(sV, p.v + b * p.v_sb + h * p.v_sh + k0 * p.v_ss, p.v_ss,
                  kv_len - k0, p.D);
    __syncthreads();
    float s[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = 0.f;
    prod_nt<DP>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = m0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int key = k0 + tx + 16 * j;
        s[i][j] = attendable(p, row, key, kv_len, q_off) ? s[i][j] * p.scale_log2
                                                         : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float e = exp2f(s[i][j] - m_use);
        sP[(ty + 16 * i) * PP + tx + 16 * j] = e;
        sum += e;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[i][c] *= alpha;
    }
    __syncwarp();      // a row of sP is written and read by one half-warp
    prod_nn<DP>(o, sP, sV, ty, tx);
  }

  float* ob = p.out + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= p.Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < p.D) ob[row * p.o_ss + col] = o[i][c] * inv;
    }
    if (p.lse != nullptr && tx == 0)
      p.lse[static_cast<long long>(bh) * p.Sq + row] =
          l[i] > 0.f ? m[i] * LN2 + logf(l[i]) : -1e30f;
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
// delta[b,h,row] = sum_d dO * O, one warp a row
__global__ void __launch_bounds__(THREADS) delta_f32(const Params p) {
  const long long rows = static_cast<long long>(p.B) * p.H * p.Sq;
  const int lane = threadIdx.x & 31;
  for (long long r = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) / 32;
       r < rows; r += static_cast<long long>(gridDim.x) * (THREADS / 32)) {
    const int row = static_cast<int>(r % p.Sq);
    const int bh = static_cast<int>(r / p.Sq);
    const int h = bh % p.H, b = bh / p.H;
    const float* o = p.o + b * p.o_sb + h * p.o_sh + row * p.o_ss;
    const float* g = p.dout + b * p.g_sb + h * p.g_sh + row * p.g_ss;
    float acc = 0.f;
    for (int d = lane; d < p.D; d += 32) acc = fmaf(o[d], g[d], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) p.delta[r] = acc;
  }
}

// dq for a tile of 64 queries over the key tiles it attends (one CTA an SM:
// its shared memory takes more than half the SM's; the registers it may
// then use keep ptxas from spilling at head dim 80)
template <int DP>
__global__ void __launch_bounds__(THREADS, 1) attn_dq_f32(const Params p) {
  extern __shared__ float smem[];
  constexpr int P = DP + 1, NC = DP / 16;
  float* sQ = smem;
  float* sG = sQ + TILE * P;
  float* sK = sG + TILE * P;
  float* sV = sK + TILE * P;
  float* sS = sV + TILE * P;

  const int BH = p.B * p.H;
  const int nmt = (p.Sq + TILE - 1) / TILE;
  const int mt = nmt - 1 - static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int h = bh % p.H, b = bh / p.H;
  const int m0 = mt * TILE;
  const int kv_len = p.kv_lens ? min(p.kv_lens[b], p.Sk) : p.Sk;
  const int q_off = p.q_start ? p.q_start[b] : 0;
  const int last_row = min(m0 + TILE, p.Sq) - 1;
  int k_hi = kv_len;
  if (p.causal) k_hi = min(k_hi, q_off + last_row + 1);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_rows<DP>(sQ, p.q + b * p.q_sb + h * p.q_sh + m0 * p.q_ss, p.q_ss,
                p.Sq - m0, p.D);
  load_rows<DP>(sG, p.dout + b * p.g_sb + h * p.g_sh + m0 * p.g_ss, p.g_ss,
                p.Sq - m0, p.D);
  float lse2[R], dlt[R], dq[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = m0 + ty + 16 * i;
    const long long at = static_cast<long long>(bh) * p.Sq + row;
    lse2[i] = row < p.Sq ? p.lse[at] * LOG2E : 0.f;
    dlt[i] = row < p.Sq ? p.delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < k_hi; k0 += TILE) {
    __syncthreads();
    load_rows<DP>(sK, p.k + b * p.k_sb + h * p.k_sh + k0 * p.k_ss, p.k_ss,
                  kv_len - k0, p.D);
    load_rows<DP>(sV, p.v + b * p.v_sb + h * p.v_sh + k0 * p.v_ss, p.v_ss,
                  kv_len - k0, p.D);
    __syncthreads();
    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
    prod_nt<DP>(s, sQ, sK, ty, tx);
    prod_nt<DP>(dp, sG, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = m0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int key = k0 + tx + 16 * j;
        const float pr = attendable(p, row, key, kv_len, q_off)
                             ? exp2f(s[i][j] * p.scale_log2 - lse2[i]) : 0.f;
        sS[(ty + 16 * i) * PP + tx + 16 * j] = pr * (dp[i][j] - dlt[i]) * p.scale;
      }
    }
    __syncwarp();
    prod_nn<DP>(dq, sS, sK, ty, tx);
  }

  float* qb = p.dq + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < p.D) qb[row * p.dq_ss + col] = dq[i][c];
    }
  }
}

// dk and dv for a tile of 64 keys over the query tiles that attend it
template <int DP>
__global__ void __launch_bounds__(THREADS, 1) attn_dkv_f32(const Params p) {
  extern __shared__ float smem[];
  constexpr int P = DP + 1, NC = DP / 16;
  float* sK = smem;
  float* sV = sK + TILE * P;
  float* sQ = sV + TILE * P;
  float* sG = sQ + TILE * P;
  float* sP = sG + TILE * P;
  float* sS = sP + TILE * PP;
  float* sL = sS + TILE * PP;        // lse * log2(e) of the query tile
  float* sD = sL + TILE;             // delta of the query tile

  const int BH = p.B * p.H;
  const int kt = static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int h = bh % p.H, b = bh / p.H;
  const int k0 = kt * TILE;
  const int kv_len = p.kv_lens ? min(p.kv_lens[b], p.Sk) : p.Sk;
  const int q_off = p.q_start ? p.q_start[b] : 0;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  // the first query that can see a key of the tile
  int q_lo = 0;
  if (p.causal) q_lo = max(0, k0 - q_off);
  const int q_end = k0 < kv_len ? p.Sq : 0;

  load_rows<DP>(sK, p.k + b * p.k_sb + h * p.k_sh + k0 * p.k_ss, p.k_ss,
                kv_len - k0, p.D);
  load_rows<DP>(sV, p.v + b * p.v_sb + h * p.v_sh + k0 * p.v_ss, p.v_ss,
                kv_len - k0, p.D);
  float dk[R][NC], dv[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int q0 = (q_lo / TILE) * TILE; q0 < q_end; q0 += TILE) {
    __syncthreads();
    load_rows<DP>(sQ, p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_ss, p.q_ss,
                  p.Sq - q0, p.D);
    load_rows<DP>(sG, p.dout + b * p.g_sb + h * p.g_sh + q0 * p.g_ss, p.g_ss,
                  p.Sq - q0, p.D);
    if (threadIdx.x < TILE) {
      const int row = q0 + threadIdx.x;
      const long long at = static_cast<long long>(bh) * p.Sq + row;
      sL[threadIdx.x] = row < p.Sq ? p.lse[at] * LOG2E : 0.f;
      sD[threadIdx.x] = row < p.Sq ? p.delta[at] : 0.f;
    }
    __syncthreads();
    // transposed scores: rows are keys, columns queries
    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
    prod_nt<DP>(s, sK, sQ, ty, tx);
    prod_nt<DP>(dp, sV, sG, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int key = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int q = tx + 16 * j, row = q0 + q;
        const float pr = row < p.Sq && attendable(p, row, key, kv_len, q_off)
                             ? exp2f(s[i][j] * p.scale_log2 - sL[q]) : 0.f;
        sP[(ty + 16 * i) * PP + q] = pr;
        sS[(ty + 16 * i) * PP + q] = pr * (dp[i][j] - sD[q]) * p.scale;
      }
    }
    __syncwarp();
    prod_nn<DP>(dv, sP, sG, ty, tx);
    prod_nn<DP>(dk, sS, sQ, ty, tx);
  }

  float* kb = p.dk + b * p.dk_sb + h * p.dk_sh;
  float* vb = p.dv + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= p.Sk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < p.D) {
        kb[key * p.dk_ss + col] = dk[i][c];
        vb[key * p.dv_ss + col] = dv[i][c];
      }
    }
  }
}

template <int DP>
constexpr int fwd_smem() { return (3 * TILE * (DP + 1) + TILE * PP) * 4; }
template <int DP>
constexpr int dq_smem() { return (4 * TILE * (DP + 1) + TILE * PP) * 4; }
template <int DP>
constexpr int dkv_smem() { return (4 * TILE * (DP + 1) + 2 * TILE * PP + 2 * TILE) * 4; }

template <typename K>
cudaError_t launch_with(K kernel, int smem, long long blocks, const Params& p,
                        cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t forward(const Params& p, cudaStream_t s) {
  const long long blocks = static_cast<long long>((p.Sq + TILE - 1) / TILE) * p.B * p.H;
  return launch_with(attn_fwd_f32<DP>, fwd_smem<DP>(), blocks, p, s);
}

template <int DP>
cudaError_t backward(const Params& p, cudaStream_t s) {
  const long long rows = static_cast<long long>(p.B) * p.H * p.Sq;
  const long long want = (rows + THREADS / 32 - 1) / (THREADS / 32);
  const long long dblocks = want < 8LL * sm_count() ? want : 8LL * sm_count();
  delta_f32<<<static_cast<unsigned>(dblocks), THREADS, 0, s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long qblocks = static_cast<long long>((p.Sq + TILE - 1) / TILE) * p.B * p.H;
  e = launch_with(attn_dq_f32<DP>, dq_smem<DP>(), qblocks, p, s);
  if (e != cudaSuccess) return e;
  const long long kblocks = static_cast<long long>((p.Sk + TILE - 1) / TILE) * p.B * p.H;
  return launch_with(attn_dkv_f32<DP>, dkv_smem<DP>(), kblocks, p, s);
}

}  // namespace

// Padded head dims: 32, 64, 80, 96, 128 and (forward only) 256, as K1 and K6.
extern "C" int vgt_attention_fwd_f32(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    const void* kv_lens, const void* q_start,
    int B, int H, int Sq, int Sk, int D, int causal, int win,
    float sm_scale, void* lse, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (D <= 0 || D % 8 || D > 256) return cudaErrorInvalidValue;
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

// ptrs: q, k, v, out, dout, dq, dk, dv; strides: (batch, head, token) of each
// in that order; lse: [B,H,Sq] as the forward wrote it; delta: [B,H,Sq]
// scratch. The signature of vgt_flash_bwd (csrc/flash_bwd.cu).
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
