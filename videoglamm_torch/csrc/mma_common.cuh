// Device helpers shared by the attention kernels that run on mma.sync
// m16n8k16 bf16 tiles (attention_fwd.cu, window_attention.cu,
// smallwin_attention.cu): the tensor-core step, bf16 packing, and the load /
// store of a bf16 or f32 storage type to and from bf16 shared-memory form.
// Included inside each source's anonymous namespace.
#pragma once

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Storage type T -> eight bf16 values in shared-memory form, and back.
template <typename T> struct Io;
template <> struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};
template <> struct Io<float> {
  static __device__ __forceinline__ uint4 load8(const float* p) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                      pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};
