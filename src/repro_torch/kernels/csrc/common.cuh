// common.cuh — element I/O shared by the port's CUDA kernels.
//
// Kernels compute in f32 whatever the storage type.  Global memory is read and
// written in 16-byte vectors (8 bf16 or 4 f32 elements); a bf16 widens to f32
// by a 16-bit shift and narrows with round-to-nearest-even, as PyTorch does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// dtype codes passed by the Python wrappers
enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int N = 4;  // elements per 16-byte vector
  static __device__ __forceinline__ void unpack(uint4 r, float* o) {
    o[0] = __uint_as_float(r.x);
    o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z);
    o[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
  static __device__ __forceinline__ float cvt(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack2(uint32_t w, float* o) {
    o[0] = __uint_as_float(w << 16);          // element 0: low half
    o[1] = __uint_as_float(w & 0xffff0000u);  // element 1: high half
  }
  static __device__ __forceinline__ void unpack(uint4 r, float* o) {
    unpack2(r.x, o);
    unpack2(r.y, o + 2);
    unpack2(r.z, o + 4);
    unpack2(r.w, o + 6);
  }
  static __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                      pack2(v[4], v[5]), pack2(v[6], v[7]));
  }
  static __device__ __forceinline__ __nv_bfloat16 cvt(float v) {
    return __float2bfloat16_rn(v);
  }
};

// One 16-byte vector at p widened to f32, or zeros when !ok (p is then never
// dereferenced, so it may point past the tensor).
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, bool ok, float* out) {
  if (ok) {
    Io<T>::unpack(__ldg(reinterpret_cast<const uint4*>(p)), out);
  } else {
#pragma unroll
    for (int i = 0; i < Io<T>::N; ++i) out[i] = 0.f;
  }
}

// 8 consecutive f32 values narrowed to T and stored at p (8-element aligned).
template <typename T>
__device__ __forceinline__ void store8(T* p, const float* v) {
#pragma unroll
  for (int h = 0; h < 8; h += Io<T>::N)
    *reinterpret_cast<uint4*>(p + h) = Io<T>::pack(v + h);
}

// N consecutive f32 values from shared memory, in the widest aligned loads.
template <int N>
__device__ __forceinline__ void lds(const float* p, float* o) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      float4 v = *reinterpret_cast<const float4*>(p + i);
      o[i] = v.x;
      o[i + 1] = v.y;
      o[i + 2] = v.z;
      o[i + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x;
    o[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = p[i];
  }
}

}  // namespace rt

// The most dynamic shared memory a kernel of a launcher's last call asked
// for: the launcher sets it to 0 on entry and notes each request.  Read back
// through <name>_requested_smem, which the card tests hold each wrapper's
// smem_bytes to (the figure narrowing's resource pre-check uses).
namespace rt {
inline int& smem_requested() {
  static int bytes = 0;
  return bytes;
}
inline void note_smem(int bytes) {
  if (bytes > smem_requested()) smem_requested() = bytes;
}
}  // namespace rt

#define RT_REQUESTED_SMEM(name) \
  extern "C" int name##_requested_smem() { return rt::smem_requested(); }

// Every launcher library exports its CUDA error strings for the wrapper.
#define RT_ERROR_STRING(name)                                         \
  extern "C" const char* name##_error_string(int e) {                 \
    return cudaGetErrorString(static_cast<cudaError_t>(e));           \
  }
