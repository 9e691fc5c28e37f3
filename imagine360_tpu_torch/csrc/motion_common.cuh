// Helpers of the motion-attention lab kernels (L1-L3): contiguous global runs
// staged into shared-memory rows whose stride is an odd number of 4-byte
// words, and two neighbouring elements of such a row read or written at once
// (one 4-byte access for a bfloat16 pair), which halves the shared-memory
// loads of a dot product over an even head dim.
#pragma once

#include "attn_common.cuh"

namespace i360 {

// 16 bytes from global memory (16-byte aligned) into shared memory (4-byte
// aligned: an odd-word row stride keeps rows off 16-byte boundaries).
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  d[0] = x.x;
  d[1] = x.y;
  d[2] = x.z;
  d[3] = x.w;
}

// Elements p[0], p[1] as floats; a bfloat16 pair must be 4-byte aligned.
__device__ __forceinline__ float2 load2(const float* p) { return make_float2(p[0], p[1]); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  p[0] = x;
  p[1] = y;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// a += x . y over the two elements
__device__ __forceinline__ float dot2(float a, float2 x, float2 y) {
  return fmaf(x.y, y.y, fmaf(x.x, y.x, a));
}

// Whether runs of `run` elements of T that start at multiples of `run`
// elements from these pointers can be copied 16 bytes at a time.
template <typename T>
inline bool runs_are_16_byte(int run, const void* a, const void* b, const void* c) {
  return (run * sizeof(T)) % 16 == 0 &&
         ((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) % 16 == 0;
}

// Whether two neighbouring elements of a head's row can go as one access: an
// even head dim (every row of every tensor then starts on an even element)
// and, for the 4-byte bfloat16 pair, tensors that start on a 4-byte boundary.
template <typename T>
inline bool pairs_are_aligned(int D, const void* a, const void* b, const void* c,
                              const void* d) {
  return D % 2 == 0 &&
         ((uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d) % 4 == 0;
}

}  // namespace i360
