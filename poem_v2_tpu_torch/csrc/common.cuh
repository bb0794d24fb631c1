// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel takes its floating tensors either as float32 or as
// bfloat16 (the serving dtype). Arithmetic is always float32; values that
// the JAX package casts to the compute dtype before a matrix product are
// rounded through `round_to<T>` so the kernel and the plain PyTorch
// version round at the same places.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace poem {

enum { DTYPE_F32 = 0, DTYPE_BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
// round to nearest even, as torch's float -> bfloat16 cast
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// |v|^2 and the squared distance (|q|^2 + |p|^2) - 2 q.p, one rounded float32
// operation at a time in a fixed order (no fused multiply-add), as
// ops/knn_attn.py:square_distance_rn forms them: a selection kernel and its
// plain version then see the same bits and pick the same neighbours.
__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}
// ... with |p|^2 given (pp = sq3(px, py, pz), formed once a point)
__device__ __forceinline__ float d2_rn_pp(float qx, float qy, float qz, float qq, float px,
                                          float py, float pz, float pp) {
  const float cross =
      __fadd_rn(__fadd_rn(__fmul_rn(qx, px), __fmul_rn(qy, py)), __fmul_rn(qz, pz));
  return __fsub_rn(__fadd_rn(qq, pp), __fmul_rn(2.0f, cross));
}
__device__ __forceinline__ float d2_rn(float qx, float qy, float qz, float qq, float px, float py,
                                       float pz) {
  return d2_rn_pp(qx, qy, qz, qq, px, py, pz, sq3(px, py, pz));
}

// float32 bits <-> unsigned values in the same order (negative values included)
__device__ __forceinline__ uint32_t float_to_ordered(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float ordered_to_float(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

// Raise the dynamic shared-memory limit of `kernel` when it needs more
// than the default 48 KB. Returns the CUDA error code.
template <typename K> inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace poem
