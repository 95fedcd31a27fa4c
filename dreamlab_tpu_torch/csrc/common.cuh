// Shared helpers of the port's hand-written kernels: element conversion,
// 16-byte vector access for fp32 and bf16 tensors, and the flash kernels'
// constants.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed from Python (dreamlab_tpu_torch/ops/_build.py::DTYPES)
enum DlDtype : int { kFloat32 = 0, kBFloat16 = 1 };

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // finite mask value, as in the Pallas kernel
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float dl_to_float(float x) { return x; }
__device__ __forceinline__ float dl_to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void dl_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void dl_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Elements per 16-byte vector: 4 fp32 or 8 bf16.
template <typename T>
struct DlVec {
  static constexpr int kN = 16 / sizeof(T);
};

// Load one 16-byte vector (p must be 16-byte aligned) as fp32 values.
__device__ __forceinline__ void dl_load_vec(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void dl_load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Store fp32 values as one 16-byte vector of T (p must be 16-byte aligned).
__device__ __forceinline__ void dl_store_vec(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
__device__ __forceinline__ void dl_store_vec(__nv_bfloat16* p, const float* in) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(p) = v;
}
