// Shared helpers of the COOT Hopper kernels: bf16/f32 conversion, the
// activations, warp reductions and the finite masked-fill constant.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace coot {

using bf16 = __nv_bfloat16;

// typext.INF: masked logits are filled with -32752, a FINITE value, so a
// row whose positions are all masked softmaxes to the uniform average
// instead of 0/0.
constexpr float kMaskFill = -32752.0f;

enum Act : int { kActNone = 0, kActGelu = 1, kActRelu = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
// round to nearest even, as jnp.astype(bfloat16) and torch .to(bfloat16)
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// exact-erf gelu (torch's default, not the tanh approximation)
__device__ __forceinline__ float activate(float x, int act) {
  if (act == kActGelu) return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
  if (act == kActRelu) return fmaxf(x, 0.0f);
  return x;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace coot
