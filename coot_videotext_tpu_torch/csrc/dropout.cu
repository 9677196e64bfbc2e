// B4: dropout y = x * keep / (1 - rate), keep iff Philox bits >=
// floor(rate * 2^32); the backward applies the same mask to the cotangent,
// regenerated from (seed, site), so no mask is stored.
//
// Replaces the TPU kernel coot_videotext_tpu/ops/pallas_dropout.py::
// hw_dropout (_mask_scale_kernel :68, used by its forward and backward).
//
// What bounds it on the H100: one read and one write of each element and
// ~40 integer operations per 4 elements (one Philox4x32-10 call gives the
// bits of 4 elements), so it is bound by the bytes: 4 bytes per bf16
// element over 3.35 TB/s.
//
// Design: a grid-stride loop in which each thread takes one group of 4
// consecutive elements, draws one Philox call for the group and writes the
// 4 results. Bits depend only on (seed, site, element), never on the grid
// (csrc/philox.cuh).

#include <algorithm>

#include "common.cuh"
#include "philox.cuh"

namespace coot {
namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n,
               DropParams d, uint32_t site) {
  const int64_t groups = (n + 3) >> 2;
  for (int64_t g = blockIdx.x * (int64_t)kThreads + threadIdx.x; g < groups;
       g += (int64_t)gridDim.x * kThreads) {
    const Philox4 bits = dropout_group(d.seed, site, (uint64_t)g);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t e = g * 4 + j;
      if (e < n) {
        const float f = bits.x[j] >= d.thresh ? d.scale : 0.0f;
        y[e] = from_f32<T>(to_f32(x[e]) * f);
      }
    }
  }
}

}  // namespace
}  // namespace coot

// x, y: n elements of the compute dtype (distinct buffers); seed 64-bit,
// thresh = floor(rate * 2^32) > 0, scale = 1 / (1 - rate).
extern "C" int coot_dropout(const void* x, void* y, long long n,
                            unsigned long long seed, unsigned int thresh,
                            float scale, unsigned int site, int is_bf16,
                            void* stream) {
  using namespace coot;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long groups = (n + 3) / 4;
  const int blocks = (int)std::min<long long>((groups + kThreads - 1) /
                                                  kThreads, 132LL * 16);
  DropParams d{seed, thresh, scale};
  if (is_bf16) {
    dropout_kernel<bf16><<<blocks, kThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<bf16*>(y), n, d, site);
  } else {
    dropout_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, d, site);
  }
  return static_cast<int>(cudaGetLastError());
}
