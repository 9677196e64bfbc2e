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
// element over 3.35 TB/s. At the activations' sizes (~26 M elements) a call
// takes tens of microseconds, so the host's time per call matters as much:
// the wrapper (ops/dropout.py) keeps the backward's launch to one ctypes
// call with arguments the forward computed.
//
// Design: each thread of a grid-stride loop takes one 16-byte vector (8
// bf16 or 4 f32 elements, two or one Philox calls) with one load and one
// store. When x and y share their offset modulo 16 bytes, the elements
// before the first aligned vector (the head) and after the last one (the
// tail) are done one Philox group at a time; when they do not, every
// element goes that way. Bits depend only on (seed, site, element), never
// on the grid or the alignment (csrc/philox.cuh), so every path gives the
// same mask.

#include <algorithm>

#include "common.cuh"
#include "philox.cuh"

namespace coot {
namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float keep_factor(const DropParams& d,
                                             uint32_t bits) {
  return bits >= d.thresh ? d.scale : 0.0f;
}

// Elements [lo, hi) one Philox group (4 elements) per thread.
template <typename T>
__device__ __forceinline__ void dropout_scalar(const T* __restrict__ x,
                                               T* __restrict__ y, int64_t lo,
                                               int64_t hi,
                                               const DropParams& d,
                                               uint32_t site) {
  if (lo >= hi) return;
  const int64_t g0 = lo >> 2, groups = ((hi - 1) >> 2) - g0 + 1;
  for (int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x; i < groups;
       i += (int64_t)gridDim.x * kThreads) {
    const Philox4 bits = dropout_group(d.seed, site, (uint64_t)(g0 + i));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t e = (g0 + i) * 4 + j;
      if (e >= lo && e < hi)
        y[e] = from_f32<T>(to_f32(x[e]) * keep_factor(d, bits.x[j]));
    }
  }
}

union Vec16 {
  uint4 raw;
  float f[4];
  uint32_t u[4];  // bf16 pairs, the lower element in the low half
};

// The kVec elements of one vector starting at element e0.
__device__ __forceinline__ void apply(Vec16& v, float, int64_t e0,
                                      const DropParams& d, uint32_t site) {
  if ((e0 & 3) == 0) {
    const Philox4 bits = dropout_group(d.seed, site, (uint64_t)e0 >> 2);
#pragma unroll
    for (int j = 0; j < 4; ++j) v.f[j] *= keep_factor(d, bits.x[j]);
    return;
  }
  const Philox4 lo = dropout_group(d.seed, site, (uint64_t)e0 >> 2);
  const Philox4 hi = dropout_group(d.seed, site, ((uint64_t)e0 >> 2) + 1);
  const int s = (int)(e0 & 3);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v.f[j] *= keep_factor(d, s + j < 4 ? lo.x[s + j] : hi.x[s + j - 4]);
}

__device__ __forceinline__ void apply(Vec16& v, bf16, int64_t e0,
                                      const DropParams& d, uint32_t site) {
  float f[8];  // bf16 -> f32 is exact: the bits shifted up
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(v.u[j] << 16);
    f[2 * j + 1] = __uint_as_float(v.u[j] & 0xffff0000u);
  }
  const int s = (int)(e0 & 3);
  const uint64_t g0 = (uint64_t)e0 >> 2;
  if (s == 0) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const Philox4 bits = dropout_group(d.seed, site, g0 + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) f[4 * k + j] *= keep_factor(d, bits.x[j]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const Philox4 bits = dropout_group(d.seed, site, g0 + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int idx = 4 * k + j - s;
        if (idx >= 0 && idx < 8) f[idx] *= keep_factor(d, bits.x[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    v.u[j] = *reinterpret_cast<const uint32_t*>(&p);
  }
}

// head elements one group at a time, `vecs` 16-byte vectors, then the tail
template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n,
               int64_t head, int64_t vecs, DropParams d, uint32_t site) {
  constexpr int kVec = 16 / sizeof(T);
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  uint4* yv = reinterpret_cast<uint4*>(y + head);
  for (int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x; i < vecs;
       i += (int64_t)gridDim.x * kThreads) {
    Vec16 v;
    v.raw = xv[i];
    apply(v, T(), head + i * kVec, d, site);
    yv[i] = v.raw;
  }
  dropout_scalar(x, y, 0, head, d, site);
  dropout_scalar(x, y, head + vecs * kVec, n, d, site);
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
  const long long size = is_bf16 ? 2 : 4, vec = 16 / size;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ya = reinterpret_cast<uintptr_t>(y);
  long long head = n, vecs = 0;
  if (xa % 16 == ya % 16 && xa % size == 0) {
    head = std::min<long long>(n, (long long)((16 - xa % 16) % 16) / size);
    vecs = (n - head) / vec;
  }
  const long long work = std::max<long long>(vecs, (head + 3) / 4 + 2);
  const int blocks = (int)std::min<long long>(
      (work + kThreads - 1) / kThreads, 132LL * 32);
  DropParams d{seed, thresh, scale};
  if (is_bf16) {
    dropout_kernel<bf16><<<blocks, kThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<bf16*>(y), n, head, vecs, d,
        site);
  } else {
    dropout_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, head, vecs,
        d, site);
  }
  return static_cast<int>(cudaGetLastError());
}
