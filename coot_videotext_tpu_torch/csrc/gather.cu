// B5: row gather out[i] = table[idx[i]] from the device-resident feature
// store, with an optional fused truncated-normal noise epilogue
// out = (table[idx[i]] + std * tn).to(dtype).
//
// Replaces the TPU kernel coot_videotext_tpu/ops/pallas_gather.py::
// pallas_gather_rows (:64; body _gather_kernel :35), which copies rows by
// DMA with the indices prefetched as scalars and needs D divisible by 2048
// in bf16. Here any row whose size is a multiple of 16 bytes is taken (the
// text store has D = 1536).
//
// What bounds it on the H100: bytes. Each gathered row is read once and
// written once, 2 * N * D * itemsize over 3.35 TB/s; the noise adds one
// Philox4x32-10 call per 4 elements and one erfinv per element, which stay
// under the bytes' time.
//
// Design (simple first): one warp per row, 8 rows per 256-thread block. The
// block loads its own 8 indices; an index outside [0, T) traps, so the
// fault surfaces at the next synchronisation and nothing is clamped. Each
// lane moves 16-byte vectors, 4 loads in flight before their stores. Row
// and element offsets are 64-bit: a real YouCook2 video store holds ~540k
// rows x 4096, more than 2^31 elements.
//
// Noise: output element e (row-major over (N, D)) takes the Philox bits of
// (seed, site, e), as dropout does (csrc/philox.cuh); u = (bits >> 8) *
// 2^-24, v = u * span + lo with lo = -erf(sqrt 2), span = 2 erf(sqrt 2), and
// tn = sqrt(2) * erfinv(v) clamped to [-2, 2]: a standard normal truncated
// at +-2, as jax.random.truncated_normal draws it. Every product and sum is
// rounded on its own (no FMA contraction), so ops/philox.py reproduces it
// with PyTorch's separate float32 ops.

#include <stdint.h>

#include "common.cuh"
#include "philox.cuh"

namespace coot {
namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr int kInFlight = 4;

struct NoiseParams {
  const uint64_t* state;  // the step's seed state (device memory)
  uint32_t call;          // the call's position in the step
  uint64_t seed;          // derive_seed(*state, call), on the device
  uint32_t site;
  float std;
  float lo;
  float span;
};

__device__ __forceinline__ float truncnorm(uint32_t bits,
                                           const NoiseParams& p) {
  const float u = __fmul_rn(static_cast<float>(bits >> 8),
                            5.9604644775390625e-08f);  // 2^-24
  const float v = __fadd_rn(__fmul_rn(u, p.span), p.lo);
  const float tn = __fmul_rn(erfinvf(v), 1.41421356237309505f);
  return fminf(fmaxf(tn, -2.0f), 2.0f);
}

// Adds the noise to the 16 / sizeof(T) elements of one vector whose first
// element is output element e0 (a multiple of 4: rows are 16-byte
// multiples).
template <typename T>
__device__ __forceinline__ void add_noise(uint4* vec, uint64_t e0,
                                          const NoiseParams& p) {
  constexpr int kElems = 16 / sizeof(T);
  T* x = reinterpret_cast<T*>(vec);
#pragma unroll
  for (int g = 0; g < kElems / 4; ++g) {
    const Philox4 bits = dropout_group(p.seed, p.site, (e0 >> 2) + g);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float tn = truncnorm(bits.x[j], p);
      x[4 * g + j] = from_f32<T>(
          __fadd_rn(to_f32(x[4 * g + j]), __fmul_rn(p.std, tn)));
    }
  }
}

template <typename T, bool kNoise>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const uint4* __restrict__ table,
                   const int32_t* __restrict__ idx, uint4* __restrict__ out,
                   int64_t n, int64_t t, int vecs, NoiseParams noise) {
  if (kNoise) noise.seed = derive_seed(*noise.state, noise.call);
  __shared__ int64_t rows[kRowsPerBlock];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  if (threadIdx.x < kRowsPerBlock) {
    const int64_t i = first + threadIdx.x;
    int64_t r = 0;
    if (i < n) {
      r = idx[i];
      if (r < 0 || r >= t) __trap();
    }
    rows[threadIdx.x] = r;
  }
  __syncthreads();
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t i = first + w;
  if (i >= n) return;
  const uint4* src = table + rows[w] * vecs;
  uint4* dst = out + i * vecs;
  for (int v0 = lane; v0 < vecs; v0 += 32 * kInFlight) {
    uint4 buf[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int v = v0 + 32 * j;
      if (v < vecs) buf[j] = __ldg(src + v);
    }
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int v = v0 + 32 * j;
      if (v < vecs) {
        if (kNoise) {
          add_noise<T>(&buf[j],
                       static_cast<uint64_t>(i * vecs + v) * (16 / sizeof(T)),
                       noise);
        }
        dst[v] = buf[j];
      }
    }
  }
}

}  // namespace
}  // namespace coot

// table (t, row_bytes / itemsize) and out (n, same) 16-byte aligned, idx n
// int32 in [0, t); row_bytes a multiple of 16. std == 0: a plain copy
// (the dtype does not matter then, and the seed state is not read);
// otherwise the noise epilogue above in bf16 (is_bf16) or f32, keyed on
// (seed, site), the seed derived on the device from the step's seed state
// and the call's position (csrc/philox.cuh).
extern "C" int coot_gather_rows(const void* table, const void* idx,
                                void* out, long long n, long long t,
                                long long row_bytes, const void* seed_state,
                                unsigned int call, unsigned int site,
                                float std, float lo, float span, int is_bf16,
                                void* stream) {
  using namespace coot;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vecs = static_cast<int>(row_bytes / 16);
  const long long blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  const auto* tab = static_cast<const uint4*>(table);
  const auto* ids = static_cast<const int32_t*>(idx);
  auto* dst = static_cast<uint4*>(out);
  NoiseParams p{static_cast<const uint64_t*>(seed_state), call, 0ull, site,
                std, lo, span};
  if (std == 0.0f) {
    gather_rows_kernel<float, false><<<blocks, kThreads, 0, st>>>(
        tab, ids, dst, n, t, vecs, p);
  } else if (is_bf16) {
    gather_rows_kernel<bf16, true><<<blocks, kThreads, 0, st>>>(
        tab, ids, dst, n, t, vecs, p);
  } else {
    gather_rows_kernel<float, true><<<blocks, kThreads, 0, st>>>(
        tab, ids, dst, n, t, vecs, p);
  }
  return static_cast<int>(cudaGetLastError());
}
