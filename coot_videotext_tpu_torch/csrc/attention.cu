// B3: masked multi-head attention forward,
//   o[n] = softmax(where(key_valid[n / heads], q[n] k[n]^T * scale, -32752))
//          . v[n]
// with q, k, v in the (N = B*heads, L, Dh) layout, all softmax math in f32.
//
// Replaces the forward of the TPU kernel
// coot_videotext_tpu/ops/pallas_attention.py::pallas_masked_attention
// (_fwd_kernel). The COOT nets only ever mask keys, so the kernel takes the
// (B, Lk) key mask instead of a materialized (N, Lq, Lk) mask.
//
// What bounds it on the H100: at COOT's lengths (L <= 80 on the video side,
// Dh = 48) each cell does 4*Lq*Lk*Dh flops on (2*Lq + 2*Lk)*Dh elements,
// ~40 flops per byte, so it is bound by the bytes of q, k, v and o.
//
// Design: one block of 4 warps per (cell, 32-query tile); K/V stream
// through shared memory in 32-key tiles, converted to f32 on the way in
// (the scores come from the bf16 q and k read into f32, as on the TPU; the
// scale is applied to the f32 dot product, not folded into a bf16 q). Each
// warp owns 8 query rows; lane j scores key j of the tile, and an online
// softmax (running max, running sum, rescaled accumulator; lanes own
// output dims lane and lane+32, so Dh <= 64 and Dh need not be a power of
// two) folds the tile in. Masked keys get the finite fill -32752 and still
// count, so a row whose keys are all masked averages all keys uniformly,
// as the reference does; keys past Lk are skipped. Lq = 1 and Lk of any
// size work; the score matrix never reaches device memory.

#include "common.cuh"

namespace coot {
namespace {

constexpr int kQT = 32, kKT = 32, kWarps = 4, kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kQT / kWarps;  // 8
constexpr int kMaxDh = 64, kLd = kMaxDh + 1;

template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_attention_fwd(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const uint8_t* __restrict__ key_valid,
                     T* __restrict__ o, int Lq, int Lk, int Dh,
                     int num_heads, float scale) {
  __shared__ float sQ[kQT * kLd];
  __shared__ float sK[kKT * kLd];
  __shared__ float sV[kKT * kLd];
  __shared__ uint8_t sValid[kKT];

  const int n = blockIdx.x, q0 = blockIdx.y * kQT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = n / num_heads;
  const T* qn = q + (size_t)n * Lq * Dh;
  const T* kn = k + (size_t)n * Lk * Dh;
  const T* vn = v + (size_t)n * Lk * Dh;
  const uint8_t* valid = key_valid + (size_t)b * Lk;
  const int q_rows = min(kQT, Lq - q0);

  for (int i = threadIdx.x; i < q_rows * Dh; i += kThreads)
    sQ[(i / Dh) * kLd + i % Dh] = to_f32(qn[(size_t)q0 * Dh + i]);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc0[kRowsPerWarp],
      acc1[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    acc0[i] = 0.f;
    acc1[i] = 0.f;
  }
  const bool has_d0 = lane < Dh, has_d1 = lane + 32 < Dh;

  for (int k0 = 0; k0 < Lk; k0 += kKT) {
    const int k_rows = min(kKT, Lk - k0);
    __syncthreads();  // previous tile fully consumed (and sQ written)
    for (int i = threadIdx.x; i < k_rows * Dh; i += kThreads) {
      const int r = i / Dh, d = i % Dh;
      sK[r * kLd + d] = to_f32(kn[(size_t)k0 * Dh + i]);
      sV[r * kLd + d] = to_f32(vn[(size_t)k0 * Dh + i]);
    }
    if (threadIdx.x < k_rows) sValid[threadIdx.x] = valid[k0 + threadIdx.x];
    __syncthreads();

    const bool in_range = lane < k_rows;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int qr = warp * kRowsPerWarp + i;
      if (qr < q_rows) {  // uniform across the warp
        float s = -INFINITY;
        if (in_range) {
          float dot = 0.f;
          for (int d = 0; d < Dh; ++d)
            dot = fmaf(sQ[qr * kLd + d], sK[lane * kLd + d], dot);
          s = sValid[lane] ? dot * scale : kMaskFill;
        }
        const float m_new = fmaxf(m[i], warp_max(s));
        const float alpha = expf(m[i] - m_new);  // 0 on the first tile
        const float p = in_range ? expf(s - m_new) : 0.f;
        l[i] = l[i] * alpha + warp_sum(p);
        float a0 = acc0[i] * alpha, a1 = acc1[i] * alpha;
        for (int j = 0; j < k_rows; ++j) {
          const float pj = __shfl_sync(0xffffffffu, p, j);
          if (has_d0) a0 = fmaf(pj, sV[j * kLd + lane], a0);
          if (has_d1) a1 = fmaf(pj, sV[j * kLd + lane + 32], a1);
        }
        acc0[i] = a0;
        acc1[i] = a1;
        m[i] = m_new;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qr = warp * kRowsPerWarp + i;
    if (qr < q_rows) {
      T* orow = o + ((size_t)n * Lq + q0 + qr) * Dh;
      const float inv = 1.f / l[i];
      if (has_d0) orow[lane] = from_f32<T>(acc0[i] * inv);
      if (has_d1) orow[lane + 32] = from_f32<T>(acc1[i] * inv);
    }
  }
}

}  // namespace
}  // namespace coot

// q (N, Lq, Dh), k, v (N, Lk, Dh) in the compute dtype, key_valid (B, Lk)
// uint8 with N = B * num_heads; o (N, Lq, Dh). Dh <= 64 (wrapper-checked).
extern "C" int coot_attention_fwd(const void* q, const void* k,
                                  const void* v, const void* key_valid,
                                  void* o, int N, int Lq, int Lk, int Dh,
                                  int num_heads, float scale, int is_bf16,
                                  void* stream) {
  using namespace coot;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(N, (Lq + kQT - 1) / kQT);
  if (is_bf16) {
    masked_attention_fwd<bf16><<<grid, kThreads, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const uint8_t*>(key_valid),
        static_cast<bf16*>(o), Lq, Lk, Dh, num_heads, scale);
  } else {
    masked_attention_fwd<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const uint8_t*>(key_valid),
        static_cast<float*>(o), Lq, Lk, Dh, num_heads, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
