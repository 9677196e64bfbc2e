// B3: masked multi-head attention, forward and backward,
//   P = softmax(where(key_valid[n / heads], q[n] k[n]^T * scale, -32752))
//   o[n] = dropout(P) . v[n]
// with q, k, v in the (N = B*heads, L, Dh) layout, all softmax math in f32.
//
// Replaces the TPU kernel
// coot_videotext_tpu/ops/pallas_attention.py::pallas_masked_attention
// (_fwd_kernel :43, _bwd_kernel :62). The COOT nets only ever mask keys, so
// the kernels take the (B, Lk) key mask instead of a materialized
// (N, Lq, Lk) mask. Unlike the TPU kernel they also drop P (the module's
// dropout on the attention probabilities, models/attention.py:187-192),
// with Philox bits of element (n*Lq + q)*Lk + k (csrc/philox.cuh).
//
// What bounds them on the H100: at COOT's lengths (L <= 80 on the video
// side, Dh = 48) a cell does 4*Lq*Lk*Dh flops forward (10x backward) on
// (2*Lq + 2*Lk)*Dh elements, ~40 flops per byte, so they are bound by the
// bytes of q, k, v, o (and g, dq, dk, dv).
//
// Forward design: one block of 4 warps per (cell, 32-query tile); K/V
// stream through shared memory in 32-key tiles, converted to f32 on the way
// in (the scores come from q and k read into f32, as on the TPU; the scale
// is applied to the f32 dot product). Each warp owns 8 query rows; lane j
// scores key j of the tile, and an online softmax (running max, running
// sum, rescaled accumulator; lanes own output dims lane and lane+32, so
// Dh <= 64 and Dh need not be a power of two) folds the tile in. Masked
// keys get the finite fill -32752 and still count, so a row whose keys are
// all masked averages all keys uniformly, as the reference does; keys past
// Lk are skipped. The running sum takes P undropped, the accumulator
// P * keep / (1 - rate). With `stats` the row max and 1/sum are written
// for the backward, which then recomputes P exactly.
//
// Backward design (flash-style, no atomics, so runs repeat bit for bit):
//   D_i = rowsum(g_i * o_i)  (= rowsum(dP o P) also under dropout)
//   dS  = where(key_valid, P * (dPd * keep/(1-rate) - D), 0), dPd = g v^T
//   dv  = (P keep/(1-rate))^T g, dk = dS^T q * scale, dq = dS k * scale.
// dS is zero at masked keys, as autodiff of the module's where() gives; the
// Pallas _bwd_kernel (:84-89) does not zero it there, which differs on rows
// whose keys are all masked. Two kernels: (a) one block per (cell, 128
// keys), each lane owning one key's dk and dv rows in registers while the
// queries stream through shared memory in 32-row tiles; (b) one block per
// (cell, 32-query tile) like the forward, each lane owning two dims of dq.

#include "common.cuh"
#include "philox.cuh"

namespace coot {
namespace {

constexpr int kQT = 32, kKT = 32, kWarps = 4, kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kQT / kWarps;  // 8
constexpr int kMaxDh = 64, kLd = kMaxDh + 1;
constexpr uint32_t kSiteAttention = 1;  // ops/philox.py SITE_ATTENTION
constexpr int kBwdKeys = kWarps * 32;   // keys per block of kernel (a)

__device__ __forceinline__ uint64_t p_index(int n, int q, int k, int Lq,
                                            int Lk) {
  return ((uint64_t)n * Lq + q) * Lk + k;
}

template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          int rows, int Dh) {
  for (int i = threadIdx.x; i < rows * Dh; i += kThreads)
    dst[(i / Dh) * kLd + i % Dh] = to_f32(src[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_attention_fwd(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const uint8_t* __restrict__ key_valid,
                     T* __restrict__ o, float* __restrict__ row_max,
                     float* __restrict__ row_inv, int Lq, int Lk, int Dh,
                     int num_heads, float scale, DropParams drop) {
  __shared__ float sQ[kQT * kLd];
  __shared__ float sK[kKT * kLd];
  __shared__ float sV[kKT * kLd];
  __shared__ uint8_t sValid[kKT];

  const int n = blockIdx.x, q0 = blockIdx.y * kQT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = n / num_heads;
  const T* kn = k + (size_t)n * Lk * Dh;
  const T* vn = v + (size_t)n * Lk * Dh;
  const uint8_t* valid = key_valid + (size_t)b * Lk;
  const int q_rows = min(kQT, Lq - q0);

  load_rows(sQ, q + ((size_t)n * Lq + q0) * Dh, q_rows, Dh);

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
    load_rows(sK, kn + (size_t)k0 * Dh, k_rows, Dh);
    load_rows(sV, vn + (size_t)k0 * Dh, k_rows, Dh);
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
        const float pd =
            in_range ? p * dropout_factor(drop, kSiteAttention,
                                          p_index(n, q0 + qr, k0 + lane,
                                                  Lq, Lk))
                     : 0.f;
        l[i] = l[i] * alpha + warp_sum(p);
        float a0 = acc0[i] * alpha, a1 = acc1[i] * alpha;
        for (int j = 0; j < k_rows; ++j) {
          const float pj = __shfl_sync(0xffffffffu, pd, j);
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
      const size_t row = (size_t)n * Lq + q0 + qr;
      T* orow = o + row * Dh;
      const float inv = 1.f / l[i];
      if (has_d0) orow[lane] = from_f32<T>(acc0[i] * inv);
      if (has_d1) orow[lane + 32] = from_f32<T>(acc1[i] * inv);
      if (row_max != nullptr && lane == 0) {
        row_max[row] = m[i];
        row_inv[row] = inv;
      }
    }
  }
}

// D_r = rowsum(g_r * o_r) for the rows of a tile, one warp per row group.
template <typename T>
__device__ __forceinline__ void tile_delta(float* sD, const T* g,
                                           const T* o, int rows, int Dh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    float acc = 0.f;
    for (int d = lane; d < Dh; d += 32)
      acc = fmaf(to_f32(g[(size_t)r * Dh + d]), to_f32(o[(size_t)r * Dh + d]),
                 acc);
    acc = warp_sum(acc);
    if (lane == 0) sD[r] = acc;
  }
}

// (a) dk, dv: one block per (cell, 128 keys); lane owns one key.
template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_attention_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ o,
                          const T* __restrict__ g,
                          const uint8_t* __restrict__ key_valid,
                          const float* __restrict__ row_max,
                          const float* __restrict__ row_inv,
                          T* __restrict__ dk, T* __restrict__ dv, int Lq,
                          int Lk, int Dh, int num_heads, float scale,
                          DropParams drop) {
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                      // kBwdKeys x kLd
  float* sV = sK + kBwdKeys * kLd;       // kBwdKeys x kLd
  float* sQ = sV + kBwdKeys * kLd;       // kQT x kLd
  float* sG = sQ + kQT * kLd;            // kQT x kLd
  float* sM = sG + kQT * kLd;            // kQT
  float* sI = sM + kQT;                  // kQT
  float* sD = sI + kQT;                  // kQT

  const int n = blockIdx.x, kb = blockIdx.y * kBwdKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = n / num_heads;
  const int k_rows = min(kBwdKeys, Lk - kb);
  load_rows(sK, k + ((size_t)n * Lk + kb) * Dh, k_rows, Dh);
  load_rows(sV, v + ((size_t)n * Lk + kb) * Dh, k_rows, Dh);

  const int jl = warp * 32 + lane;  // this lane's key within the block
  const int key = kb + jl;
  const bool active = jl < k_rows;
  const bool kvalid = active && key_valid[(size_t)b * Lk + key] != 0;

  float ak[kMaxDh], av[kMaxDh];
#pragma unroll
  for (int d = 0; d < kMaxDh; ++d) {
    ak[d] = 0.f;
    av[d] = 0.f;
  }

  for (int q0 = 0; q0 < Lq; q0 += kQT) {
    const int q_rows = min(kQT, Lq - q0);
    __syncthreads();  // previous query tile consumed (and sK/sV written)
    const size_t row0 = (size_t)n * Lq + q0;
    load_rows(sQ, q + row0 * Dh, q_rows, Dh);
    load_rows(sG, g + row0 * Dh, q_rows, Dh);
    if (threadIdx.x < q_rows) {
      sM[threadIdx.x] = row_max[row0 + threadIdx.x];
      sI[threadIdx.x] = row_inv[row0 + threadIdx.x];
    }
    tile_delta(sD, g + row0 * Dh, o + row0 * Dh, q_rows, Dh);
    __syncthreads();
    if (!active) continue;
    for (int r = 0; r < q_rows; ++r) {
      float dot = 0.f, dpd = 0.f;
#pragma unroll
      for (int d = 0; d < kMaxDh; ++d) {
        if (d < Dh) {
          dot = fmaf(sQ[r * kLd + d], sK[jl * kLd + d], dot);
          dpd = fmaf(sG[r * kLd + d], sV[jl * kLd + d], dpd);
        }
      }
      const float s = kvalid ? dot * scale : kMaskFill;
      const float p = expf(s - sM[r]) * sI[r];
      const float f = dropout_factor(drop, kSiteAttention,
                                     p_index(n, q0 + r, key, Lq, Lk));
      const float pd = p * f;
      const float ds = kvalid ? p * (dpd * f - sD[r]) : 0.f;
#pragma unroll
      for (int d = 0; d < kMaxDh; ++d) {
        if (d < Dh) {
          av[d] = fmaf(pd, sG[r * kLd + d], av[d]);
          ak[d] = fmaf(ds, sQ[r * kLd + d], ak[d]);
        }
      }
    }
  }
  if (!active) return;
  const size_t out = ((size_t)n * Lk + key) * Dh;
#pragma unroll
  for (int d = 0; d < kMaxDh; ++d) {
    if (d < Dh) {
      dk[out + d] = from_f32<T>(ak[d] * scale);
      dv[out + d] = from_f32<T>(av[d]);
    }
  }
}

// (b) dq: one block per (cell, 32-query tile); lanes own dims lane and
// lane + 32 of dq and, in the score step, key j of the 32-key tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_attention_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ g,
                        const uint8_t* __restrict__ key_valid,
                        const float* __restrict__ row_max,
                        const float* __restrict__ row_inv,
                        T* __restrict__ dq, int Lq, int Lk, int Dh,
                        int num_heads, float scale, DropParams drop) {
  __shared__ float sQ[kQT * kLd];
  __shared__ float sG[kQT * kLd];
  __shared__ float sK[kKT * kLd];
  __shared__ float sV[kKT * kLd];
  __shared__ float sD[kQT];
  __shared__ uint8_t sValid[kKT];

  const int n = blockIdx.x, q0 = blockIdx.y * kQT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = n / num_heads;
  const int q_rows = min(kQT, Lq - q0);
  const size_t row0 = (size_t)n * Lq + q0;
  load_rows(sQ, q + row0 * Dh, q_rows, Dh);
  load_rows(sG, g + row0 * Dh, q_rows, Dh);
  tile_delta(sD, g + row0 * Dh, o + row0 * Dh, q_rows, Dh);

  float m[kRowsPerWarp], inv[kRowsPerWarp], a0[kRowsPerWarp],
      a1[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qr = warp * kRowsPerWarp + i;
    m[i] = qr < q_rows ? row_max[row0 + qr] : 0.f;
    inv[i] = qr < q_rows ? row_inv[row0 + qr] : 0.f;
    a0[i] = 0.f;
    a1[i] = 0.f;
  }
  const bool has_d0 = lane < Dh, has_d1 = lane + 32 < Dh;

  for (int k0 = 0; k0 < Lk; k0 += kKT) {
    const int k_rows = min(kKT, Lk - k0);
    __syncthreads();
    load_rows(sK, k + ((size_t)n * Lk + k0) * Dh, k_rows, Dh);
    load_rows(sV, v + ((size_t)n * Lk + k0) * Dh, k_rows, Dh);
    if (threadIdx.x < k_rows)
      sValid[threadIdx.x] = key_valid[(size_t)b * Lk + k0 + threadIdx.x];
    __syncthreads();
    const bool in_range = lane < k_rows;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int qr = warp * kRowsPerWarp + i;
      if (qr < q_rows) {
        float ds = 0.f;
        if (in_range && sValid[lane]) {
          float dot = 0.f, dpd = 0.f;
          for (int d = 0; d < Dh; ++d) {
            dot = fmaf(sQ[qr * kLd + d], sK[lane * kLd + d], dot);
            dpd = fmaf(sG[qr * kLd + d], sV[lane * kLd + d], dpd);
          }
          const float p = expf(dot * scale - m[i]) * inv[i];
          const float f = dropout_factor(
              drop, kSiteAttention, p_index(n, q0 + qr, k0 + lane, Lq, Lk));
          ds = p * (dpd * f - sD[qr]);
        }
        float b0 = a0[i], b1 = a1[i];
        for (int j = 0; j < k_rows; ++j) {
          const float dsj = __shfl_sync(0xffffffffu, ds, j);
          if (has_d0) b0 = fmaf(dsj, sK[j * kLd + lane], b0);
          if (has_d1) b1 = fmaf(dsj, sK[j * kLd + lane + 32], b1);
        }
        a0[i] = b0;
        a1[i] = b1;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qr = warp * kRowsPerWarp + i;
    if (qr < q_rows) {
      T* row = dq + (row0 + qr) * Dh;
      if (has_d0) row[lane] = from_f32<T>(a0[i] * scale);
      if (has_d1) row[lane + 32] = from_f32<T>(a1[i] * scale);
    }
  }
}

size_t dkdv_smem_bytes() {
  return sizeof(float) * ((2 * kBwdKeys + 2 * kQT) * kLd + 3 * kQT);
}

}  // namespace
}  // namespace coot

// q (N, Lq, Dh), k, v (N, Lk, Dh) in the compute dtype, key_valid (B, Lk)
// uint8 with N = B * num_heads; o (N, Lq, Dh). Dh <= 64 (wrapper-checked).
// row_max, row_inv (N, Lq) f32, or null when the backward is not needed.
// thresh == 0: no dropout.
extern "C" int coot_attention_fwd(const void* q, const void* k,
                                  const void* v, const void* key_valid,
                                  void* o, void* row_max, void* row_inv,
                                  int N, int Lq, int Lk, int Dh,
                                  int num_heads, float scale,
                                  unsigned long long seed,
                                  unsigned int thresh, float drop_scale,
                                  int is_bf16, void* stream) {
  using namespace coot;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(N, (Lq + kQT - 1) / kQT);
  DropParams drop{seed, thresh, drop_scale};
  float* rm = static_cast<float*>(row_max);
  float* ri = static_cast<float*>(row_inv);
  if (is_bf16) {
    masked_attention_fwd<bf16><<<grid, kThreads, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const uint8_t*>(key_valid),
        static_cast<bf16*>(o), rm, ri, Lq, Lk, Dh, num_heads, scale, drop);
  } else {
    masked_attention_fwd<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const uint8_t*>(key_valid),
        static_cast<float*>(o), rm, ri, Lq, Lk, Dh, num_heads, scale, drop);
  }
  return static_cast<int>(cudaGetLastError());
}

// The forward's inputs and residuals (o, row_max, row_inv) and the
// cotangent g (N, Lq, Dh); writes dq, dk, dv in the compute dtype.
extern "C" int coot_attention_bwd(const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* g, const void* key_valid,
                                  const void* row_max, const void* row_inv,
                                  void* dq, void* dk, void* dv, int N,
                                  int Lq, int Lk, int Dh, int num_heads,
                                  float scale, unsigned long long seed,
                                  unsigned int thresh, float drop_scale,
                                  int is_bf16, void* stream) {
  using namespace coot;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DropParams drop{seed, thresh, drop_scale};
  const float* rm = static_cast<const float*>(row_max);
  const float* ri = static_cast<const float*>(row_inv);
  const uint8_t* kv = static_cast<const uint8_t*>(key_valid);
  const size_t smem = dkdv_smem_bytes();
  dim3 grid_kv(N, (Lk + kBwdKeys - 1) / kBwdKeys);
  dim3 grid_q(N, (Lq + kQT - 1) / kQT);
  cudaError_t err;
  if (is_bf16) {
    err = cudaFuncSetAttribute(masked_attention_bwd_dkdv<bf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    masked_attention_bwd_dkdv<bf16><<<grid_kv, kThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(o),
        static_cast<const bf16*>(g), kv, rm, ri, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), Lq, Lk, Dh, num_heads, scale, drop);
    masked_attention_bwd_dq<bf16><<<grid_q, kThreads, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(o),
        static_cast<const bf16*>(g), kv, rm, ri, static_cast<bf16*>(dq), Lq,
        Lk, Dh, num_heads, scale, drop);
  } else {
    err = cudaFuncSetAttribute(masked_attention_bwd_dkdv<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    masked_attention_bwd_dkdv<float><<<grid_kv, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o),
        static_cast<const float*>(g), kv, rm, ri, static_cast<float*>(dk),
        static_cast<float*>(dv), Lq, Lk, Dh, num_heads, scale, drop);
    masked_attention_bwd_dq<float><<<grid_q, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o),
        static_cast<const float*>(g), kv, rm, ri, static_cast<float*>(dq),
        Lq, Lk, Dh, num_heads, scale, drop);
  }
  return static_cast<int>(cudaGetLastError());
}
