// B6: the post-LN residual add and CootLayerNorm in one pass,
// out = gain * (s - mean) / (std_bessel + eps) + bias with s = y + residual
// rounded to the compute dtype, forward and backward.
//
// Replaces no TPU kernel: on the TPU, XLA fused CootLayerNorm
// (coot_videotext_tpu/models/layers.py CootLayerNorm) into one or two
// fusions, while eager PyTorch runs it as written, about fifty float32
// broadcast, reduction and cast kernels a forward and backward.
//
// What bounds it on the H100: a handful of flops per element against 6-8
// bytes, so the bytes at 3.35 TB/s. A yc2_2d3d_coot train step normalizes
// ~112,000 rows of 384 at each of its two norm sites (the encoder layer of
// each of the four local-net calls), 86 M elements a site: ~0.2 ms of
// traffic a site forward and backward at the bound.
//
// Design: each element is read once and written once.
//  Forward (residual_norm_fwd): one warp per row holds the row in registers,
//   16-byte loads a lane (8 bf16 or 4 f32 elements), widths up to 1024 in
//   multiples of 8. s = y + residual is rounded to the compute dtype (where
//   the plain path's add rounds) and, when the backward needs it, stored
//   once in that dtype. The row's moments come from the registers in two
//   float32 passes and warp shuffles: the mean of s shifted by the row's
//   first element (so a constant row gives s - mean = 0 exactly, std 0),
//   then the Bessel variance of s - mean. denom = std + eps (eps on the
//   std, as CootLayerNorm). The output is written once in the compute
//   dtype, and, for the backward, the row's mean and 1/denom in float32.
//  Backward (residual_norm_bwd): one warp per row again reads dout and s and
//   the row's mean and 1/denom, forms xhat = (s - mean) / denom and
//   g = dout * gain, and writes
//     dx = (g - mean(g)) / denom - xhat * sum(g xhat) / ((D - 1) std)
//   once in the compute dtype: the gradient of the sum, the same for the
//   sublayer output and the residual. The second term is 0 for a constant
//   row (no gradient through std = 0). std is the forward's: the same
//   float32 sums over the same s and mean, in the same order. dgain =
//   sum dout * xhat and dbias = sum dout over the rows are float32
//   column sums with no atomics: each block sums a fixed range of rows,
//   lane by lane and then warp by warp in order, into a partial row of
//   its own; norm_colsum adds the blocks' partials in a fixed order.
//   Two backward calls are bit-equal.
// Several rows a block (8 warps) and enough blocks to keep the 132 SMs
// streaming; the backward's block count comes from the wrapper
// (ops/coot_norm.py::backward_blocks).

#include <initializer_list>

#include "common.cuh"

namespace coot {
namespace {

constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* f) {
  constexpr int kV = 16 / sizeof(T);
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < kV; ++j) f[j] = to_f32(v[j]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float* f) {
  constexpr int kV = 16 / sizeof(T);
  uint4 raw;
  T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < kV; ++j) v[j] = from_f32<T>(f[j]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// kV float32 values from 16-byte aligned float32 memory
template <int kV>
__device__ __forceinline__ void load_f32(const float* __restrict__ p,
                                         float* f) {
#pragma unroll
  for (int j = 0; j < kV; j += 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + j));
    f[j] = q.x;
    f[j + 1] = q.y;
    f[j + 2] = q.z;
    f[j + 3] = q.w;
  }
}

// The row's mean, from x shifted by its first element (lane 0's first
// value). Every lane returns the same float.
template <int kV, int kMaxVec>
__device__ __forceinline__ float row_mean(const float (&x)[kMaxVec][kV],
                                          int lane, int nvec, int D) {
  const float c = __shfl_sync(kFull, x[0][0], 0);
  float s1 = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    if (lane + 32 * i < nvec) {
#pragma unroll
      for (int j = 0; j < kV; ++j) s1 += x[i][j] - c;
    }
  }
  return c + warp_sum(s1) / (float)D;
}

// The Bessel std of the row about `mean`; 0 for a constant row. The
// forward and the backward call it on the same values and so agree bit
// for bit.
template <int kV, int kMaxVec>
__device__ __forceinline__ float row_std(const float (&x)[kMaxVec][kV],
                                         float mean, int lane, int nvec,
                                         int D) {
  float s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    if (lane + 32 * i < nvec) {
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const float d = x[i][j] - mean;
        s2 = fmaf(d, d, s2);
      }
    }
  }
  const float var = warp_sum(s2) / (float)(D - 1);
  return var > 0.f ? sqrtf(var) : 0.f;
}

// One row per warp. y, residual (or null), out, sum (or null): N x D in T;
// mean, inv (or null): N float32; gain, bias: D float32.
template <typename T, int kMaxVec>
__global__ void __launch_bounds__(kThreads)
residual_norm_fwd(const T* __restrict__ y, const T* __restrict__ residual,
                  const float* __restrict__ gain,
                  const float* __restrict__ bias, T* __restrict__ out,
                  T* __restrict__ sum, float* __restrict__ mean_out,
                  float* __restrict__ inv_out, int N, int D, float eps) {
  constexpr int kV = 16 / sizeof(T);
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;  // the whole warp leaves together
  const int nvec = D / kV;
  const size_t base = (size_t)row * D;
  float x[kMaxVec][kV];
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int k = (lane + 32 * i) * kV;
    if (k < D) {
      load_vec(y + base + k, x[i]);
      if (residual != nullptr) {
        float r[kV];
        load_vec(residual + base + k, r);
#pragma unroll
        for (int j = 0; j < kV; ++j)  // rounded as the plain path's add
          x[i][j] = to_f32(from_f32<T>(x[i][j] + r[j]));
        if (sum != nullptr) store_vec(sum + base + k, x[i]);
      }
    }
  }
  const float mean = row_mean(x, lane, nvec, D);
  const float inv = 1.f / (row_std(x, mean, lane, nvec, D) + eps);
  if (mean_out != nullptr && lane == 0) {
    mean_out[row] = mean;
    inv_out[row] = inv;
  }
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int k = (lane + 32 * i) * kV;
    if (k < D) {
      float g[kV], b[kV], o[kV];
      load_f32<kV>(gain + k, g);
      load_f32<kV>(bias + k, b);
#pragma unroll
      for (int j = 0; j < kV; ++j)
        o[j] = fmaf(g[j], (x[i][j] - mean) * inv, b[j]);
      store_vec(out + base + k, o);
    }
  }
}

// Rows [blockIdx.x * rows_per_block, +rows_per_block), warp w taking every
// kWarps-th from the w-th. dout, s, dx: N x D in T; mean, inv: N float32;
// gain: D float32; partial: gridDim.x x 2 x D float32, the block's dgain
// then dbias column sums.
template <typename T, int kMaxVec>
__global__ void __launch_bounds__(kThreads)
residual_norm_bwd(const T* __restrict__ dout, const T* __restrict__ s,
                  const float* __restrict__ mean,
                  const float* __restrict__ inv,
                  const float* __restrict__ gain, T* __restrict__ dx,
                  float* __restrict__ partial, int N, int D,
                  int rows_per_block) {
  constexpr int kV = 16 / sizeof(T);
  __shared__ float red[kWarps][1024];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = D / kV;
  const int r_end = min(N, ((int)blockIdx.x + 1) * rows_per_block);
  float pg[kMaxVec][kV], pb[kMaxVec][kV];
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
#pragma unroll
    for (int j = 0; j < kV; ++j) pg[i][j] = pb[i][j] = 0.f;
  }
  for (int row = (int)blockIdx.x * rows_per_block + warp; row < r_end;
       row += kWarps) {
    const size_t base = (size_t)row * D;
    float x[kMaxVec][kV], g[kMaxVec][kV];
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      const int k = (lane + 32 * i) * kV;
      if (k < D) {
        load_vec(s + base + k, x[i]);
        load_vec(dout + base + k, g[i]);
      }
    }
    const float m = mean[row], iv = inv[row];
    const float sd = row_std(x, m, lane, nvec, D);
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      const int k = (lane + 32 * i) * kV;
      if (k < D) {
        float gn[kV];
        load_f32<kV>(gain + k, gn);
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          x[i][j] = (x[i][j] - m) * iv;  // xhat from here on
          pg[i][j] = fmaf(g[i][j], x[i][j], pg[i][j]);
          pb[i][j] += g[i][j];
          g[i][j] *= gn[j];
          sg += g[i][j];
          sgx = fmaf(g[i][j], x[i][j], sgx);
        }
      }
    }
    const float mg = warp_sum(sg) / (float)D;
    sgx = warp_sum(sgx);
    const float k2 = sd > 0.f ? sgx / ((float)(D - 1) * sd) : 0.f;
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      const int k = (lane + 32 * i) * kV;
      if (k < D) {
        float d[kV];
#pragma unroll
        for (int j = 0; j < kV; ++j)
          d[j] = fmaf(iv, g[i][j] - mg, -x[i][j] * k2);
        store_vec(dx + base + k, d);
      }
    }
  }
  // the block's column sums, warp by warp in order: dgain, then dbias
  float* out = partial + (size_t)blockIdx.x * 2 * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      const int k = (lane + 32 * i) * kV;
      if (k < D) {
#pragma unroll
        for (int j = 0; j < kV; ++j)
          red[warp][k + j] = half ? pb[i][j] : pg[i][j];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += kThreads) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += red[w][c];
      out[half * D + c] = acc;
    }
    __syncthreads();
  }
}

// out[c] = sum over the blocks' partial rows of column c, in a fixed
// order: 32 columns a block, its 8 warps each summing every 8th partial
// row, then the warps' sums added in order.
__global__ void __launch_bounds__(kThreads)
norm_colsum(const float* __restrict__ partial, int rows, int n,
            float* __restrict__ out) {
  __shared__ float red[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < n)
    for (int r = warp; r < rows; r += kWarps)
      acc += partial[(size_t)r * n + c];
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < n) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += red[w][lane];
    out[c] = total;
  }
}

struct FwdArgs {
  const void *y, *residual;
  const float *gain, *bias;
  void *out, *sum;
  float *mean, *inv;
  int N, D;
  float eps;
};

struct BwdArgs {
  const void *dout, *s;
  const float *mean, *inv, *gain;
  void* dx;
  float* partial;
  int N, D, blocks;
};

template <typename T, int kMaxVec>
void launch(const FwdArgs& a, cudaStream_t st) {
  residual_norm_fwd<T, kMaxVec>
      <<<(a.N + kWarps - 1) / kWarps, kThreads, 0, st>>>(
          static_cast<const T*>(a.y), static_cast<const T*>(a.residual),
          a.gain, a.bias, static_cast<T*>(a.out), static_cast<T*>(a.sum),
          a.mean, a.inv, a.N, a.D, a.eps);
}

template <typename T, int kMaxVec>
void launch(const BwdArgs& a, cudaStream_t st) {
  residual_norm_bwd<T, kMaxVec><<<a.blocks, kThreads, 0, st>>>(
      static_cast<const T*>(a.dout), static_cast<const T*>(a.s), a.mean,
      a.inv, a.gain, static_cast<T*>(a.dx), a.partial, a.N, a.D,
      (a.N + a.blocks - 1) / a.blocks);
}

// The kernel instance whose kMaxVec (16-byte vectors a lane) is the
// fewest that hold a row of a.D elements of T: 1-4 in bf16, 1-8 in f32.
template <typename T, int kMaxVec = 1, typename Args>
void dispatch(const Args& a, cudaStream_t st) {
  constexpr int kRow = 32 * kMaxVec * (16 / sizeof(T));  // a warp's elements
  if constexpr (kRow < 1024) {
    if (a.D > kRow) return dispatch<T, kMaxVec + 1>(a, st);
  }
  launch<T, kMaxVec>(a, st);
}

// D a multiple of 8 up to 1024, every vector pointer 16-byte aligned
bool takes(int D, std::initializer_list<const void*> vector_ptrs) {
  if (D < 8 || D > 1024 || D % 8) return false;
  for (const void* p : vector_ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

}  // namespace
}  // namespace coot

// y, residual (null: none), out (N, D) in the compute dtype; gain, bias (D)
// float32; sum (N, D) in the compute dtype, the rounded y + residual, or
// null (not stored); mean, inv (N) float32 or null (not stored). D a
// multiple of 8 up to 1024, every (N, D) and (D) pointer 16-byte aligned.
extern "C" int coot_norm_fwd(const void* y, const void* residual,
                             const void* gain, const void* bias, void* out,
                             void* sum, void* mean, void* inv, int N, int D,
                             float eps, int is_bf16, void* stream) {
  using namespace coot;
  if (!takes(D, {y, residual, gain, bias, out, sum}) ||
      (mean == nullptr) != (inv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const FwdArgs a{y, residual, static_cast<const float*>(gain),
                  static_cast<const float*>(bias), out, sum,
                  static_cast<float*>(mean), static_cast<float*>(inv), N, D,
                  eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    dispatch<bf16>(a, st);
  else
    dispatch<float>(a, st);
  return static_cast<int>(cudaGetLastError());
}

// dout, s (the forward's rounded sum, or its input without a residual), dx
// (N, D) in the compute dtype; mean, inv (N) float32 from the forward; gain
// (D) float32. Writes dx and dgain_dbias (2 * D float32: dgain, then
// dbias); scratch is blocks * 2 * D float32 (blocks from
// ops/coot_norm.py::backward_blocks, 1 <= blocks <= N).
extern "C" int coot_norm_bwd(const void* dout, const void* s,
                             const void* mean, const void* inv,
                             const void* gain, void* dx, void* scratch,
                             void* dgain_dbias, int N, int D, int blocks,
                             int is_bf16, void* stream) {
  using namespace coot;
  if (!takes(D, {dout, s, gain, dx}) || N < 1 || blocks < 1 || blocks > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{dout, s, static_cast<const float*>(mean),
                  static_cast<const float*>(inv),
                  static_cast<const float*>(gain), dx,
                  static_cast<float*>(scratch), N, D, blocks};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    dispatch<bf16>(a, st);
  else
    dispatch<float>(a, st);
  const int n = 2 * D;
  norm_colsum<<<(n + 31) / 32, kThreads, 0, st>>>(
      a.partial, blocks, n, static_cast<float*>(dgain_dbias));
  return static_cast<int>(cudaGetLastError());
}
