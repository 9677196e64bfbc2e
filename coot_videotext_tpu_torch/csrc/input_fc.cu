// B1: fused input projection y = act(cootnorm(x; gain, bias) . W + b),
// forward and backward.
//
// Replaces the TPU kernel coot_videotext_tpu/ops/pallas_input_fc.py::
// fused_input_fc (_fwd_kernel :153, _bwd_kernel :167).
//
// What bounds it on the H100: at the video local net's shapes (S up to
// ~90k rows, din 4096, dout 384) the product is 2*S*din*dout flops against
// S*din*2 bytes of input, ~380 flops per byte, so it is compute-bound on
// the tensor cores (989 TF/s bf16); the f32 variant is bound by the
// 67 TF/s of the FMA units.
//
// Design: two launches.
//  (a) row_stats: one warp per row computes the shifted single-pass sums
//      (shift by the row's first element), the Bessel variance (ddof=1)
//      with the zero-variance guard, and writes mean and 1/(std + eps):
//      eps sits on the std, not on the variance, as in CootLayerNorm.
//  (b) a tiled GEMM that normalizes the A tile while loading it into
//      shared memory (xn = gain*(x-mean)*inv + bias, rounded to the compute
//      dtype exactly where the unfused path rounds the norm output), so the
//      normalized activation never goes to device memory. bf16 runs on the
//      tensor cores through nvcuda::wmma (bf16 in, f32 accumulate); the
//      block owns 64 rows x 384 columns, so at dout <= 384 each input row is
//      read from device memory once. The epilogue adds b, applies gelu
//      through erff, and stores. f32 takes a shared-memory-tiled FMA loop.
// Any S is taken: the ragged row edge (and ragged din/dout) is masked.
// A simple kernel that is right comes first: no cp.async/TMA pipeline and
// no wgmma yet. With `pre` the forward also writes the f32 pre-activation
// (the TPU kernel's need_pre residual) for the backward.
//
// Backward: the input is pipeline data, so, as on the TPU, no dx is formed;
// the parameter gradients are
//   dpre = dy * act'(pre)                  (one elementwise pass, rounded)
//   dW = xn^T dpre, db = sum_rows dpre     (csrc/tn_reduce.cuh; A = x is
//                                           normalized while it is staged)
//   dxn = dpre W^T, dgain = sum_rows dxn * xhat, dbias = sum_rows dxn.
// Both products are 2*S*din*dout flops, so the backward is compute-bound on
// the tensor cores like the forward (4*S*din*dout flops in all). The (S,
// din) dxn never reaches device memory: `dxn_colsum` gives each block one
// 64-column tile of din and one split of the rows; it forms dxn for 32 rows
// at a time with wmma (dpre staged in shared memory, W read from L2) and
// folds it into per-column partial sums, which `sum_splits` adds in split
// order. No float atomics: the sums repeat bit for bit.

#include <mma.h>

#include <type_traits>

#include "common.cuh"
#include "tn_reduce.cuh"

using namespace nvcuda;

namespace coot {
namespace {

constexpr int kStatsThreads = 256;  // 8 rows per block, one warp each

template <typename T>
__global__ void __launch_bounds__(kStatsThreads)
row_stats(const T* __restrict__ x, float* __restrict__ mean,
          float* __restrict__ inv, int S, int din, float eps) {
  const int row = (blockIdx.x * kStatsThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= S) return;  // whole warp leaves together
  const T* xr = x + (size_t)row * din;
  const float c = to_f32(xr[0]);
  float s1 = 0.f, s2 = 0.f;
  for (int k = lane; k < din; k += 32) {
    const float v = to_f32(xr[k]) - c;
    s1 += v;
    s2 += v * v;
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    const float mean_c = s1 / (float)din;
    const float var = fmaxf(s2 - mean_c * s1, 0.f) / (float)max(din - 1, 1);
    const float sd = var > 0.f ? sqrtf(var) : 0.f;
    mean[row] = c + mean_c;
    inv[row] = 1.f / (sd + eps);
  }
}

// ---- bf16: tensor cores via wmma ----
constexpr int kBM = 64, kBN = 384, kBK = 32, kLds = kBK + 8;
constexpr int kWarps = 8, kThreads = kWarps * 32;
constexpr int kWarpCols = kBN / kWarps;   // 48 columns per warp
constexpr int kFragM = kBM / 16;          // 4
constexpr int kFragN = kWarpCols / 16;    // 3

__global__ void __launch_bounds__(kThreads)
gemm_bf16(const bf16* __restrict__ x, const float* __restrict__ mean,
          const float* __restrict__ inv, const float* __restrict__ gain,
          const float* __restrict__ bias, const bf16* __restrict__ w,
          const float* __restrict__ b, bf16* __restrict__ y,
          float* __restrict__ pre, int S, int din, int dout, int act) {
  __shared__ __align__(128) bf16 sA[kBM * kLds];
  __shared__ __align__(128) bf16 sB[kBN * kLds];  // [n][k]: B col-major
  __shared__ __align__(128) float sC[kWarps][16 * 16];
  __shared__ float sMean[kBM], sInv[kBM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  if (tid < kBM) {
    const int r = row0 + tid;
    sMean[tid] = r < S ? mean[r] : 0.f;
    sInv[tid] = r < S ? inv[r] : 0.f;
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFragM][kFragN];
#pragma unroll
  for (int m = 0; m < kFragM; ++m)
#pragma unroll
    for (int n = 0; n < kFragN; ++n) wmma::fill_fragment(acc[m][n], 0.f);
  __syncthreads();

  for (int k0 = 0; k0 < din; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;
      const int gr = row0 + r, gk = k0 + kk;
      float v = 0.f;
      if (gr < S && gk < din)
        v = gain[gk] * ((to_f32(x[(size_t)gr * din + gk]) - sMean[r]) *
                        sInv[r]) + bias[gk];
      sA[r * kLds + kk] = from_f32<bf16>(v);
    }
    for (int i = tid; i < kBN * kBK; i += kThreads) {
      const int n = i / kBK, kk = i % kBK;
      const int gn = col0 + n, gk = k0 + kk;
      sB[n * kLds + kk] = (gn < dout && gk < din)
                              ? w[(size_t)gn * din + gk]
                              : from_f32<bf16>(0.f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          a[kFragM];
#pragma unroll
      for (int m = 0; m < kFragM; ++m)
        wmma::load_matrix_sync(a[m], sA + (m * 16) * kLds + kk, kLds);
#pragma unroll
      for (int n = 0; n < kFragN; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
            bf;
        wmma::load_matrix_sync(
            bf, sB + (warp * kWarpCols + n * 16) * kLds + kk, kLds);
#pragma unroll
        for (int m = 0; m < kFragM; ++m)
          wmma::mma_sync(acc[m][n], a[m], bf, acc[m][n]);
      }
    }
    __syncthreads();
  }

  // epilogue: bias + activation + store, one 16x16 fragment at a time
#pragma unroll
  for (int m = 0; m < kFragM; ++m) {
#pragma unroll
    for (int n = 0; n < kFragN; ++n) {
      wmma::store_matrix_sync(sC[warp], acc[m][n], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gr = row0 + m * 16 + e / 16;
        const int gc = col0 + warp * kWarpCols + n * 16 + e % 16;
        if (gr < S && gc < dout) {
          const float v = sC[warp][e] + b[gc];
          if (pre != nullptr) pre[(size_t)gr * dout + gc] = v;
          y[(size_t)gr * dout + gc] = from_f32<bf16>(activate(v, act));
        }
      }
      __syncwarp();
    }
  }
}

// ---- f32: shared-memory-tiled FMA ----
constexpr int kFBM = 64, kFBN = 64, kFBK = 16;

__global__ void __launch_bounds__(256)
gemm_f32(const float* __restrict__ x, const float* __restrict__ mean,
         const float* __restrict__ inv, const float* __restrict__ gain,
         const float* __restrict__ bias, const float* __restrict__ w,
         const float* __restrict__ b, float* __restrict__ y,
         float* __restrict__ pre, int S, int din, int dout, int act) {
  __shared__ float sA[kFBK][kFBM + 4];
  __shared__ float sB[kFBK][kFBN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * kFBM, col0 = blockIdx.y * kFBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < din; k0 += kFBK) {
    for (int i = tid; i < kFBM * kFBK; i += 256) {
      const int r = i / kFBK, kk = i % kFBK;
      const int gr = row0 + r, gk = k0 + kk;
      float v = 0.f;
      if (gr < S && gk < din)
        v = gain[gk] * ((x[(size_t)gr * din + gk] - mean[gr]) * inv[gr]) +
            bias[gk];
      sA[kk][r] = v;
    }
    for (int i = tid; i < kFBN * kFBK; i += 256) {
      const int n = i / kFBK, kk = i % kFBK;
      const int gn = col0 + n, gk = k0 + kk;
      sB[kk][n] = (gn < dout && gk < din) ? w[(size_t)gn * din + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = sB[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx * 4 + j;
      if (gr < S && gc < dout) {
        const float v = acc[i][j] + b[gc];
        if (pre != nullptr) pre[(size_t)gr * dout + gc] = v;
        y[(size_t)gr * dout + gc] = activate(v, act);
      }
    }
  }
}

// ---- backward ----

template <typename T>
__global__ void __launch_bounds__(256)
dpre_kernel(const T* __restrict__ dy, const float* __restrict__ pre,
            T* __restrict__ dpre, long long n, int act) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += (long long)gridDim.x * 256) {
    const float g = to_f32(dy[i]);
    dpre[i] = from_f32<T>(act == kActGelu ? g * act_grad(pre[i], act) : g);
  }
}

constexpr int kDxRows = 32, kDxCols = 64, kDxMaxOut = 384;
constexpr int kDxLdp = kDxMaxOut + 8, kDxLdx = kDxCols + 4;

// partial_g / partial_b [split][din]: sums over the split's rows of
// dxn * xhat and dxn, dxn = dpre . W^T, for one 64-column tile of din.
template <typename T>
__global__ void __launch_bounds__(256)
dxn_colsum(const T* __restrict__ x, const float* __restrict__ mean,
           const float* __restrict__ inv, const T* __restrict__ w,
           const T* __restrict__ dpre, int S, int din, int dout,
           int rows_per_split, float* __restrict__ partial_g,
           float* __restrict__ partial_b) {
  __shared__ __align__(128) bf16 sP[kDxRows * kDxLdp];  // bf16 only
  __shared__ __align__(128) float sX[kDxRows * kDxLdx];
  __shared__ float sRed[2][4][kDxCols];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int c0 = blockIdx.x * kDxCols;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(S, r_begin + rows_per_split);
  const int col = tid % kDxCols, rg = tid / kDxCols;  // rows rg*8 .. +7
  float acc_g = 0.f, acc_b = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += kDxRows) {
    if constexpr (std::is_same<T, bf16>::value) {
      for (int i = tid; i < kDxRows * dout; i += 256) {
        const int r = i / dout, o = i % dout;
        sP[r * kDxLdp + o] = r0 + r < r_end
                                 ? dpre[(size_t)(r0 + r) * dout + o]
                                 : from_f32<bf16>(0.f);
      }
      __syncthreads();
      const int mi = warp >> 2, ni = warp & 3;  // 2 x 4 fragments
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k = 0; k < dout; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sP + mi * 16 * kDxLdp + k, kDxLdp);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, w + (size_t)k * din + c0 + ni * 16, din);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sX + mi * 16 * kDxLdx + ni * 16, acc, kDxLdx,
                              wmma::mem_row_major);
    } else {
      for (int rr = 0; rr < 8; ++rr) {
        const int r = rg * 8 + rr, gr = r0 + r;
        float v = 0.f;
        if (gr < r_end)
          for (int o = 0; o < dout; ++o)
            v = fmaf(to_f32(dpre[(size_t)gr * dout + o]),
                     to_f32(w[(size_t)o * din + c0 + col]), v);
        sX[r * kDxLdx + col] = v;
      }
    }
    __syncthreads();
    for (int rr = 0; rr < 8; ++rr) {
      const int r = rg * 8 + rr, gr = r0 + r;
      if (gr < r_end) {
        const float dxn = sX[r * kDxLdx + col];
        const float xhat =
            (to_f32(x[(size_t)gr * din + c0 + col]) - mean[gr]) * inv[gr];
        acc_g = fmaf(dxn, xhat, acc_g);
        acc_b += dxn;
      }
    }
    __syncthreads();
  }
  sRed[0][rg][col] = acc_g;
  sRed[1][rg][col] = acc_b;
  __syncthreads();
  if (rg == 0) {
    float g = 0.f, b = 0.f;
    for (int i = 0; i < 4; ++i) {
      g += sRed[0][i][col];
      b += sRed[1][i][col];
    }
    partial_g[(size_t)blockIdx.y * din + c0 + col] = g;
    partial_b[(size_t)blockIdx.y * din + c0 + col] = b;
  }
}

template <typename T>
int input_fc_bwd_launch(const T* x, const float* gain, const float* bias,
                        const T* w, const float* mean, const float* inv,
                        const float* pre, const T* dy, T* dpre,
                        float* scratch, float* dw, float* db, float* dgain,
                        float* dbias, int S, int din, int dout, int act,
                        int splits, cudaStream_t st) {
  const long long n = (long long)S * dout;
  dpre_kernel<T><<<sum_blocks(n), 256, 0, st>>>(dy, pre, dpre, n, act);
  launch_tn<T, true>(x, din, dpre, dout, S, din, dout, splits, scratch, dw,
                     NormA{mean, inv, gain, bias}, st);
  launch_colsum<T>(dpre, dout, S, dout, splits, scratch, db, st);
  float* pg = scratch;
  float* pb = scratch + (size_t)splits * din;
  dim3 grid(din / kDxCols, splits);
  dxn_colsum<T><<<grid, 256, 0, st>>>(x, mean, inv, w, dpre, S, din, dout,
                                      split_rows(S, splits), pg, pb);
  sum_splits<<<sum_blocks(din), 256, 0, st>>>(pg, splits, din, dgain);
  sum_splits<<<sum_blocks(din), 256, 0, st>>>(pb, splits, din, dbias);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace coot

// x (S, din), w (dout, din) [torch Linear layout] in the compute dtype;
// gain, bias (din), b (dout) f32; mean, inv (S) f32 (kept for the
// backward); y (S, dout); pre (S, dout) f32, the pre-activation, or null.
extern "C" int coot_input_fc_fwd(const void* x, const void* gain,
                                 const void* bias, const void* w,
                                 const void* b, void* y, void* mean,
                                 void* inv, void* pre, int S, int din,
                                 int dout, float eps, int act, int is_bf16,
                                 void* stream) {
  using namespace coot;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int stats_blocks = (S + kStatsThreads / 32 - 1) / (kStatsThreads / 32);
  if (is_bf16) {
    row_stats<bf16><<<stats_blocks, kStatsThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<float*>(mean),
        static_cast<float*>(inv), S, din, eps);
    dim3 grid((S + kBM - 1) / kBM, (dout + kBN - 1) / kBN);
    gemm_bf16<<<grid, kThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(mean),
        static_cast<const float*>(inv), static_cast<const float*>(gain),
        static_cast<const float*>(bias), static_cast<const bf16*>(w),
        static_cast<const float*>(b), static_cast<bf16*>(y),
        static_cast<float*>(pre), S, din, dout, act);
  } else {
    row_stats<float><<<stats_blocks, kStatsThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(mean),
        static_cast<float*>(inv), S, din, eps);
    dim3 grid((S + kFBM - 1) / kFBM, (dout + kFBN - 1) / kFBN);
    gemm_f32<<<grid, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(mean),
        static_cast<const float*>(inv), static_cast<const float*>(gain),
        static_cast<const float*>(bias), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(y),
        static_cast<float*>(pre), S, din, dout, act);
  }
  return static_cast<int>(cudaGetLastError());
}

// The forward's x, gain, bias, w, mean, inv and pre, and dy (S, dout) in the
// compute dtype. Writes f32 dw (din, dout), db (dout), dgain, dbias (din);
// dpre (S, dout) is compute-dtype scratch, `scratch` f32 of
// splits * din * dout elements. The wrapper checks din % 64 == 0,
// dout % 16 == 0 and dout <= 384.
extern "C" int coot_input_fc_bwd(const void* x, const void* gain,
                                 const void* bias, const void* w,
                                 const void* mean, const void* inv,
                                 const void* pre, const void* dy, void* dpre,
                                 void* scratch, void* dw, void* db,
                                 void* dgain, void* dbias, int S, int din,
                                 int dout, int act, int splits, int is_bf16,
                                 void* stream) {
  using namespace coot;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gain);
  const float* bi = static_cast<const float*>(bias);
  const float* mn = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(inv);
  const float* pr = static_cast<const float*>(pre);
  float* sc = static_cast<float*>(scratch);
  if (is_bf16)
    return input_fc_bwd_launch<bf16>(
        static_cast<const bf16*>(x), g, bi, static_cast<const bf16*>(w), mn,
        iv, pr, static_cast<const bf16*>(dy), static_cast<bf16*>(dpre), sc,
        static_cast<float*>(dw), static_cast<float*>(db),
        static_cast<float*>(dgain), static_cast<float*>(dbias), S, din, dout,
        act, splits, st);
  return input_fc_bwd_launch<float>(
      static_cast<const float*>(x), g, bi, static_cast<const float*>(w), mn,
      iv, pr, static_cast<const float*>(dy), static_cast<float*>(dpre), sc,
      static_cast<float*>(dw), static_cast<float*>(db),
      static_cast<float*>(dgain), static_cast<float*>(dbias), S, din, dout,
      act, splits, st);
}
