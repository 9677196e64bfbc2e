// Weight-gradient reductions over rows: C (M x N) = sum_r A[r, :M]^T
// B[r, :N], and column sums of B, for the float32 backwards (B1 with a
// NormA, B2); the bf16 backwards take the tensor-core product of
// csrc/tn_mma.cuh and, like these, `sum_splits`.
//
// On the TPU the backward kernels carry these sums across their sequential
// grid in resident VMEM blocks (pallas_input_fc.py:170-203,
// pallas_genpool.py:210-256). Hopper's blocks run in parallel and in no
// order, so the sum is split in two deterministic passes instead of float
// atomics: each block sums one contiguous split of the rows into its own
// partial tile, and `sum_splits` adds the partials in split order. Runs
// repeat bit for bit.
//
// tn_partial: one block of 4 warps per (64 x 64 output tile, row split);
// rows stream through shared memory 32 at a time into FMA loops. With a
// NormA the A rows are normalized while they are staged (a = gain * (x -
// mean) * inv + bias; B1's f32 backward passes gain 1 and bias 0 for
// xhat).
#pragma once

#include <algorithm>

#include "common.cuh"

namespace coot {
namespace {

constexpr int kTnTile = 64, kTnRows = 32, kTnThreads = 128;
constexpr int kTnLd = kTnTile + 8, kTnLdc = kTnTile + 4;

struct NormA {
  const float* mean;  // per row
  const float* inv;   // per row, 1 / (std + eps)
  const float* gain;  // per column of A
  const float* bias;
};

template <typename T, bool kNorm>
__global__ void __launch_bounds__(kTnThreads)
tn_partial(const T* __restrict__ A, int lda, const T* __restrict__ B,
           int ldb, int R, int M, int N, int rows_per_split,
           float* __restrict__ partial, NormA norm) {
  __shared__ __align__(128) T sA[kTnRows * kTnLd];
  __shared__ __align__(128) T sB[kTnRows * kTnLd];
  __shared__ __align__(128) float sC[kTnTile * kTnLdc];
  const int m0 = blockIdx.x * kTnTile, n0 = blockIdx.y * kTnTile;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  const int tid = threadIdx.x;
  // thread owns rows tm*4 .. +3 and columns tn*8 .. +7 of the tile
  const int tm = tid >> 3, tn = tid & 7;
  float facc[4][8] = {};

  for (int r0 = r_begin; r0 < r_end; r0 += kTnRows) {
    for (int i = tid; i < kTnRows * kTnTile; i += kTnThreads) {
      const int r = i / kTnTile, c = i % kTnTile;
      const int gr = r0 + r, gm = m0 + c, gn = n0 + c;
      float a = 0.f, b = 0.f;
      if (gr < r_end && gm < M) {
        a = to_f32(A[(size_t)gr * lda + gm]);
        if constexpr (kNorm)
          a = norm.gain[gm] * ((a - norm.mean[gr]) * norm.inv[gr]) +
              norm.bias[gm];
      }
      if (gr < r_end && gn < N) b = to_f32(B[(size_t)gr * ldb + gn]);
      sA[r * kTnLd + c] = from_f32<T>(a);
      sB[r * kTnLd + c] = from_f32<T>(b);
    }
    __syncthreads();
    for (int k = 0; k < kTnRows; ++k) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = to_f32(sA[k * kTnLd + tm * 4 + i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = to_f32(sB[k * kTnLd + tn * 8 + j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) facc[i][j] = fmaf(a[i], b[j], facc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      sC[(tm * 4 + i) * kTnLdc + tn * 8 + j] = facc[i][j];
  __syncthreads();
  float* out = partial + (size_t)blockIdx.z * M * N;
  for (int i = tid; i < kTnTile * kTnTile; i += kTnThreads) {
    const int m = m0 + i / kTnTile, n = n0 + i % kTnTile;
    if (m < M && n < N) out[(size_t)m * N + n] = sC[(i / kTnTile) * kTnLdc +
                                                    i % kTnTile];
  }
}

// partial[split][n] = sum of B[r, n] over the rows of the split
template <typename T>
__global__ void __launch_bounds__(256)
colsum_partial(const T* __restrict__ B, int ldb, int R, int N,
               int rows_per_split, float* __restrict__ partial) {
  const int n = blockIdx.x * 256 + threadIdx.x;
  if (n >= N) return;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  float acc = 0.f;
  for (int r = r_begin; r < r_end; ++r) acc += to_f32(B[(size_t)r * ldb + n]);
  partial[(size_t)blockIdx.y * N + n] = acc;
}

// out[i] = sum over splits of partial[split][i], in split order
__global__ void __launch_bounds__(256)
sum_splits(const float* __restrict__ partial, int splits, long long n,
           float* __restrict__ out) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += (long long)gridDim.x * 256) {
    float acc = 0.f;
    for (int sp = 0; sp < splits; ++sp) acc += partial[sp * n + i];
    out[i] = acc;
  }
}

inline int split_rows(int R, int splits) {
  return (R + splits - 1) / splits;
}

inline int sum_blocks(long long n) {
  return (int)std::min<long long>((n + 255) / 256, 132LL * 8);
}

// C (M x N, f32) = sum_r A[r]^T B[r] through `scratch` (splits * M * N)
template <typename T, bool kNorm>
void launch_tn(const T* A, int lda, const T* B, int ldb, int R, int M,
               int N, int splits, float* scratch, float* C, NormA norm,
               cudaStream_t st) {
  dim3 grid((M + kTnTile - 1) / kTnTile, (N + kTnTile - 1) / kTnTile,
            splits);
  tn_partial<T, kNorm><<<grid, kTnThreads, 0, st>>>(
      A, lda, B, ldb, R, M, N, split_rows(R, splits), scratch, norm);
  const long long n = (long long)M * N;
  sum_splits<<<sum_blocks(n), 256, 0, st>>>(scratch, splits, n, C);
}

// c (N, f32) = column sums of B through `scratch` (splits * N)
template <typename T>
void launch_colsum(const T* B, int ldb, int R, int N, int splits,
                   float* scratch, float* c, cudaStream_t st) {
  dim3 grid((N + 255) / 256, splits);
  colsum_partial<T><<<grid, 256, 0, st>>>(B, ldb, R, N,
                                         split_rows(R, splits), scratch);
  sum_splits<<<sum_blocks(N), 256, 0, st>>>(scratch, splits, N, c);
}

}  // namespace
}  // namespace coot
