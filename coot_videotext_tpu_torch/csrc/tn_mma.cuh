// Tall-K weight-gradient products on the tensor cores, shared by B1's and
// B2's bf16 backwards:
//   partial[split][item] (M x N, f32) = sum over the split's rows r of
//       a(r, m)^T B[r, n],   a = A, or with kNorm (A - mean_r) * inv_r
// with A and B row-major in memory and the rows as K (B1: G = xhat^T dpre;
// B2: dw1 = f^T dpre1 and, per head, dw2[h] = h1[:, h]^T dh2[:, h]).
//
// On the TPU these sums are carried across the sequential grid in resident
// VMEM blocks (pallas_input_fc.py:170-203, pallas_genpool.py:210-256).
// Hopper's blocks run in parallel and in no order, so each block sums one
// contiguous row split into its own partial tile, and the caller adds the
// partials in split order afterwards: no float atomics, and two runs are
// bit-equal.
//
// Design (B1's backward product, made generic): one block per (128 of M x
// 192 of N, batch item, row split), 64 rows a step through a 4-stage
// cp.async ring, warp-specialized: 4 producer warps stage A and B by 16-byte
// cp.async (and with kNorm mean and inv, forming (a - mean) * inv in place
// once per element, rounded to bf16); 8 consumer warps (64 x 48 each) run
// mma.sync m16n8k16 from ldmatrix.trans fragments (both operands have the
// rows as their slow axis, so nothing is transposed in memory). Without
// kNorm, the producers of the blocks of the first M tile also sum B's
// columns over the rows they stage (B2's db1 and db2) when `colsum` is set.
// Named barriers hand the stages over:
//   full[s]  producers arrive once stage s holds a ready tile, consumers
//            wait on it before multiplying;
//   empty[s] consumers arrive once they are done with stage s, producers
//            wait on it before refilling it (only for a tile that is
//            refilled, so every phase of every barrier completes);
//   loaded   producers only: every producer's copies of a tile have landed.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace coot {
namespace {

// 8 bf16 of a row into shared memory: the first n (none when n <= 0) from
// src, zeros after; one 16-byte cp.async when all 8 are there and `vec`
// says the source is 16-byte aligned.
__device__ __forceinline__ void stage8(bf16* dst, const bf16* src, int n,
                                       bool vec) {
  if (vec && n >= 8) {
    cp_async_16(dst, src);
  } else {
    const bf16 zero = __ushort_as_bfloat16(0);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[j] = j < n ? src[j] : zero;
  }
}

// The same for 4 floats.
__device__ __forceinline__ void stage4f(float* dst, const float* src, int n,
                                        bool vec) {
  if (vec && n >= 4) {
    cp_async_16(dst, src);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[j] = j < n ? src[j] : 0.f;
  }
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

constexpr int kStages = 4;  // the cp.async ring
constexpr int kBarFull = 1, kBarEmpty = kBarFull + kStages,
              kBarLoaded = kBarEmpty + kStages;  // 0 is __syncthreads
constexpr int kBN = 192;
constexpr int kWarpN = kBN / 4, kNF = kWarpN / 8;  // 48 columns, 6 x n8

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One consumer warp's products over a staged k tile: 64 rows of A (sA at
// the warp's first row) times 48 columns of B, 16-deep steps; both
// operands k-contiguous ([row][k], non-transposed ldmatrix) or, with
// kTrans, k-major ([k][row], ldmatrix.trans). The next step's fragments
// load while this step's products run.
template <int kK, bool kTrans>
__device__ __forceinline__ void warp_mma(float (&acc)[4][kNF][4],
                                         const bf16* sA, int lda,
                                         const bf16* sB, int ldb) {
  const int lane = threadIdx.x & 31;
  const int r8 = lane & 7, hi8 = ((lane >> 3) & 1) * 8, hi16 = (lane >> 4) * 8;
  // this lane's ldmatrix row address, and the offsets of the next 16 rows
  // of the operand (m16 or n16) and of the next 16-deep step
  const bf16* pa = kTrans ? sA + (r8 + hi16) * lda + hi8
                          : sA + (r8 + hi8) * lda + hi16;
  const bf16* pb = kTrans ? sB + (r8 + hi8) * ldb + hi16
                          : sB + (r8 + hi16) * ldb + hi8;
  const int a16 = kTrans ? 16 : 16 * lda, b16 = kTrans ? 16 : 16 * ldb;
  const int ak = kTrans ? 16 * lda : 16, bk = kTrans ? 16 * ldb : 16;
  uint32_t a[2][4][4], bq[2][kNF / 2][4];
  auto fragments = [&](int buf, int step) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (kTrans)
        ldsm_x4_t(a[buf][m], pa + m * a16 + step * ak);
      else
        ldsm_x4(a[buf][m], pa + m * a16 + step * ak);
    }
#pragma unroll
    for (int np = 0; np < kNF / 2; ++np) {
      if (kTrans)
        ldsm_x4_t(bq[buf][np], pb + np * b16 + step * bk);
      else
        ldsm_x4(bq[buf][np], pb + np * b16 + step * bk);
    }
  };
  fragments(0, 0);
#pragma unroll
  for (int step = 0; step < kK / 16; ++step) {
    const int cur = step & 1;
    if (step + 1 < kK / 16) fragments(cur ^ 1, step + 1);
#pragma unroll
    for (int np = 0; np < kNF / 2; ++np)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        mma_bf16(acc[m][2 * np], a[cur][m], bq[cur][np][0], bq[cur][np][1]);
        mma_bf16(acc[m][2 * np + 1], a[cur][m], bq[cur][np][2],
                 bq[cur][np][3]);
      }
  }
}

constexpr int kGM = 128, kGN = kBN, kGK = 64;  // M x N tile, rows/step
constexpr int kLdx = kGM + 8, kLdp = kGN + 8;  // +8: ldmatrix rows
constexpr int kGConsumers = 256, kGProducers = 128;  // 8 + 4 warps
constexpr int kGThreads = kGConsumers + kGProducers;
// A (kGK x kLdx) and B (kGK x kLdp) bf16, mean and inv (kGK) f32
constexpr int kGStageBytes = 2 * kGK * (kLdx + kLdp) + 2 * 4 * kGK;
constexpr int kGSmem = kStages * kGStageBytes;

// One tall-K product: batch item i reads A's M columns at a + i * a_step
// (row stride lda) and B's N columns at b + i * b_step (row stride ldb),
// and writes its partial plane at partial + split * p_split + i * p_step
// (row stride N) and, with colsum, B's column sums at colsum + split *
// c_split + i * c_step.
struct TnArgs {
  const bf16* a;
  const bf16* b;
  const float* mean;  // kNorm only, per row
  const float* inv;
  float* partial;
  float* colsum;  // !kNorm only, or null
  long long a_step, b_step, p_split, p_step, c_split, c_step;
  int lda, ldb, R, M, N, rows_per_split, m_tiles;
};

// grid (N tiles, m_tiles * items, splits); rows_per_split % kGK == 0.
template <bool kNorm>
__global__ void __launch_bounds__(kGThreads, 1)
tn_mma(const TnArgs p) {
  constexpr int kXChunks = kGM / 8, kPChunks = kGN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int item = blockIdx.y / p.m_tiles;
  const int n0 = blockIdx.x * kGN, m0 = (blockIdx.y % p.m_tiles) * kGM;
  const int r_begin = blockIdx.z * p.rows_per_split;
  const int r_end = min(p.R, r_begin + p.rows_per_split);
  const int KT = r_end > r_begin ? (r_end - r_begin + kGK - 1) / kGK : 0;
  const bf16* A = p.a + item * p.a_step;
  const bf16* B = p.b + item * p.b_step;
  const bool vec = p.lda % 8 == 0 && p.ldb % 8 == 0 && aligned16(A) &&
                   aligned16(B) &&
                   (!kNorm || (aligned16(p.mean) && aligned16(p.inv)));

  auto tile_x = [&](int s) {
    return reinterpret_cast<bf16*>(smem + s * kGStageBytes);
  };
  auto tile_p = [&](int s) { return tile_x(s) + kGK * kLdx; };
  auto tile_mean = [&](int s) {
    return reinterpret_cast<float*>(tile_p(s) + kGK * kLdp);
  };

  if (tid >= kGConsumers) {  // producer warps
    const int pt = tid - kGConsumers;
    auto load = [&](int s, int r0) {
      bf16* sX = tile_x(s);
      bf16* sP = tile_p(s);
      for (int i = pt; i < kGK * kXChunks; i += kGProducers) {
        const int r = i / kXChunks, c = (i % kXChunks) * 8;
        const int gr = r0 + r, gk = m0 + c;
        stage8(sX + r * kLdx + c, A + (size_t)gr * p.lda + gk,
               gr < r_end ? p.M - gk : 0, vec);
      }
      for (int i = pt; i < kGK * kPChunks; i += kGProducers) {
        const int r = i / kPChunks, c = (i % kPChunks) * 8;
        const int gr = r0 + r, go = n0 + c;
        stage8(sP + r * kLdp + c, B + (size_t)gr * p.ldb + go,
               gr < r_end ? p.N - go : 0, vec);
      }
      if (kNorm && pt < kGK / 2) {  // mean, then inv: kGK / 4 chunks of 4
        const int c = (pt % (kGK / 4)) * 4;
        const bool is_mean = pt < kGK / 4;
        stage4f(tile_mean(s) + (is_mean ? 0 : kGK) + c,
                (is_mean ? p.mean : p.inv) + r0 + c, r_end - r0 - c, vec);
      }
    };
    // kNorm: a = (x - mean) * inv, in place, rounded to bf16 (rows past
    // the split are zero: x, mean and inv were staged as 0)
    auto normalize = [&](int s) {
      bf16* sX = tile_x(s);
      const float* sM = tile_mean(s);
      const float* sI = sM + kGK;
      const int c = (pt % kXChunks) * 8;
#pragma unroll
      for (int r = pt / kXChunks; r < kGK; r += kGProducers / kXChunks) {
        uint4* q = reinterpret_cast<uint4*>(sX + r * kLdx + c);
        uint4 raw = *q;
        uint32_t* v = reinterpret_cast<uint32_t*>(&raw);
        const float m = sM[r], iv = sI[r];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = pack_bf16((bf16_lo(v[j]) - m) * iv,
                           (bf16_hi(v[j]) - m) * iv);
        *q = raw;
      }
    };
    // column sums of B over the staged rows (zero past the split), in row
    // order: columns pt and pt + 128 of the tile
    const bool sums = !kNorm && p.colsum != nullptr && m0 == 0;
    float cs0 = 0.f, cs1 = 0.f;
    auto column_sums = [&](int s) {
      const bf16* sP = tile_p(s);
      for (int r = 0; r < kGK; ++r) {
        cs0 += __bfloat162float(sP[r * kLdp + pt]);
        if (pt + kGProducers < kGN)
          cs1 += __bfloat162float(sP[r * kLdp + pt + kGProducers]);
      }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < KT) load(s, r_begin + s * kGK);
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<kStages - 2>();
      bar_sync(kBarLoaded, kGProducers);
      if (kNorm) normalize(kt % kStages);
      if (sums) column_sums(kt % kStages);
      bar_arrive(kBarFull + kt % kStages, kGThreads);
      const int next = kt + kStages - 1;
      if (next < KT) {
        if (kt >= 1) bar_sync(kBarEmpty + (kt - 1) % kStages, kGThreads);
        load(next % kStages, r_begin + next * kGK);
      }
      cp_async_commit();
    }
    cp_async_wait<0>();
    if (sums) {
      float* out = p.colsum + blockIdx.z * p.c_split + item * p.c_step;
      if (n0 + pt < p.N) out[n0 + pt] = cs0;
      if (pt + kGProducers < kGN && n0 + pt + kGProducers < p.N)
        out[n0 + pt + kGProducers] = cs1;
    }
    return;  // only the consumers write the partial tile
  }

  float acc[4][kNF][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < kNF; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
  const int wm = warp >> 2, wn = warp & 3;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % kStages;
    bar_sync(kBarFull + s, kGThreads);
    // A^T (M x rows) and B (rows x N): both stored with the rows (K) as
    // the slow axis, so both come through ldmatrix.trans
    warp_mma<kGK, true>(acc, tile_x(s) + wm * 64, kLdx,
                        tile_p(s) + wn * kWarpN, kLdp);
    if (kt + kStages < KT) bar_arrive(kBarEmpty + s, kGThreads);
  }

  float* out = p.partial + blockIdx.z * p.p_split + item * p.p_step;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < kNF; ++n) {
      const int k = m0 + wm * 64 + m * 16 + gq;
      const int o = n0 + wn * kWarpN + n * 8 + tq * 2;
      if (o >= p.N) continue;  // N is even: o + 1 < N
      if (k < p.M)
        *reinterpret_cast<float2*>(out + (size_t)k * p.N + o) =
            make_float2(acc[m][n][0], acc[m][n][1]);
      if (k + 8 < p.M)
        *reinterpret_cast<float2*>(out + (size_t)(k + 8) * p.N + o) =
            make_float2(acc[m][n][2], acc[m][n][3]);
    }
}

// Launches tn_mma on `st`; rows_per_split is rounded up to kGK.
template <bool kNorm>
cudaError_t launch_tn_mma(TnArgs p, int items, int splits, cudaStream_t st) {
  // set on every launch: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      tn_mma<kNorm>, cudaFuncAttributeMaxDynamicSharedMemorySize, kGSmem);
  if (err != cudaSuccess) return err;
  p.rows_per_split = (p.rows_per_split + kGK - 1) / kGK * kGK;
  p.m_tiles = (p.M + kGM - 1) / kGM;
  dim3 grid((p.N + kGN - 1) / kGN, p.m_tiles * items, splits);
  tn_mma<kNorm><<<grid, kGThreads, kGSmem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace coot
