// B1: fused input projection y = act(cootnorm(x; gain, bias) . W + b),
// forward and backward.
//
// Replaces the TPU kernel coot_videotext_tpu/ops/pallas_input_fc.py::
// fused_input_fc (_fwd_kernel :153, _bwd_kernel :167).
//
// What bounds it on the H100. The four calls of a yc2_2d3d_coot train step
// (x rows x din -> dout = 384): the clips 66,560 x 4096, the video global
// net 5,120 x 4096, the paragraph 20,480 x 1536 and the sentences 19,968 x
// 1536. Each does 2*S*din*dout flops against ~2*S*din bytes of x, i.e.
// dout = 384 flops per byte of x, just above the card's bf16 ridge (989
// TF/s over 3.35 TB/s, ~295 flops per byte): the product and the stream of
// x bound each half about equally, ~0.21 ms at the clips, ~0.016 ms at the
// video global net and ~0.024 ms at each text call. f32 (used on the card
// only by the checks) is bound by the 67 TF/s of the FMA units.
//
// Why the norm is applied before the product. pre = xn . W with xn =
// gain*(x - mean)*inv + bias could be refolded as inv*(x . (gain W)) -
// inv*mean*u + v and the raw x sent to the tensor cores; but the padded
// slots are constant rows (std 0, so inv = 1/eps = 1e6), and there the
// folded form multiplies an f32 cancellation residue by 1e6. So x is
// normalized in shared memory, once per element, before any product, and a
// constant row gives xhat = 0 exactly, as in the plain version.
//
// Forward (bf16), two launches:
//  (a) row_stats: one warp per row, 16 bytes a lane, the shifted sums
//      (shift by the row's first element), the Bessel variance (ddof = 1),
//      the zero-variance guard and 1/(std + eps): eps on the std, as in
//      CootLayerNorm. The vector loads sum in another order than the
//      earlier scalar loop, so mean and inv agree with it to f32 rounding.
//  (b) input_fc_fwd_mma: one block per (128 rows x 192 columns) of y, one
//      block per SM (184 KB of shared memory). Warp-specialized: 4 producer
//      warps fill a 4-stage ring of 64-deep k tiles (x, W, gain and bias)
//      by 16-byte cp.async and, once a tile has landed, normalize it in
//      place (xn = gain*(x - mean)*inv + bias rounded to bf16, where the
//      plain version rounds); 8 consumer warps, 64 rows x 48 columns each,
//      run mma.sync m16n8k16 (bf16 in, f32 accumulate) from ldmatrix
//      fragments, loading the next 16-deep step's fragments while this
//      step's products run. Named barriers (one "full" and one "empty" per
//      stage) hand the stages over. The epilogue goes through shared
//      memory: + b, exact-erf gelu, 16-byte stores of y (bf16) and of the
//      f32 pre-activation `pre` (the TPU kernel's need_pre residual) when
//      the backward needs it. Blocks of one row tile are adjacent in the
//      grid, so x's second read comes from L2. A 64-row variant (two
//      blocks per SM, for the video global net's 40 row tiles) was slower
//      than this one at all four calls on the H100, so there is none.
//      What holds both bf16 products at ~5x their bound: the products
//      (ldmatrix + mma.sync) and the staging (cp.async + the normalizing
//      pass, 4 warps) each take about half of a k tile's time and overlap
//      little. wgmma would read both operands from shared memory (no
//      ldmatrix, W read once per 64-row warpgroup), and TMA would free the
//      producers to normalize only.
// f32 keeps a shared-memory-tiled FMA loop (gemm_f32).
//
// Backward: the input is pipeline data, so, as on the TPU, no dx is formed.
// With dpre = dy * act'(pre) (rounded to the compute dtype) the TPU kernel
// forms dxn = dpre W and sums dgain = sum_r dxn*xhat, dbias = sum_r dxn; here
// one product over the rows gives every parameter gradient:
//   G = xhat^T dpre                     (din x dout, f32, K = S rows)
//   db_o    = sum_r dpre_ro
//   dW_ko   = gain_k G_ko + bias_k db_o  (as xn = gain*xhat + bias)
//   dgain_k = sum_r xhat_rk sum_o dpre_ro W_ok = sum_o W_ok G_ko
//   dbias_k = sum_o W_ok db_o
// so the backward does 2*S*din*dout flops, half the two products, and reads
// x once. Launches:
//  (1) dpre_colsum: dpre in 16-byte vectors and, per block (one row split),
//      the column sums of the rounded dpre; sum_splits adds them in split
//      order into db;
//  (2) tn_mma<true> (bf16, csrc/tn_mma.cuh, shared with B2's backward):
//      one block per (128 of din x 192 of dout, row
//      split), 64 rows a step through a 4-stage cp.async ring, warp-
//      specialized as the forward; x is staged raw and xhat = (x -
//      mean)*inv formed in place once per element (rounded to bf16), then
//      both operands, row-major in memory with the rows as K, come to the
//      tensor cores through ldmatrix.trans. Each block writes its partial
//      tile of G; nothing is transposed in memory.
//      The split count (ops/input_fc.py::backward_splits) fills whole
//      waves of the card; the blocks of one row split run together, so x
//      is read from device memory once and dpre from L2. f32 takes
//      tn_partial<float, true> (csrc/tn_reduce.cuh) with gain 1, bias 0;
//  (3) param_grads: one warp per row k of din sums the partial tiles in
//      split order and writes dW, dgain and dbias, in a fixed order.
// No float atomics anywhere: two backward calls are bit-equal.
// Any S is taken, ragged row, din and dout edges are masked.

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"
#include "tn_mma.cuh"
#include "tn_reduce.cuh"

namespace coot {
namespace {

constexpr int kStatsThreads = 256;  // 8 rows per block, one warp each

template <typename T>
__global__ void __launch_bounds__(kStatsThreads)
row_stats(const T* __restrict__ x, float* __restrict__ mean,
          float* __restrict__ inv, int S, int din, float eps, bool vec) {
  constexpr int kV = 16 / sizeof(T);
  const int row = (blockIdx.x * kStatsThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= S) return;  // whole warp leaves together
  const T* xr = x + (size_t)row * din;
  const float c = to_f32(xr[0]);
  float s1 = 0.f, s2 = 0.f;
  if (vec) {
#pragma unroll 4
    for (int k = lane * kV; k < din; k += 32 * kV) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + k);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const float d = to_f32(v[j]) - c;
        s1 += d;
        s2 += d * d;
      }
    }
  } else {
    for (int k = lane; k < din; k += 32) {
      const float d = to_f32(xr[k]) - c;
      s1 += d;
      s2 += d * d;
    }
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

// ---- bf16 forward on the tensor cores ----
//
// Warp-specialized: producer warps stage the k tiles by cp.async and
// normalize each in place once it has landed; consumer warps (each 64 rows x
// 48 columns of the block's tile) run the products. The two sides hand the
// ring's stages to each other through named barriers, so staging and
// normalizing overlap the tensor cores instead of alternating with them:
//   full[s]  producers arrive once stage s holds a normalized tile,
//            consumers wait on it before multiplying;
//   empty[s] consumers arrive once they are done with stage s, producers
//            wait on it before refilling it (only for a tile that is
//            refilled, so every phase of every barrier completes);
//   loaded   producers only: every producer's copies of a tile have landed.
// (the ring's constants, the barriers and warp_mma live in tn_mma.cuh,
// which the backward's product shares with B2)
constexpr int kLdc = kBN + 8;  // f32 epilogue tile

// One block per 128 rows x 192 columns of y, 64-deep k tiles: 8 consumer
// warps (64 x 48 each) and 4 producer warps.
constexpr int kBM = 128, kBK = 64;
constexpr int kLdk = kBK + 8;  // +8: conflict-free ldmatrix rows
constexpr int kConsumers = 256, kProducers = 128;
constexpr int kThreads = kConsumers + kProducers;
// x (kBM x kLdk) and W (kBN x kLdk) bf16, gain and bias (kBK) f32
constexpr int kStageBytes = 2 * (kBM + kBN) * kLdk + 2 * 4 * kBK;
// + mean, inv (kBM) and b (kBN)
constexpr int kSmem = kStages * kStageBytes + 4 * (2 * kBM + kBN);
static_assert(kBM * kLdc * 4 <= kStages * kStageBytes, "epilogue tile");

__global__ void __launch_bounds__(kThreads, 1)
input_fc_fwd_mma(const bf16* __restrict__ x, const float* __restrict__ mean,
                 const float* __restrict__ inv,
                 const float* __restrict__ gain,
                 const float* __restrict__ bias, const bf16* __restrict__ w,
                 const float* __restrict__ b, bf16* __restrict__ y,
                 float* __restrict__ pre, int S, int din, int dout, int act,
                 int n_tiles) {
  constexpr int kChunks = kBK / 8;  // 16-byte chunks of a staged row
  extern __shared__ __align__(16) unsigned char smem[];
  float* sMean = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  float* sInv = sMean + kBM;
  float* sBo = sInv + kBM;  // b of the block's columns

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = (blockIdx.x / n_tiles) * kBM;
  const int col0 = (blockIdx.x % n_tiles) * kBN;
  const bool vec = din % 8 == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(gain) && aligned16(bias);
  const int KT = (din + kBK - 1) / kBK;

  for (int i = tid; i < kBM; i += kThreads) {
    const int r = row0 + i;
    sMean[i] = r < S ? mean[r] : 0.f;
    sInv[i] = r < S ? inv[r] : 0.f;
  }
  for (int i = tid; i < kBN; i += kThreads)
    sBo[i] = col0 + i < dout ? b[col0 + i] : 0.f;
  __syncthreads();

  auto tile_x = [&](int s) {
    return reinterpret_cast<bf16*>(smem + s * kStageBytes);
  };
  auto tile_w = [&](int s) { return tile_x(s) + kBM * kLdk; };
  auto tile_gain = [&](int s) {
    return reinterpret_cast<float*>(tile_w(s) + kBN * kLdk);
  };

  if (tid >= kConsumers) {  // producer warps
    const int pt = tid - kConsumers;
    auto load = [&](int s, int k0) {
      bf16* sX = tile_x(s);
      bf16* sW = tile_w(s);
      for (int i = pt; i < kBM * kChunks; i += kProducers) {
        const int r = i / kChunks, c = (i % kChunks) * 8;
        const int gr = row0 + r, gk = k0 + c;
        stage8(sX + r * kLdk + c, x + (size_t)gr * din + gk,
               gr < S ? din - gk : 0, vec);
      }
      for (int i = pt; i < kBN * kChunks; i += kProducers) {
        const int n = i / kChunks, c = (i % kChunks) * 8;
        const int gn = col0 + n, gk = k0 + c;
        stage8(sW + n * kLdk + c, w + (size_t)gn * din + gk,
               gn < dout ? din - gk : 0, vec);
      }
      if (pt < kBK / 2) {  // gain, then bias: kBK / 4 chunks of 4 each
        const int c = (pt % (kBK / 4)) * 4;
        const bool is_gain = pt < kBK / 4;
        stage4f(tile_gain(s) + (is_gain ? 0 : kBK) + c,
                (is_gain ? gain : bias) + k0 + c, din - k0 - c, vec);
      }
    };
    // xn = gain * (x - mean) * inv + bias, in place, rounded to bf16; each
    // thread keeps one 8-wide column chunk (its gain and bias in registers)
    auto normalize = [&](int s) {
      bf16* sX = tile_x(s);
      const float* sGain = tile_gain(s);
      const int c = (pt % kChunks) * 8;
      const float4 g0 = *reinterpret_cast<const float4*>(sGain + c);
      const float4 g1 = *reinterpret_cast<const float4*>(sGain + c + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(sGain + kBK + c);
      const float4 b1 = *reinterpret_cast<const float4*>(sGain + kBK + c + 4);
      const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = pt / kChunks; r < kBM; r += kProducers / kChunks) {
        uint4* p = reinterpret_cast<uint4*>(sX + r * kLdk + c);
        uint4 raw = *p;
        uint32_t* v = reinterpret_cast<uint32_t*>(&raw);
        const float m = sMean[r], iv = sInv[r];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = pack_bf16(
              g[2 * j] * ((bf16_lo(v[j]) - m) * iv) + bb[2 * j],
              g[2 * j + 1] * ((bf16_hi(v[j]) - m) * iv) + bb[2 * j + 1]);
        *p = raw;
      }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < KT) load(s, s * kBK);
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<kStages - 2>();  // this thread's copies of tile kt
      bar_sync(kBarLoaded, kProducers);
      normalize(kt % kStages);
      bar_arrive(kBarFull + kt % kStages, kThreads);
      const int next = kt + kStages - 1;  // into the stage of tile kt - 1
      if (next < KT) {
        if (kt >= 1) bar_sync(kBarEmpty + (kt - 1) % kStages, kThreads);
        load(next % kStages, next * kBK);
      }
      cp_async_commit();
    }
    cp_async_wait<0>();
  }

  float acc[4][kNF][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < kNF; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
  const int wm = warp >> 2, wn = warp & 3;  // consumer warps
  if (tid < kConsumers) {
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % kStages;
      bar_sync(kBarFull + s, kThreads);
      warp_mma<kBK, false>(acc, tile_x(s) + wm * 64 * kLdk, kLdk,
                           tile_w(s) + wn * kWarpN * kLdk, kLdk);
      if (kt + kStages < KT) bar_arrive(kBarEmpty + s, kThreads);
    }
  }

  // epilogue through shared memory (the ring is free): + b, act, 16-byte
  // stores of y and pre
  __syncthreads();
  float* sC = reinterpret_cast<float*>(smem);
  if (tid < kConsumers) {
    const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < kNF; ++n) {
        const int r = wm * 64 + m * 16 + gq;
        const int c = wn * kWarpN + n * 8 + tq * 2;
        *reinterpret_cast<float2*>(sC + r * kLdc + c) =
            make_float2(acc[m][n][0], acc[m][n][1]);
        *reinterpret_cast<float2*>(sC + (r + 8) * kLdc + c) =
            make_float2(acc[m][n][2], acc[m][n][3]);
      }
  }
  __syncthreads();
  const bool vec_out = dout % 8 == 0;
  for (int i = tid; i < kBM * (kBN / 8); i += kThreads) {
    const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= S || gc >= dout) continue;
    const float4 c0 = *reinterpret_cast<const float4*>(sC + r * kLdc + c);
    const float4 c1 = *reinterpret_cast<const float4*>(sC + r * kLdc + c + 4);
    float v[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] += sBo[c + j];
    const size_t at = (size_t)gr * dout + gc;
    if (vec_out) {
      if (pre != nullptr) {
        *reinterpret_cast<float4*>(pre + at) =
            make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(pre + at + 4) =
            make_float4(v[4], v[5], v[6], v[7]);
      }
      uint4 out;
      out.x = pack_bf16(activate(v[0], act), activate(v[1], act));
      out.y = pack_bf16(activate(v[2], act), activate(v[3], act));
      out.z = pack_bf16(activate(v[4], act), activate(v[5], act));
      out.w = pack_bf16(activate(v[6], act), activate(v[7], act));
      *reinterpret_cast<uint4*>(y + at) = out;
    } else {
      for (int j = 0; j < 8 && gc + j < dout; ++j) {
        if (pre != nullptr) pre[at + j] = v[j];
        y[at + j] = from_f32<bf16>(activate(v[j], act));
      }
    }
  }
}

cudaError_t launch_fwd_mma(const bf16* x, const float* mean,
                           const float* inv, const float* gain,
                           const float* bias, const bf16* w, const float* b,
                           bf16* y, float* pre, int S, int din, int dout,
                           int act, cudaStream_t st) {
  // set on every launch: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      input_fc_fwd_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (dout + kBN - 1) / kBN;
  const long long blocks = (long long)((S + kBM - 1) / kBM) * n_tiles;
  input_fc_fwd_mma<<<(unsigned)blocks, kThreads, kSmem, st>>>(
      x, mean, inv, gain, bias, w, b, y, pre, S, din, dout, act, n_tiles);
  return cudaGetLastError();
}

// ---- f32 forward: shared-memory-tiled FMA ----
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

constexpr int kDpreThreads = 1024;

// dpre = dy * act'(pre) rounded to T, in 16-byte vectors; partial[block]
// [dout] = column sums of the rounded dpre over the block's rows (one row
// split per block). blockDim = (rows in flight) x dout / (16 / sizeof(T)).
template <typename T>
__global__ void __launch_bounds__(kDpreThreads)
dpre_colsum(const T* __restrict__ dy, const float* __restrict__ pre,
            T* __restrict__ dpre, int S, int dout, int act,
            int rows_per_split, float* __restrict__ partial) {
  constexpr int kV = 16 / sizeof(T);
  __shared__ float sRed[kDpreThreads * kV];
  const int tpr = dout / kV, rp = blockDim.x / tpr;
  const int c = (threadIdx.x % tpr) * kV, ty = threadIdx.x / tpr;
  const int r_begin = blockIdx.x * rows_per_split;
  const int r_end = min(S, r_begin + rows_per_split);
  float acc[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j) acc[j] = 0.f;
#pragma unroll 2
  for (int r = r_begin + ty; r < r_end; r += rp) {
    const size_t at = (size_t)r * dout + c;
    const uint4 graw = *reinterpret_cast<const uint4*>(dy + at);
    const T* g = reinterpret_cast<const T*>(&graw);
    float p[kV];
#pragma unroll
    for (int j = 0; j < kV; j += 4) {
      const float4 pv = *reinterpret_cast<const float4*>(pre + at + j);
      p[j] = pv.x;
      p[j + 1] = pv.y;
      p[j + 2] = pv.z;
      p[j + 3] = pv.w;
    }
    uint4 out;
    T* d = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const float gj = to_f32(g[j]);
      d[j] = from_f32<T>(act == kActGelu ? gj * act_grad(p[j], act) : gj);
      acc[j] += to_f32(d[j]);
    }
    *reinterpret_cast<uint4*>(dpre + at) = out;
  }
#pragma unroll
  for (int j = 0; j < kV; ++j) sRed[ty * dout + c + j] = acc[j];
  __syncthreads();
  for (int o = threadIdx.x; o < dout; o += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < rp; ++t) s += sRed[t * dout + o];
    partial[(size_t)blockIdx.x * dout + o] = s;
  }
}

// One warp per row k of din: G_k = sum of the splits' partial rows (in
// split order), dW_k = gain_k G_k + bias_k db, dgain_k = W[:, k] . G_k,
// dbias_k = W[:, k] . db.
template <typename T>
__global__ void __launch_bounds__(256)
param_grads(const float* __restrict__ partial, int splits,
            const T* __restrict__ w, const float* __restrict__ gain,
            const float* __restrict__ bias, const float* __restrict__ db,
            float* __restrict__ dw, float* __restrict__ dgain,
            float* __restrict__ dbias, int din, int dout) {
  const int k = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (k >= din) return;
  const float gk = gain[k], bk = bias[k];
  const size_t plane = (size_t)din * dout;
  float sg = 0.f, sb = 0.f;
  for (int o = lane; o < dout; o += 32) {
    const size_t at = (size_t)k * dout + o;
    float g = 0.f;
    for (int sp = 0; sp < splits; ++sp) g += partial[sp * plane + at];
    const float dbo = db[o];
    dw[at] = gk * g + bk * dbo;
    const float wv = to_f32(w[(size_t)o * din + k]);
    sg = fmaf(wv, g, sg);
    sb = fmaf(wv, dbo, sb);
  }
  sg = warp_sum(sg);
  sb = warp_sum(sb);
  if (lane == 0) {
    dgain[k] = sg;
    dbias[k] = sb;
  }
}

template <typename T>
int input_fc_bwd_launch(const T* x, const float* gain, const float* bias,
                        const T* w, const float* mean, const float* inv,
                        const float* pre, const T* dy, T* dpre,
                        float* scratch, const float* unit, float* dw,
                        float* db, float* dgain, float* dbias, int S,
                        int din, int dout, int act, int splits,
                        int dpre_splits, cudaStream_t st) {
  constexpr int kV = 16 / sizeof(T);
  if (dout % kV || !aligned16(dy) || !aligned16(pre) || !aligned16(dpre))
    return static_cast<int>(cudaErrorInvalidValue);
  float* pg = scratch;                                   // splits x din x dout
  float* pdb = scratch + (size_t)splits * din * dout;    // dpre_splits x dout
  const int tpr = dout / kV;
  const int threads = (kDpreThreads / tpr) * tpr;
  dpre_colsum<T><<<dpre_splits, threads, 0, st>>>(
      dy, pre, dpre, S, dout, act, split_rows(S, dpre_splits), pdb);
  sum_splits<<<sum_blocks(dout), 256, 0, st>>>(pdb, dpre_splits, dout, db);
  if constexpr (std::is_same<T, bf16>::value) {
    // G = xhat^T dpre: one item, A = x normalized by mean and inv
    TnArgs p{};
    p.a = x;
    p.b = dpre;
    p.mean = mean;
    p.inv = inv;
    p.partial = pg;
    p.p_split = (long long)din * dout;
    p.lda = din;
    p.ldb = dout;
    p.R = S;
    p.M = din;
    p.N = dout;
    p.rows_per_split = split_rows(S, splits);
    const cudaError_t err = launch_tn_mma<true>(p, 1, splits, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    // G through the FMA reduction with gain 1 and bias 0: xn = xhat
    dim3 grid((din + kTnTile - 1) / kTnTile, (dout + kTnTile - 1) / kTnTile,
              splits);
    tn_partial<T, true><<<grid, kTnThreads, 0, st>>>(
        x, din, dpre, dout, S, din, dout, split_rows(S, splits), pg,
        NormA{mean, inv, unit, unit + din});
  }
  param_grads<T><<<(din + 7) / 8, 256, 0, st>>>(
      pg, splits, w, gain, bias, db, dw, dgain, dbias, din, dout);
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
  const float* mn = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(inv);
  if (is_bf16) {
    const bf16* xb = static_cast<const bf16*>(x);
    row_stats<bf16><<<stats_blocks, kStatsThreads, 0, st>>>(
        xb, static_cast<float*>(mean), static_cast<float*>(inv), S, din, eps,
        din % 8 == 0 && aligned16(x));
    return static_cast<int>(launch_fwd_mma(
        xb, mn, iv, static_cast<const float*>(gain),
        static_cast<const float*>(bias), static_cast<const bf16*>(w),
        static_cast<const float*>(b), static_cast<bf16*>(y),
        static_cast<float*>(pre), S, din, dout, act, st));
  }
  row_stats<float><<<stats_blocks, kStatsThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<float*>(mean),
      static_cast<float*>(inv), S, din, eps, din % 4 == 0 && aligned16(x));
  dim3 grid((S + kFBM - 1) / kFBM, (dout + kFBN - 1) / kFBN);
  gemm_f32<<<grid, 256, 0, st>>>(
      static_cast<const float*>(x), mn, iv, static_cast<const float*>(gain),
      static_cast<const float*>(bias), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(y),
      static_cast<float*>(pre), S, din, dout, act);
  return static_cast<int>(cudaGetLastError());
}

// The forward's x, gain, bias, w, mean, inv and pre, and dy (S, dout) in the
// compute dtype (dy, pre and dpre 16-byte aligned). Writes f32 dw (din,
// dout), db (dout), dgain, dbias (din); dpre (S, dout) is compute-dtype
// scratch, `scratch` f32 of splits * din * dout + dpre_splits * dout
// elements; `unit` (f32 only) 2 * din floats, din ones then din zeros. The
// wrapper zero-pads din to a multiple of 64 and dout to one of 16 (and
// checks dout <= 384); splits and dpre_splits come from
// ops/input_fc.py::backward_plan.
extern "C" int coot_input_fc_bwd(const void* x, const void* gain,
                                 const void* bias, const void* w,
                                 const void* mean, const void* inv,
                                 const void* pre, const void* dy, void* dpre,
                                 void* scratch, const void* unit, void* dw,
                                 void* db, void* dgain, void* dbias, int S,
                                 int din, int dout, int act, int splits,
                                 int dpre_splits, int is_bf16,
                                 void* stream) {
  using namespace coot;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gain);
  const float* bi = static_cast<const float*>(bias);
  const float* mn = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(inv);
  const float* pr = static_cast<const float*>(pre);
  float* sc = static_cast<float*>(scratch);
  float* dw_ = static_cast<float*>(dw);
  float* db_ = static_cast<float*>(db);
  float* dg = static_cast<float*>(dgain);
  float* dbi = static_cast<float*>(dbias);
  if (is_bf16)
    return input_fc_bwd_launch<bf16>(
        static_cast<const bf16*>(x), g, bi, static_cast<const bf16*>(w), mn,
        iv, pr, static_cast<const bf16*>(dy), static_cast<bf16*>(dpre), sc,
        nullptr, dw_, db_, dg, dbi, S, din, dout, act, splits, dpre_splits,
        st);
  return input_fc_bwd_launch<float>(
      static_cast<const float*>(x), g, bi, static_cast<const float*>(w), mn,
      iv, pr, static_cast<const float*>(dy), static_cast<float*>(dpre), sc,
      static_cast<const float*>(unit), dw_, db_, dg, dbi, S, din, dout, act,
      splits, dpre_splits, st);
}
