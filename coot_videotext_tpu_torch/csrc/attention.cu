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
// side, 320 for a paragraph, Dh = 48) a cell does 4*Lq*Lk*Dh flops forward
// (10x backward) on (2*Lq + 2*Lk)*Dh elements, ~40 flops per byte at L = 80,
// so the bound is the bytes of q, k, v, o (and g, dq, dk, dv). What a
// straightforward kernel spends its time on is instructions: scalar FMAs
// with both operands from shared memory, one Philox4x32-10 call per element
// of P, S and dP computed again by a second kernel (the earlier scalar
// backward ran at ~55x its bound on the H100).
//
// bf16 forward design (masked_attention_fwd_mma), on the tensor cores: one
// warp per 16 queries of a cell; a block takes a chunk of up to 128
// queries of one cell (balanced: L = 80, 5 warps; L = 320, 3 chunks of 7
// warps), or, where Lq and Lk are at most 32, several cells (at least 4
// warps a block). Per staged block of up to 128 keys (K and V of the
// block's cells by 16-byte cp.async, once per query chunk; the keep mask
// of the (chunk, key block) tile built cooperatively, one Philox call per
// 4 consecutive elements) each warp walks the keys 32 at a time:
//   - S = Q K^T by mma.sync m16n8k16 from ldmatrix fragments (Q's A
//     fragments held in registers for the whole walk), scaled in f32;
//   - an online softmax in registers: the row max reduced over the quad
//     of lanes that holds a row, the accumulator rescaled, the sum kept
//     per lane over P undropped and reduced once at the end;
//   - O += P_d V: P * keep / (1 - rate) rounded to bf16 and fed straight
//     back as the A fragment (the accumulator layout of two 16x8 tiles is
//     the A layout of one 16x16 tile), V's B fragments by ldmatrix.trans.
// Masked keys get the finite fill -32752 and still count, so a row whose
// keys are all masked averages all keys uniformly, as the reference does;
// keys past Lk get -inf (P = 0). With `stats` the row max and 1/sum are
// written for the backward, which then recomputes P exactly.
// float32 inputs (only the checks use them) keep the scalar kernel
// masked_attention_fwd: one block of 4 warps per (cell, 32-query tile),
// K/V in f32 in shared memory, lane j scores key j by FMAs.
//
// Backward (no float atomics, so runs repeat bit for bit):
//   D_i = rowsum(g_i * o_i)  (= rowsum(dP o P) also under dropout)
//   dS  = where(key_valid, P * (dPd * keep/(1-rate) - D), 0), dPd = g v^T
//   dv  = (P keep/(1-rate))^T g, dk = dS^T q * scale, dq = dS k * scale.
// dS is zero at masked keys, as autodiff of the module's where() gives; the
// Pallas _bwd_kernel (:84-89) does not zero it there, which differs on rows
// whose keys are all masked.
//
// bf16 backward design (masked_attention_bwd_mma), one pass on the tensor
// cores: one block per cell, one warp per 16 keys of a key block of up to
// 128 keys (8 warps), the warps balanced over the blocks (L = 80: 5 warps,
// one block; L = 320: 7 warps, blocks of 112). All five products run as
// mma.sync m16n8k16 (bf16 in, f32 accumulate) from ldmatrix fragments:
//   - the cell's K and V rows of the block are staged once (16-byte
//     cp.async) and held as A fragments in registers; queries stream in
//     chunks of up to 128 rows (q, g, row_max, row_inv and D staged once
//     per chunk; with one chunk, once per cell);
//   - per 16 queries a warp forms S^T and dP^T (its keys x 16 queries),
//     then P, P*f and dS in registers, and feeds them straight back as A
//     fragments (the accumulator layout of two 16x8 tiles is the A layout
//     of one 16x16 tile) for dv += (P f)^T g and dk += dS^T q, which stay
//     in registers for the whole block;
//   - dS^T goes to shared memory in bf16 and, once the chunk is done, the
//     warps split dq = dS k over (16 queries x 16 dims) tiles. With one key
//     block (Lk <= 128) dq is written straight out; with more, an f32
//     scratch row of the cell's own (no other block touches it) carries the
//     sum from block to block in a fixed order.
// The keep mask of a (chunk, key block) tile is built cooperatively before
// the products: one Philox call per 4 consecutive elements, one byte per
// element in shared memory (groups that straddle a row when Lk % 4 != 0 are
// drawn once for each row, with the bits of csrc/philox.cuh). P*f and dS
// are rounded to bf16 for their products, as the inputs are; the larger
// error against the plain version is D, formed from the forward's bf16 o
// where the plain version recomputes o in f32. Ragged Lq, Lk
// and Dh are padded with zero rows and columns in shared memory and masked
// out of every output. float32 inputs (only the checks use them) keep the
// scalar kernels (a) masked_attention_bwd_dkdv, one block per (cell, 128
// keys), a lane per key, and (b) masked_attention_bwd_dq, one block per
// (cell, 32 queries).

#include "common.cuh"
#include "mma.cuh"
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

// ---------------- bf16 backward on the tensor cores ----------------

constexpr int kMmaWarps = 8;        // at most 8 warps x 16 keys per block
constexpr int kMmaMaxRows = 16 * kMmaWarps;
constexpr uint8_t kPadKey = 2;      // sValid: 1 valid, 0 masked, 2 past Lk

// Rows [0, rows) of a (., Dh) bf16 matrix into a (prows x kD) shared tile
// of row stride kD + 8 (conflict-free ldmatrix), zero past rows and Dh.
template <int kD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int rows, int prows, int Dh,
                                           bool vec) {
  constexpr int kChunks = kD / 8;
  const bf16 zero = __ushort_as_bfloat16(0);
  for (int i = threadIdx.x; i < prows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    bf16* d = dst + r * (kD + 8) + c;
    if (vec && r < rows && c < Dh) {
      cp_async_16(d, src + (size_t)r * Dh + c);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = (r < rows && c + j < Dh) ? src[(size_t)r * Dh + c + j] : zero;
    }
  }
}

// Elements d and d + 1 of a bf16 row of Dh elements.
__device__ __forceinline__ void store_pair(bf16* row, int d, int Dh,
                                           float a, float b) {
  if ((Dh & 1) == 0 && d + 1 < Dh) {
    *reinterpret_cast<__nv_bfloat162*>(row + d) = __floats2bfloat162_rn(a, b);
  } else {
    if (d < Dh) row[d] = __float2bfloat16_rn(a);
    if (d + 1 < Dh) row[d + 1] = __float2bfloat16_rn(b);
  }
}

struct BwdTiles {
  int bq;  // queries per chunk, a multiple of 16, <= 128
  int bk;  // keys per block: 16 x the block's warps
};

__host__ __device__ __forceinline__ size_t bwd_mma_smem_bytes(int kD,
                                                              BwdTiles t) {
  const size_t ld = kD + 8;
  return 2 * (2 * t.bq * ld + 2 * t.bk * ld + (size_t)t.bk * (t.bq + 8)) +
         sizeof(float) * t.bq * (3 + kD / 8) + t.bk + (size_t)t.bq * t.bk;
}

// Fewest parts of at most kMmaWarps 16-row tiles, tiles split evenly.
int balanced_tiles(int len) {
  const int tiles = (len + 15) / 16;
  const int parts = (tiles + kMmaWarps - 1) / kMmaWarps;
  return (tiles + parts - 1) / parts;
}

// At most 128 registers a thread for Dh <= 48, so that three blocks of 5
// warps (L = 80, ~58 KB of shared memory each) fit on an SM: the kernel is
// bound by latency between its phases, and a third block hides it.
template <int kD>
__global__ void __launch_bounds__(kMmaWarps * 32, kD <= 48 ? 2 : 1)
masked_attention_bwd_mma(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ o,
                         const bf16* __restrict__ g,
                         const uint8_t* __restrict__ key_valid,
                         const float* __restrict__ row_max,
                         const float* __restrict__ row_inv,
                         bf16* __restrict__ dq, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, float* __restrict__ dq_acc,
                         int Lq, int Lk, int Dh, int num_heads, float scale,
                         DropParams drop, BwdTiles t) {
  constexpr int kLd = kD + 8, kSteps = kD / 16, kNt = kD / 8,
                kChunks = kD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Bq = t.bq, Bk = t.bk, dld = Bq + 8;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // Bq x kLd
  bf16* sG = sQ + Bq * kLd;                      // Bq x kLd
  bf16* sK = sG + Bq * kLd;                      // Bk x kLd
  bf16* sV = sK + Bk * kLd;                      // Bk x kLd
  bf16* sDsT = sV + Bk * kLd;                    // Bk x dld: dS^T
  float* sM = reinterpret_cast<float*>(sDsT + Bk * dld);  // Bq
  float* sI = sM + Bq;                                     // Bq
  float* sD = sI + Bq;                                     // Bq
  float* sDpart = sD + Bq;                // Bq x kChunks: D's partials
  uint8_t* sValid = reinterpret_cast<uint8_t*>(sDpart + Bq * kChunks);  // Bk
  uint8_t* sKeep = sValid + Bk;                            // Bq x Bk

  const int n = blockIdx.x, b = n / num_heads;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  // ldmatrix row / column offsets of this lane
  const int r8 = lane & 7, hi8 = ((lane >> 3) & 1) * 8, hi16 = (lane >> 4) * 8;
  const size_t koff = (size_t)n * Lk * Dh;
  const bool vec =
      Dh % 8 == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g) |
        reinterpret_cast<uintptr_t>(o)) &
       15) == 0;
  const bool drop_on = drop.thresh != 0u;
  const bool one_chunk = Lq <= Bq, one_block = Lk <= Bk;

  for (int kb = 0; kb < Lk; kb += Bk) {
    const int k_rows = min(Bk, Lk - kb);
    const bool last_block = kb + Bk >= Lk;
    __syncthreads();  // the previous block's K rows are consumed
    stage_rows<kD>(sK, k + koff + (size_t)kb * Dh, k_rows, Bk, Dh, vec);
    stage_rows<kD>(sV, v + koff + (size_t)kb * Dh, k_rows, Bk, Dh, vec);
    for (int i = threadIdx.x; i < Bk; i += blockDim.x)
      sValid[i] = kb + i < Lk ? key_valid[(size_t)b * Lk + kb + i] != 0
                              : kPadKey;

    float dk_acc[kNt][4], dv_acc[kNt][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dk_acc[j][i] = 0.f;
        dv_acc[j][i] = 0.f;
      }
    uint32_t ka[kSteps][4], va[kSteps][4];

    for (int q0 = 0; q0 < Lq; q0 += Bq) {
      const int q_rows = min(Bq, Lq - q0), q_tiles = (q_rows + 15) >> 4;
      const size_t row0 = (size_t)n * Lq + q0;
      if (q0 > 0) __syncthreads();  // the previous chunk is consumed
      if (!one_chunk || kb == 0) {
        stage_rows<kD>(sQ, q + row0 * Dh, q_rows, q_tiles * 16, Dh, vec);
        stage_rows<kD>(sG, g + row0 * Dh, q_rows, q_tiles * 16, Dh, vec);
        // rows past Lq: inv 0 gives P = 0 (their q and g rows are zero)
        for (int i = threadIdx.x; i < q_tiles * 16; i += blockDim.x) {
          sM[i] = i < q_rows ? row_max[row0 + i] : 0.f;
          sI[i] = i < q_rows ? row_inv[row0 + i] : 0.f;
        }
        // D = rowsum(g * o): partial sums of 8 elements, all loads issued
        // at once (a warp per row would wait on each row in turn)
        for (int i = threadIdx.x; i < q_tiles * 16 * kChunks;
             i += blockDim.x) {
          const int r = i / kChunks, c = (i % kChunks) * 8;
          float acc = 0.f;
          if (r < q_rows && c < Dh) {
            const size_t at = (row0 + r) * Dh + c;
            if (vec) {
              const uint4 gv = *reinterpret_cast<const uint4*>(g + at);
              const uint4 ov = *reinterpret_cast<const uint4*>(o + at);
              const uint32_t* gw = reinterpret_cast<const uint32_t*>(&gv);
              const uint32_t* ow = reinterpret_cast<const uint32_t*>(&ov);
#pragma unroll
              for (int j = 0; j < 4; ++j) {  // bf16 pairs, low half first
                acc = fmaf(__uint_as_float(gw[j] << 16),
                           __uint_as_float(ow[j] << 16), acc);
                acc = fmaf(__uint_as_float(gw[j] & 0xffff0000u),
                           __uint_as_float(ow[j] & 0xffff0000u), acc);
              }
            } else {
              for (int j = 0; j < 8 && c + j < Dh; ++j)
                acc = fmaf(to_f32(g[at + j]), to_f32(o[at + j]), acc);
            }
          }
          sDpart[i] = acc;
        }
      }
      if (drop_on) {
        // one Philox call per group of 4 consecutive elements that meets
        // the row's keys [kb, kb + k_rows)
        const int groups = (k_rows >> 2) + 2;
        for (int i = threadIdx.x; i < q_rows * groups; i += blockDim.x) {
          const int r = i / groups;
          const uint64_t e0 = p_index(n, q0 + r, kb, Lq, Lk);
          const uint64_t e1 = e0 + k_rows;
          const uint64_t grp = (e0 >> 2) + (i - r * groups);
          if (grp * 4 >= e1) continue;
          const Philox4 bits = dropout_group(drop.seed, kSiteAttention, grp);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint64_t e = grp * 4 + j;
            if (e >= e0 && e < e1)
              sKeep[r * Bk + (int)(e - e0)] = bits.x[j] >= drop.thresh;
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();
      if (!one_chunk || kb == 0) {
        for (int r = threadIdx.x; r < q_tiles * 16; r += blockDim.x) {
          float acc = 0.f;
#pragma unroll
          for (int c = 0; c < kChunks; ++c) acc += sDpart[r * kChunks + c];
          sD[r] = acc;
        }
        __syncthreads();
      }
      if (q0 == 0) {  // this warp's 16 keys of the block as A fragments
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          const int off = (warp * 16 + r8 + hi8) * kLd + s * 16 + hi16;
          ldsm_x4(ka[s], sK + off);
          ldsm_x4(va[s], sV + off);
        }
      }

      for (int t16 = 0; t16 < q_tiles; ++t16) {
        // S^T = K Q^T and dP^T = V G^T: this warp's keys x 16 queries
        float s_acc[2][4], p_acc[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s_acc[j][i] = 0.f;
            p_acc[j][i] = 0.f;
          }
        const int rows_nt = (t16 * 16 + r8 + hi16) * kLd + hi8;
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          uint32_t bq4[4], bg4[4];
          ldsm_x4(bq4, sQ + rows_nt + s * 16);
          ldsm_x4(bg4, sG + rows_nt + s * 16);
          mma_bf16(s_acc[0], ka[s], bq4[0], bq4[1]);
          mma_bf16(s_acc[1], ka[s], bq4[2], bq4[3]);
          mma_bf16(p_acc[0], va[s], bg4[0], bg4[1]);
          mma_bf16(p_acc[1], va[s], bg4[2], bg4[3]);
        }
        // element (j, i): key gq + 8 (i / 2), query 8 j + 2 tq + i % 2
        float pd[2][4], ds[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int kl = warp * 16 + gq + (i >> 1) * 8;
            const int ql = t16 * 16 + j * 8 + tq * 2 + (i & 1);
            const int valid = sValid[kl];
            float p = 0.f, f = 1.f;
            if (valid != kPadKey) {
              const float sc = valid ? s_acc[j][i] * scale : kMaskFill;
              p = expf(sc - sM[ql]) * sI[ql];
              if (drop_on) f = sKeep[ql * Bk + kl] ? drop.scale : 0.f;
            }
            pd[j][i] = p * f;
            ds[j][i] = valid == 1 ? p * (p_acc[j][i] * f - sD[ql]) : 0.f;
          }
        const uint32_t pa[4] = {pack_bf16(pd[0][0], pd[0][1]),
                                pack_bf16(pd[0][2], pd[0][3]),
                                pack_bf16(pd[1][0], pd[1][1]),
                                pack_bf16(pd[1][2], pd[1][3])};
        const uint32_t da[4] = {pack_bf16(ds[0][0], ds[0][1]),
                                pack_bf16(ds[0][2], ds[0][3]),
                                pack_bf16(ds[1][0], ds[1][1]),
                                pack_bf16(ds[1][2], ds[1][3])};
        // dv += (P f)^T g, dk += dS^T q over these 16 queries
        const int rows_t = (t16 * 16 + r8 + hi8) * kLd + hi16;
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          uint32_t bg4[4], bq4[4];
          ldsm_x4_t(bg4, sG + rows_t + s * 16);
          ldsm_x4_t(bq4, sQ + rows_t + s * 16);
          mma_bf16(dv_acc[2 * s], pa, bg4[0], bg4[1]);
          mma_bf16(dv_acc[2 * s + 1], pa, bg4[2], bg4[3]);
          mma_bf16(dk_acc[2 * s], da, bq4[0], bq4[1]);
          mma_bf16(dk_acc[2 * s + 1], da, bq4[2], bq4[3]);
        }
        bf16* dst = sDsT + (warp * 16 + gq) * dld + t16 * 16 + tq * 2;
        *reinterpret_cast<uint32_t*>(dst) = da[0];
        *reinterpret_cast<uint32_t*>(dst + 8) = da[2];
        *reinterpret_cast<uint32_t*>(dst + 8 * dld) = da[1];
        *reinterpret_cast<uint32_t*>(dst + 8 * dld + 8) = da[3];
      }
      __syncthreads();  // dS^T of the chunk is complete

      // dq (chunk rows) = dS k over the block's keys, in 16 x 16 tiles
      const int k_tiles = (k_rows + 15) >> 4;
      for (int u = warp; u < q_tiles * kSteps; u += nwarps) {
        const int mt = u / kSteps, dp = u % kSteps;
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        if (!one_block && kb > 0) {  // the sum of the earlier key blocks,
                                     // read before the products
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ql = mt * 16 + gq + h * 8;
            if (ql >= q_rows) continue;
            const float* a = dq_acc + (row0 + ql) * Dh;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int d = dp * 16 + j * 8 + tq * 2;
              if (d < Dh) acc[j][2 * h] = a[d];
              if (d + 1 < Dh) acc[j][2 * h + 1] = a[d + 1];
            }
          }
        }
        for (int ks = 0; ks < k_tiles; ++ks) {
          uint32_t a4[4], b4[4];
          ldsm_x4_t(a4, sDsT + (ks * 16 + r8 + hi16) * dld + mt * 16 + hi8);
          ldsm_x4_t(b4, sK + (ks * 16 + r8 + hi8) * kLd + dp * 16 + hi16);
          mma_bf16(acc[0], a4, b4[0], b4[1]);
          mma_bf16(acc[1], a4, b4[2], b4[3]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ql = mt * 16 + gq + h * 8;
          if (ql >= q_rows) continue;
          const size_t row = (row0 + ql) * Dh;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int d = dp * 16 + j * 8 + tq * 2;
            const float x0 = acc[j][2 * h], x1 = acc[j][2 * h + 1];
            if (!last_block) {  // the cell's own f32 rows, block by block
              if (d < Dh) dq_acc[row + d] = x0;
              if (d + 1 < Dh) dq_acc[row + d + 1] = x1;
            } else {
              store_pair(dq + row, d, Dh, x0 * scale, x1 * scale);
            }
          }
        }
      }
    }

#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = kb + warp * 16 + gq + h * 8;
        if (key >= Lk) continue;
        const size_t row = koff + (size_t)key * Dh;
        const int d = nt * 8 + tq * 2;
        store_pair(dk + row, d, Dh, dk_acc[nt][2 * h] * scale,
                   dk_acc[nt][2 * h + 1] * scale);
        store_pair(dv + row, d, Dh, dv_acc[nt][2 * h],
                   dv_acc[nt][2 * h + 1]);
      }
  }
}

template <int kD>
cudaError_t launch_bwd_mma(const bf16* q, const bf16* k, const bf16* v,
                           const bf16* o, const bf16* g, const uint8_t* kv,
                           const float* rm, const float* ri, bf16* dq,
                           bf16* dk, bf16* dv, float* dq_acc, int N, int Lq,
                           int Lk, int Dh, int num_heads, float scale,
                           DropParams drop, cudaStream_t st) {
  // the largest tile, set on every launch: the attribute belongs to the
  // current device
  const cudaError_t err = cudaFuncSetAttribute(
      masked_attention_bwd_mma<kD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(
          bwd_mma_smem_bytes(kD, BwdTiles{kMmaMaxRows, kMmaMaxRows})));
  if (err != cudaSuccess) return err;
  const int warps = balanced_tiles(Lk);
  const BwdTiles t{16 * balanced_tiles(Lq), 16 * warps};
  if (Lk > t.bk && dq_acc == nullptr) return cudaErrorInvalidValue;
  masked_attention_bwd_mma<kD><<<N, warps * 32, bwd_mma_smem_bytes(kD, t),
                                 st>>>(q, k, v, o, g, kv, rm, ri, dq, dk, dv,
                                       dq_acc, Lq, Lk, Dh, num_heads, scale,
                                       drop, t);
  return cudaGetLastError();
}

// ---------------- bf16 forward on the tensor cores ----------------

struct FwdTiles {
  int bq;     // queries per chunk, a multiple of 16
  int bk;     // keys per staged block, a multiple of 32
  int cells;  // cells per block (bq / 16 warps each)
};

__host__ __device__ __forceinline__ size_t fwd_mma_smem_bytes(int kD,
                                                              FwdTiles t,
                                                              bool drop) {
  const size_t ld = kD + 8;
  return 2 * ld * t.cells * (t.bq + 2 * (size_t)t.bk) +
         (size_t)t.cells * t.bk +
         (drop ? (size_t)t.cells * t.bq * t.bk : 0);
}

template <int kD>
__global__ void __launch_bounds__(kMmaWarps * 32, 2)
masked_attention_fwd_mma(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const uint8_t* __restrict__ key_valid,
                         bf16* __restrict__ o, float* __restrict__ row_max,
                         float* __restrict__ row_inv, int N, int Lq, int Lk,
                         int Dh, int num_heads, float scale, DropParams drop,
                         FwdTiles t) {
  constexpr int kLd = kD + 8, kSteps = kD / 16, kNt = kD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Bq = t.bq, Bk = t.bk, C = t.cells;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);       // C x Bq x kLd
  bf16* sK = sQ + C * Bq * kLd;                       // C x Bk x kLd
  bf16* sV = sK + C * Bk * kLd;                       // C x Bk x kLd
  uint8_t* sValid = reinterpret_cast<uint8_t*>(sV + C * Bk * kLd);  // C x Bk
  uint8_t* sKeep = sValid + C * Bk;                   // C x Bq x Bk

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  // ldmatrix row / column offsets of this lane
  const int r8 = lane & 7, hi8 = ((lane >> 3) & 1) * 8, hi16 = (lane >> 4) * 8;
  const int wpc = Bq / 16;                      // warps per cell
  const int cl = warp / wpc, t16 = warp % wpc;  // this warp's cell, queries
  const int n0 = blockIdx.x * C, n = n0 + cl;
  const int q0 = blockIdx.y * Bq, q_rows = min(Bq, Lq - q0);
  const bool active = n < N && t16 * 16 < q_rows;  // warp-uniform
  const bool vec =
      Dh % 8 == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) &
       15) == 0;
  const bool drop_on = drop.thresh != 0u;
  const bf16* sQw = sQ + (cl * Bq + t16 * 16) * kLd;
  const bf16* sKc = sK + cl * Bk * kLd;
  const bf16* sVc = sV + cl * Bk * kLd;
  const uint8_t* sValc = sValid + cl * Bk;
  const uint8_t* sKeepw = sKeep + (cl * Bq + t16 * 16) * Bk;

  for (int c = 0; c < C && n0 + c < N; ++c)
    stage_rows<kD>(sQ + c * Bq * kLd, q + ((size_t)(n0 + c) * Lq + q0) * Dh,
                   q_rows, Bq, Dh, vec);

  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  float o_acc[kNt][4];
#pragma unroll
  for (int j = 0; j < kNt; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o_acc[j][i] = 0.f;
  uint32_t qa[kSteps][4];

  for (int kb = 0; kb < Lk; kb += Bk) {
    const int k_rows = min(Bk, Lk - kb), subs = (k_rows + 31) >> 5;
    if (kb > 0) __syncthreads();  // the previous key block is consumed
    for (int c = 0; c < C && n0 + c < N; ++c) {
      const size_t at = ((size_t)(n0 + c) * Lk + kb) * Dh;
      stage_rows<kD>(sK + c * Bk * kLd, k + at, k_rows, subs * 32, Dh, vec);
      stage_rows<kD>(sV + c * Bk * kLd, v + at, k_rows, subs * 32, Dh, vec);
    }
    for (int i = threadIdx.x; i < C * Bk; i += blockDim.x) {
      const int c = i / Bk, j = i - c * Bk;
      sValid[i] = n0 + c < N && j < k_rows
                      ? key_valid[(size_t)((n0 + c) / num_heads) * Lk + kb +
                                  j] != 0
                      : kPadKey;
    }
    if (drop_on) {
      // one Philox call per group of 4 consecutive elements that meets
      // a row's keys [kb, kb + k_rows)
      const int groups = (k_rows >> 2) + 2;
      for (int i = threadIdx.x; i < C * q_rows * groups; i += blockDim.x) {
        const int cr = i / groups, c = cr / q_rows, r = cr - c * q_rows;
        if (n0 + c >= N) continue;
        const uint64_t e0 = p_index(n0 + c, q0 + r, kb, Lq, Lk);
        const uint64_t e1 = e0 + k_rows;
        const uint64_t grp = (e0 >> 2) + (i - cr * groups);
        if (grp * 4 >= e1) continue;
        const Philox4 bits = dropout_group(drop.seed, kSiteAttention, grp);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint64_t e = grp * 4 + j;
          if (e >= e0 && e < e1)
            sKeep[(c * Bq + r) * Bk + (int)(e - e0)] =
                bits.x[j] >= drop.thresh;
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if (!active) continue;
    if (kb == 0) {  // this warp's 16 queries as A fragments
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        ldsm_x4(qa[s], sQw + (r8 + hi8) * kLd + s * 16 + hi16);
    }
    for (int sb = 0; sb < subs; ++sb) {
      // S: 16 queries x 32 keys; element (j, e): query gq + 8 (e / 2),
      // key 8 j + 2 tq + e % 2 of the 32
      float s_acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s_acc[j][e] = 0.f;
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t b4[4];
          ldsm_x4(b4, sKc + (sb * 32 + h * 16 + r8 + hi16) * kLd + s * 16 +
                          hi8);
          mma_bf16(s_acc[2 * h], qa[s], b4[0], b4[1]);
          mma_bf16(s_acc[2 * h + 1], qa[s], b4[2], b4[3]);
        }
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int valid = sValc[sb * 32 + 8 * j + 2 * tq + (e & 1)];
          const float sc = valid == kPadKey ? -INFINITY
                           : valid        ? s_acc[j][e] * scale
                                          : kMaskFill;
          s_acc[j][e] = sc;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = expf(m_r[h] - mx[h]);  // 0 on the first keys
        m_r[h] = mx[h];
        l_r[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        o_acc[j][0] *= alpha[0];
        o_acc[j][1] *= alpha[0];
        o_acc[j][2] *= alpha[1];
        o_acc[j][3] *= alpha[1];
      }
      // P (its sum undropped), then P * keep / (1 - rate) in place
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s_acc[j][e] - m_r[e >> 1]);
          l_r[e >> 1] += p;
          float f = 1.f;
          if (drop_on)
            f = sKeepw[(gq + 8 * (e >> 1)) * Bk + sb * 32 + 8 * j + 2 * tq +
                       (e & 1)]
                    ? drop.scale
                    : 0.f;
          s_acc[j][e] = p * f;
        }
      // O += P_d V over the 32 keys, two 16-deep steps
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s_acc[2 * kk][0], s_acc[2 * kk][1]),
            pack_bf16(s_acc[2 * kk][2], s_acc[2 * kk][3]),
            pack_bf16(s_acc[2 * kk + 1][0], s_acc[2 * kk + 1][1]),
            pack_bf16(s_acc[2 * kk + 1][2], s_acc[2 * kk + 1][3])};
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          uint32_t b4[4];
          ldsm_x4_t(b4, sVc + (sb * 32 + kk * 16 + r8 + hi8) * kLd + s * 16 +
                            hi16);
          mma_bf16(o_acc[2 * s], pa, b4[0], b4[1]);
          mma_bf16(o_acc[2 * s + 1], pa, b4[2], b4[3]);
        }
      }
    }
  }
  if (!active) return;
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
    inv[h] = 1.f / l_r[h];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ql = t16 * 16 + gq + 8 * h;
    if (ql >= q_rows) continue;
    const size_t row = (size_t)n * Lq + q0 + ql;
#pragma unroll
    for (int j = 0; j < kNt; ++j)
      store_pair(o + row * Dh, 8 * j + 2 * tq, Dh, o_acc[j][2 * h] * inv[h],
                 o_acc[j][2 * h + 1] * inv[h]);
    if (row_max != nullptr && tq == 0) {
      row_max[row] = m_r[h];
      row_inv[row] = inv[h];
    }
  }
}

template <int kD>
cudaError_t launch_fwd_mma(const bf16* q, const bf16* k, const bf16* v,
                           const uint8_t* kv, bf16* o, float* rm, float* ri,
                           int N, int Lq, int Lk, int Dh, int num_heads,
                           float scale, DropParams drop, FwdTiles t,
                           cudaStream_t st) {
  if (t.bq < 16 || t.bq % 16 || t.bk < 32 || t.bk % 32 ||
      t.bk > kMmaMaxRows || t.cells < 1 || t.cells * t.bq > kMmaMaxRows)
    return cudaErrorInvalidValue;
  const size_t smem = fwd_mma_smem_bytes(kD, t, drop.thresh != 0u);
  // set on every launch: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      masked_attention_fwd_mma<kD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + t.cells - 1) / t.cells, (Lq + t.bq - 1) / t.bq);
  masked_attention_fwd_mma<kD><<<grid, t.cells * t.bq / 16 * 32, smem, st>>>(
      q, k, v, kv, o, rm, ri, N, Lq, Lk, Dh, num_heads, scale, drop, t);
  return cudaGetLastError();
}

}  // namespace
}  // namespace coot

// q (N, Lq, Dh), k, v (N, Lk, Dh) in the compute dtype, key_valid (B, Lk)
// uint8 with N = B * num_heads; o (N, Lq, Dh). Dh <= 64 (wrapper-checked).
// row_max, row_inv (N, Lq) f32, or null when the backward is not needed.
// thresh == 0: no dropout. bq, bk, cells: the bf16 kernel's tiles
// (ops/attention.py::forward_plan).
extern "C" int coot_attention_fwd(const void* q, const void* k,
                                  const void* v, const void* key_valid,
                                  void* o, void* row_max, void* row_inv,
                                  int N, int Lq, int Lk, int Dh,
                                  int num_heads, float scale,
                                  unsigned long long seed,
                                  unsigned int thresh, float drop_scale,
                                  int bq, int bk, int cells, int is_bf16,
                                  void* stream) {
  using namespace coot;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DropParams drop{seed, thresh, drop_scale};
  float* rm = static_cast<float*>(row_max);
  float* ri = static_cast<float*>(row_inv);
  const uint8_t* kv = static_cast<const uint8_t*>(key_valid);
  if (is_bf16) {  // Dh padded to a multiple of 16 in shared memory
    const auto launch = Dh <= 16   ? launch_fwd_mma<16>
                        : Dh <= 32 ? launch_fwd_mma<32>
                        : Dh <= 48 ? launch_fwd_mma<48>
                                   : launch_fwd_mma<64>;
    return static_cast<int>(launch(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), kv, static_cast<bf16*>(o), rm, ri, N,
        Lq, Lk, Dh, num_heads, scale, drop, FwdTiles{bq, bk, cells}, st));
  }
  dim3 grid(N, (Lq + kQT - 1) / kQT);
  masked_attention_fwd<float><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), kv, static_cast<float*>(o), rm, ri, Lq,
      Lk, Dh, num_heads, scale, drop);
  return static_cast<int>(cudaGetLastError());
}

// The forward's inputs and residuals (o, row_max, row_inv) and the
// cotangent g (N, Lq, Dh); writes dq, dk, dv in the compute dtype.
// dq_acc: N * Lq * Dh float32 scratch, needed in bf16 when Lk > 128 (the
// dq sum over key blocks), else null.
extern "C" int coot_attention_bwd(const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* g, const void* key_valid,
                                  const void* row_max, const void* row_inv,
                                  void* dq, void* dk, void* dv, void* dq_acc,
                                  int N, int Lq, int Lk, int Dh,
                                  int num_heads, float scale,
                                  unsigned long long seed,
                                  unsigned int thresh, float drop_scale,
                                  int is_bf16, void* stream) {
  using namespace coot;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DropParams drop{seed, thresh, drop_scale};
  const float* rm = static_cast<const float*>(row_max);
  const float* ri = static_cast<const float*>(row_inv);
  const uint8_t* kv = static_cast<const uint8_t*>(key_valid);
  if (is_bf16) {  // Dh padded to a multiple of 16 in shared memory
    const auto launch = Dh <= 16   ? launch_bwd_mma<16>
                        : Dh <= 32 ? launch_bwd_mma<32>
                        : Dh <= 48 ? launch_bwd_mma<48>
                                   : launch_bwd_mma<64>;
    return static_cast<int>(launch(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(o),
        static_cast<const bf16*>(g), kv, rm, ri, static_cast<bf16*>(dq),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        static_cast<float*>(dq_acc), N, Lq, Lk, Dh, num_heads, scale, drop,
        st));
  }
  const size_t smem = dkdv_smem_bytes();
  dim3 grid_kv(N, (Lk + kBwdKeys - 1) / kBwdKeys);
  dim3 grid_q(N, (Lq + kQT - 1) / kQT);
  {
    const cudaError_t err = cudaFuncSetAttribute(
        masked_attention_bwd_dkdv<float>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
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
