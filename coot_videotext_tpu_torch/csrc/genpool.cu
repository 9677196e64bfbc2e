// B2: GenPool, forward and backward:
//   h1  = act(dropout(f . w1 + b1))                        (S, L, H)
//   lg  = fill(dropout(h1 . w2_blk + b2), -32752)          (S, L, D)
//   out = sum_L f * dropout(softmax_L(lg))                 (S, D)
//
// Replaces the TPU kernel coot_videotext_tpu/ops/pallas_genpool.py::
// fused_genpool (_fwd_kernel :190, _bwd_kernel :202, _recompute :149). The
// three dropout sites (hidden pre-activation, second projection, softmax
// weights) draw Philox bits of their element's row-major index in the
// (S*L, H), (S*L, D) and (S, L, D) tensors (csrc/philox.cuh), so the
// backward regenerates the forward's masks whatever its grid.
//
// What bounds it on the H100: per pooled row, 2*L*D*H + 2*L*H*D/heads flops
// forward (about 2.5x that backward) against L*D input elements (~1150
// flops per bf16 byte at D=384, H=768, 2 heads), so it is compute-bound on
// the tensor cores.
//
// Forward, bf16 (for Hopper): two passes. genpool_fwd_tiles is the
// backward tile pass's pass A with another epilogue (design note above
// it): flat tiles of 64 of the S*L rows, the weights staged once per tile
// through a cp.async ring into mma.sync, h1 kept in shared memory, and
// the masked, dropped logits written out in f32. genpool_pool then takes
// the softmax over L per (pooled row, column) in f32 and the weighted sum
// of f, and with `stats` writes the column max, the sum and the f32
// pooled row for the backward. Masked rows get the finite fill -32752 and
// still count, so an all-masked row pools to the uniform average exactly
// as the reference does. What bounds it: 2*rows*(D*H + H*D/heads) flops
// on the tensor cores (0.060 ms at the clips call, 66,560 rows at D 384,
// H 768, 2 heads) against f read once (~768 B a row).
//
// Forward, f32 (only the checks use it): one block per pooled row s walks
// the sequence in chunks of 16 rows; the 16 x H hidden activations and
// the 16 x D logits never leave the SM; the products are FMA loops
// (`chunk_mm`). The second product uses the block-diagonal structure:
// the output columns of head h only read head h's slice of the hidden
// activations, so the zero blocks of w2 are never touched and w2 is
// passed head-stacked (heads, dh, dho); the output column order stays
// [h*dho + o]. The softmax over the sequence is online (flash-style), per
// output column: a running max, a running sum of e and a running sum of
// e * keep3 * f, so one pass covers any L.
//
// Backward, bf16 (for Hopper): genpool_bwd_tiles, a fused pass over
// flat tiles of 64 of the S*L rows (design note above the kernel), writes
// df, h1, dpre1 and dh2; tn_mma<false> (csrc/tn_mma.cuh, B1's tensor-core
// product made generic) forms dw1 = f^T dpre1, dw2[h] = h1[:, h]^T dh2[:, h]
// and, in its producer warps, db1 and db2, over row splits summed in split
// order. What bounds it: 6 * rows * (D*H + H*D/heads) flops (3 * 2.65 Mflop
// per row at D 384, H 768, 2 heads) on the tensor cores, ~0.18 ms at the
// clips call (66,560 rows), against ~9 KB a row of device memory (f, df,
// h1, dpre1, dh2 once each way).
//
// Backward, f32: (1) one block per pooled row recomputes the chunk
// as the forward does and, with the saved softmax statistics, forms
//   dsm = dout * f * keep3,  dlg = valid ? sm * (dsm - dout * out) : 0,
//   dh2 = dlg * keep2,  dpre1 = (dh2 . w2_blk^T) * act'(h1_in) * keep1,
//   df  = dout * sm * keep3 + dpre1 . w1^T,
// all in shared memory (the last two products again in chunk_mm); it
// writes df, and h1, dh2 and dpre1 for (2): the weight gradients dw1 =
// f^T dpre1, dw2[h] = h1[:, h]^T dh2[:, h], db1, db2 are sums over all S*L
// rows, made by the deterministic split reductions of csrc/tn_reduce.cuh.

#include <algorithm>

#include "common.cuh"
#include "mma.cuh"
#include "philox.cuh"
#include "tn_mma.cuh"
#include "tn_reduce.cuh"

namespace coot {
namespace {

constexpr int kCh = 16;  // sequence rows per chunk
constexpr int kWarps = 8, kThreads = kWarps * 32;
constexpr int kMaxCols = 4;  // D <= 4 * 256 columns owned per thread
// ops/philox.py SITE_GENPOOL_*
constexpr uint32_t kSiteHidden = 2, kSiteLogits = 3, kSiteWeights = 4;

struct Dims {
  int S, L, D, H, heads, dh, dho, act;
};

// Shared-memory buffers of one block (the f32 kernels); float buffers
// first.
template <typename T>
struct Buffers {
  float* log;  // kCh x ldl: logits, then (backward) the df term dout*smd
  float* fac;  // kCh x ldh (backward): act'(h1_in) * keep1 / (1 - rate)
  T* f;        // kCh x ldf: the chunk of f
  T* h;        // kCh x ldh: h1, then (backward) dpre1
  T* dh2;      // kCh x ldf (backward)
  uint8_t* mask;
  int ldf, ldh, ldl;
};

template <typename T>
__host__ __device__ size_t buffer_bytes(const Dims& p, bool bwd) {
  const size_t ldf = p.D + 8, ldh = p.H + 8, ldl = p.D + 4;
  size_t n = sizeof(float) * kCh * ldl +
             sizeof(T) * (kCh * ldf + kCh * ldh) + 32;
  if (bwd) n += sizeof(float) * kCh * ldh + sizeof(T) * kCh * ldf;
  return n;
}

template <typename T>
__device__ Buffers<T> carve(unsigned char* smem, const Dims& p, bool bwd) {
  Buffers<T> b;
  b.ldf = p.D + 8;
  b.ldh = p.H + 8;
  b.ldl = p.D + 4;
  float* fp = reinterpret_cast<float*>(smem);
  b.log = fp;
  fp += kCh * b.ldl;
  b.fac = nullptr;
  if (bwd) {
    b.fac = fp;
    fp += kCh * b.ldh;
  }
  T* tp = reinterpret_cast<T*>(fp);
  b.f = tp;
  tp += kCh * b.ldf;
  b.h = tp;
  tp += kCh * b.ldh;
  b.dh2 = nullptr;
  if (bwd) {
    b.dh2 = tp;
    tp += kCh * b.ldf;
  }
  b.mask = reinterpret_cast<uint8_t*>(tp);
  return b;
}

// C[r][c] = sum_k A[r][k] * B(k, c) for the kCh rows of a chunk, with
// B(k, c) = B[k*ldb + c] (row-major) or B[c*ldb + k] (col-major); epi(r,
// c, value) receives every result once. FMA, threads owning columns.
template <typename T, bool kColMajorB, typename Epi>
__device__ __forceinline__ void chunk_mm(const T* sA, int lda, const T* B,
                                         int ldb, int K, int N, Epi epi) {
  for (int c = threadIdx.x; c < N; c += kThreads) {
    float acc[kCh];
#pragma unroll
    for (int r = 0; r < kCh; ++r) acc[r] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float w = to_f32(kColMajorB ? B[(size_t)c * ldb + k]
                                        : B[(size_t)k * ldb + c]);
#pragma unroll
      for (int r = 0; r < kCh; ++r)
        acc[r] = fmaf(to_f32(sA[r * lda + k]), w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kCh; ++r) epi(r, c, acc[r]);
  }
}

template <typename T>
__device__ __forceinline__ void load_chunk(const Dims& p, const T* fs,
                                           const uint8_t* ms, int l0,
                                           const Buffers<T>& sb) {
  for (int i = threadIdx.x; i < kCh * p.D; i += kThreads) {
    const int r = i / p.D, d = i % p.D;
    sb.f[r * sb.ldf + d] = (l0 + r < p.L) ? fs[(size_t)(l0 + r) * p.D + d]
                                          : from_f32<T>(0.f);
  }
  if (threadIdx.x < kCh)
    sb.mask[threadIdx.x] =
        (l0 + threadIdx.x < p.L) ? ms[l0 + threadIdx.x] : 0;
}

// h1 = act(dropout(f . w1 + b1)) into sb.h; the backward also keeps the
// factor act'(h1_in) * keep1 / (1 - rate) and writes h1 of the real rows.
template <typename T>
__device__ __forceinline__ void hidden(const Dims& p, const Buffers<T>& sb,
                                       const T* w1, const float* b1, int s,
                                       int l0, const DropParams& drop,
                                       T* h1_out) {
  chunk_mm<T, false>(sb.f, sb.ldf, w1, p.H, p.D, p.H,
                     [&](int r, int c, float v) {
    const uint64_t e = ((uint64_t)s * p.L + l0 + r) * p.H + c;
    const float f1 = dropout_factor(drop, kSiteHidden, e);
    const float hin = (v + b1[c]) * f1;
    const T h = from_f32<T>(activate(hin, p.act));
    sb.h[r * sb.ldh + c] = h;
    if (sb.fac != nullptr) {
      sb.fac[r * sb.ldh + c] = act_grad(hin, p.act) * f1;
      if (l0 + r < p.L) h1_out[((size_t)s * p.L + l0 + r) * p.H + c] = h;
    }
  });
}

// logits without b2 (h1 . w2_blk, per head) into sb.log
template <typename T>
__device__ __forceinline__ void logits(const Dims& p, const Buffers<T>& sb,
                                       const T* w2) {
  for (int hh = 0; hh < p.heads; ++hh) {
    float* out = sb.log + hh * p.dho;
    chunk_mm<T, false>(sb.h + hh * p.dh, sb.ldh,
                       w2 + (size_t)hh * p.dh * p.dho, p.dho, p.dh, p.dho,
                       [&](int r, int c, float v) {
      out[r * sb.ldl + c] = v;
    });
  }
}

// the masked, dropped logit of chunk row r, column d (f2: its dropout
// factor)
template <typename T>
__device__ __forceinline__ float logit(const Dims& p, const Buffers<T>& sb,
                                       int r, int d, float bd, int s,
                                       int l0, const DropParams& drop,
                                       float* f2) {
  *f2 = dropout_factor(drop, kSiteLogits,
                       ((uint64_t)s * p.L + l0 + r) * p.D + d);
  return sb.mask[r] ? (sb.log[r * sb.ldl + d] + bd) * *f2 : kMaskFill;
}

__device__ __forceinline__ uint64_t weight_index(const Dims& p, int s,
                                                 int l, int d) {
  return ((uint64_t)s * p.L + l) * p.D + d;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
genpool_fwd(const T* __restrict__ f, const uint8_t* __restrict__ mask,
            const T* __restrict__ w1, const float* __restrict__ b1,
            const T* __restrict__ w2, const float* __restrict__ b2,
            T* __restrict__ out, float* __restrict__ stats, Dims p,
            DropParams drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Buffers<T> sb = carve<T>(smem, p, false);
  const int s = blockIdx.x;
  const T* fs = f + (size_t)s * p.L * p.D;
  const uint8_t* ms = mask + (size_t)s * p.L;
  float m[kMaxCols], l[kMaxCols], acc[kMaxCols];
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
    acc[j] = 0.f;
  }

  for (int l0 = 0; l0 < p.L; l0 += kCh) {
    load_chunk(p, fs, ms, l0, sb);
    __syncthreads();
    hidden(p, sb, w1, b1, s, l0, drop, static_cast<T*>(nullptr));
    __syncthreads();
    logits(p, sb, w2);
    __syncthreads();
    const int rows = min(kCh, p.L - l0);
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      const int d = threadIdx.x + j * kThreads;
      if (d >= p.D) break;
      const float bd = b2[d];
      float cmax = -INFINITY;
      for (int r = 0; r < rows; ++r) {
        float f2;
        const float lg = logit(p, sb, r, d, bd, s, l0, drop, &f2);
        sb.log[r * sb.ldl + d] = lg;  // this thread owns column d
        cmax = fmaxf(cmax, lg);
      }
      const float m_new = fmaxf(m[j], cmax);
      const float scale = expf(m[j] - m_new);  // 0 on the first chunk
      float ls = l[j] * scale, as = acc[j] * scale;
      for (int r = 0; r < rows; ++r) {
        const float e = expf(sb.log[r * sb.ldl + d] - m_new);
        const float f3 = dropout_factor(drop, kSiteWeights,
                                        weight_index(p, s, l0 + r, d));
        ls += e;
        as = fmaf(e * f3, to_f32(sb.f[r * sb.ldf + d]), as);
      }
      m[j] = m_new;
      l[j] = ls;
      acc[j] = as;
    }
    __syncthreads();
  }
  const size_t sd = (size_t)p.S * p.D;
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    const int d = threadIdx.x + j * kThreads;
    if (d >= p.D) break;
    const size_t i = (size_t)s * p.D + d;
    const float pooled = acc[j] / l[j];
    out[i] = from_f32<T>(pooled);
    if (stats != nullptr) {
      stats[i] = m[j];
      stats[sd + i] = l[j];
      stats[2 * sd + i] = pooled;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
genpool_bwd_rows(const T* __restrict__ f, const uint8_t* __restrict__ mask,
                 const T* __restrict__ w1, const float* __restrict__ b1,
                 const T* __restrict__ w2, const float* __restrict__ b2,
                 const float* __restrict__ stats, const T* __restrict__ dout,
                 T* __restrict__ df, T* __restrict__ h1_out,
                 T* __restrict__ dpre_out, T* __restrict__ dh2_out, Dims p,
                 DropParams drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Buffers<T> sb = carve<T>(smem, p, true);
  const int s = blockIdx.x;
  const T* fs = f + (size_t)s * p.L * p.D;
  const uint8_t* ms = mask + (size_t)s * p.L;
  const size_t sd = (size_t)p.S * p.D;
  float cm[kMaxCols], cl[kMaxCols], go[kMaxCols], cc[kMaxCols];
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    const int d = threadIdx.x + j * kThreads;
    if (d < p.D) {
      const size_t i = (size_t)s * p.D + d;
      cm[j] = stats[i];
      cl[j] = stats[sd + i];
      go[j] = to_f32(dout[i]);
      cc[j] = go[j] * stats[2 * sd + i];  // rowsum(dsm * sm)
    }
  }

  for (int l0 = 0; l0 < p.L; l0 += kCh) {
    load_chunk(p, fs, ms, l0, sb);
    __syncthreads();
    hidden(p, sb, w1, b1, s, l0, drop, h1_out);
    __syncthreads();
    logits(p, sb, w2);
    __syncthreads();
    const int rows = min(kCh, p.L - l0);
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      const int d = threadIdx.x + j * kThreads;
      if (d >= p.D) break;
      const float bd = b2[d];
      for (int r = 0; r < kCh; ++r) {
        float term1 = 0.f, dh2 = 0.f;
        if (r < rows) {
          float f2;
          const float lg = logit(p, sb, r, d, bd, s, l0, drop, &f2);
          const float sm = expf(lg - cm[j]) / cl[j];
          const uint64_t e = weight_index(p, s, l0 + r, d);
          const float f3 = dropout_factor(drop, kSiteWeights, e);
          const float dsm = go[j] * to_f32(sb.f[r * sb.ldf + d]) * f3;
          term1 = go[j] * sm * f3;
          const float dlg = sb.mask[r] ? sm * (dsm - cc[j]) : 0.f;
          dh2 = dlg * f2;
        }
        const T dh2c = from_f32<T>(dh2);
        sb.log[r * sb.ldl + d] = term1;
        sb.dh2[r * sb.ldf + d] = dh2c;
        if (r < rows) dh2_out[weight_index(p, s, l0 + r, d)] = dh2c;
      }
    }
    __syncthreads();
    // dpre1 = (dh2 . w2_blk^T) * act'(h1_in) * keep1, over sb.h (h1 is
    // no longer needed: the logits are done)
    for (int hh = 0; hh < p.heads; ++hh) {
      chunk_mm<T, true>(sb.dh2 + hh * p.dho, sb.ldf,
                        w2 + (size_t)hh * p.dh * p.dho, p.dho, p.dho, p.dh,
                        [&](int r, int c, float v) {
        const int col = hh * p.dh + c;
        const T dp = from_f32<T>(v * sb.fac[r * sb.ldh + col]);
        sb.h[r * sb.ldh + col] = dp;
        if (l0 + r < p.L)
          dpre_out[((size_t)s * p.L + l0 + r) * p.H + col] = dp;
      });
    }
    __syncthreads();
    // df = dout * smd + dpre1 . w1^T
    chunk_mm<T, true>(sb.h, sb.ldh, w1, p.H, p.H, p.D,
                      [&](int r, int c, float v) {
      if (l0 + r < p.L)
        df[((size_t)s * p.L + l0 + r) * p.D + c] =
            from_f32<T>(sb.log[r * sb.ldl + c] + v);
    });
    __syncthreads();
  }
}

// ---- bf16 backward on the tensor cores: flat row tiles ----
//
// Given the forward's stats, every quantity of sequence row r = s*L + l
// (sm, dsm, dlg, dh2, dpre1, df) needs only f[r], mask[r], dout[s] and
// stats[:, s]: the row-coupling sum of the softmax backward is dout * out.
// So genpool_bwd_tiles walks flat tiles of kT rows of the S*L rows, across
// pooled-row boundaries (each row looks up its own s, from stats rows
// staged once per tile), and stages each weight tile once per kT rows
// instead of once per 16. One block of 8 warps per tile of 64 rows:
//   sF  the tile of f (kT x D); sX its dh2; sB one block of 64 hidden
//       units (h1, then dpre1), the A operand of the next product; b1, b2;
//   a 4-stage ring of weight tiles by 16-byte cp.async, one __syncthreads
//   per stage; operands through ldmatrix into mma.sync m16n8k16 (bf16 in,
//   f32 accumulate);
//   the logits, and then df, in registers: one column group of up to 384
//   columns of D, each warp 32 rows x 96 columns.
// Pass A, per head and per block of 64 hidden units:
//   P   pre1 = f . w1[:, blk] (K = D, 128-deep stages), h1 = act(drop(pre1
//       + b1)) rounded into sB and out, and the factor act'(hin) * keep1
//       out in f32 (4 bytes per element each way instead of recomputing
//       pre1 in pass B: 2*rows*D*H flops and D/64 more ring steps a block);
//   L   logits[:, head] += h1 . w2[head][blk, :] (32-deep stages);
//   after the group's last block, the softmax backward on the accumulator
//   fragments: b2, keep2, the fill, sm from the stats, dsm, dlg, dh2
//   (rounded) into sX and out; the accumulator becomes df's first term
//   dout * sm * keep3.
// Pass B, per block: D1 dh1 = dh2[:, head] . w2[head][blk, :]^T (K =
//   dho, 128-deep stages), dpre1 = dh1 * the factor (read back from global
//   by the thread that wrote it in pass A), rounded into sB and out; F df
//   += dpre1 . w1[:, blk]^T (16-deep stages).
// df, h1, dpre1 and dh2 go out from the fragments (4 bytes a thread; L2
// merges the halves of each sector). Dropout draws one Philox call per 4
// elements: the two threads that hold a row's 4 columns each draw one of
// their two rows' groups and swap half of it.
// More than 384 columns (or heads that do not share them evenly) take
// several column groups: pass A runs once per group for dh2, then, per
// group, again for df's first term, and pass B for the group's columns.
// Where shared memory cannot hold a tile of 64 rows (D over about 550),
// tiles of 32 (tile_plan).
// The weight gradients are tall-K products of the tile pass's outputs
// (dw1 = f^T dpre1, dw2[h] = h1[:, h]^T dh2[:, h]) on tn_mma<false>
// (csrc/tn_mma.cuh), whose producers also sum db1 and db2.

constexpr int kTThreads = 256;   // 8 warps
constexpr int kHB = 64;          // hidden units of one block product
constexpr int kTStages = 4;      // the weight ring
constexpr int kGroupUnits = 48;  // n8 units of D in one column group
constexpr int kLdB = kHB + 8;    // sB and the P stages
constexpr int kPK = 128, kOK = 128;  // depth of the P and D1 stages
constexpr int kLdO = kOK + 8;       // the D1 stages ([j][o])
constexpr int kLdF16 = 16 + 8;   // the F stages (16-deep, [d][j])
constexpr int kTStageBytes = kGroupUnits * 8 * kLdF16 * 2;  // the largest

enum StepType : int { kStepP = 0, kStepL = 1, kStepD1 = 2, kStepF = 3 };
enum StepFlag : int {
  kZeroAcc = 1,    // zero the group accumulator first
  kEpiH1 = 2,      // P: h1 into sB (kWriteOut: h1 and act'(hin)*keep1 out)
  kEpiE = 8,       // L: the group's epilogue (the softmax backward; in
                   // genpool_fwd_tiles the logits out)
  kEpiDpre = 16,   // D1: dpre1 into sB
  kEpiDf = 32,     // F: df out
  kWriteOut = 64,  // write h1 and the factor (P), dpre1 or dh2 (E) out
  kTerm1 = 128,    // E: the accumulator becomes dout * sm * keep3
};

struct Step {
  int type, flags, hh, jb, bw, chunk, seg, g;
};

struct TileDims {
  int S, L, D, H, heads, dh, dho, act, R;
  int groups, hpg, parts;  // column groups; heads per group (0: split)
  int staged;              // pooled rows of stats staged per tile
};

// A column group: nseg segments (heads hh0 .. hh0 + nseg - 1, units uo ..
// uo + nu of each, 8 columns a unit); each of the kCW column warps owns U
// consecutive units of each segment.
struct Group {
  int g, hh0, nseg, uo, nu, U, c0, inv;  // inv: s / U == (s * inv) >> 16
  int lk;  // depth of the L stages: 32, or 16 for a segment over 280 wide
};

template <int kCW>
__device__ __forceinline__ Group column_group(const TileDims& p, int g) {
  Group G;
  G.g = g;
  const int units_h = p.dho / 8;
  if (p.hpg > 0) {
    G.hh0 = g * p.hpg;
    G.nseg = min(p.hpg, p.heads - G.hh0);
    G.uo = 0;
    G.nu = units_h;
  } else {
    G.hh0 = g / p.parts;
    G.nseg = 1;
    G.uo = (g % p.parts) * kGroupUnits;
    G.nu = min(kGroupUnits, units_h - G.uo);
  }
  G.U = (G.nu + kCW - 1) / kCW;
  G.inv = (65536 + G.U - 1) / G.U;  // exact for s < 64
  G.lk = 64 * (G.nu * 8 + 8) <= kTStageBytes ? 32 : 16;
  G.c0 = G.hh0 * p.dho + G.uo * 8;
  return G;
}

// slot s of column warp cw: its unit within its segment (-1: none)
__device__ __forceinline__ int slot_unit(const Group& G, int cw, int s,
                                         int* seg) {
  const int j = (s * G.inv) >> 16, unit = cw * G.U + s - j * G.U;
  *seg = j;
  return (j < G.nseg && unit < G.nu) ? unit : -1;
}

// m16 x k16 A fragment at (row0, k0) of a row-major [row][k] tile
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* sA,
                                     int lda, int row0, int k0, int lane) {
  const int r8 = lane & 7, hi8 = ((lane >> 3) & 1) * 8, hi16 = (lane >> 4) * 8;
  ldsm_x4(a, sA + (row0 + r8 + hi8) * lda + k0 + hi16);
}

// k16 x n8 B fragment at (k0, n0): kTrans for a [k][n] tile, else [n][k]
template <bool kTrans>
__device__ __forceinline__ void ld_b8(uint32_t (&b)[2], const bf16* sB,
                                      int ldb, int k0, int n0, int lane) {
  const int r8 = lane & 7, hi8 = ((lane >> 3) & 1) * 8;
  if (kTrans)
    ldsm_x2_t(b, sB + (k0 + r8 + hi8) * ldb + n0);
  else
    ldsm_x2(b, sB + (n0 + r8) * ldb + k0 + hi8);
}

// k16 x n16 (two n8) B fragments at (k0, n0)
template <bool kTrans>
__device__ __forceinline__ void ld_b16(uint32_t (&b)[4], const bf16* sB,
                                       int ldb, int k0, int n0, int lane) {
  const int r8 = lane & 7, hi8 = ((lane >> 3) & 1) * 8, hi16 = (lane >> 4) * 8;
  if (kTrans)
    ldsm_x4_t(b, sB + (k0 + r8 + hi8) * ldb + n0 + hi16);
  else
    ldsm_x4(b, sB + (n0 + r8 + hi16) * ldb + k0 + hi8);
}

// acc (32 rows x 8 * kBN8 columns of a block product) += A[arow0.., ak0..]
// B[.., n0..] over ksteps 16-deep steps
template <int kBN8, bool kTrans>
__device__ __forceinline__ void block_mma(float (&acc)[2][kBN8][4],
                                          const bf16* sA, int lda, int arow0,
                                          int ak0, const bf16* sB, int ldb,
                                          int n0, int ksteps, int lane) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    if (ks >= ksteps) break;
    uint32_t a[2][4];
    ld_a(a[0], sA, lda, arow0, ak0 + 16 * ks, lane);
    ld_a(a[1], sA, lda, arow0 + 16, ak0 + 16 * ks, lane);
    if constexpr (kBN8 == 2) {
      uint32_t b[4];
      ld_b16<kTrans>(b, sB, ldb, 16 * ks, n0, lane);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma_bf16(acc[m][0], a[m], b[0], b[1]);
        mma_bf16(acc[m][1], a[m], b[2], b[3]);
      }
    } else {
      uint32_t b[2];
      ld_b8<kTrans>(b, sB, ldb, 16 * ks, n0, lane);
#pragma unroll
      for (int m = 0; m < 2; ++m) mma_bf16(acc[m][0], a[m], b[0], b[1]);
    }
  }
}

// one 16-deep step of a group product: acc[slot] += A[arow0.., 0..16]
// B[0..16, slot's columns], for the slots of segment `only` (-1: all);
// `seg_local`: B's columns are the segment's units (L), else the group's
// columns (F)
template <int kSlots, bool kTrans>
__device__ __forceinline__ void group_step(float (&acc)[2][kSlots][4],
                                           const bf16* sA, int lda, int arow0,
                                           const bf16* sB, int ldb,
                                           const Group& G, int cw, int only,
                                           bool seg_local, int lane) {
  uint32_t a[2][4];
  ld_a(a[0], sA, lda, arow0, 0, lane);
  ld_a(a[1], sA, lda, arow0 + 16, 0, lane);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    // every slot loads (an idle one column 0), so the loop has no branch
    // around its loads; only the products are predicated
    int seg;
    const int unit = slot_unit(G, cw, s, &seg);
    const bool on = unit >= 0 && (only < 0 || seg == only);
    const int n0 = on ? (seg_local ? unit : seg * G.nu + unit) * 8 : 0;
    uint32_t b[2];
    ld_b8<kTrans>(b, sB, ldb, 0, n0, lane);
    if (on) {
      mma_bf16(acc[0][s], a[0], b[0], b[1]);
      mma_bf16(acc[1][s], a[1], b[0], b[1]);
    }
  }
}

// up to 2 such steps (32 deep)
template <int kSlots, bool kTrans>
__device__ __forceinline__ void group_mma(float (&acc)[2][kSlots][4],
                                          const bf16* sA, int lda, int arow0,
                                          const bf16* sB, int ldb,
                                          const Group& G, int cw, int only,
                                          bool seg_local, int ksteps,
                                          int lane) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    if (ks >= ksteps) break;
    group_step<kSlots, kTrans>(acc, sA + 16 * ks, lda, arow0,
                               kTrans ? sB + 16 * ks * ldb : sB + 16 * ks,
                               ldb, G, cw, only, seg_local, lane);
  }
}


// The keep factors of one fragment's 4 elements, rows (row, row + 8) x
// columns (col, col + 1) of a (rows, W) tensor: .x, .y on row, .z, .w on
// row + 8. col is 2 * tq (mod 4), so the 4 columns of a Philox group lie
// with the thread pair tq, tq ^ 1: each draws the group of one row and
// hands its partner the half it needs. All 32 lanes must call. The
// epilogue helpers below are not inlined: the fragment loops that call
// them unroll over up to 24 fragments, and inlined bodies made the kernel
// larger than the instruction cache (genpool_fwd_tiles inlines this body
// in its epilogue of 4 fragments: the calls cost more than the work).
__device__ __forceinline__ float4 frag_keep_inl(const DropParams d,
                                               uint32_t site, uint64_t row,
                                               int W, int col, int tq) {
  if (d.thresh == 0u) return make_float4(1.f, 1.f, 1.f, 1.f);
  const bool lo = (tq & 1) == 0;
  const uint64_t e = (lo ? row : row + 8) * (uint64_t)W + (col & ~3);
  const Philox4 b = dropout_group(d.seed, site, e >> 2);
  const uint32_t s0 = lo ? b.x[2] : b.x[0], s1 = lo ? b.x[3] : b.x[1];
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  auto f = [&](uint32_t w) { return w >= d.thresh ? d.scale : 0.f; };
  return make_float4(f(lo ? b.x[0] : r0), f(lo ? b.x[1] : r1),
                     f(lo ? r0 : b.x[2]), f(lo ? r1 : b.x[3]));
}

__device__ __noinline__ float4 frag_keep(const DropParams d, uint32_t site,
                                         uint64_t row, int W, int col,
                                         int tq) {
  return frag_keep_inl(d, site, row, W, col, tq);
}

// activate(x) and act_grad(x) (csrc/common.cuh), the gelu's erf shared
__device__ __forceinline__ void act_and_grad(float x, int act, float* y,
                                             float* g) {
  if (act == kActGelu) {
    const float cdf = 0.5f * (1.0f + erff(x * 0.70710678118654752f));
    *y = x * cdf;
    *g = cdf + x * expf(-0.5f * x * x) * 0.39894228040143268f;
  } else {
    *y = activate(x, act);
    *g = act_grad(x, act);
  }
}

struct Frag2 {
  float4 a, b;
};

// The hidden epilogue of one fragment: hin = (pre + b1) * keep1 (0 past
// the block's width, `width` columns from the fragment's first), a =
// act(hin), b = act'(hin) * keep1.
__device__ __noinline__ Frag2 hidden_frag(float4 pre, float4 keep,
                                          const float* b1c, int width,
                                          int act) {
  const float v[4] = {pre.x, pre.y, pre.z, pre.w};
  const float k[4] = {keep.x, keep.y, keep.z, keep.w};
  float h[4], g[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int cj = e & 1;
    const float hin = cj < width ? (v[e] + b1c[cj]) * k[e] : 0.f;
    act_and_grad(hin, act, &h[e], &g[e]);
    g[e] *= k[e];
  }
  return Frag2{make_float4(h[0], h[1], h[2], h[3]),
               make_float4(g[0], g[1], g[2], g[3])};
}

// Where a row's softmax statistics are: staged (go null: max, sum, dout *
// out and dout at st, st + stride, ...) or in place (st = stats + s*D + d,
// stride S*D, go = dout + s*D + d).
struct RowSrc {
  const float* st;
  size_t stride;
  const bf16* go;
  bool valid;
};

// The softmax backward of one fragment (rows lo, hi of its column pair):
// a = dh2 = dlg * keep2, b = df's first term dout * sm * keep3, from the
// raw logits lg (h1 . w2), b2 at b2d, f at f_lo and f_hi.
__device__ __noinline__ Frag2 softmax_frag(float4 lg, float4 k2, float4 k3,
                                           const float* b2d,
                                           const bf16* f_lo, const bf16* f_hi,
                                           RowSrc lo, RowSrc hi) {
  const float raw[4] = {lg.x, lg.y, lg.z, lg.w};
  const float f2[4] = {k2.x, k2.y, k2.z, k2.w};
  const float f3[4] = {k3.x, k3.y, k3.z, k3.w};
  float dh[4], t1[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const RowSrc& r = e < 2 ? lo : hi;
    const int j = e & 1;
    const float mx = r.st[j], sum = r.st[r.stride + j];
    float cc, go;
    if (r.go == nullptr) {
      cc = r.st[2 * r.stride + j];
      go = r.st[3 * r.stride + j];
    } else {
      go = to_f32(r.go[j]);
      cc = go * r.st[2 * r.stride + j];
    }
    const float lgv = r.valid ? (raw[e] + b2d[j]) * f2[e] : kMaskFill;
    const float sm = expf(lgv - mx) / sum;
    const float dsm = go * to_f32((e < 2 ? f_lo : f_hi)[j]) * f3[e];
    t1[e] = go * sm * f3[e];
    dh[e] = r.valid ? sm * (dsm - cc) * f2[e] : 0.f;
  }
  return Frag2{make_float4(dh[0], dh[1], dh[2], dh[3]),
               make_float4(t1[0], t1[1], t1[2], t1[3])};
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// a rows x (8 * chunks) tile into shared memory (row stride lds) from src
// (row stride ld): rows_valid rows of cols_valid values, zeros elsewhere;
// kChunks > 0 fixes the chunks per row at compile time
template <int kThreads, int kChunks>
__device__ __forceinline__ void stage_rect(bf16* dst, int lds,
                                           const bf16* src, int ld, int rows,
                                           int rows_valid, int cols_valid,
                                           int chunks = kChunks) {
  const bool vec = ld % 8 == 0 && aligned16(src);
  if (kChunks > 0) chunks = kChunks;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    stage8(dst + r * lds + c, src + (size_t)r * ld + c,
           r < rows_valid ? cols_valid - c : 0, vec);
  }
}

// shared memory of one tile block: sF, sX (rows x (D + 8)) and sB (rows x
// kLdB) in bf16, the ring, the staged stats (4 x staged x D f32), b1 and
// b2 (f32), the ring's step records and the rows' mask
constexpr size_t tile_smem(int rows, int staged, int D, int H) {
  return (size_t)4 * rows * (D + 8) + (size_t)2 * rows * kLdB +
         (size_t)kTStages * kTStageBytes + (size_t)16 * staged * D +
         (size_t)4 * (H + D) + kTStages * sizeof(Step) + rows;
}

constexpr size_t kSmemLimit = 232448;  // dynamic shared memory of a block
constexpr int kMaxStaged = 4;          // pooled rows of stats staged a tile

// Rows per tile (64, or 32 where shared memory cannot hold 64) and the
// pooled rows of stats staged per tile: the most a tile can meet, at most
// kMaxStaged, as shared memory allows (the rest are read in place).
void tile_plan(const Dims& p, int* rows, int* staged) {
  *rows = tile_smem(64, 0, p.D, p.H) <= kSmemLimit ? 64 : 32;
  *staged = std::min({kMaxStaged, p.S, (*rows - 2) / p.L + 2});
  while (*staged > 0 && tile_smem(*rows, *staged, p.D, p.H) > kSmemLimit)
    --*staged;
}

template <int kT>
__global__ void __launch_bounds__(kTThreads, 1)
genpool_bwd_tiles(const bf16* __restrict__ f, const uint8_t* __restrict__ mask,
                  const bf16* __restrict__ w1, const float* __restrict__ b1,
                  const bf16* __restrict__ w2, const float* __restrict__ b2,
                  const float* __restrict__ stats,
                  const bf16* __restrict__ dout, bf16* __restrict__ df,
                  bf16* __restrict__ h1_out, bf16* __restrict__ dpre_out,
                  bf16* __restrict__ dh2_out, float* __restrict__ fac,
                  TileDims p, DropParams drop) {
  // warps: kRW row warps of 32 rows x kCW column warps
  constexpr int kThreads = kTThreads;
  constexpr int kRW = kT / 32, kCW = kTThreads / 32 / kRW;
  constexpr int kSlots = kGroupUnits / kCW, kBN8 = 8 / kCW;
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = p.D, H = p.H, ldF = D + 8;
  bf16* sF = reinterpret_cast<bf16*>(smem);
  bf16* sX = sF + kT * ldF;
  bf16* sB = sX + kT * ldF;
  unsigned char* ring = reinterpret_cast<unsigned char*>(sB + kT * kLdB);
  float* sStat = reinterpret_cast<float*>(ring + kTStages * kTStageBytes);
  float* sB1 = sStat + 4 * p.staged * D;
  float* sB2 = sB1 + H;
  Step* sDesc = reinterpret_cast<Step*>(sB2 + D);
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sDesc + kTStages);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = (warp / kCW) * 32, cw = warp % kCW;
  const int gq = lane >> 2, tq = lane & 3;
  const int col0 = cw * 8 * kBN8;  // this warp's columns of a block product
  const int r0 = blockIdx.x * kT;
  const int rows = min(kT, p.R - r0);
  const int s_first = r0 / p.L;
  const size_t SD = (size_t)p.S * D;
  const int ns = p.staged * D;

  // the tile of f, its rows' mask and the stats of its first pooled rows
  stage_rect<kThreads, 0>(sF, ldF, f + (size_t)r0 * D, D, kT, rows, D,
                          D / 8);
  cp_async_commit();
  for (int i = tid; i < kT; i += kThreads)
    sMask[i] = i < rows ? mask[r0 + i] : 0;
  for (int i = tid; i < H; i += kThreads) sB1[i] = b1[i];
  for (int i = tid; i < D; i += kThreads) sB2[i] = b2[i];
  for (int i = tid; i < ns; i += kThreads) {
    const int s = s_first + i / D;
    float m = 0.f, l = 1.f, cc = 0.f, go = 0.f;
    if (s < p.S) {
      const size_t at = (size_t)s * D + i % D;
      m = stats[at];
      l = stats[SD + at];
      go = to_f32(dout[at]);
      cc = go * stats[2 * SD + at];  // rowsum(dsm * sm)
    }
    sStat[i] = m;
    sStat[ns + i] = l;
    sStat[2 * ns + i] = cc;
    sStat[3 * ns + i] = go;
  }
  cp_async_wait<0>();
  __syncthreads();

  float acc[2][kSlots][4], pacc[2][kBN8][4], qacc[2][kBN8][4];
  auto zero = [](auto& a) {
    for (auto& x : a)
      for (auto& y : x)
        for (auto& z : y) z = 0.f;
  };
  zero(acc);
  zero(pacc);
  zero(qacc);

  // the column group of the current step (one unless D > 384): Gs for the
  // schedule's step, Gc for the step being multiplied
  Group Gs = column_group<kCW>(p, 0), Gc = Gs;
  auto load = [&](const Step& st, const Group& G, bf16* dst) {
    const int j0 = st.hh * p.dh + st.jb;
    const bf16* w2h = w2 + (size_t)st.hh * p.dh * p.dho;
    if (st.type == kStepP) {
      const int k0 = kPK * st.chunk;  // [d][j]
      stage_rect<kThreads, 8>(dst, kLdB, w1 + (size_t)k0 * H + j0, H, kPK,
                              min(kPK, D - k0), st.bw);
    } else if (st.type == kStepL) {  // [j][o] of the segment's columns
      const int k0 = G.lk * st.chunk;
      if (k0 >= st.bw) return;  // past a narrower block
      const int n = G.nu * 8;
      stage_rect<kThreads, 0>(
          dst, n + 8, w2h + (size_t)(st.jb + k0) * p.dho + G.uo * 8, p.dho,
          G.lk, min(G.lk, st.bw - k0), n, G.nu);
    } else if (st.type == kStepD1) {  // [j][o]
      const int o0 = kOK * st.chunk;
      stage_rect<kThreads, kOK / 8>(dst, kLdO,
                                    w2h + (size_t)st.jb * p.dho + o0, p.dho,
                                    64, st.bw, min(kOK, p.dho - o0));
    } else {  // [d][j] of the group's columns
      if (16 * st.chunk >= st.bw) return;
      const int n = G.nseg * G.nu * 8;
      stage_rect<kThreads, 2>(dst, kLdF16,
                              w1 + (size_t)G.c0 * H + j0 + 16 * st.chunk, H,
                              n, n, 16);
    }
  };

  // one staged step: its products, then the epilogue it ends with
  auto compute = [&](int i) {
    const Step st = sDesc[i % kTStages];
    const bf16* stg =
        reinterpret_cast<const bf16*>(ring + (i % kTStages) * kTStageBytes);
    if (st.flags & kZeroAcc) zero(acc);
    if (st.g != Gc.g) Gc = column_group<kCW>(p, st.g);
    const Group& G = Gc;
    const int j0 = st.hh * p.dh + st.jb;  // the block's first hidden unit
    if (st.type == kStepP) {
      if (st.chunk == 0) zero(pacc);
      const int k0 = kPK * st.chunk;
      block_mma<kBN8, true>(pacc, sF, ldF, wr, k0, stg, kLdB, col0,
                            min(kPK, D - k0) / 16, lane);
      if (!(st.flags & kEpiH1)) return;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < kBN8; ++n) {
          const int lr = wr + 16 * m + gq, c = col0 + 8 * n + 2 * tq;
          const Frag2 hf = hidden_frag(
              make_float4(pacc[m][n][0], pacc[m][n][1], pacc[m][n][2],
                          pacc[m][n][3]),
              frag_keep(drop, kSiteHidden, r0 + lr, H, j0 + c, tq),
              sB1 + j0 + c, st.bw - c, p.act);
          const float h[4] = {hf.a.x, hf.a.y, hf.a.z, hf.a.w};
          const float fa[4] = {hf.b.x, hf.b.y, hf.b.z, hf.b.w};
          store2(sB + lr * kLdB + c, h[0], h[1]);
          store2(sB + (lr + 8) * kLdB + c, h[2], h[3]);
          if ((st.flags & kWriteOut) && c < st.bw) {
            const size_t at = (size_t)(r0 + lr) * H + j0 + c;
            if (lr < rows) {
              store2(h1_out + at, h[0], h[1]);
              *reinterpret_cast<float2*>(fac + at) = make_float2(fa[0], fa[1]);
            }
            if (lr + 8 < rows) {
              store2(h1_out + at + 8 * (size_t)H, h[2], h[3]);
              *reinterpret_cast<float2*>(fac + at + 8 * (size_t)H) =
                  make_float2(fa[2], fa[3]);
            }
          }
        }
    } else if (st.type == kStepL) {
      const int k0 = G.lk * st.chunk;
      if (k0 < st.bw)
        group_mma<kSlots, true>(acc, sB + k0, kLdB, wr, stg, G.nu * 8 + 8, G,
                                cw, st.seg, true, min(G.lk, st.bw - k0) / 16,
                                lane);
      if (!(st.flags & kEpiE)) return;
      // the softmax backward of the group's columns; per row of this
      // thread (m, upper half): its stats row (staged or in place) and
      // mask (rows past the end: pooled row S - 1, masked, no output)
      RowSrc src[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int rr = wr + 16 * m + gq + 8 * u;
          const int s_ = min((r0 + rr) / p.L, p.S - 1), ps = s_ - s_first;
          src[m][u] = ps < p.staged
              ? RowSrc{sStat + ps * D, (size_t)ns, nullptr, sMask[rr] != 0}
              : RowSrc{stats + (size_t)s_ * D, SD, dout + (size_t)s_ * D,
                       sMask[rr] != 0};
        }
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        // idle slots compute on a valid column and store nothing
        int seg;
        const int unit_ = slot_unit(G, cw, s, &seg);
        const bool on = unit_ >= 0;
        const int unit = on ? unit_ : 0;
        const int d = (G.hh0 + (on ? seg : 0)) * p.dho + (G.uo + unit) * 8 +
                      2 * tq;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int lr = wr + 16 * m + gq;
          RowSrc lo = src[m][0], hi = src[m][1];
          lo.st += d;
          hi.st += d;
          if (lo.go != nullptr) lo.go += d;
          if (hi.go != nullptr) hi.go += d;
          const Frag2 sf = softmax_frag(
              make_float4(acc[m][s][0], acc[m][s][1], acc[m][s][2],
                          acc[m][s][3]),
              frag_keep(drop, kSiteLogits, r0 + lr, D, d, tq),
              frag_keep(drop, kSiteWeights, r0 + lr, D, d, tq), sB2 + d,
              sF + lr * ldF + d, sF + (lr + 8) * ldF + d, lo, hi);
          const float dh[4] = {sf.a.x, sf.a.y, sf.a.z, sf.a.w};
          const float t1[4] = {sf.b.x, sf.b.y, sf.b.z, sf.b.w};
          if (on && (st.flags & kTerm1)) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][s][e] = t1[e];
          }
          if (on && (st.flags & kWriteOut)) {
            store2(sX + lr * ldF + d, dh[0], dh[1]);
            store2(sX + (lr + 8) * ldF + d, dh[2], dh[3]);
            bf16* out = dh2_out + (size_t)(r0 + lr) * D + d;
            if (lr < rows) store2(out, dh[0], dh[1]);
            if (lr + 8 < rows) store2(out + 8 * (size_t)D, dh[2], dh[3]);
          }
        }
      }
    } else if (st.type == kStepD1) {
      if (st.chunk == 0) zero(qacc);
      const int o0 = kOK * st.chunk;
      block_mma<kBN8, false>(qacc, sX, ldF, wr, st.hh * p.dho + o0, stg,
                             kLdO, col0, min(kOK, p.dho - o0) / 16, lane);
      if (!(st.flags & kEpiDpre)) return;
      // dpre1 = dh1 * act'(hin) * keep1, rounded. The factor comes from
      // global memory, written in pass A by this same thread (P's epilogue
      // has the fragment layout of this one), so no barrier orders the
      // two; rows past the end and columns past the block are 0.
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < kBN8; ++n) {
          const int lr = wr + 16 * m + gq, c = col0 + 8 * n + 2 * tq;
          const float* fp = fac + (size_t)(r0 + lr) * H + j0 + c;
          const bool in = c < st.bw;
          const float2 lo = in && lr < rows
              ? *reinterpret_cast<const float2*>(fp) : make_float2(0.f, 0.f);
          const float2 hi = in && lr + 8 < rows
              ? *reinterpret_cast<const float2*>(fp + 8 * (size_t)H)
              : make_float2(0.f, 0.f);
          const float dp[4] = {qacc[m][n][0] * lo.x, qacc[m][n][1] * lo.y,
                               qacc[m][n][2] * hi.x, qacc[m][n][3] * hi.y};
          store2(sB + lr * kLdB + c, dp[0], dp[1]);
          store2(sB + (lr + 8) * kLdB + c, dp[2], dp[3]);
          if ((st.flags & kWriteOut) && c < st.bw) {
            bf16* out = dpre_out + (size_t)(r0 + lr) * H + j0 + c;
            if (lr < rows) store2(out, dp[0], dp[1]);
            if (lr + 8 < rows) store2(out + 8 * (size_t)H, dp[2], dp[3]);
          }
        }
    } else {
      if (16 * st.chunk < st.bw)
        group_mma<kSlots, false>(acc, sB + 16 * st.chunk, kLdB, wr, stg,
                                 kLdF16, G, cw, -1, false, 1, lane);
      if (!(st.flags & kEpiDf)) return;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        int seg;
        const int unit = slot_unit(G, cw, s, &seg);
        if (unit < 0) continue;  // stores only
        const int d = G.c0 + (seg * G.nu + unit) * 8 + 2 * tq;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int lr = wr + 16 * m + gq;
          bf16* out = df + (size_t)(r0 + lr) * D + d;
          if (lr < rows) store2(out, acc[m][s][0], acc[m][s][1]);
          if (lr + 8 < rows)
            store2(out + 8 * (size_t)D, acc[m][s][2], acc[m][s][3]);
        }
      }
    }
  };

  // The schedule, walked one step per iteration by every thread alike:
  // mode 0 pass A of group g for dh2 only (several groups), mode 1 pass A
  // of group g for df's first term (and dh2 with one group), mode 2 pass B
  // of group g. The first pass A over a head writes h1 and the factor out.
  // L steps are 64 / lk a block and F steps 4 (16 deep); the steps past a
  // narrower block's width are empty.
  const int kcD = (D + kPK - 1) / kPK, kcO = (p.dho + kOK - 1) / kOK;
  const int nblk = (p.dh + kHB - 1) / kHB;
  int mode = p.groups == 1 ? 1 : 0, g = 0, hh = 0, blk = 0, kind = kStepP;
  int chunk = 0, last_step = 1 << 30;
  bool done = false;
  auto current = [&]() {
    const Group& G = Gs;
    Step st{kind, 0, hh, blk * kHB, min(kHB, p.dh - blk * kHB), chunk,
            hh - G.hh0, g};
    const bool last_blk = blk == nblk - 1;
    if (mode < 2) {
      if (kind == kStepP) {
        if (chunk == 0 && hh == G.hh0 && blk == 0) st.flags |= kZeroAcc;
        const bool first = (mode == 0 || p.groups == 1) &&
                           (p.hpg > 0 || g % p.parts == 0);
        if (chunk == kcD - 1) st.flags |= kEpiH1 | (first ? kWriteOut : 0);
      } else if (chunk == kHB / G.lk - 1 && last_blk &&
                 hh == G.hh0 + G.nseg - 1) {
        const int term = (p.groups == 1 ? kWriteOut : 0) | kTerm1;
        st.flags = kEpiE | (mode == 0 ? kWriteOut : term);
      }
    } else {
      const int wo = g == 0 ? kWriteOut : 0;
      if (kind == kStepD1 && chunk == kcO - 1) st.flags = kEpiDpre | wo;
      if (kind == kStepF && chunk == 3 && last_blk && hh == p.heads - 1)
        st.flags = kEpiDf;
    }
    return st;
  };
  auto advance = [&]() {
    const int chunks = kind == kStepP    ? kcD
                       : kind == kStepD1 ? kcO
                       : kind == kStepL  ? kHB / Gs.lk
                                         : 4;
    if (++chunk < chunks) return;
    chunk = 0;
    if (kind == kStepP || kind == kStepD1) {  // then L, or F
      kind = kind == kStepP ? kStepL : kStepF;
      return;
    }
    kind = mode < 2 ? kStepP : kStepD1;
    if (++blk < nblk) return;
    blk = 0;
    if (++hh < (mode < 2 ? Gs.hh0 + Gs.nseg : p.heads)) return;
    if (mode == 0) {  // next group's dh2, or the first group's df
      if (++g == p.groups) {
        g = 0;
        mode = 1;
      }
    } else if (mode == 1) {
      mode = 2;
    } else if (++g < p.groups) {
      mode = 1;
    } else {
      done = true;
    }
    Gs = column_group<kCW>(p, g);
    hh = mode < 2 ? Gs.hh0 : 0;
    kind = mode < 2 ? kStepP : kStepD1;
  };

  // The ring: step j is staged kTStages - 1 steps ahead of its products.
  // Before step j's copies go into the stage of step j - kTStages, every
  // thread is past that step's products (the __syncthreads).
  for (int j = 0;; ++j) {
    if (j >= kTStages - 1) {
      cp_async_wait<kTStages - 2>();
      __syncthreads();
    }
    if (!done) {
      const Step st = current();
      if (tid == 0) sDesc[j % kTStages] = st;
      load(st, Gs,
           reinterpret_cast<bf16*>(ring + (j % kTStages) * kTStageBytes));
      advance();
      if (done) last_step = j;
    }
    cp_async_commit();
    if (j >= kTStages - 1) compute(j - (kTStages - 1));
    if (j - (kTStages - 1) == last_step) break;
  }
}

// The column groups of a tile kernel of kT rows: the heads that share one
// accumulator of kGroupUnits units, or the parts of one head that does
// not fit in it.
template <int kT>
void plan_groups(TileDims* t) {
  constexpr int kCW = kTThreads / 32 / (kT / 32), kSlots = kGroupUnits / kCW;
  const int units_h = t->dho / 8, U = (units_h + kCW - 1) / kCW;
  if (U <= kSlots) {
    t->hpg = kSlots / U;
    t->parts = 1;
    t->groups = (t->heads + t->hpg - 1) / t->hpg;
  } else {
    t->hpg = 0;
    t->parts = (units_h + kGroupUnits - 1) / kGroupUnits;
    t->groups = t->heads * t->parts;
  }
}

template <int kT>
cudaError_t launch_tiles(const bf16* f, const uint8_t* mask, const bf16* w1,
                         const float* b1, const bf16* w2, const float* b2,
                         const float* stats, const bf16* dout, bf16* df,
                         bf16* h1, bf16* dpre, bf16* dh2, float* fac,
                         TileDims t,
                         const DropParams& drop, cudaStream_t st) {
  const size_t smem = tile_smem(kT, t.staged, t.D, t.H);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      genpool_bwd_tiles<kT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  plan_groups<kT>(&t);
  genpool_bwd_tiles<kT><<<(t.R + kT - 1) / kT, kTThreads, smem, st>>>(
      f, mask, w1, b1, w2, b2, stats, dout, df, h1, dpre, dh2, fac, t, drop);
  return cudaGetLastError();
}

// ---- bf16 forward on the tensor cores: flat row tiles, then pooling ----
//
// genpool_fwd_tiles is pass A of genpool_bwd_tiles with another epilogue,
// on the same tiles, steps and fragments: one block of 8 warps per flat
// tile of kFwdT of the S*L rows, across pooled-row boundaries; the
// tile of f staged once; per head and per block of 64 hidden units the
// weights stream through the 4-stage cp.async ring (P: pre1 = f . w1[:,
// blk], 128 deep; L: logits[:, head] += h1 . w2[head][blk, :], 32 deep),
// each weight tile staged once per 64 rows (about 0.9 MB a tile from L2);
// h1 = act(drop(pre1 + b1)) is rounded into shared memory (sB) and never
// leaves the SM. After a column group's last
// L step the epilogue adds b2, applies keep2 and the fill and writes the
// masked, dropped logits out in f32 (4 bytes a logit each way instead of
// a second pass over the products). The logits sum in the backward's
// order, so its pass A recomputes them bit for bit.
// genpool_pool then reduces over L: one block per (pooled row, 128
// columns), 8 row groups of 32 threads, each thread 4 consecutive columns
// (one Philox call for their 4 keep3 bits, 16-byte logit loads), an online
// max / sum / sum e*keep3*f per row group, merged in row-group order.

constexpr int kFwdT = 64;                      // rows per forward tile
constexpr int kPoolCols = 128, kPoolGroups = 8;  // genpool_pool's block

// shared memory of a forward tile block: sF (kFwdT x (D + 8)) and sB
// (kFwdT x kLdB) in bf16, the ring, b1 and b2 (f32), the ring's step
// records and the rows' mask
constexpr size_t fwd_tile_smem(int D, int H) {
  return (size_t)2 * kFwdT * (D + 8) + (size_t)2 * kFwdT * kLdB +
         (size_t)kTStages * kTStageBytes + (size_t)4 * (H + D) +
         kTStages * sizeof(Step) + kFwdT;
}

// The forward's hidden epilogue of one fragment: act((pre + b1) * keep1),
// 0 past the block's width (`width` columns from the fragment's first);
// the gelu as act_and_grad forms it.
__device__ __forceinline__ float4 hidden_fwd_frag(float4 pre, float4 keep,
                                               const float* b1c, int width,
                                               int act) {
  const float v[4] = {pre.x, pre.y, pre.z, pre.w};
  const float k[4] = {keep.x, keep.y, keep.z, keep.w};
  float h[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int cj = e & 1;
    const float hin = cj < width ? (v[e] + b1c[cj]) * k[e] : 0.f;
    h[e] = act == kActGelu
               ? hin * (0.5f * (1.0f + erff(hin * 0.70710678118654752f)))
               : activate(hin, act);
  }
  return make_float4(h[0], h[1], h[2], h[3]);
}

__global__ void __launch_bounds__(kTThreads, 1)
genpool_fwd_tiles(const bf16* __restrict__ f, const uint8_t* __restrict__ mask,
                  const bf16* __restrict__ w1, const float* __restrict__ b1,
                  const bf16* __restrict__ w2, const float* __restrict__ b2,
                  float* __restrict__ logits, TileDims p, DropParams drop) {
  // warps: kRW row warps of 32 rows x kCW column warps
  constexpr int kThreads = kTThreads, kT = kFwdT;
  constexpr int kRW = kT / 32, kCW = kTThreads / 32 / kRW;
  constexpr int kSlots = kGroupUnits / kCW, kBN8 = 8 / kCW;
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = p.D, H = p.H, ldF = D + 8;
  bf16* sF = reinterpret_cast<bf16*>(smem);
  bf16* sB = sF + kT * ldF;
  unsigned char* ring = reinterpret_cast<unsigned char*>(sB + kT * kLdB);
  float* sB1 = reinterpret_cast<float*>(ring + kTStages * kTStageBytes);
  float* sB2 = sB1 + H;
  Step* sDesc = reinterpret_cast<Step*>(sB2 + D);
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sDesc + kTStages);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = (warp / kCW) * 32, cw = warp % kCW;
  const int gq = lane >> 2, tq = lane & 3;
  const int col0 = cw * 8 * kBN8;  // this warp's columns of a block product
  const int r0 = blockIdx.x * kT;
  const int rows = min(kT, p.R - r0);

  stage_rect<kThreads, 0>(sF, ldF, f + (size_t)r0 * D, D, kT, rows, D,
                          D / 8);
  cp_async_commit();
  for (int i = tid; i < kT; i += kThreads)
    sMask[i] = i < rows ? mask[r0 + i] : 0;
  for (int i = tid; i < H; i += kThreads) sB1[i] = b1[i];
  for (int i = tid; i < D; i += kThreads) sB2[i] = b2[i];
  cp_async_wait<0>();
  __syncthreads();

  float acc[2][kSlots][4], pacc[2][kBN8][4];
  auto zero = [](auto& a) {
    for (auto& x : a)
      for (auto& y : x)
        for (auto& z : y) z = 0.f;
  };
  zero(acc);
  zero(pacc);

  Group Gs = column_group<kCW>(p, 0), Gc = Gs;
  auto load = [&](const Step& st, const Group& G, bf16* dst) {
    if (st.type == kStepP) {  // [d][j]
      const int k0 = kPK * st.chunk;
      stage_rect<kThreads, 8>(dst, kLdB,
                              w1 + (size_t)k0 * H + st.hh * p.dh + st.jb, H,
                              kPK, min(kPK, D - k0), st.bw);
    } else {  // [j][o] of the segment's columns
      const int k0 = G.lk * st.chunk;
      if (k0 >= st.bw) return;  // past a narrower block
      const int n = G.nu * 8;
      stage_rect<kThreads, 0>(
          dst, n + 8,
          w2 + (size_t)st.hh * p.dh * p.dho + (size_t)(st.jb + k0) * p.dho +
              G.uo * 8,
          p.dho, G.lk, min(G.lk, st.bw - k0), n, G.nu);
    }
  };

  auto compute = [&](int i) {
    const Step st = sDesc[i % kTStages];
    const bf16* stg =
        reinterpret_cast<const bf16*>(ring + (i % kTStages) * kTStageBytes);
    if (st.flags & kZeroAcc) zero(acc);
    if (st.g != Gc.g) Gc = column_group<kCW>(p, st.g);
    const Group& G = Gc;
    if (st.type == kStepP) {
      if (st.chunk == 0) zero(pacc);
      const int k0 = kPK * st.chunk;
      block_mma<kBN8, true>(pacc, sF, ldF, wr, k0, stg, kLdB, col0,
                            min(kPK, D - k0) / 16, lane);
      if (!(st.flags & kEpiH1)) return;
      const int j0 = st.hh * p.dh + st.jb;  // the block's first hidden unit
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < kBN8; ++n) {
          const int lr = wr + 16 * m + gq, c = col0 + 8 * n + 2 * tq;
          const float4 h = hidden_fwd_frag(
              make_float4(pacc[m][n][0], pacc[m][n][1], pacc[m][n][2],
                          pacc[m][n][3]),
              frag_keep_inl(drop, kSiteHidden, r0 + lr, H, j0 + c, tq),
              sB1 + j0 + c, st.bw - c, p.act);
          store2(sB + lr * kLdB + c, h.x, h.y);
          store2(sB + (lr + 8) * kLdB + c, h.z, h.w);
        }
      return;
    }
    const int k0 = G.lk * st.chunk;
    if (k0 < st.bw)
      group_mma<kSlots, true>(acc, sB + k0, kLdB, wr, stg, G.nu * 8 + 8, G,
                              cw, st.seg, true, min(G.lk, st.bw - k0) / 16,
                              lane);
    if (!(st.flags & kEpiE)) return;
    // the group's logits out: + b2, keep2, the fill on masked rows
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      int seg;
      const int unit = slot_unit(G, cw, s, &seg);
      if (unit < 0) continue;  // warp-uniform
      const int d = G.c0 + (seg * G.nu + unit) * 8 + 2 * tq;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int lr = wr + 16 * m + gq;
        const float4 k2 = frag_keep(drop, kSiteLogits, r0 + lr, D, d, tq);
        const bool lo = sMask[lr] != 0, hi = sMask[lr + 8] != 0;
        float* out = logits + (size_t)(r0 + lr) * D + d;
        if (lr < rows)
          *reinterpret_cast<float2*>(out) = make_float2(
              lo ? (acc[m][s][0] + sB2[d]) * k2.x : kMaskFill,
              lo ? (acc[m][s][1] + sB2[d + 1]) * k2.y : kMaskFill);
        if (lr + 8 < rows)
          *reinterpret_cast<float2*>(out + 8 * (size_t)D) = make_float2(
              hi ? (acc[m][s][2] + sB2[d]) * k2.z : kMaskFill,
              hi ? (acc[m][s][3] + sB2[d + 1]) * k2.w : kMaskFill);
      }
    }
  };

  // The schedule: per column group, per head of the group, per block of
  // 64 hidden units, kcD P steps then 64 / lk L steps (those past a
  // narrower block are empty); the group's last L step writes its logits.
  const int kcD = (D + kPK - 1) / kPK;
  const int nblk = (p.dh + kHB - 1) / kHB;
  int g = 0, hh = Gs.hh0, blk = 0, kind = kStepP, chunk = 0;
  int last_step = 1 << 30;
  bool done = false;
  auto current = [&]() {
    Step st{kind, 0, hh, blk * kHB, min(kHB, p.dh - blk * kHB), chunk,
            hh - Gs.hh0, g};
    if (kind == kStepP) {
      if (chunk == 0 && hh == Gs.hh0 && blk == 0) st.flags |= kZeroAcc;
      if (chunk == kcD - 1) st.flags |= kEpiH1;
    } else if (chunk == kHB / Gs.lk - 1 && blk == nblk - 1 &&
               hh == Gs.hh0 + Gs.nseg - 1) {
      st.flags = kEpiE;
    }
    return st;
  };
  auto advance = [&]() {
    if (++chunk < (kind == kStepP ? kcD : kHB / Gs.lk)) return;
    chunk = 0;
    if (kind == kStepP) {
      kind = kStepL;
      return;
    }
    kind = kStepP;
    if (++blk < nblk) return;
    blk = 0;
    if (++hh < Gs.hh0 + Gs.nseg) return;
    if (++g == p.groups) {
      done = true;
      return;
    }
    Gs = column_group<kCW>(p, g);
    hh = Gs.hh0;
  };

  // The ring, as in genpool_bwd_tiles: step j is staged kTStages - 1 steps
  // ahead of its products; the __syncthreads before step j's copies puts
  // every thread past the products of step j - kTStages.
  for (int j = 0;; ++j) {
    if (j >= kTStages - 1) {
      cp_async_wait<kTStages - 2>();
      __syncthreads();
    }
    if (!done) {
      const Step st = current();
      if (tid == 0) sDesc[j % kTStages] = st;
      load(st, Gs,
           reinterpret_cast<bf16*>(ring + (j % kTStages) * kTStageBytes));
      advance();
      if (done) last_step = j;
    }
    cp_async_commit();
    if (j >= kTStages - 1) compute(j - (kTStages - 1));
    if (j - (kTStages - 1) == last_step) break;
  }
}

// Pass 2 of the bf16 forward: out = sum_L f * keep3 * softmax_L(logits)
// and, with stats, the column max, the sum and the f32 pooled row.
__global__ void __launch_bounds__(kPoolGroups * 32)
genpool_pool(const float* __restrict__ logits, const bf16* __restrict__ f,
             bf16* __restrict__ out, float* __restrict__ stats, int S, int L,
             int D, DropParams drop) {
  __shared__ __align__(16) float sPart[3][kPoolGroups][kPoolCols];
  const int s = blockIdx.x, rg = threadIdx.x >> 5;
  const int c4 = (threadIdx.x & 31) * 4, d = blockIdx.y * kPoolCols + c4;
  float m[4], l[4], a[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
    a[j] = 0.f;
  }
  if (d < D) {  // D % 16 == 0: all 4 columns are in
    for (int li = rg; li < L; li += kPoolGroups) {
      const size_t e = ((size_t)s * L + li) * D + d;
      const float4 lg4 = *reinterpret_cast<const float4*>(logits + e);
      const uint2 fw = *reinterpret_cast<const uint2*>(f + e);
      const float lg[4] = {lg4.x, lg4.y, lg4.z, lg4.w};
      const float fv[4] = {bf16_lo(fw.x), bf16_hi(fw.x), bf16_lo(fw.y),
                           bf16_hi(fw.y)};
      float k3[4] = {1.f, 1.f, 1.f, 1.f};
      if (drop.thresh != 0u) {
        const Philox4 bits = dropout_group(drop.seed, kSiteWeights, e >> 2);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          k3[j] = bits.x[j] >= drop.thresh ? drop.scale : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float mn = fmaxf(m[j], lg[j]);
        const float sc = expf(m[j] - mn);  // 0 on the first row
        const float ex = expf(lg[j] - mn);
        l[j] = fmaf(l[j], sc, ex);
        a[j] = fmaf(a[j], sc, ex * k3[j] * fv[j]);
        m[j] = mn;
      }
    }
  }
  *reinterpret_cast<float4*>(&sPart[0][rg][c4]) =
      make_float4(m[0], m[1], m[2], m[3]);
  *reinterpret_cast<float4*>(&sPart[1][rg][c4]) =
      make_float4(l[0], l[1], l[2], l[3]);
  *reinterpret_cast<float4*>(&sPart[2][rg][c4]) =
      make_float4(a[0], a[1], a[2], a[3]);
  __syncthreads();
  const int c = threadIdx.x, dc = blockIdx.y * kPoolCols + c;
  if (c >= kPoolCols || dc >= D) return;
  float mx = -INFINITY;
#pragma unroll
  for (int g = 0; g < kPoolGroups; ++g) mx = fmaxf(mx, sPart[0][g][c]);
  float sum = 0.f, acc = 0.f;
#pragma unroll
  for (int g = 0; g < kPoolGroups; ++g) {
    const float w = expf(sPart[0][g][c] - mx);  // 0 for a group of no rows
    sum = fmaf(sPart[1][g][c], w, sum);
    acc = fmaf(sPart[2][g][c], w, acc);
  }
  const size_t i = (size_t)s * D + dc, sd = (size_t)S * D;
  const float pooled = acc / sum;
  out[i] = __float2bfloat16_rn(pooled);
  if (stats != nullptr) {
    stats[i] = mx;
    stats[sd + i] = sum;
    stats[2 * sd + i] = pooled;
  }
}

// bf16: the tile pass into `logits` (S*L, D) f32, then the pooling pass
int genpool_fwd_bf16(const void* f, const void* mask, const void* w1,
                     const void* b1, const void* w2, const void* b2,
                     void* out, void* stats, void* logits, const Dims& p,
                     const DropParams& drop, cudaStream_t st) {
  const size_t smem = fwd_tile_smem(p.D, p.H);
  if (smem > kSmemLimit || logits == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      genpool_fwd_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  TileDims t{p.S, p.L, p.D, p.H, p.heads, p.dh, p.dho, p.act, p.S * p.L,
             0,   0,   0,   0};
  plan_groups<kFwdT>(&t);
  float* lg = static_cast<float*>(logits);
  const bf16* fb = static_cast<const bf16*>(f);
  genpool_fwd_tiles<<<(t.R + kFwdT - 1) / kFwdT, kTThreads, smem, st>>>(
      fb, static_cast<const uint8_t*>(mask), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), lg, t, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  genpool_pool<<<dim3(p.S, (p.D + kPoolCols - 1) / kPoolCols),
                 kPoolGroups * 32, 0, st>>>(
      lg, fb, static_cast<bf16*>(out), static_cast<float*>(stats), p.S, p.L,
      p.D, drop);
  return static_cast<int>(cudaGetLastError());
}

// bf16: the tile pass, then dw1|db1 and dw2|db2 on tn_mma<false>, each
// summed over its row splits in split order (db1 follows dw1 and db2
// follows dw2 in memory; one sum each)
int genpool_bwd_bf16(const void* f, const void* mask, const void* w1,
                     const void* b1, const void* w2, const void* b2,
                     const void* stats, const void* dout, void* df, void* h1,
                     void* dpre, void* dh2, void* fac, void* scratch,
                     void* dw1, void* db1, void* dw2, void* db2,
                     const Dims& p,
                     const DropParams& drop, int splits1, int splits2,
                     cudaStream_t st) {
  const size_t w1n = (size_t)p.D * p.H, w2n = (size_t)p.heads * p.dh * p.dho;
  const long long n1 = (long long)(w1n + p.H), n2 = (long long)(w2n + p.D);
  float* out1 = static_cast<float*>(dw1);
  float* out2 = static_cast<float*>(dw2);
  if (static_cast<float*>(db1) != out1 + w1n ||
      static_cast<float*>(db2) != out2 + w2n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = p.S * p.L;
  int tile_rows, staged;
  tile_plan(p, &tile_rows, &staged);
  const TileDims t{p.S, p.L, p.D, p.H, p.heads, p.dh, p.dho, p.act, R,
                   0,   0,   0,   staged};
  const bf16* fb = static_cast<const bf16*>(f);
  bf16* h1b = static_cast<bf16*>(h1);
  bf16* dpb = static_cast<bf16*>(dpre);
  bf16* dh2b = static_cast<bf16*>(dh2);
  const auto launch = tile_rows == 64 ? launch_tiles<64> : launch_tiles<32>;
  cudaError_t err = launch(
      fb, static_cast<const uint8_t*>(mask), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(stats),
      static_cast<const bf16*>(dout), static_cast<bf16*>(df), h1b, dpb, dh2b,
      static_cast<float*>(fac), t, drop, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* s1 = static_cast<float*>(scratch);
  float* s2 = s1 + (size_t)splits1 * n1;
  TnArgs a{};  // dw1 = f^T dpre1, db1 = colsum(dpre1)
  a.a = fb;
  a.b = dpb;
  a.partial = s1;
  a.colsum = s1 + w1n;
  a.p_split = a.c_split = n1;
  a.lda = p.D;
  a.ldb = p.H;
  a.R = R;
  a.M = p.D;
  a.N = p.H;
  a.rows_per_split = split_rows(R, splits1);
  err = launch_tn_mma<false>(a, 1, splits1, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  TnArgs b{};  // per head: dw2[h] = h1[:, h]^T dh2[:, h], db2 = colsum(dh2)
  b.a = h1b;
  b.b = dh2b;
  b.a_step = p.dh;
  b.b_step = p.dho;
  b.partial = s2;
  b.p_step = (long long)p.dh * p.dho;
  b.colsum = s2 + w2n;
  b.c_step = p.dho;
  b.p_split = b.c_split = n2;
  b.lda = p.H;
  b.ldb = p.D;
  b.R = R;
  b.M = p.dh;
  b.N = p.dho;
  b.rows_per_split = split_rows(R, splits2);
  err = launch_tn_mma<false>(b, p.heads, splits2, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_splits<<<sum_blocks(n1), 256, 0, st>>>(s1, splits1, n1, out1);
  sum_splits<<<sum_blocks(n2), 256, 0, st>>>(s2, splits2, n2, out2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int genpool_fwd_launch(const void* f, const void* mask, const void* w1,
                       const void* b1, const void* w2, const void* b2,
                       void* out, void* stats, const Dims& p,
                       const DropParams& drop, cudaStream_t st) {
  const size_t smem = buffer_bytes<T>(p, false);
  cudaError_t err = set_smem<T>((const void*)genpool_fwd<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  genpool_fwd<T><<<p.S, kThreads, smem, st>>>(
      static_cast<const T*>(f), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(b2),
      static_cast<T*>(out), static_cast<float*>(stats), p, drop);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int genpool_bwd_launch(const void* f, const void* mask, const void* w1,
                       const void* b1, const void* w2, const void* b2,
                       const void* stats, const void* dout, void* df,
                       void* h1, void* dpre, void* dh2, void* scratch,
                       void* dw1, void* db1, void* dw2, void* db2,
                       const Dims& p, const DropParams& drop, int splits,
                       cudaStream_t st) {
  const size_t smem = buffer_bytes<T>(p, true);
  cudaError_t err = set_smem<T>((const void*)genpool_bwd_rows<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  genpool_bwd_rows<T><<<p.S, kThreads, smem, st>>>(
      static_cast<const T*>(f), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(stats), static_cast<const T*>(dout),
      static_cast<T*>(df), static_cast<T*>(h1), static_cast<T*>(dpre),
      static_cast<T*>(dh2), p, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int R = p.S * p.L;
  float* scr = static_cast<float*>(scratch);
  const T* ft = static_cast<const T*>(f);
  const T* h1t = static_cast<const T*>(h1);
  const T* dpt = static_cast<const T*>(dpre);
  const T* dh2t = static_cast<const T*>(dh2);
  const NormA none{nullptr, nullptr, nullptr, nullptr};
  launch_tn<T, false>(ft, p.D, dpt, p.H, R, p.D, p.H, splits, scr,
                      static_cast<float*>(dw1), none, st);
  for (int hh = 0; hh < p.heads; ++hh)
    launch_tn<T, false>(h1t + hh * p.dh, p.H, dh2t + hh * p.dho, p.D, R,
                        p.dh, p.dho, splits, scr,
                        static_cast<float*>(dw2) + (size_t)hh * p.dh * p.dho,
                        none, st);
  launch_colsum<T>(dpt, p.H, R, p.H, splits, scr, static_cast<float*>(db1),
                   st);
  launch_colsum<T>(dh2t, p.D, R, p.D, splits, scr, static_cast<float*>(db2),
                   st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace coot

// f (S, L, D), w1 (D, H) flat [head-interleaved], w2 (heads, dh, dho)
// head-stacked, all in the compute dtype; b1 (H), b2 (D) f32; mask (S, L)
// uint8; out (S, D); stats (3, S, D) f32 or null. logits: (S*L, D) f32
// scratch of the bf16 passes (null in f32; f 16-byte aligned in bf16).
// The wrapper checks D, H % 16 == 0, D, H <= 1024, and dh, dho % 16 == 0.
// thresh == 0: no dropout.
extern "C" int coot_genpool_fwd(const void* f, const void* mask,
                                const void* w1, const void* b1,
                                const void* w2, const void* b2, void* out,
                                void* stats, void* logits, int S, int L,
                                int D, int H, int heads, int act,
                                unsigned long long seed, unsigned int thresh,
                                float drop_scale, int is_bf16, void* stream) {
  using namespace coot;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Dims p{S, L, D, H, heads, H / heads, D / heads, act};
  DropParams drop{seed, thresh, drop_scale};
  if (is_bf16)
    return genpool_fwd_bf16(f, mask, w1, b1, w2, b2, out, stats, logits, p,
                            drop, st);
  return genpool_fwd_launch<float>(f, mask, w1, b1, w2, b2, out, stats, p,
                                   drop, st);
}

// The forward's inputs and stats, and dout (S, D). Writes df (S, L, D) in
// the compute dtype, and f32 dw1 (D, H) flat, db1 (H), dw2 (heads, dh, dho)
// head-stacked, db2 (D). h1, dpre (S*L, H) and dh2 (S*L, D) are
// compute-dtype scratch, fac (S*L, H) f32 scratch (bf16 only: act'(hin) *
// keep1 from pass A to pass B). bf16: the tile pass (tiles from
// tile_plan) and tn_mma, with db1 right after dw1 and db2 right after dw2
// in memory; `scratch` f32 of splits * (D*H + H) + splits2 * (heads*dh*dho
// + D) elements (ops/genpool.py::backward_plan). f32: the row kernel and
// the FMA reductions, `scratch` of splits * D * H.
extern "C" int coot_genpool_bwd(const void* f, const void* mask,
                                const void* w1, const void* b1,
                                const void* w2, const void* b2,
                                const void* stats, const void* dout,
                                void* df, void* h1, void* dpre, void* dh2,
                                void* fac, void* scratch, void* dw1,
                                void* db1, void* dw2, void* db2, int S,
                                int L, int D, int H, int heads, int act,
                                unsigned long long seed, unsigned int thresh,
                                float drop_scale, int splits, int splits2,
                                int is_bf16, void* stream) {
  using namespace coot;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Dims p{S, L, D, H, heads, H / heads, D / heads, act};
  DropParams drop{seed, thresh, drop_scale};
  if (is_bf16)
    return genpool_bwd_bf16(f, mask, w1, b1, w2, b2, stats, dout, df, h1,
                            dpre, dh2, fac, scratch, dw1, db1, dw2, db2, p,
                            drop, splits, splits2, st);
  return genpool_bwd_launch<float>(f, mask, w1, b1, w2, b2, stats, dout, df,
                                   h1, dpre, dh2, scratch, dw1, db1, dw2, db2,
                                   p, drop, splits, st);
}
