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
// Forward design: one block per pooled row s walks the sequence in chunks
// of 16 rows. Each chunk of f is staged once in shared memory; the 16 x H
// hidden activations and the 16 x D logits never leave the SM. The
// products run in `chunk_mm` (bf16: nvcuda::wmma with f32 accumulation,
// weights read straight from L2; f32: FMA loops). The second product uses
// the block-diagonal structure: the output columns of head h only read
// head h's slice of the hidden activations, so the zero blocks of w2 are
// never touched and w2 is passed head-stacked (heads, dh, dho); the output
// column order stays [h*dho + o]. The softmax over the sequence is online
// (flash-style), per output column, in f32: a running max, a running sum of
// e and a running sum of e * keep3 * f, so one pass covers any L. Masked
// rows get the finite fill -32752 and still count, so an all-masked row
// pools to the uniform average exactly as the reference does. With `stats`
// the column max, sum and the f32 pooled row are written for the backward.
//
// Backward design: (1) one block per pooled row recomputes the chunk as the
// forward does and, with the saved softmax statistics, forms
//   dsm = dout * f * keep3,  dlg = valid ? sm * (dsm - dout * out) : 0,
//   dh2 = dlg * keep2,  dpre1 = (dh2 . w2_blk^T) * act'(h1_in) * keep1,
//   df  = dout * sm * keep3 + dpre1 . w1^T,
// all in shared memory (the last two products again in chunk_mm); it
// writes df, and h1, dh2 and dpre1 in the compute dtype for (2): the
// weight gradients dw1 = f^T dpre1, dw2[h] = h1[:, h]^T dh2[:, h], db1, db2
// are sums over all S*L rows, made by the deterministic split reductions
// of csrc/tn_reduce.cuh.

#include <mma.h>

#include <type_traits>

#include "common.cuh"
#include "philox.cuh"
#include "tn_reduce.cuh"

using namespace nvcuda;

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

// Shared-memory buffers of one block; float buffers first, every size a
// multiple of 32 bytes, so each buffer is aligned for wmma.
template <typename T>
struct Buffers {
  float* log;  // kCh x ldl: logits, then (backward) the df term dout*smd
  float* scr;  // kWarps x 256: wmma fragment staging
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
  size_t n = sizeof(float) * (kCh * ldl + kWarps * 256) +
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
  b.scr = fp;
  fp += kWarps * 256;
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
// c, value) receives every result once. bf16: wmma 16x16x16 with f32
// accumulation, warps taking 16-column tiles in turn (K, N multiples of
// 16); f32: FMA, threads owning columns.
template <typename T, bool kColMajorB, typename Epi>
__device__ __forceinline__ void chunk_mm(const T* sA, int lda, const T* B,
                                         int ldb, int K, int N, float* scr,
                                         Epi epi) {
  if constexpr (std::is_same<T, bf16>::value) {
    using BLayout = typename std::conditional<kColMajorB, wmma::col_major,
                                              wmma::row_major>::type;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* ws = scr + warp * 256;
    for (int c0 = warp * 16; c0 < N; c0 += kWarps * 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k = 0; k < K; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sA + k, lda);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> bw;
        const T* bp = kColMajorB ? B + (size_t)c0 * ldb + k
                                 : B + (size_t)k * ldb + c0;
        wmma::load_matrix_sync(bw, bp, ldb);
        wmma::mma_sync(acc, a, bw, acc);
      }
      wmma::store_matrix_sync(ws, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) epi(e / 16, c0 + e % 16, ws[e]);
      __syncwarp();
    }
  } else {
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
  chunk_mm<T, false>(sb.f, sb.ldf, w1, p.H, p.D, p.H, sb.scr,
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
                       sb.scr, [&](int r, int c, float v) {
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
                        sb.scr, [&](int r, int c, float v) {
        const int col = hh * p.dh + c;
        const T dp = from_f32<T>(v * sb.fac[r * sb.ldh + col]);
        sb.h[r * sb.ldh + col] = dp;
        if (l0 + r < p.L)
          dpre_out[((size_t)s * p.L + l0 + r) * p.H + col] = dp;
      });
    }
    __syncthreads();
    // df = dout * smd + dpre1 . w1^T
    chunk_mm<T, true>(sb.h, sb.ldh, w1, p.H, p.H, p.D, sb.scr,
                      [&](int r, int c, float v) {
      if (l0 + r < p.L)
        df[((size_t)s * p.L + l0 + r) * p.D + c] =
            from_f32<T>(sb.log[r * sb.ldl + c] + v);
    });
    __syncthreads();
  }
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
// uint8; out (S, D); stats (3, S, D) f32 or null. The wrapper checks D, H
// % 16 == 0, D <= 1024, and dh, dho % 16 == 0. thresh == 0: no dropout.
extern "C" int coot_genpool_fwd(const void* f, const void* mask,
                                const void* w1, const void* b1,
                                const void* w2, const void* b2, void* out,
                                void* stats, int S, int L, int D, int H,
                                int heads, int act, unsigned long long seed,
                                unsigned int thresh, float drop_scale,
                                int is_bf16, void* stream) {
  using namespace coot;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Dims p{S, L, D, H, heads, H / heads, D / heads, act};
  DropParams drop{seed, thresh, drop_scale};
  if (is_bf16)
    return genpool_fwd_launch<bf16>(f, mask, w1, b1, w2, b2, out, stats, p,
                                    drop, st);
  return genpool_fwd_launch<float>(f, mask, w1, b1, w2, b2, out, stats, p,
                                   drop, st);
}

// The forward's inputs and stats, and dout (S, D). Writes df (S, L, D) in
// the compute dtype, and f32 dw1 (D, H) flat, db1 (H), dw2 (heads, dh, dho)
// head-stacked, db2 (D). h1, dpre (S*L, H) and dh2 (S*L, D) are
// compute-dtype scratch, `scratch` f32 of splits * D * H elements.
extern "C" int coot_genpool_bwd(const void* f, const void* mask,
                                const void* w1, const void* b1,
                                const void* w2, const void* b2,
                                const void* stats, const void* dout,
                                void* df, void* h1, void* dpre, void* dh2,
                                void* scratch, void* dw1, void* db1,
                                void* dw2, void* db2, int S, int L, int D,
                                int H, int heads, int act,
                                unsigned long long seed, unsigned int thresh,
                                float drop_scale, int splits, int is_bf16,
                                void* stream) {
  using namespace coot;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Dims p{S, L, D, H, heads, H / heads, D / heads, act};
  DropParams drop{seed, thresh, drop_scale};
  if (is_bf16)
    return genpool_bwd_launch<bf16>(f, mask, w1, b1, w2, b2, stats, dout, df,
                                    h1, dpre, dh2, scratch, dw1, db1, dw2,
                                    db2, p, drop, splits, st);
  return genpool_bwd_launch<float>(f, mask, w1, b1, w2, b2, stats, dout, df,
                                   h1, dpre, dh2, scratch, dw1, db1, dw2, db2,
                                   p, drop, splits, st);
}
