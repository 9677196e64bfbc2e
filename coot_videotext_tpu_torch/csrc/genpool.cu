// B2: GenPool forward (deterministic):
//   out[s, d] = sum_l f[s,l,d] * softmax_l(fill(act(f[s,l,:].w1 + b1)
//                                               . w2_blk + b2)[d], -32752)
//
// Replaces the forward of the TPU kernel
// coot_videotext_tpu/ops/pallas_genpool.py::fused_genpool (_fwd_kernel,
// _recompute); dropout is the training slice's.
//
// What bounds it on the H100: per pooled row, 2*L*D*H + 2*L*H*D/heads
// flops against L*D input elements (~1150 flops per bf16 byte at D=384,
// H=768, 2 heads), so it is compute-bound on the tensor cores.
//
// Design: one block per pooled row s walks the sequence in chunks of 16
// rows. Each chunk of f is staged once in shared memory; the 16 x H hidden
// activations and the 16 x D logits never leave the SM. Both products run
// in the kernel (bf16: nvcuda::wmma with f32 accumulation, weights read
// straight from L2; f32: FMA loops). The second product uses the
// block-diagonal structure directly: the output columns of head h only read
// head h's slice of the hidden activations, so the zero blocks of w2 are
// never touched and w2 is passed head-stacked (heads, dh, dho); the output
// column order stays [h*dho + o]. The softmax over the sequence is online
// (flash-style), per output column, in f32: a running max, a running sum
// and a running sum of e*f, so one pass covers any L (a whole (300, 384)
// paragraph tile would not fit in shared memory). Masked rows get the
// finite fill -32752 and still count, so an all-masked row pools to the
// uniform average exactly as the reference does; only rows past L are
// skipped.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace coot {
namespace {

constexpr int kCh = 16;            // sequence rows per chunk
constexpr int kWarps = 8, kThreads = kWarps * 32;
constexpr int kMaxCols = 4;        // D <= 4 * 256
constexpr int kMaxTiles1 = 8;      // H <= 8 warps * 8 tiles * 16
constexpr int kMaxTiles2 = 8;      // D <= 8 warps * 8 tiles * 16

struct Dims {
  int S, L, D, H, heads, dh, dho, act;
};

// Online-softmax state update for one chunk, shared by both variants.
// sLog holds the chunk's logits (without b2), sF the chunk's features.
template <typename T>
__device__ __forceinline__ void softmax_chunk(
    const Dims& p, int rows, const float* sLog, int ldl, const T* sF,
    int ldf, const uint8_t* sMask, const float* __restrict__ b2,
    float* m, float* l, float* acc) {
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    const int d = threadIdx.x + j * kThreads;
    if (d >= p.D) break;
    const float bd = b2[d];
    float cmax = -INFINITY;
    for (int r = 0; r < rows; ++r) {
      const float lg = sMask[r] ? sLog[r * ldl + d] + bd : kMaskFill;
      cmax = fmaxf(cmax, lg);
    }
    const float m_new = fmaxf(m[j], cmax);
    const float scale = expf(m[j] - m_new);  // 0 on the first chunk
    float ls = l[j] * scale, as = acc[j] * scale;
    for (int r = 0; r < rows; ++r) {
      const float lg = sMask[r] ? sLog[r * ldl + d] + bd : kMaskFill;
      const float e = expf(lg - m_new);
      ls += e;
      as = fmaf(e, to_f32(sF[r * ldf + d]), as);
    }
    m[j] = m_new;
    l[j] = ls;
    acc[j] = as;
  }
}

template <typename T>
__device__ __forceinline__ void load_chunk(const Dims& p, const T* fs,
                                           const uint8_t* ms, int l0,
                                           T* sF, int ldf, uint8_t* sMask) {
  for (int i = threadIdx.x; i < kCh * p.D; i += kThreads) {
    const int r = i / p.D, d = i % p.D;
    sF[r * ldf + d] = (l0 + r < p.L) ? fs[(size_t)(l0 + r) * p.D + d]
                                     : from_f32<T>(0.f);
  }
  if (threadIdx.x < kCh)
    sMask[threadIdx.x] = (l0 + threadIdx.x < p.L) ? ms[l0 + threadIdx.x] : 0;
}

template <typename T>
__device__ __forceinline__ void write_out(const Dims& p, T* out, int s,
                                          const float* l, const float* acc) {
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    const int d = threadIdx.x + j * kThreads;
    if (d >= p.D) break;
    out[(size_t)s * p.D + d] = from_f32<T>(acc[j] / l[j]);
  }
}

// ---- bf16: wmma ----
__global__ void __launch_bounds__(kThreads)
genpool_bf16(const bf16* __restrict__ f, const uint8_t* __restrict__ mask,
             const bf16* __restrict__ w1, const float* __restrict__ b1,
             const bf16* __restrict__ w2, const float* __restrict__ b2,
             bf16* __restrict__ out, Dims p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldf = p.D + 8, ldh = p.H + 8, ldl = p.D + 4;
  float* sLog = reinterpret_cast<float*>(smem);                 // kCh x ldl
  float* sScr = sLog + kCh * ldl;                               // warps x 256
  bf16* sF = reinterpret_cast<bf16*>(sScr + kWarps * 256);      // kCh x ldf
  bf16* sH1 = sF + kCh * ldf;                                   // kCh x ldh
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sH1 + kCh * ldh); // kCh

  const int s = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* fs = f + (size_t)s * p.L * p.D;
  const uint8_t* ms = mask + (size_t)s * p.L;
  const int tiles1 = p.H / 16, tiles2 = p.D / 16;
  float m[kMaxCols], l[kMaxCols], acc[kMaxCols];
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
    acc[j] = 0.f;
  }

  for (int l0 = 0; l0 < p.L; l0 += kCh) {
    load_chunk(p, fs, ms, l0, sF, ldf, sMask);
    __syncthreads();

    // h1 = act(f . w1 + b1), rounded to bf16: warp w owns tiles w, w+8, ..
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c1[kMaxTiles1];
#pragma unroll
      for (int t = 0; t < kMaxTiles1; ++t) wmma::fill_fragment(c1[t], 0.f);
      for (int k = 0; k < p.D; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sF + k, ldf);
#pragma unroll
        for (int t = 0; t < kMaxTiles1; ++t) {
          const int tile = warp + t * kWarps;
          if (tile < tiles1) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                           wmma::row_major> bw;
            wmma::load_matrix_sync(bw, w1 + (size_t)k * p.H + tile * 16,
                                   p.H);
            wmma::mma_sync(c1[t], a, bw, c1[t]);
          }
        }
      }
      float* scr = sScr + warp * 256;
#pragma unroll
      for (int t = 0; t < kMaxTiles1; ++t) {
        const int tile = warp + t * kWarps;
        if (tile < tiles1) {
          wmma::store_matrix_sync(scr, c1[t], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int col = tile * 16 + e % 16;
            sH1[(e / 16) * ldh + col] =
                from_f32<bf16>(activate(scr[e] + b1[col], p.act));
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();

    // logits = h1 . w2_blk (per head), b2 is added in the softmax step
#pragma unroll
    for (int t = 0; t < kMaxTiles2; ++t) {
      const int tile = warp + t * kWarps;
      if (tile < tiles2) {
        const int col = tile * 16;
        const int hh = col / p.dho, c0 = col - hh * p.dho;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c2;
        wmma::fill_fragment(c2, 0.f);
        const bf16* w2h = w2 + (size_t)hh * p.dh * p.dho;
        for (int k = 0; k < p.dh; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
              a;
          wmma::load_matrix_sync(a, sH1 + hh * p.dh + k, ldh);
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              bw;
          wmma::load_matrix_sync(bw, w2h + (size_t)k * p.dho + c0, p.dho);
          wmma::mma_sync(c2, a, bw, c2);
        }
        wmma::store_matrix_sync(sLog + col, c2, ldl, wmma::mem_row_major);
      }
    }
    __syncthreads();

    softmax_chunk(p, min(kCh, p.L - l0), sLog, ldl, sF, ldf, sMask, b2, m,
                  l, acc);
    __syncthreads();
  }
  write_out(p, out, s, l, acc);
}

// ---- f32: FMA ----
__global__ void __launch_bounds__(kThreads)
genpool_f32(const float* __restrict__ f, const uint8_t* __restrict__ mask,
            const float* __restrict__ w1, const float* __restrict__ b1,
            const float* __restrict__ w2, const float* __restrict__ b2,
            float* __restrict__ out, Dims p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldf = p.D + 4, ldh = p.H + 4, ldl = p.D + 4;
  float* sLog = reinterpret_cast<float*>(smem);
  float* sF = sLog + kCh * ldl;
  float* sH1 = sF + kCh * ldf;
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sH1 + kCh * ldh);

  const int s = blockIdx.x;
  const float* fs = f + (size_t)s * p.L * p.D;
  const uint8_t* ms = mask + (size_t)s * p.L;
  float m[kMaxCols], l[kMaxCols], acc[kMaxCols];
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
    acc[j] = 0.f;
  }

  for (int l0 = 0; l0 < p.L; l0 += kCh) {
    load_chunk(p, fs, ms, l0, sF, ldf, sMask);
    __syncthreads();
    // h1: thread owns columns j = tid + 256*u, all 16 rows
#pragma unroll
    for (int u = 0; u < kMaxCols; ++u) {
      const int col = threadIdx.x + u * kThreads;
      if (col >= p.H) break;
      float c[kCh] = {};
      for (int k = 0; k < p.D; ++k) {
        const float wv = w1[(size_t)k * p.H + col];
#pragma unroll
        for (int r = 0; r < kCh; ++r) c[r] = fmaf(sF[r * ldf + k], wv, c[r]);
      }
#pragma unroll
      for (int r = 0; r < kCh; ++r)
        sH1[r * ldh + col] = activate(c[r] + b1[col], p.act);
    }
    __syncthreads();
    // logits: thread owns output columns d = tid + 256*u
#pragma unroll
    for (int u = 0; u < kMaxCols; ++u) {
      const int d = threadIdx.x + u * kThreads;
      if (d >= p.D) break;
      const int hh = d / p.dho, c0 = d - hh * p.dho;
      const float* w2h = w2 + (size_t)hh * p.dh * p.dho + c0;
      const float* h1h = sH1 + hh * p.dh;
      float c[kCh] = {};
      for (int k = 0; k < p.dh; ++k) {
        const float wv = w2h[(size_t)k * p.dho];
#pragma unroll
        for (int r = 0; r < kCh; ++r) c[r] = fmaf(h1h[r * ldh + k], wv, c[r]);
      }
#pragma unroll
      for (int r = 0; r < kCh; ++r) sLog[r * ldl + d] = c[r];
    }
    __syncthreads();
    softmax_chunk(p, min(kCh, p.L - l0), sLog, ldl, sF, ldf, sMask, b2, m,
                  l, acc);
    __syncthreads();
  }
  write_out(p, out, s, l, acc);
}

size_t smem_bytes(const Dims& p, bool is_bf16) {
  if (is_bf16)
    return sizeof(float) * (kCh * (p.D + 4) + kWarps * 256) +
           sizeof(bf16) * (kCh * (p.D + 8) + kCh * (p.H + 8)) + kCh;
  return sizeof(float) * (kCh * (p.D + 4) * 2 + kCh * (p.H + 4)) + kCh;
}

}  // namespace
}  // namespace coot

// f (S, L, D), w1 (D, H) flat [head-interleaved], w2 (heads, dh, dho)
// head-stacked, all in the compute dtype; b1 (H), b2 (D) f32; mask (S, L)
// uint8; out (S, D). The wrapper checks D, H % 16 == 0, D <= 1024,
// H <= 1024, and dh, dho % 16 == 0.
extern "C" int coot_genpool_fwd(const void* f, const void* mask,
                                const void* w1, const void* b1,
                                const void* w2, const void* b2, void* out,
                                int S, int L, int D, int H, int heads,
                                int act, int is_bf16, void* stream) {
  using namespace coot;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Dims p{S, L, D, H, heads, H / heads, D / heads, act};
  const size_t smem = smem_bytes(p, is_bf16 != 0);
  cudaError_t err;
  if (is_bf16) {
    err = cudaFuncSetAttribute(genpool_bf16,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    genpool_bf16<<<S, kThreads, smem, st>>>(
        static_cast<const bf16*>(f), static_cast<const uint8_t*>(mask),
        static_cast<const bf16*>(w1), static_cast<const float*>(b1),
        static_cast<const bf16*>(w2), static_cast<const float*>(b2),
        static_cast<bf16*>(out), p);
  } else {
    err = cudaFuncSetAttribute(genpool_f32,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    genpool_f32<<<S, kThreads, smem, st>>>(
        static_cast<const float*>(f), static_cast<const uint8_t*>(mask),
        static_cast<const float*>(w1), static_cast<const float*>(b1),
        static_cast<const float*>(w2), static_cast<const float*>(b2),
        static_cast<float*>(out), p);
  }
  return static_cast<int>(cudaGetLastError());
}
