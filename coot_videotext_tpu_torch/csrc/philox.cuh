// Counter-based random bits for dropout: Philox4x32-10 (Salmon et al.,
// "Parallel random numbers: as easy as 1, 2, 3", SC'11), keyed by a 64-bit
// seed. Stands in for the TPU's hardware PRNG of
// coot_videotext_tpu/ops/pallas_dropout.py:68-75 and
// pallas_genpool.py:144-146.
//
// Element e of dropout site `site` takes word (e & 3) of
//   philox(counter = (lo32(e >> 2), hi32(e >> 2), site, 0),
//          key = (lo32(seed), hi32(seed))).
// The bits depend only on (seed, site, element index), never on the block
// layout of the kernel that draws them, so a backward kernel with another
// grid regenerates the forward's mask exactly. ops/philox.py computes the
// same bits in PyTorch integer ops for the plain versions.
// Dropout keeps an element iff its bits >= floor(rate * 2^32).
#pragma once

#include <stdint.h>

namespace coot {

struct Philox4 {
  uint32_t x[4];
};

__host__ __device__ __forceinline__ void mulhilo32(uint32_t a, uint32_t b,
                                                   uint32_t* hi,
                                                   uint32_t* lo) {
  const uint64_t p = static_cast<uint64_t>(a) * b;
  *hi = static_cast<uint32_t>(p >> 32);
  *lo = static_cast<uint32_t>(p);
}

__host__ __device__ __forceinline__ Philox4 philox4x32_10(Philox4 c,
                                                          uint32_t k0,
                                                          uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    uint32_t hi0, lo0, hi1, lo1;
    mulhilo32(0xD2511F53u, c.x[0], &hi0, &lo0);
    mulhilo32(0xCD9E8D57u, c.x[2], &hi1, &lo1);
    Philox4 n;
    n.x[0] = hi1 ^ c.x[1] ^ k0;
    n.x[1] = lo1;
    n.x[2] = hi0 ^ c.x[3] ^ k1;
    n.x[3] = lo0;
    c = n;
  }
  return c;
}

// The four words of the counter group holding elements 4g .. 4g+3.
__host__ __device__ __forceinline__ Philox4 dropout_group(uint64_t seed,
                                                          uint32_t site,
                                                          uint64_t g) {
  Philox4 c;
  c.x[0] = static_cast<uint32_t>(g);
  c.x[1] = static_cast<uint32_t>(g >> 32);
  c.x[2] = site;
  c.x[3] = 0u;
  return philox4x32_10(c, static_cast<uint32_t>(seed),
                       static_cast<uint32_t>(seed >> 32));
}

__host__ __device__ __forceinline__ uint32_t dropout_bits(uint64_t seed,
                                                          uint32_t site,
                                                          uint64_t e) {
  return dropout_group(seed, site, e >> 2).x[e & 3];
}

// Dropout parameters as a kernel takes them; thresh == 0 means no dropout
// (rate 0 or evaluation), and then no bits are drawn at all.
struct DropParams {
  uint64_t seed;
  uint32_t thresh;  // floor(rate * 2^32)
  float scale;      // 1 / (1 - rate)
};

__host__ __device__ __forceinline__ bool dropout_keep(const DropParams& d,
                                                      uint32_t site,
                                                      uint64_t e) {
  return d.thresh == 0u || dropout_bits(d.seed, site, e) >= d.thresh;
}

// keep * scale as one factor (1 without dropout)
__host__ __device__ __forceinline__ float dropout_factor(
    const DropParams& d, uint32_t site, uint64_t e) {
  if (d.thresh == 0u) return 1.0f;
  return dropout_bits(d.seed, site, e) >= d.thresh ? d.scale : 0.0f;
}

}  // namespace coot
