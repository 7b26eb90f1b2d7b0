// clmul.cuh: the Rabin fold and Barrett step shared by fingerprint.cu and
// fingerprint_bank.cu (kernels/build.py hashes this header into the name of
// every library, so an edit to it rebuilds both).
//
// A fingerprint is fp = Barrett(XOR_i clmul64((0, word_i), weight_i)) mod P:
// each packed word times its fold weight x^(32 i) mod P gives a 96-bit
// product, the XOR of all products is reduced once. GPUs have no carry-less
// multiply, so a 32x32 product is 32 bit-sliced mask/shift/XOR steps.

#pragma once

#include <cstdint>

namespace rabin {

__device__ __forceinline__ void clmul32(uint32_t a, uint32_t b, uint32_t &hi,
                                        uint32_t &lo) {
  hi = 0u;
  lo = 0u;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const uint32_t mask = 0u - ((b >> i) & 1u);
    lo ^= (a << i) & mask;
    hi ^= ((a >> (31 - i)) >> 1) & mask;  // a >> (32 - i) without i == 0 UB
  }
}

// Fold the W words of one row with weights wt ([W][2]: hi, lo of each
// x^(32 i) mod P) and reduce with limbs lm ([p_hi, p_lo, mu_hi, mu_lo]);
// writes o[0] = hi, o[1] = lo of the 64-bit fingerprint.
__device__ __forceinline__ void fold_reduce(const uint32_t *__restrict__ row,
                                            int W, const uint32_t *wt,
                                            const uint32_t *lm, uint32_t *o) {
  uint32_t l0 = 0u, l1 = 0u, l2 = 0u;
  for (int i = 0; i < W; ++i) {
    const uint32_t w = row[i];
    uint32_t h, l;
    clmul32(w, wt[2 * i + 1], h, l);  // x weight lo -> limbs 1, 0
    l0 ^= l;
    l1 ^= h;
    clmul32(w, wt[2 * i], h, l);      // x weight hi -> limbs 2, 1
    l1 ^= l;
    l2 ^= h;
  }
  const uint32_t p_hi = lm[0], p_lo = lm[1];
  const uint32_t mu_hi = lm[2];  // mu_lo: see the Barrett step
  // Barrett step on the 96-bit fold A = (l2, l1, l0). T1 = floor(A / t^64)
  // is the one limb l2, so T2 = T1 ^ hi64(T1 * mu) = l2 ^ hi32(l2 * mu_hi)
  // (l2 * mu_lo reaches no higher than limb 1): one 32x32 product.
  uint32_t h, l;
  clmul32(l2, mu_hi, h, l);
  const uint32_t t2 = l2 ^ h;
  // The low 64 bits of T2 * p_low cancel A's low limbs down to the residue;
  // T2 is one limb, so two products (of t2 * p_hi only the low limb counts).
  uint32_t r1, r0;
  clmul32(t2, p_lo, r1, r0);
  clmul32(t2, p_hi, h, l);
  o[0] = l1 ^ r1 ^ l;
  o[1] = l0 ^ r0;
}

}  // namespace rabin
