// fingerprint_bank: per-pattern Rabin fingerprints of packed SFA state words.
//
// Replaces the Pallas kernel src/repro/kernels/clmul.py::fingerprint_bank_pallas
// (_fingerprint_bank_kernel, _fold_block, _clmul32_block, _clmul64_hi/_lo).
//
// Computes, for every pattern p and candidate row b:
//   acc  = XOR_i clmul64((0, words[p,b,i]), weights[p,i])      (96-bit fold)
//   fp   = Barrett(acc) mod P_p                                 (64 bits)
//   out[p,b] = [hi, lo]
// with per-pattern constants (each pattern may sit on its own polynomial
// after a collision retry).
//
// What bounds it on Hopper: integer ALU work. There is no carry-less multiply
// instruction, so each 32x32 clmul is 32 bit-sliced mask/shift/XOR steps:
// about 2*160 integer operations per word plus 3*160 for the Barrett step,
// against 4 bytes read per word. Design: one thread per (pattern, row);
// the W-word loop and all three accumulator limbs stay in registers; the
// pattern's fold weights (at most 44*2 words at n_max = 87) and its four
// Barrett limbs are staged once per block in shared memory, so the only
// global traffic is each word read once and two words written per row.
// u32 values arrive as int32 tensors carrying the same bits.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

__global__ void fingerprint_bank_kernel(const uint32_t *__restrict__ words,
                                        const uint32_t *__restrict__ weights,
                                        const uint32_t *__restrict__ limbs,
                                        uint32_t *__restrict__ out,
                                        long long B, int W) {
  extern __shared__ uint32_t smem[];  // [W][2] weights, then 4 limbs
  const int p = blockIdx.y;
  const uint32_t *wp = weights + (size_t)p * W * 2;
  for (int i = threadIdx.x; i < 2 * W; i += blockDim.x) smem[i] = wp[i];
  if (threadIdx.x < 4) smem[2 * W + threadIdx.x] = limbs[p * 4 + threadIdx.x];
  __syncthreads();

  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint32_t *row = words + ((size_t)p * B + b) * W;

  uint32_t l0 = 0u, l1 = 0u, l2 = 0u;
  for (int i = 0; i < W; ++i) {
    const uint32_t w = row[i];
    uint32_t h, l;
    clmul32(w, smem[2 * i + 1], h, l);  // x weight lo -> limbs 1, 0
    l0 ^= l;
    l1 ^= h;
    clmul32(w, smem[2 * i], h, l);      // x weight hi -> limbs 2, 1
    l1 ^= l;
    l2 ^= h;
  }

  const uint32_t p_hi = smem[2 * W], p_lo = smem[2 * W + 1];
  const uint32_t mu_hi = smem[2 * W + 2];  // mu_lo: see the Barrett step
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
  uint32_t *o = out + ((size_t)p * B + b) * 2;
  o[0] = l1 ^ r1 ^ l;
  o[1] = l0 ^ r0;
}

}  // namespace

extern "C" int fingerprint_bank_launch(const void *words, const void *weights,
                                       const void *limbs, void *out, int P,
                                       long long B, int W, void *stream) {
  const int threads = 128;
  const size_t smem = (size_t)(2 * W + 4) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fingerprint_bank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)((B + threads - 1) / threads), (unsigned)P);
  fingerprint_bank_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t *)words, (const uint32_t *)weights,
      (const uint32_t *)limbs, (uint32_t *)out, B, W);
  return (int)cudaGetLastError();
}

extern "C" const char *fingerprint_bank_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
