// fingerprint: Rabin fingerprints of packed SFA state words, one polynomial.
//
// Replaces the Pallas kernel src/repro/kernels/clmul.py::fingerprint_pallas
// (_fingerprint_kernel, _fold_block). It is the P = 1 case of
// fingerprint_bank.cu, for the single-pattern construction
// (construction/stores.py SortedFingerprintStore, one candidate tile of up
// to 4,096 x 20 rows of 44 words per call).
//
// Computes, for every row b of words (B, W):
//   out[b] = [hi, lo] of Barrett(XOR_i clmul64((0, words[b,i]), weights[i]))
// with weights (W, 2) = x^(32 i) mod P as [hi, lo] and limbs (4,) =
// [p_hi, p_lo, mu_hi, mu_lo].
//
// What bounds it on Hopper: integer ALU work, as for fingerprint_bank (about
// 2*160 integer operations per word against 4 bytes read). Design: one thread
// per row, the fold's three limbs in registers; the weights and limbs are
// staged once per block in shared memory, so the only global traffic is each
// word read once and two words written per row. The fold and the Barrett
// step are clmul.cuh's. u32 values arrive as int32 tensors carrying the same
// bits.

#include <cstdint>
#include <cuda_runtime.h>

#include "clmul.cuh"

namespace {

__global__ void fingerprint_kernel(const uint32_t *__restrict__ words,
                                   const uint32_t *__restrict__ weights,
                                   const uint32_t *__restrict__ limbs,
                                   uint32_t *__restrict__ out, long long B,
                                   int W) {
  extern __shared__ uint32_t smem[];  // [W][2] weights, then 4 limbs
  for (int i = threadIdx.x; i < 2 * W; i += blockDim.x) smem[i] = weights[i];
  if (threadIdx.x < 4) smem[2 * W + threadIdx.x] = limbs[threadIdx.x];
  __syncthreads();

  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  rabin::fold_reduce(words + (size_t)b * W, W, smem, smem + 2 * W,
                     out + (size_t)b * 2);
}

}  // namespace

extern "C" int fingerprint_launch(const void *words, const void *weights,
                                  const void *limbs, void *out, long long B,
                                  int W, void *stream) {
  const int threads = 128;
  const size_t smem = (size_t)(2 * W + 4) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fingerprint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  fingerprint_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t *)words, (const uint32_t *)weights,
      (const uint32_t *)limbs, (uint32_t *)out, B, W);
  return (int)cudaGetLastError();
}

extern "C" const char *fingerprint_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
