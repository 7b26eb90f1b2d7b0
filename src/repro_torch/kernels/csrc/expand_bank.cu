// expand_bank: frontier x alphabet expansion of batched SFA construction,
// with the candidates' packed, masked u32 words in the same launch.
//
// Replaces the Pallas kernel src/repro/kernels/expand.py::expand_bank_pallas
// (_expand_kernel). The TPU kernel re-expressed the gather as a one-hot MXU
// matmul; that was a TPU choice and is not carried over. On the TPU the
// round's pack of the candidates into u32 words (two 16-bit ids a word, the
// padding tail masked) fused into the same XLA program for free; here it is
// this kernel's second output, so the round does not run ten PyTorch
// launches over an int64 copy of the candidates to build it.
//
// Computes, for tables (B, n, k), frontier tiles ft (B, T, n) and optional
// word masks (B, W), W = ceil(n / 2), all int32:
//   cand[b, t*k + a, q] = tables[b, ft[b, t, q], a]          (B, T*k, n)
//   words[b, r, w] = ((cand[b, r, 2w] & 0xFFFF)
//                     | (cand[b, r, 2w + 1] & 0xFFFF) << 16) & masks[b, w]
//                                                             (B, T*k, W)
// (u32 bit patterns; an odd n's last word has a zero high half). Without
// masks only cand is written (the single-pattern closure).
//
// What bounds it on Hopper: bytes — each output int32 is one shared-memory
// read and one global write. At the construction's shape (B = 6, T = 128,
// k = 20, n = 87) that is 5.35 MB of candidates and 2.70 MB of words.
// Design: a thread owns word pairs (candidate row r, word w): consecutive
// threads take consecutive w of one row, so both outputs are written at
// consecutive addresses and the threads of a row read the same frontier
// row. A block (blockIdx.y = the pattern) stages its pattern's (n, k) table
// in shared memory with rows padded to k | 1 words: a warp's 64 lookups
// tab[s * (k | 1) + a] in random states then spread over the 32 banks (an
// even width of 20 puts s * 20 + a on 8 of them). The staging (n * (k | 1)
// * 4 = 7.3 KB at n = 87, from L2) is paid per block, so where the work
// fills the card several times over a thread takes kPairs pairs, one block
// width apart and unrolled (their loads in flight together): at the
// construction's shape 330 blocks of 512 threads, all resident at once,
// stage the tables instead of 1,320 blocks in 2.5 waves. A small launch
// (the ragged edges of a round) keeps one pair a thread, the most blocks.

#include <cstdint>
#include <cuda_runtime.h>

#include "device.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kPairs = 4;  // pairs a thread takes when the work is large

template <int kThreadPairs>
__global__ void __launch_bounds__(kThreads)
expand_bank_kernel(const int32_t *__restrict__ tables,
                   const int32_t *__restrict__ ft,
                   const int32_t *__restrict__ masks,
                   int32_t *__restrict__ cand, int32_t *__restrict__ words,
                   int T, int n, int k) {
  extern __shared__ int32_t tab[];  // (n, k | 1)
  const int b = blockIdx.y;
  const int row = k | 1;
  const int32_t *tb = tables + (size_t)b * n * k;
  for (int i = threadIdx.x; i < n * k; i += blockDim.x) {
    const int s = i / k;
    tab[s * row + (i - s * k)] = __ldg(tb + i);
  }
  __syncthreads();

  const int W = (n + 1) >> 1;
  const int work = T * k * W;  // < 2^31 (the wrapper checks)
#pragma unroll
  for (int u = 0; u < kThreadPairs; ++u) {
    const int e = (blockIdx.x * kThreadPairs + u) * blockDim.x + threadIdx.x;
    if (e >= work) break;
    const int r = e / W;  // candidate row t * k + a
    const int w = e - r * W;
    const int t = r / k;
    const int a = r - t * k;
    const int q = 2 * w;
    const int32_t *frow = ft + ((size_t)b * T + t) * n;
    int32_t *crow = cand + ((size_t)b * T * k + r) * n;
    const int32_t lo = tab[__ldg(frow + q) * row + a];
    crow[q] = lo;
    int32_t hi = 0;
    if (q + 1 < n) {
      hi = tab[__ldg(frow + q + 1) * row + a];
      crow[q + 1] = hi;
    }
    if (words != nullptr) {
      const uint32_t packed = ((uint32_t)lo & 0xFFFFu) |
                              (((uint32_t)hi & 0xFFFFu) << 16);
      words[((size_t)b * T * k + r) * W + w] = (int32_t)(
          packed & (uint32_t)__ldg(masks + (size_t)b * W + w));
    }
  }
}

template <int kThreadPairs>
int launch(const void *tables, const void *ft, const void *masks, void *cand,
           void *words, int B, int T, int n, int k, size_t smem,
           void *stream) {
  auto kernel = expand_bank_kernel<kThreadPairs>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long work = (long long)T * k * ((n + 1) / 2);
  const long long per_block = (long long)kThreads * kThreadPairs;
  dim3 grid((unsigned)((work + per_block - 1) / per_block), (unsigned)B);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t *)tables, (const int32_t *)ft, (const int32_t *)masks,
      (int32_t *)cand, (int32_t *)words, T, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

// masks and words are both null (candidates only) or both set.
extern "C" int expand_bank_launch(const void *tables, const void *ft,
                                  const void *masks, void *cand, void *words,
                                  int B, int T, int n, int k, void *stream) {
  const size_t smem = (size_t)n * (k | 1) * sizeof(int32_t);
  const long long pairs = (long long)B * T * k * ((n + 1) / 2);
  if (pairs >= (long long)sm_count() * kThreads * kPairs)
    return launch<kPairs>(tables, ft, masks, cand, words, B, T, n, k, smem,
                          stream);
  return launch<1>(tables, ft, masks, cand, words, B, T, n, k, smem, stream);
}

extern "C" const char *expand_bank_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
