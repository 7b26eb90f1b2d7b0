// match_chunks: every chunk run through one table from every start state —
// the chunk transition functions of the single-pattern matchers.
//
// Replaces the Pallas kernel src/repro/kernels/match_scan.py::match_chunks_pallas
// (_match_kernel, _chunk_block_body). The TPU kernel turned each step into
// two one-hot MXU contractions; that was a TPU choice and is not carried
// over: here a step is one table lookup. It is the P = 1, n_starts = n case
// of match_bank_chunks.cu, written afresh for its shared-memory layout.
//
// Computes out[b, q] = table walked from state q over chunks[b, :] for
// table (n, k), chunks (B, L) -> (B, n) int32. Scanner.locate's first pass
// (4,096 chunks of 1,024 symbols, 87 lanes each) and the single-table
// executors run it.
//
// What bounds it on Hopper: the latency of the dependent loads — step t+1's
// address is step t's loaded value, so each thread is a chain of L loads.
// Design: one thread per (chunk, start state), the L-step loop in a register;
// consecutive threads take consecutive start states of one chunk, so they
// read the same symbol (a broadcast) and write coalesced outputs. When the
// table fits (the caller passes use_smem; kernels/ops.py holds the
// threshold), it is staged in shared memory with rows padded to an odd width
// (k | 1 words): 32 lanes in 32 different states then spread over the 32
// banks instead of aliasing (an even width of 20 words maps s*20 + sym onto 8
// of 32 banks). A larger table is read from global memory, where it stays
// resident in the 50 MB L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kSmem>
__global__ void match_chunks_kernel(const int32_t *__restrict__ table,
                                    const int32_t *__restrict__ chunks,
                                    int32_t *__restrict__ out, int n, int k,
                                    long long B, int L) {
  extern __shared__ int32_t tab_s[];
  const int32_t *tab = table;
  int row = k;
  if (kSmem) {
    row = k | 1;
    for (int i = threadIdx.x; i < n * k; i += blockDim.x) {
      const int s = i / k;
      tab_s[s * row + (i - s * k)] = table[i];
    }
    __syncthreads();
    tab = tab_s;
  }
  const long long work = B * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < work; e += stride) {
    const long long b = e / n;
    const int32_t *c = chunks + b * L;
    int s = (int)(e - b * n);
    for (int t = 0; t < L; ++t) s = tab[s * row + __ldg(c + t)];
    out[e] = s;
  }
}

}  // namespace

extern "C" int match_chunks_launch(const void *table, const void *chunks,
                                   void *out, int n, int k, long long B, int L,
                                   int use_smem, void *stream) {
  const long long work = B * n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;  // the loop strides the rest
  if (use_smem) {
    const size_t smem = (size_t)n * (k | 1) * sizeof(int32_t);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          match_chunks_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    match_chunks_kernel<true><<<(unsigned)blocks, kThreads, smem,
                                (cudaStream_t)stream>>>(
        (const int32_t *)table, (const int32_t *)chunks, (int32_t *)out, n, k,
        B, L);
  } else {
    match_chunks_kernel<false><<<(unsigned)blocks, kThreads, 0,
                                 (cudaStream_t)stream>>>(
        (const int32_t *)table, (const int32_t *)chunks, (int32_t *)out, n, k,
        B, L);
  }
  return (int)cudaGetLastError();
}

extern "C" const char *match_chunks_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
