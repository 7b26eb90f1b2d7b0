// match_bank_chunks: every chunk run through every table, from start states
// 0 .. n_starts-1 — the (pattern, chunk) transition functions of the scan.
//
// Replaces the Pallas kernel
// src/repro/kernels/match_scan.py::match_bank_chunks_pallas
// (_match_bank_kernel, _chunk_block_body). The TPU kernel turned each step
// into two one-hot MXU contractions; that was a TPU choice and is not
// carried over: here a step is one table lookup.
//
// Computes out[p, b, q] = tables[p] walked from state q over chunks[b, :]
// for tables (P, n, k), chunks (B, L) -> (P, B, n_starts) int32.
// Enumeration passes n_starts = n (the chunk's whole transition function);
// the SFA path passes n_starts = 1: it reads only the walk from SFA state 0.
//
// What bounds it on Hopper: the latency of the dependent loads — step t+1's
// address is step t's loaded value, so each thread is a chain of L loads.
// Design: one thread per (pattern, chunk, start state), the L-step loop in a
// register; consecutive threads take consecutive start states of one chunk,
// so they read the same symbol (a broadcast) and write coalesced outputs.
// When the table fits (the caller passes use_smem; kernels/ops.py holds the
// threshold, two blocks per SM), it is staged in shared memory and a step
// costs a shared-memory load; a larger table (an
// SFA delta of thousands of rows, 575 KB at 7,184 states) is read from
// global memory, where it stays resident in the 50 MB L2. Blocks stride
// over their pattern's work so each staged table serves many chunks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kSmem>
__global__ void match_bank_kernel(const int32_t *__restrict__ tables,
                                  const int32_t *__restrict__ chunks,
                                  int32_t *__restrict__ out, int n, int k,
                                  long long B, int L, int n_starts) {
  extern __shared__ int32_t tab_s[];
  const int p = blockIdx.y;
  const int32_t *tab = tables + (size_t)p * n * k;
  if (kSmem) {
    for (int i = threadIdx.x; i < n * k; i += blockDim.x) tab_s[i] = tab[i];
    __syncthreads();
    tab = tab_s;
  }
  const long long work = B * n_starts;
  const long long stride = (long long)gridDim.x * blockDim.x;
  int32_t *op = out + (size_t)p * work;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < work; e += stride) {
    const long long b = e / n_starts;
    const int32_t *c = chunks + b * L;
    int s = (int)(e - b * n_starts);
    for (int t = 0; t < L; ++t) s = tab[s * k + __ldg(c + t)];
    op[e] = s;
  }
}

}  // namespace

extern "C" int match_bank_chunks_launch(const void *tables, const void *chunks,
                                        void *out, int P, int n, int k,
                                        long long B, int L, int n_starts,
                                        int use_smem, void *stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;

  const long long work = B * n_starts;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long per_pattern = ((long long)sms * 8 + P - 1) / P;
  if (blocks > per_pattern) blocks = per_pattern;
  dim3 grid((unsigned)blocks, (unsigned)P);

  if (use_smem) {
    const size_t smem = (size_t)n * k * sizeof(int32_t);
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(match_bank_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    match_bank_kernel<true><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t *)tables, (const int32_t *)chunks, (int32_t *)out, n, k,
        B, L, n_starts);
  } else {
    match_bank_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t *)tables, (const int32_t *)chunks, (int32_t *)out, n, k,
        B, L, n_starts);
  }
  return (int)cudaGetLastError();
}

extern "C" const char *match_bank_chunks_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
