// expand_bank: frontier x alphabet expansion of batched SFA construction.
//
// Replaces the Pallas kernel src/repro/kernels/expand.py::expand_bank_pallas
// (_expand_kernel). The TPU kernel re-expressed the gather as a one-hot MXU
// matmul; that was a TPU choice and is not carried over.
//
// Computes out[b, t*k + a, q] = tables[b, ft[b, t, q], a] for tables (B, n, k)
// and frontier tiles ft (B, T, n) -> (B, T*k, n) int32, in row-major
// (frontier, symbol) candidate order.
//
// What bounds it on Hopper: bytes moved — each output int32 is one shared-
// memory read and one global write (k times more output than frontier
// input). Design: one block per (pattern, ROWS frontier rows); the pattern's
// (n, k) table is staged in shared memory (at most 87 * 20 * 4 B = 7 KB at
// n_max = 87); thread e of a block owns frontier element (t, q) = divmod(e, n)
// and writes its k outputs, so consecutive threads store consecutive q of
// each output row: the stores are coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 8;

__global__ void expand_bank_kernel(const int32_t *__restrict__ tables,
                                   const int32_t *__restrict__ ft,
                                   int32_t *__restrict__ out, int T, int n,
                                   int k) {
  extern __shared__ int32_t tab[];  // (n, k)
  const int b = blockIdx.y;
  const int32_t *tb = tables + (size_t)b * n * k;
  for (int i = threadIdx.x; i < n * k; i += blockDim.x) tab[i] = tb[i];
  __syncthreads();

  const int t0 = blockIdx.x * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, T - t0);
  const int span = rows * n;
  const int32_t *fb = ft + ((size_t)b * T + t0) * n;
  int32_t *ob = out + ((size_t)b * T + t0) * (size_t)k * n;
  for (int e = threadIdx.x; e < span; e += blockDim.x) {
    const int t = e / n;
    const int q = e - t * n;
    const int32_t *trow = tab + (size_t)fb[e] * k;
    int32_t *orow = ob + (size_t)t * k * n + q;
    for (int a = 0; a < k; ++a) orow[(size_t)a * n] = trow[a];
  }
}

}  // namespace

extern "C" int expand_bank_launch(const void *tables, const void *ft,
                                  void *out, int B, int T, int n, int k,
                                  void *stream) {
  const int threads = 256;
  const size_t smem = (size_t)n * k * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        expand_bank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)((T + kRowsPerBlock - 1) / kRowsPerBlock), (unsigned)B);
  expand_bank_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t *)tables, (const int32_t *)ft, (int32_t *)out, T, n, k);
  return (int)cudaGetLastError();
}

extern "C" const char *expand_bank_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
