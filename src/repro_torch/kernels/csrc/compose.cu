// compose: the function-monoid combine, out[b, q] = g[b, f[b, q]].
//
// Replaces the Pallas kernel src/repro/kernels/compose.py::compose_pallas
// (_compose_kernel). The TPU kernel recast the gather as a one-hot MXU
// contraction (n^2 MACs for n loads); that was a TPU choice and is not
// carried over: here the combine is one load of f and one gather from g.
//
// Computes, for f, g (B, n) int32 mapping vectors ("apply f, then g"):
//   out[b, q] = g[b, f[b, q]]  -> (B, n) int32.
// Every reduce and scan of the port's function monoid (core/monoid.py)
// combines through it: the scan engine's chunk folds, locate's exclusive
// scan, census_windows' prefix and suffix scans, the stream's running prefix.
//
// What bounds it on Hopper: bytes — each element reads f and g once and
// writes out once (12 B) and does one address computation. Design: one thread
// per output element; f is read as int32 (no int64 index copy, unlike
// torch.gather); the g[b, :] row a warp gathers from is 4n bytes that the
// block's threads share, so those reads hit L1/L2. A block covers whole rows
// (a tile of rows of at most kTile elements), so the row of an element comes
// from a 32-bit division inside the tile.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8192;  // elements per block, rounded down to whole rows

__global__ void compose_kernel(const int32_t *__restrict__ f,
                               const int32_t *__restrict__ g,
                               int32_t *__restrict__ out, long long B, int n,
                               int rows_per_block) {
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long rows_left = B - row0;
  const int rows = rows_left < rows_per_block ? (int)rows_left : rows_per_block;
  const size_t base = (size_t)row0 * n;
  const int span = rows * n;
  for (int e = threadIdx.x; e < span; e += blockDim.x) {
    const int r = e / n;
    out[base + e] = __ldg(g + base + (size_t)r * n + __ldg(f + base + e));
  }
}

}  // namespace

extern "C" int compose_launch(const void *f, const void *g, void *out,
                              long long B, int n, void *stream) {
  const int rows_per_block = n >= kTile ? 1 : kTile / n;
  const long long blocks = (B + rows_per_block - 1) / rows_per_block;
  compose_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t *)f, (const int32_t *)g, (int32_t *)out, B, n,
      rows_per_block);
  return (int)cudaGetLastError();
}

extern "C" const char *compose_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
