// compose: folds of the function monoid, m combines in one launch.
//
// Replaces the Pallas kernel src/repro/kernels/compose.py::compose_pallas
// (_compose_kernel), one combine out[b, q] = g[b, f[b, q]] per call. The TPU
// kernel recast the gather as a one-hot MXU contraction (n^2 MACs for n
// loads); that was a TPU choice and is not carried over. The TPU's callers
// fold inside one jit (lax.scan), so the fold costs no launches there; here
// the fold itself is the kernel: each output element is one dependent chain
// of m loads kept in a register,
//   out[b, q] = g_{m-1}[b, ... g_1[b, g_0[b, f[b, q]]] ...],
// so a reduce of m + 1 elements is one launch, not m.
//
// Two forms of the operands, one body (template on kRows):
//   stacked: f (B, n) or null (the identity), gs (B, m, n) int32 ->
//     out (B, n), g_j[b] = gs[b, j]. m = 1 with f is the single combine
//     (ops.compose); f null is core/monoid.py::reduce of the function monoid;
//     f = the running prefix and gs a stream piece's block mappings is one
//     piece of engine/streaming.py.
//   rows of a mapping stack: stacks (P, S, n), idx (P, D, m) int32 ->
//     out (P, D, n), g_j[p, d] = stacks[p, idx[p, d, j]], identity start.
//     This is the SFA scan's chunk fold (engine/executors.py::
//     bank_doc_mappings_sfa): the final SFA state of every chunk indexes its
//     mapping row, with no gathered (P, D, n) tensor per chunk in between.
//
// What bounds it on Hopper: bytes at the bound, latency in practice. Each
// element writes out once (4 B) and reads f once; the g_j rows are shared by
// the n threads of a row and come from L1/L2. At the SFA scan's shape
// (P = 23, D = 65,536, m = 8, n = 87) the bound is 525 MB of output + 48 MB
// of idx (0.17 ms at 3.35 TB/s). The stack rows are random 348 B reads from
// a 23 x 7,184 x 87 x 4 B = 57 MB stack, more than the 50 MB L2 as a whole;
// the grid runs pattern-major (below), so the rows in use, one pattern's
// 2.5 MB, stay in L2 and HBM is read about once. Each element's m row loads
// are a dependent chain of L2 hits: measured on an H100 the rows fold takes
// ~1.0 ms at that shape, on uniformly random rows and on the scan's own
// final states alike — the chains' latency bounds it, not the bytes.
//
// Design: the output is cut into tiles of at most `elems` elements — whole
// rows (rows_per_tile rows of n) or, for n > elems, segments of elems
// columns of one row — and a block of kThreads threads takes one tile, so
// a row index is a 32-bit division inside the tile. The launch sizes elems
// from the work (256 to 4,096, about eight tiles per SM), so a small fold
// still spreads over the SMs and a large one runs as ~4,096-element tiles.
// Each thread then walks up to kChains elements of its tile at once: their
// chains are independent, so kChains loads are in flight per thread at every
// step, the memory-level parallelism a gather of this kind needs (on an
// H100, one element a thread left the census fold at 1.1 ms against 0.89
// for a looping kernel). The rows form runs a 2-D grid, blockIdx.y = the
// pattern p, with x fastest: the blocks in flight work on one or two
// patterns, so their 2.5 MB of stack rows stay in L2 (a grid-stride over
// all patterns at once thrashed it on an H100: 3.0 ms against 1.3).
// Consecutive threads take consecutive q of one row: the f reads and out
// writes are coalesced, and the warp's g_j reads fall in one 4n-byte row.

#include <cstdint>
#include <cuda_runtime.h>

#include "device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 4;          // elements a thread walks at once
constexpr int kMinTile = kThreads;  // elements of a tile, at least
constexpr int kMaxTile = kThreads * kChains * 4;
constexpr int kTilesPerSM = 8;

template <bool kRows>
__global__ void __launch_bounds__(kThreads)
compose_fold_kernel(const int32_t *__restrict__ f,
                    const int32_t *__restrict__ g,
                    const int32_t *__restrict__ idx,
                    int32_t *__restrict__ out, long long rows_total, int n,
                    int m, int S, int rows_per_tile, int segs, int elems) {
  const int p = blockIdx.y;  // 0 in the stacked form
  const long long tile = blockIdx.x;
  long long row0;
  int c0 = 0, cols = n, rows = 1;
  if (segs > 1) {  // one segment of one wide row
    row0 = tile / segs;
    c0 = (int)(tile - row0 * segs) * elems;
    cols = min(elems, n - c0);
  } else {  // whole rows
    row0 = tile * rows_per_tile;
    const long long left = rows_total - row0;
    rows = left < rows_per_tile ? (int)left : rows_per_tile;
  }
  const int span = rows * cols;
  const size_t prow = (size_t)p * rows_total + row0;  // flat (p, d) or b
  const int32_t *stack = g + (size_t)p * S * n;      // rows form: stacks[p]

  for (int e0 = threadIdx.x; e0 < span; e0 += kChains * kThreads) {
    int s[kChains];
    size_t at[kChains];              // out offset; ix / g_0 row below
    const int32_t *src[kChains];
#pragma unroll
    for (int u = 0; u < kChains; ++u) {
      int e = e0 + u * kThreads;
      e = e < span ? e : e0;  // past the tile: repeat e0, store nothing
      const int r = e / cols;
      const int q = c0 + (e - r * cols);
      const size_t row = prow + r;
      at[u] = row * n + q;
      if (kRows) {
        src[u] = idx + row * m;
        s[u] = q;
      } else {
        src[u] = g + row * m * n;
        s[u] = f ? __ldg(f + at[u]) : q;
      }
    }
    for (int j = 0; j < m; ++j) {
#pragma unroll
      for (int u = 0; u < kChains; ++u) {
        if (kRows)
          s[u] = __ldg(stack + (size_t)__ldg(src[u] + j) * n + s[u]);
        else
          s[u] = __ldg(src[u] + (size_t)j * n + s[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kChains; ++u)
      if (e0 + u * kThreads < span) out[at[u]] = s[u];
  }
}

template <bool kRows>
int launch(const void *f, const void *g, const void *idx, void *out,
           long long rows_total, int n, int m, int S, int P, void *stream) {
  // Tile size: the work over kTilesPerSM tiles per SM, a power of two
  // clamped to [kMinTile, kMaxTile].
  const long long per_tile =
      (long long)P * rows_total * n / ((long long)sm_count() * kTilesPerSM);
  int elems = kMinTile;
  while (elems < kMaxTile && 2LL * elems <= per_tile) elems *= 2;
  int rows_per_tile = 1, segs = 1;
  if (n <= elems)
    rows_per_tile = elems / n;
  else
    segs = (n + elems - 1) / elems;
  const long long tiles =
      segs > 1 ? rows_total * segs
               : (rows_total + rows_per_tile - 1) / rows_per_tile;
  dim3 grid((unsigned)tiles, (unsigned)P);
  compose_fold_kernel<kRows><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t *)f, (const int32_t *)g, (const int32_t *)idx,
      (int32_t *)out, rows_total, n, m, S, rows_per_tile, segs, elems);
  return (int)cudaGetLastError();
}

}  // namespace

// Stacked form: f (B, n) or null, gs (B, m, n) -> out (B, n).
extern "C" int compose_launch(const void *f, const void *gs, void *out,
                              long long B, int n, int m, void *stream) {
  return launch<false>(f, gs, nullptr, out, B, n, m, 0, 1, stream);
}

// Rows form: stacks (P, S, n), idx (P, D, m) -> out (P, D, n).
extern "C" int compose_rows_launch(const void *stacks, const void *idx,
                                   void *out, int P, int S, int n,
                                   long long D, int m, void *stream) {
  return launch<true>(nullptr, stacks, idx, out, D, n, m, S, P, stream);
}

extern "C" const char *compose_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
