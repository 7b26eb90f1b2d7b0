// spec_resolve: validate and repair of speculative scanning, one launch.
//
// Replaces the reference's XLA loop (no Pallas kernel there):
// src/repro/speculative/executor.py:94 (_speculative_core), its lax.scan
// validation walk and its lax.while_loop of repair rounds. In PyTorch that
// loop is C validation steps of about ten small ops each, up to
// max_rounds + 1 times, with a host sync a round to test "all resolved";
// here it is one launch, and the caller syncs once to read the totals.
//
// Inputs: tables (P, n, k); spec (P, m) speculated chunk entry states;
// starts (P,); exits (P, D*C, m), exits[p, d*C + c, q] the state chunk c of
// doc d leaves from spec[p, q] (match_bank_chunks with explicit starts);
// chunks (D*C, Lc) symbols. Outputs: finals (P, D) int32, resolved (P, D)
// bool (one byte), totals (3,) int64 = [hit_chunks, repaired, rounds].
//
// One thread per (pattern, doc) lane walks the C chunks in order from
// starts[p]:
// - the entry state is speculated (spec[p, q] == entry, first such q): it
//   adopts exits[..., q] and counts a hit;
// - else, with fewer than max_rounds repairs so far, it re-walks the chunk
//   from its exact entry, reading the table from global memory (L2), and
//   counts one repair;
// - else the lane stops unresolved, its final state the chunk's entry.
// Then hit_chunks = sum of the hits walked, repaired = sum of the repairs,
// rounds = the most repairs of any lane.
//
// That is the reference loop's function: a round repairs exactly the first
// unrepaired miss of every broken lane, so a lane with j misses on its exact
// path takes min(j, max_rounds) repairs, the loop runs min(max_rounds,
// max_j) rounds, its last validation counts the hits a lane walks before
// its first unrepaired miss, and an unresolved lane keeps that miss's entry
// (its "last verified state"). kernels/ref.py::spec_resolve runs the rounds
// literally; the two check each other on the card.
//
// What bounds it: a lane is a dependent chain (each chunk's entry is the
// previous exit), C compares of m registers and one 4-byte exit load a
// chunk, plus Lc dependent table loads a repair. The compares and the
// exit loads are small beside the m-lane pass that wrote the exits; a
// profile that misses turns every chunk into a walk of Lc L2 loads. A warp
// takes 32 consecutive docs of one pattern; spec[p] sits in shared memory,
// read as a broadcast. The totals reduce within the warp (__reduce_*_sync)
// and take one atomic a warp each.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    spec_resolve_kernel(const int32_t *__restrict__ tables,
                        const int32_t *__restrict__ spec,
                        const int32_t *__restrict__ starts,
                        const int32_t *__restrict__ exits,
                        const int32_t *__restrict__ chunks,
                        int32_t *__restrict__ finals,
                        uint8_t *__restrict__ resolved,
                        unsigned long long *__restrict__ totals, int n, int k,
                        int m, long long D, int C, int Lc, int max_rounds) {
  extern __shared__ int32_t sp[];
  const int p = blockIdx.y;
  for (int i = threadIdx.x; i < m; i += blockDim.x)
    sp[i] = spec[(size_t)p * m + i];
  __syncthreads();

  const long long d = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned hits = 0, repairs = 0;
  if (d < D) {
    const int32_t *tab = tables + (size_t)p * n * k;
    int cur = starts[p];
    bool ok = true;
    for (int c = 0; c < C; ++c) {
      const size_t chunk = (size_t)d * C + c;
      int q = 0;
      while (q < m && sp[q] != cur) ++q;
      if (q < m) {
        cur = __ldg(exits + ((size_t)p * D * C + chunk) * m + q);
        ++hits;
      } else if ((int)repairs < max_rounds) {
        const int32_t *sym = chunks + chunk * Lc;
        for (int t = 0; t < Lc; ++t)
          cur = __ldg(tab + (size_t)cur * k + __ldg(sym + t));
        ++repairs;
      } else {
        ok = false;
        break;
      }
    }
    finals[(size_t)p * D + d] = cur;
    resolved[(size_t)p * D + d] = ok ? 1 : 0;
  }
  hits = __reduce_add_sync(0xffffffffu, hits);
  const unsigned most = __reduce_max_sync(0xffffffffu, repairs);
  repairs = __reduce_add_sync(0xffffffffu, repairs);
  if ((threadIdx.x & 31) == 0 && (hits || repairs)) {
    atomicAdd(totals + 0, (unsigned long long)hits);
    atomicAdd(totals + 1, (unsigned long long)repairs);
    atomicMax(totals + 2, (unsigned long long)most);
  }
}

}  // namespace

extern "C" int spec_resolve_launch(const void *tables, const void *spec,
                                   const void *starts, const void *exits,
                                   const void *chunks, void *finals,
                                   void *resolved, void *totals, int P, int n,
                                   int k, int m, long long D, int C, int Lc,
                                   int max_rounds, void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(totals, 0, 3 * sizeof(long long), st);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (D + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL || P > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)m * sizeof(int32_t);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(spec_resolve_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  spec_resolve_kernel<<<dim3((unsigned)blocks, (unsigned)P), kThreads, smem,
                        st>>>(
      (const int32_t *)tables, (const int32_t *)spec, (const int32_t *)starts,
      (const int32_t *)exits, (const int32_t *)chunks, (int32_t *)finals,
      (uint8_t *)resolved, (unsigned long long *)totals, n, k, m, D, C, Lc,
      max_rounds);
  return (int)cudaGetLastError();
}

extern "C" const char *spec_resolve_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
