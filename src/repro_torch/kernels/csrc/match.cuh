// match.cuh: the chunk walk of match_bank_chunks.cu and match_chunks.cu.
//
// Computes out[p, b, q] = tables[p] walked from state q over chunks[b, :]
// for tables (P, n, k), chunks (B, L) -> (P, B, n_starts) int32; a walk is
// s <- tables[p, s, chunks[b, t]] for t = 0 .. L-1. match_chunks is its
// P = 1, n_starts = n case. Given explicit starts (P, n_starts), lane q of
// pattern p walks from starts[p, q] instead (the speculative scan's m-lane
// pass from a hot-state profile); only the seed of a chain changes, in its
// own instantiations (kFrom), so the walks from 0 .. n_starts-1 compile as
// they did; a start on a row >= R takes the L2 branch like any other step.
// Walks from explicit starts are always chunk-major, so kFrom is built for
// the chunk-major layouts only (see launch_j).
//
// What bounds it on Hopper: the lookups. Each lane is a chain of L dependent
// loads (step t+1's address is step t's value), so latency bounds one lane;
// across the card the instructions issued a step and the shared-memory
// pipe (one 32-lane wavefront a cycle an SM, more with bank conflicts)
// bound it. The stated bound counts the int32 ops (an address and a load a
// step). Bytes are small beside it: chunks, tables and output once each.
// Measured on an H100 (PERF.md): the enumeration walk runs at about 1.6x
// that bound; an SFA walk of one lane a chunk spends more on reading its
// symbols (int32, once a table group) than on its lookups; a small launch
// (a stream piece) waits on staging loads and on its deepest walk.
//
// Design, with what each choice removes:
// - A step is a few instructions: the staged table holds each entry as the
//   byte offset of its target row (state * row * 4), so a step is one
//   symbol extraction (shared by the chains of one chunk), one add and one
//   shared load. Where the whole table is staged (kAll) nothing else runs.
// - Symbols never come from global memory at a step. Each warp stages its
//   own chunks, a slab of steps at a time, into a private shared buffer with
//   coalesced loads (16 B a lane where the chunks are aligned and L % 4 ==
//   0), four symbols a 32-bit word where k <= 256 (SPW = 4), one a word
//   above (SPW = 1). The buffer is laid out word[step / SPW][chunk] with an
//   odd chunk stride, so lanes on neighbouring chunks read neighbouring
//   words (no bank conflict) and lanes on one chunk read one word (a
//   broadcast); one word read serves SPW steps. Only __syncwarp orders the
//   slabs: a warp never waits for another.
// - A block stages the tables of a group of patterns and walks each staged
//   slab through all of them: where a chunk fits one slab, its symbols leave
//   global memory once for the group, not once a pattern (the enumeration
//   group's five 87-state tables fit one block together).
// - Several independent chains a thread (J), so J loads are in flight at
//   every step. Two ways to put (chunk, start state) lanes on a warp:
//     chunk-major (n_starts < 32, the SFA path's n_starts = 1): lane item
//       i = lane + 32 j is chunk i / n_starts, start i % n_starts; a warp
//       takes floor(32 J / n_starts) chunks (walks from explicit starts at
//       n_starts >= 32: chunk j, start g·32 + lane, ceil(n_starts / 32)
//       groups g);
//     start-major (n_starts >= 32, enumeration and match_chunks): a warp
//       takes one chunk and starts q = g·32J + lane + 32 j, so one word read
//       and one extraction serve all J chains (kOne); more than 32 J starts
//       take several groups g.
// - Table rows are staged padded to k | 1 words (table.cuh, shared with
//   spec_resolve.cu), so 32 lanes in 32 different states on one symbol
//   fall on 32 banks (an even width of 20 words put s*20 + sym on 8 of
//   32). A table larger than the block's
//   budget stages its first R rows; a step whose warp has a walk on a row
//   >= R reads that row from global memory (L2), found by a warp vote, so
//   the common step stays a shared load: exact for any traffic, fast where
//   the walks stay near state 0 — SFA states are numbered in the order they
//   are found from state 0, and the bundled bank's walks stay on the first
//   few hundred rows.
// - The grid is (pattern group fastest, block group): blocks of every
//   pattern group with the same block group walk the same chunks at about
//   the same time, so later groups find them in L2. Each block stages its
//   tables once and strides over the warp tasks; each warp stages its first
//   slab before the block stages its tables, so the two waits overlap. The
//   launch sizes the block groups from the card's resident blocks.
//
// The plan (threads, chains, layout, slab, staged rows, patterns a block,
// shared bytes) is made by kernels/ops.py::match_plan, where the CPU tests
// reach it, and arrives as an int array in the order of Field below.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "device.cuh"
#include "table.cuh"

// Internal linkage throughout: match_bank_chunks.cu and match_chunks.cu
// build into two libraries of one process, and a template's function-local
// statics (the opted-in shared memory below) must not be one variable
// shared by both.
namespace match {
namespace {

enum Field {
  kThreads,        // threads a block, a multiple of 32 up to 512
  kChains,         // J, chains a thread: 1 .. 3
  kOneChunk,       // 1: start-major (one chunk a warp), 0: chunk-major
  kSymPerWord,     // SPW: 4 (byte symbols, k <= 256) or 1
  kChunksPerWarp,  // chunks a warp task
  kLanesPerChunk,  // start states a warp task takes of each chunk
  kGroups,         // warp tasks a chunk (start-major, n_starts > 32 J)
  kSlabWords,      // symbol words of each chunk a slab stages
  kStride,         // word stride between slab rows: chunks_per_warp | 1
  kRows,           // R, table rows staged in shared memory, each pattern
  kPatterns,       // patterns a block stages and walks
  kSmem            // dynamic shared bytes a block
};

constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int32_t *tables, *chunks;
  const int32_t *starts;  // (P, n_starts) start states, or null: q itself
  int32_t *out;
  int P, n, k, L, n_starts;
  int cw, qw, groups, slab_words, stride, rows, pg, n_pgroups;
  int rowb;          // bytes of a staged row, (k | 1) * 4
  int roff;          // rows * rowb: offsets at or past it are global rows
  unsigned inv_row;  // (k | 1)^-1 mod 2^32: offset / 4 * inv_row = state
  long long B, tasks;
  bool vec;   // 16-byte symbol loads: chunks aligned and L % 4 == 0
  bool tvec;  // 16-byte table loads: tables aligned and n * k % 4 == 0
};

// Symbol u of word w.
template <int SPW>
__device__ __forceinline__ int symbol(uint32_t w, int u) {
  return SPW == 1 ? (int)w : (int)__byte_perm(w, 0, 0x4440 | u);
}

// The next offset from offset s on symbol a, s a staged row.
__device__ __forceinline__ int lds_step(const char *ts, int s, int a) {
  return table::lds_step(ts, s, a);
}

// The next offset from offset s on symbol a, s any row: rows >= R from the
// pattern's table in global memory.
__device__ __forceinline__ int any_step(const Args &a, const char *ts,
                                        const int32_t *tg, int s, int sym) {
  return table::any_step(ts, tg, s, sym, a.roff, a.inv_row, a.rowb, a.k);
}

// Stage steps [t0, t0 + steps) of chunks [b0, b0 + cwv) into buf:
// buf[tw * stride + c] = word tw of chunk c. Lane l takes words
// w = l, l + 32, ... in (chunk, word) order, (c, tw) carried from one to
// the next without a division, kSymBatch loads in flight before their
// stores (a small launch waits on these loads, not on the walk).
constexpr int kSymBatch = 8;

template <int SPW>
__device__ __forceinline__ void stage(const Args &a, uint32_t *buf,
                                      long long b0, int cwv, int t0,
                                      int steps, int lane) {
  const int nw = (steps + SPW - 1) / SPW;
  const int dc = 32 / nw, dtw = 32 - dc * nw;
  int c = lane / nw, tw = lane - c * nw;
  while (c < cwv) {
    uint32_t word[kSymBatch];
    int at[kSymBatch];
#pragma unroll
    for (int u = 0; u < kSymBatch; ++u) {
      at[u] = -1;
      if (c < cwv) {
        const int32_t *src =
            a.chunks + (size_t)(b0 + c) * a.L + t0 + tw * SPW;
        if (SPW == 1) {
          word[u] = (uint32_t)__ldg(src);
        } else if (a.vec) {
          const int4 v = __ldg(reinterpret_cast<const int4 *>(src));
          word[u] = __byte_perm(__byte_perm(v.x, v.y, 0x0040),
                                __byte_perm(v.z, v.w, 0x0040), 0x5410);
        } else {
          const int left = min(SPW, steps - tw * SPW);
          word[u] = 0;
          for (int i = 0; i < left; ++i)
            word[u] |= (uint32_t)__ldg(src + i) << 8 * i;
        }
        at[u] = tw * a.stride + c;
      }
      c += dc;
      tw += dtw;
      if (tw >= nw) {
        tw -= nw;
        ++c;
      }
    }
#pragma unroll
    for (int u = 0; u < kSymBatch; ++u)
      if (at[u] >= 0) buf[at[u]] = word[u];
  }
}

// Stage rows [0, R) of one table into dst, each entry as the byte offset
// of its target row, rows padded to `row` words.
__device__ __forceinline__ void stage_table(const Args &a,
                                            const int32_t *tab,
                                            int32_t *dst, int row) {
  table::stage(tab, dst, a.rows, a.k, row, a.rowb, a.tvec);
}

// One step of every chain on symbols sym[j].
template <int J, bool kAll>
__device__ __forceinline__ void step(const Args &a, const char *ts,
                                     const int32_t *tg, int (&s)[J],
                                     const int (&sym)[J]) {
  if (kAll) {
#pragma unroll
    for (int j = 0; j < J; ++j) s[j] = lds_step(ts, s[j], sym[j]);
    return;
  }
  bool far = false;
#pragma unroll
  for (int j = 0; j < J; ++j) far |= s[j] >= a.roff;
  if (__any_sync(kFull, far)) {
#pragma unroll
    for (int j = 0; j < J; ++j) s[j] = any_step(a, ts, tg, s[j], sym[j]);
  } else {
#pragma unroll
    for (int j = 0; j < J; ++j) s[j] = lds_step(ts, s[j], sym[j]);
  }
}

// The first n_u steps of the word each chain reads at wr[c[j]].
template <int SPW, int J, bool kOne, bool kAll>
__device__ __forceinline__ void walk_word(const Args &a, const char *ts,
                                          const int32_t *tg,
                                          const uint32_t *wr,
                                          const int (&c)[J], int (&s)[J],
                                          int n_u) {
  uint32_t w[J];
#pragma unroll
  for (int j = 0; j < J; ++j) w[j] = (kOne && j) ? w[0] : wr[c[j]];
  if (n_u == SPW) {
#pragma unroll
    for (int u = 0; u < SPW; ++u) {
      int sym[J];
#pragma unroll
      for (int j = 0; j < J; ++j)
        sym[j] = (kOne && j) ? sym[0] : symbol<SPW>(w[j], u);
      step<J, kAll>(a, ts, tg, s, sym);
    }
  } else {  // a ragged last word (SPW = 4 only)
    for (int u = 0; u < n_u; ++u) {
      int sym[J];
#pragma unroll
      for (int j = 0; j < J; ++j)
        sym[j] = (kOne && j) ? sym[0] : symbol<SPW>(w[j], u);
      step<J, kAll>(a, ts, tg, s, sym);
    }
  }
}

template <int SPW, int J, bool kOne, bool kAll, bool kFrom>
__global__ void __launch_bounds__(512) walk_kernel(const Args a) {
  extern __shared__ int32_t smem[];
  const int row = a.k | 1, tab_words = a.rows * row;
  const int pgi = blockIdx.x % a.n_pgroups;
  const long long group = blockIdx.x / a.n_pgroups;
  const long long n_groups = gridDim.x / a.n_pgroups;
  const int p0 = pgi * a.pg, np = min(a.pg, a.P - p0);
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint32_t *buf = reinterpret_cast<uint32_t *>(smem + a.pg * tab_words) +
                  warp * a.slab_words * a.stride;
  const int slab = a.slab_words * SPW;
  const bool one_slab = a.L <= slab;

  // Each warp stages the first slab of its first task, then the block its
  // tables (kStageBatch loads in flight a thread, 16 B each where the
  // tables are aligned): the two waits overlap.
  const long long first = group * warps + warp;
  if (first < a.tasks && a.L > 0) {
    const long long b0 = first / a.groups * a.cw;
    stage<SPW>(a, buf, b0, (int)min((long long)a.cw, a.B - b0), 0,
               min(slab, a.L), lane);
  }
  for (int pi = 0; pi < np; ++pi)
    stage_table(a, a.tables + (size_t)(p0 + pi) * a.n * a.k,
                smem + pi * tab_words, row);
  __syncthreads();

  for (long long task = first; task < a.tasks; task += n_groups * warps) {
    const long long b0 = task / a.groups * a.cw;
    const int g = (int)(task % a.groups);
    const int cwv = (int)min((long long)a.cw, a.B - b0);
    int c[J], q[J];
    bool live[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int i = lane + 32 * j, cj = kOne ? 0 : i / a.qw;
      q[j] = g * a.qw + (i - cj * a.qw);
      live[j] = cj < cwv && q[j] < a.n_starts;
      c[j] = live[j] ? cj : 0;  // a dead chain walks from 0, stores nothing
    }
    for (int pi = 0; pi < np; ++pi) {
      const char *ts = reinterpret_cast<const char *>(smem + pi * tab_words);
      const int32_t *tg = a.tables + (size_t)(p0 + pi) * a.n * a.k;
      int s[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        int from = live[j] ? q[j] : 0;
        if (kFrom && live[j])
          from = __ldg(a.starts + (size_t)(p0 + pi) * a.n_starts + q[j]);
        s[j] = from * a.rowb;
      }
      for (int t0 = 0; t0 < a.L; t0 += slab) {
        const int steps = min(slab, a.L - t0);
        if ((!one_slab || pi == 0) && (task != first || t0 || pi)) {
          __syncwarp();  // every lane is done with the previous slab
          stage<SPW>(a, buf, b0, cwv, t0, steps, lane);
          __syncwarp();
        }
        const int full = steps / SPW;
        for (int tw = 0; tw < full; ++tw)
          walk_word<SPW, J, kOne, kAll>(a, ts, tg, buf + tw * a.stride, c,
                                        s, SPW);
        if (full * SPW < steps)
          walk_word<SPW, J, kOne, kAll>(a, ts, tg, buf + full * a.stride, c,
                                        s, steps - full * SPW);
      }
      int32_t *out = a.out + (size_t)(p0 + pi) * a.B * a.n_starts;
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (live[j])
          out[(size_t)(b0 + c[j]) * a.n_starts + q[j]] =
              table::state_of(s[j], a.inv_row);
    }
  }
}

template <int SPW, int J, bool kOne, bool kAll, bool kFrom>
int launch_t(const Args &a, int threads, int smem, cudaStream_t stream) {
  auto kernel = walk_kernel<SPW, J, kOne, kAll, kFrom>;
  // Per instantiation and device, kept across launches: the shared memory
  // opted in to and the resident blocks an SM at the last (threads, smem).
  struct Seen {
    int opted = 48 * 1024, threads = -1, smem = -1, per_sm = 1;
  };
  static Seen seen[kMaxDevices];
  const int dev = current_device();
  Seen once;
  Seen &d = dev >= 0 && dev < kMaxDevices ? seen[dev] : once;
  cudaError_t e;
  if (smem > d.opted) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    d.opted = smem;
  }
  if (threads != d.threads || smem != d.smem) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&d.per_sm, kernel,
                                                      threads, smem);
    if (e != cudaSuccess) return (int)e;
    if (d.per_sm < 1) d.per_sm = 1;
    d.threads = threads;
    d.smem = smem;
  }
  // Block groups: the resident blocks shared among the pattern groups, at
  // least one, and no more than the warp tasks need.
  const long long warps = threads / 32;
  long long groups = (long long)sm_count(dev) * d.per_sm / a.n_pgroups;
  const long long need = (a.tasks + warps - 1) / warps;
  if (groups > need) groups = need;
  if (groups < 1) groups = 1;
  if ((long long)a.n_pgroups * groups > 0x7fffffffLL)
    groups = 0x7fffffffLL / a.n_pgroups;
  kernel<<<(unsigned)(a.n_pgroups * groups), threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Walks from explicit starts are chunk-major with 1 or 2 chains at any
// n_starts (ops.match_plan lays them out so), so only those 8 of their
// instantiations are built: 32 kernels in all.
template <int SPW, int J, bool kFrom>
int launch_j(const Args &a, bool one, bool all, int threads, int smem,
             cudaStream_t st) {
  if constexpr (!kFrom) {
    if (one)
      return all ? launch_t<SPW, J, true, true, false>(a, threads, smem, st)
                 : launch_t<SPW, J, true, false, false>(a, threads, smem, st);
  } else {
    if (one) return (int)cudaErrorInvalidValue;
  }
  return all ? launch_t<SPW, J, false, true, kFrom>(a, threads, smem, st)
             : launch_t<SPW, J, false, false, kFrom>(a, threads, smem, st);
}

template <int SPW, bool kFrom>
int launch_spw(const Args &a, int chains, bool one, bool all, int threads,
               int smem, cudaStream_t st) {
  switch (chains) {
    case 1: return launch_j<SPW, 1, kFrom>(a, one, all, threads, smem, st);
    case 2: return launch_j<SPW, 2, kFrom>(a, one, all, threads, smem, st);
    case 3:
      if constexpr (kFrom) return (int)cudaErrorInvalidValue;
      else return launch_j<SPW, 3, kFrom>(a, one, all, threads, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Walk every chunk through every table as `plan` (an int a Field) says,
// from states 0 .. n_starts-1, or (kFrom) from starts[p, :].
template <bool kFrom>
int run(const void *tables, const void *chunks, const void *starts,
        void *out, int P, int n, int k, long long B, int L, int n_starts,
        const int *plan, void *stream) {
  Args a;
  a.tables = (const int32_t *)tables;
  a.chunks = (const int32_t *)chunks;
  a.starts = (const int32_t *)starts;
  a.out = (int32_t *)out;
  a.P = P;
  a.n = n;
  a.k = k;
  a.L = L;
  a.n_starts = n_starts;
  a.cw = plan[kChunksPerWarp];
  a.qw = plan[kLanesPerChunk];
  a.groups = plan[kGroups];
  a.slab_words = plan[kSlabWords];
  a.stride = plan[kStride];
  a.rows = plan[kRows];
  a.pg = plan[kPatterns];
  a.n_pgroups = (P + a.pg - 1) / a.pg;
  const unsigned row = (unsigned)(k | 1);
  a.rowb = (int)row * 4;
  a.roff = a.rows * a.rowb;
  a.inv_row = table::inverse(row);
  a.B = B;
  a.tasks = (B + a.cw - 1) / a.cw * a.groups;
  a.vec = ((uintptr_t)chunks & 15) == 0 && (L & 3) == 0;
  a.tvec = ((uintptr_t)tables & 15) == 0 && ((long long)n * k & 3) == 0;
  const bool one = plan[kOneChunk] != 0, all = a.rows == n;
  const int threads = plan[kThreads], smem = plan[kSmem];
  cudaStream_t st = (cudaStream_t)stream;
  if (plan[kSymPerWord] == 4)
    return launch_spw<4, kFrom>(a, plan[kChains], one, all, threads, smem,
                                st);
  return launch_spw<1, kFrom>(a, plan[kChains], one, all, threads, smem, st);
}

}  // namespace
}  // namespace match
