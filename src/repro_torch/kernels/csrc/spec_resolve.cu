// spec_resolve: validate and repair of speculative scanning, one launch, in
// two forms.
//
// Replaces the reference's XLA loop (no Pallas kernel there):
// src/repro/speculative/executor.py:94 (_speculative_core), its lax.scan
// validation walk and its lax.while_loop of repair rounds; and, in the
// chained form, the reference stream's per-block loop around it
// (src/repro/engine/streaming.py:129, its enumeration fallback included).
//
// Inputs: tables (P, n, k); spec (P, m) speculated chunk entry states;
// starts (P,); exits (P, D*C, m), exits[p, d*C + c, q] the state chunk c of
// doc d leaves from spec[p, q] (match_bank_chunks with explicit starts);
// chunks (D*C, Lc) symbols.
//
// A lane walks the C chunks of a doc in order from its entry state:
// - the entry state is speculated (spec[p, q] == entry, first such q): it
//   adopts exits[..., q] and counts a hit;
// - else, with fewer than max_rounds repairs so far, it re-walks the chunk
//   from its exact entry on the table and counts one repair;
// - else the lane is unresolved, its last verified state the chunk's entry.
// That is the reference loop's function: a round repairs exactly the first
// unrepaired miss of every broken lane, so a lane with j misses on its exact
// path takes min(j, max_rounds) repairs, the loop runs min(max_rounds,
// max_j) rounds, its last validation counts the hits a lane walks before
// its first unrepaired miss, and an unresolved lane keeps that miss's entry.
// kernels/ref.py::spec_resolve runs the rounds literally; the two check
// each other on the card.
//
// Independent docs (spec_resolve_launch): lane (p, d) starts from
// starts[p]. Outputs finals (P, D) int32, resolved (P, D) bool (one byte),
// totals (3,) int64 = [hit_chunks, repaired, rounds], rounds the most
// repairs of any lane.
//
// Chained (spec_resolve_chain_launch): the D docs are the successive
// blocks of one input, so pattern p has one lane: doc d + 1 starts from doc
// d's exact final state, and an unresolved doc walks on exactly from its
// last verified state through its remaining chunks (the state the
// reference's enumeration fallback gives) and counts one fallback lane. The
// repair bound is per doc, as the reference's per-block calls have it.
// Outputs finals (P,) int32, the state after the last doc, and totals (4,)
// int64 = [hit_chunks, repaired, rounds, fallback_lanes]: the sums over
// (pattern, doc) and, for rounds, the most repairs of one doc's lane: the
// reference's per-block SpeculationStats merged.
//
// The table (table.cuh, shared with the chunk walks) is staged in shared
// memory as row byte offsets, rows padded to k | 1 words; a repair step is
// one add and one shared load. ops.resolve_plan sets the rows R a block
// stages (all of a 702 x 20 table: 59 KB); a step from a row >= R reads
// global memory (L2).
//
// What bounds each form on Hopper, and what the design does about it:
// - Independent docs, a profile that hits: the exits. Each (lane, chunk)
//   adopts one word of an m-word row of (P, D*C, m), and a row is one
//   32-byte sector at m = 8, so the whole exits array crosses from device
//   memory; read a sector a lane, scattered 256 bytes apart, it came at
//   about half the rate. Every doc's first chunk is entered in the
//   pattern's start state, so where that state is speculated every doc
//   hits there, and each warp first stages its 32 docs' exits into a
//   shared slab with coalesced 16-byte loads, 8 in flight a lane, rows
//   padded to C*m + 1 words so the lanes' reads fall on different banks;
//   a hit is then a shared load. Else a hit reads its exit from global
//   memory, and a profile that misses reads no exits at all.
// - Independent docs, a profile that misses: the repairs, Lc steps each,
//   the shared-memory pipe (random lookups conflict on banks) and each
//   repaired chunk's symbols. A block stages its table only once one of its
//   lanes needs a repair (a block-wide vote), and blocks are persistent
//   over the docs of their pattern, so one staging serves many docs and a
//   profile that hits stages nothing. A repair loads its symbols 4 ahead
//   of their steps (16-byte loads where the chunks are aligned and
//   Lc % 4 == 0), so no global load sits on the chain. The grid is pattern
//   fastest: the blocks of every pattern on the same docs run together and
//   read the repaired chunks' symbols from L2 after the first pattern.
// - Chained: one lane a pattern is one dependent chain, one shared load a
//   hit and one a repair step: latency, about 36 cycles a step on an H100
//   (chip_smoke.py's chained miss case).
//   A block of 256 threads stages the table once a launch, then its warp 0
//   walks: its lanes stage the exits of the next `group` chunks (32 at
//   m = 8) into shared memory with coalesced loads, the group after it
//   loading into registers meanwhile, find a hit by one ballot over the
//   profile, and walk the chain together on shared data (every lane
//   computes the same state; its loads are broadcasts), a repair's
//   symbols 64 ahead of its steps so that a batch outlasts an L2 round
//   trip. The walk steps pointers, not 64-bit indices: index arithmetic
//   on the chain cost more than the shared load. One launch serves a whole
//   stream piece, where the reference makes one call (and the port made
//   one launch and one host sync) a block.

#include <cstdint>
#include <cuda_runtime.h>

#include "device.cuh"
#include "table.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// Threads a block: independent docs (ops.SPEC_THREADS; two blocks an SM
// without slabs, one with), chained (all stage the table, warp 0 walks).
constexpr int kThreads = 512, kChainThreads = 256;
// Profile states a lane holds in registers (m <= kRow).
constexpr int kRow = 8;
// Symbols a repair loads ahead of their steps: few where many lanes hide
// each other's loads (independent docs, 64 registers a thread), more where
// one chain runs alone and a batch must outlast an L2 round trip (at 8 or
// 32 a step waited on its symbols). Exit words (16-byte words in a slab) a
// lane loads before their stores.
constexpr int kDocsSyms = 4, kChainSyms = 64, kExitBatch = 8;

struct Args {
  const int32_t *tables, *spec, *starts, *exits, *chunks;
  int32_t *finals;
  uint8_t *resolved;  // independent docs only
  unsigned long long *totals;
  int P, n, k, m, C, Lc, max_rounds;
  long long D;
  int rows;           // R, table rows staged
  int group;          // chained: chunks whose exits a warp stages at once
  int slab;           // docs: words of a warp's exits slab, 32 (C m + 1)
  int rowb, roff;     // bytes of a staged row; rows * rowb
  unsigned inv_row;   // (k | 1)^-1 mod 2^32
  bool tvec;          // 16-byte table loads: tables aligned, n * k % 4 == 0
  bool svec;          // 16-byte symbol loads: chunks aligned, Lc % 4 == 0
  bool xvec;          // 16-byte slab loads: exits aligned, C m % 4 == 0
};

// Words of shared memory before the table: the profile, then (chained) the
// staged exits, each padded to 16 bytes.
__device__ __forceinline__ int pad4(int w) { return (w + 3) & ~3; }

// Symbols p[0 .. min(left, S)), 0 past them.
template <int S>
__device__ __forceinline__ void load_syms(const int32_t *p, int left,
                                          bool vec, int (&v)[S]) {
  static_assert(S % 4 == 0, "a batch is whole 16-byte loads");
  if (vec) {
#pragma unroll
    for (int h = 0; h < S / 4; ++h) {
      int4 x = make_int4(0, 0, 0, 0);
      if (4 * h < left) x = __ldg(reinterpret_cast<const int4 *>(p) + h);
      v[4 * h] = x.x;
      v[4 * h + 1] = x.y;
      v[4 * h + 2] = x.z;
      v[4 * h + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < S; ++u) v[u] = u < left ? __ldg(p + u) : 0;
  }
}

template <bool kAll>
__device__ __forceinline__ int step(const Args &a, const char *ts,
                                    const int32_t *tg, int s, int sym) {
  if (kAll) return table::lds_step(ts, s, sym);
  return table::any_step(ts, tg, s, sym, a.roff, a.inv_row, a.rowb, a.k);
}

// The state one chunk's symbols sym[0 .. Lc) lead to from `state`: the
// next S symbols load while the current S step.
template <int S, bool kAll>
__device__ __forceinline__ int walk_chunk(const Args &a, const char *ts,
                                          const int32_t *tg,
                                          const int32_t *sym, int state) {
  int s = state * a.rowb;
  int v[S];
  load_syms<S>(sym, a.Lc, a.svec, v);
  for (int t = 0; t < a.Lc; t += S) {
    int w[S];
    load_syms<S>(sym + t + S, a.Lc - t - S, a.svec, w);
    const int steps = a.Lc - t;
#pragma unroll
    for (int u = 0; u < S; ++u)
      if (u < steps) s = step<kAll>(a, ts, tg, s, v[u]);
#pragma unroll
    for (int u = 0; u < S; ++u) v[u] = w[u];
  }
  return table::state_of(s, a.inv_row);
}

// --- independent docs ------------------------------------------------------

enum Status { kWalking, kNeedsTable, kStopped, kResolved };

struct Lane {
  int c, cur, rep, status;
};

// Stage the exits of docs [dw, dw + nd) of one pattern, rows ex (nd * C * m
// contiguous words), into a warp's slab xs: doc j's C * m words at
// j * (C * m + 1), so the lanes of a warp, each on its own doc, read their
// chunk's row on different banks. Coalesced: 16-byte loads where vec,
// lane l taking words 4l, 4l + 128, ... (a doc's row and the place in it
// carried from one to the next without a division).
__device__ __forceinline__ void stage_slab(const Args &a, const int32_t *ex,
                                           int nd, int32_t *xs, int lane) {
  const int cm = a.C * a.m, words = nd * cm;
  if (a.xvec) {
    const int4 *src = reinterpret_cast<const int4 *>(ex);
    int r = 4 * lane / cm, off = 4 * lane - r * cm;
    for (int i0 = 4 * lane; i0 < words; i0 += 128 * kExitBatch) {
      int4 v[kExitBatch];
#pragma unroll
      for (int u = 0; u < kExitBatch; ++u)
        if (i0 + 128 * u < words) v[u] = __ldg(src + i0 / 4 + 32 * u);
#pragma unroll
      for (int u = 0; u < kExitBatch; ++u) {
        if (i0 + 128 * u < words) {
          int32_t *dst = xs + r * (cm + 1) + off;
          dst[0] = v[u].x;
          dst[1] = v[u].y;
          dst[2] = v[u].z;
          dst[3] = v[u].w;
        }
        for (off += 128; off >= cm; off -= cm) ++r;
      }
    }
  } else {
    int r = lane / cm, off = lane - r * cm;
    for (int i0 = lane; i0 < words; i0 += 32 * kExitBatch) {
      int v[kExitBatch];
#pragma unroll
      for (int u = 0; u < kExitBatch; ++u)
        v[u] = i0 + 32 * u < words ? __ldg(ex + i0 + 32 * u) : 0;
#pragma unroll
      for (int u = 0; u < kExitBatch; ++u) {
        if (i0 + 32 * u < words) xs[r * (cm + 1) + off] = v[u];
        for (off += 32; off >= cm; off -= cm) ++r;
      }
    }
  }
}

// Walk lane ln of one doc (its exits rows ex, its chunks' symbols sym) on
// from chunk ln.c. It stops kStopped at a miss past the repair bound and
// kNeedsTable at a miss it may repair while the table is not staged (the
// block votes, stages, and calls again); else it ends kResolved. A hit
// reads its exit from the warp's slab xs where its docs' exits are staged,
// else from global memory. kReg: m <= kRow, the profile in registers spr
// (-1 past m); else in shared sp.
template <bool kReg, bool kAll>
__device__ __forceinline__ void resolve_lane(
    const Args &a, const int32_t *sp, const int (&spr)[kRow], const char *ts,
    const int32_t *tg, const int32_t *ex, const int32_t *xs,
    const int32_t *sym, bool staged, Lane &ln, unsigned &hits) {
  for (; ln.c < a.C; ++ln.c) {
    int q = a.m;
    if (kReg) {
#pragma unroll
      for (int j = kRow - 1; j >= 0; --j)
        if (spr[j] == ln.cur) q = j;
    } else {
      q = 0;
      while (q < a.m && sp[q] != ln.cur) ++q;
    }
    if (q < a.m) {
      ln.cur = xs ? xs[ln.c * a.m + q] : __ldg(ex + (size_t)ln.c * a.m + q);
      ++hits;
    } else if (ln.rep >= a.max_rounds) {
      ln.status = kStopped;
      return;
    } else if (!staged) {
      ln.status = kNeedsTable;
      return;
    } else {
      ln.cur = walk_chunk<kDocsSyms, kAll>(a, ts, tg,
                                           sym + (size_t)ln.c * a.Lc, ln.cur);
      ++ln.rep;
    }
  }
  ln.status = kResolved;
}

// Grid: P x G blocks, pattern fastest (p = blockIdx.x % P); block g of
// pattern p takes doc tiles g, g + G, ... of kThreads docs, a lane each,
// warp w the tile's docs 32w .. 32w + 31. Shared memory: the profile, then
// (kSlab) one exits slab a warp of a.slab words, then the table's rows.
// Every doc's first chunk is entered in the pattern's start state, so where
// that state is speculated every doc hits there, and each warp stages its
// docs' exits before it walks them (kSlab: the plan has room for slabs).
template <bool kReg, bool kAll, bool kSlab>
__global__ void __launch_bounds__(kThreads, kSlab ? 1 : 2)
    docs_kernel(const Args a) {
  extern __shared__ int32_t smem[];
  int32_t *sp = smem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int32_t *xs0 = smem + pad4(a.m) + warp * a.slab;
  int32_t *tab = smem + pad4(a.m) + pad4(kThreads / 32 * a.slab);
  const int p = blockIdx.x % a.P;
  const long long G = gridDim.x / a.P;
  for (int i = threadIdx.x; i < a.m; i += blockDim.x)
    sp[i] = __ldg(a.spec + (size_t)p * a.m + i);
  __syncthreads();
  int spr[kRow];
#pragma unroll
  for (int j = 0; j < kRow; ++j) spr[j] = kReg && j < a.m ? sp[j] : -1;

  const int start = __ldg(a.starts + p);
  bool slabbed = false;  // block-uniform
  if (kSlab)
    for (int j = 0; j < a.m; ++j) slabbed |= sp[j] == start;
  const int32_t *tg = a.tables + (size_t)p * a.n * a.k;
  const char *ts = reinterpret_cast<const char *>(tab);
  const int32_t *ex_p = a.exits + (size_t)p * a.D * a.C * a.m;
  bool staged = false;  // block-uniform
  unsigned hits = 0, repairs = 0, most = 0;
  for (long long d0 = blockIdx.x / a.P * (long long)kThreads; d0 < a.D;
       d0 += G * kThreads) {
    const long long d = d0 + threadIdx.x;
    const bool live = d < a.D;
    const int32_t *ex = ex_p + (size_t)d * a.C * a.m;
    const int32_t *sym = a.chunks + (size_t)d * a.C * a.Lc;
    const int32_t *xs = nullptr;
    if (kSlab && slabbed) {
      const long long dw = d0 + 32 * warp;
      __syncwarp();  // every lane is done with the last tile's slab
      if (dw < a.D)
        stage_slab(a, ex_p + (size_t)dw * a.C * a.m,
                   (int)min(32LL, a.D - dw), xs0, lane);
      __syncwarp();
      xs = xs0 + lane * (a.C * a.m + 1);
    }
    Lane ln{0, start, 0, live ? kWalking : kResolved};
    if (live)
      resolve_lane<kReg, kAll>(a, sp, spr, ts, tg, ex, xs, sym, staged, ln,
                               hits);
    if (!staged && __syncthreads_or(ln.status == kNeedsTable)) {
      table::stage(tg, tab, a.rows, a.k, a.k | 1, a.rowb, a.tvec);
      __syncthreads();
      staged = true;
      if (ln.status == kNeedsTable)
        resolve_lane<kReg, kAll>(a, sp, spr, ts, tg, ex, xs, sym, true, ln,
                                 hits);
    }
    if (live) {
      a.finals[(size_t)p * a.D + d] = ln.cur;
      a.resolved[(size_t)p * a.D + d] = ln.status == kResolved;
      repairs += ln.rep;
      most = max(most, (unsigned)ln.rep);
    }
  }
  hits = __reduce_add_sync(kFull, hits);
  repairs = __reduce_add_sync(kFull, repairs);
  most = __reduce_max_sync(kFull, most);
  if (lane == 0 && (hits || repairs)) {
    atomicAdd(a.totals + 0, (unsigned long long)hits);
    atomicAdd(a.totals + 1, (unsigned long long)repairs);
    atomicMax(a.totals + 2, (unsigned long long)most);
  }
}

// --- chained docs ----------------------------------------------------------

// The first q with spec[q] == cur, or m; cur is the same in every lane:
// lane l compares spec[l], spec[l + 32], ... (sp0 = spec[l], -1 past m).
__device__ __forceinline__ int find_warp(const int32_t *sp, int sp0, int cur,
                                         int m, int lane) {
  unsigned b = __ballot_sync(kFull, sp0 == cur);
  if (b) return __ffs(b) - 1;
  for (int base = 32; base < m; base += 32) {
    const int v = base + lane < m ? sp[base + lane] : -1;
    b = __ballot_sync(kFull, v == cur);
    if (b) return base + __ffs(b) - 1;
  }
  return m;
}

// Words p[l], p[l + 32], ... of p[0 .. words) into v (lane l), 0 past them.
__device__ __forceinline__ void load_exits(const int32_t *p, int words,
                                           int lane, int (&v)[kExitBatch]) {
#pragma unroll
  for (int u = 0; u < kExitBatch; ++u)
    v[u] = lane + 32 * u < words ? __ldg(p + lane + 32 * u) : 0;
}

// Grid: P blocks, one a pattern.
template <bool kAll>
__global__ void __launch_bounds__(kChainThreads) chain_kernel(const Args a) {
  extern __shared__ int32_t smem[];
  int32_t *sp = smem;
  int32_t *exg = smem + pad4(a.m);
  int32_t *tab = exg + pad4(a.group * a.m);
  const int p = blockIdx.x;
  const int32_t *tg = a.tables + (size_t)p * a.n * a.k;
  for (int i = threadIdx.x; i < a.m; i += blockDim.x)
    sp[i] = __ldg(a.spec + (size_t)p * a.m + i);
  table::stage(tg, tab, a.rows, a.k, a.k | 1, a.rowb, a.tvec);
  __syncthreads();
  if (threadIdx.x >= 32) return;

  const int lane = threadIdx.x;
  const char *ts = reinterpret_cast<const char *>(tab);
  const int sp0 = lane < a.m ? sp[lane] : -1;
  // The chunks in order: xg the current chunk's exits in exg, `left` the
  // staged chunks from it on, exn the next unstaged exits, sym its symbols.
  const int32_t *exn = a.exits + (size_t)p * a.D * a.C * a.m;
  const int32_t *sym = a.chunks;
  const int32_t *xg = exg;
  long long unstaged = a.D * a.C;
  int left = 0;
  // Where a group's exits fit kExitBatch words a lane (m <= 256), the next
  // group's load into nv while the current group walks.
  const bool ahead = a.group * a.m <= 32 * kExitBatch;
  int nv[kExitBatch];
  if (ahead) load_exits(exn, (int)min((long long)a.group, unstaged) * a.m,
                        lane, nv);
  int cur = __ldg(a.starts + p);
  unsigned long long hits = 0, repaired = 0, fallback = 0;
  int most = 0;
  for (long long d = 0; d < a.D; ++d) {
    int rep = 0;
    bool fb = false;  // past the bound: the rest of the doc walks exactly
    for (int c = 0; c < a.C; ++c) {
      if (left == 0) {  // the exits of the next `group` chunks, coalesced
        left = (int)min((long long)a.group, unstaged);
        unstaged -= left;
        const int words = left * a.m;
        __syncwarp();
        if (ahead) {
#pragma unroll
          for (int u = 0; u < kExitBatch; ++u)
            if (lane + 32 * u < words) exg[lane + 32 * u] = nv[u];
          load_exits(exn + words,
                     (int)min((long long)a.group, unstaged) * a.m, lane, nv);
        } else {
          for (int i0 = 0; i0 < words; i0 += 32 * kExitBatch) {
            int v[kExitBatch];
            load_exits(exn + i0, words - i0, lane, v);
#pragma unroll
            for (int u = 0; u < kExitBatch; ++u)
              if (i0 + lane + 32 * u < words) exg[i0 + lane + 32 * u] = v[u];
          }
        }
        __syncwarp();
        exn += words;
        xg = exg;
      }
      const int q = fb ? a.m : find_warp(sp, sp0, cur, a.m, lane);
      if (q < a.m) {
        cur = xg[q];
        ++hits;
      } else {
        if (!fb && rep >= a.max_rounds) {
          fb = true;
          ++fallback;
        }
        cur = walk_chunk<kChainSyms, kAll>(a, ts, tg, sym, cur);
        rep += !fb;
      }
      xg += a.m;
      --left;
      sym += a.Lc;
    }
    repaired += rep;
    most = max(most, rep);
  }
  if (lane == 0) {
    a.finals[p] = cur;
    atomicAdd(a.totals + 0, hits);
    atomicAdd(a.totals + 1, repaired);
    atomicMax(a.totals + 2, (unsigned long long)most);
    atomicAdd(a.totals + 3, fallback);
  }
}

// --- launches --------------------------------------------------------------

Args make_args(const void *tables, const void *spec, const void *starts,
               const void *exits, const void *chunks, void *finals,
               void *resolved, void *totals, int P, int n, int k, int m,
               long long D, int C, int Lc, int max_rounds, int rows,
               int group, int slab) {
  Args a;
  a.tables = (const int32_t *)tables;
  a.spec = (const int32_t *)spec;
  a.starts = (const int32_t *)starts;
  a.exits = (const int32_t *)exits;
  a.chunks = (const int32_t *)chunks;
  a.finals = (int32_t *)finals;
  a.resolved = (uint8_t *)resolved;
  a.totals = (unsigned long long *)totals;
  a.P = P;
  a.n = n;
  a.k = k;
  a.m = m;
  a.C = C;
  a.Lc = Lc;
  a.max_rounds = max_rounds;
  a.D = D;
  a.rows = rows;
  a.group = group;
  a.slab = slab;
  a.rowb = (k | 1) * 4;
  a.roff = rows * a.rowb;
  a.inv_row = table::inverse((unsigned)(k | 1));
  a.tvec = ((uintptr_t)tables & 15) == 0 && ((long long)n * k & 3) == 0;
  a.svec = ((uintptr_t)chunks & 15) == 0 && (Lc & 3) == 0;
  a.xvec = ((uintptr_t)exits & 15) == 0 && ((long long)C * m & 3) == 0;
  return a;
}

// Shared memory above 48 KB is opted in to once per instantiation and
// device; `per_sm` the resident blocks an SM at the last shared size.
struct Seen {
  int opted = 48 * 1024, smem = -1, per_sm = 1;
};

template <typename Kernel>
int opt_in(Kernel kernel, Seen &s, int smem) {
  if (smem <= s.opted) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  s.opted = smem;
  return 0;
}

template <bool kReg, bool kAll, bool kSlab>
int launch_docs(const Args &a, int smem, cudaStream_t st) {
  auto kernel = docs_kernel<kReg, kAll, kSlab>;
  static Seen seen[kMaxDevices];
  const int dev = current_device();
  Seen once;
  Seen &s = dev >= 0 && dev < kMaxDevices ? seen[dev] : once;
  int e = opt_in(kernel, s, smem);
  if (e) return e;
  if (smem != s.smem) {
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.per_sm, kernel,
                                                           kThreads, smem);
    if (e) return e;
    if (s.per_sm < 1) s.per_sm = 1;
    s.smem = smem;
  }
  // Blocks a pattern: the resident blocks shared among the patterns, at
  // least one, and no more than its docs need.
  long long g = (long long)sm_count(dev) * s.per_sm / a.P;
  const long long need = (a.D + kThreads - 1) / kThreads;
  if (g > need) g = need;
  if (g < 1) g = 1;
  if ((long long)a.P * g > 0x7fffffffLL) g = 0x7fffffffLL / a.P;
  kernel<<<(unsigned)(a.P * g), kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <bool kAll>
int launch_chain(const Args &a, int smem, cudaStream_t st) {
  auto kernel = chain_kernel<kAll>;
  static Seen seen[kMaxDevices];
  const int dev = current_device();
  Seen once;
  const int e = opt_in(kernel, dev >= 0 && dev < kMaxDevices ? seen[dev]
                                                             : once, smem);
  if (e) return e;
  kernel<<<(unsigned)a.P, kChainThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spec_resolve_launch(const void *tables, const void *spec,
                                   const void *starts, const void *exits,
                                   const void *chunks, void *finals,
                                   void *resolved, void *totals, int P, int n,
                                   int k, int m, long long D, int C, int Lc,
                                   int max_rounds, int rows, int slab,
                                   int smem, void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e =
      cudaMemsetAsync(totals, 0, 3 * sizeof(unsigned long long), st);
  if (e != cudaSuccess) return (int)e;
  const Args a = make_args(tables, spec, starts, exits, chunks, finals,
                           resolved, totals, P, n, k, m, D, C, Lc,
                           max_rounds, rows, 0, slab);
  const bool reg = m <= kRow, all = rows == n;
  if (slab) {
    if (reg)
      return all ? launch_docs<true, true, true>(a, smem, st)
                 : launch_docs<true, false, true>(a, smem, st);
    return all ? launch_docs<false, true, true>(a, smem, st)
               : launch_docs<false, false, true>(a, smem, st);
  }
  if (reg)
    return all ? launch_docs<true, true, false>(a, smem, st)
               : launch_docs<true, false, false>(a, smem, st);
  return all ? launch_docs<false, true, false>(a, smem, st)
             : launch_docs<false, false, false>(a, smem, st);
}

extern "C" int spec_resolve_chain_launch(const void *tables, const void *spec,
                                         const void *starts,
                                         const void *exits,
                                         const void *chunks, void *finals,
                                         void *totals, int P, int n, int k,
                                         int m, long long D, int C, int Lc,
                                         int max_rounds, int rows, int group,
                                         int smem, void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e =
      cudaMemsetAsync(totals, 0, 4 * sizeof(unsigned long long), st);
  if (e != cudaSuccess) return (int)e;
  const Args a = make_args(tables, spec, starts, exits, chunks, finals,
                           nullptr, totals, P, n, k, m, D, C, Lc, max_rounds,
                           rows, group, 0);
  return rows == n ? launch_chain<true>(a, smem, st)
                   : launch_chain<false>(a, smem, st);
}

extern "C" const char *spec_resolve_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
