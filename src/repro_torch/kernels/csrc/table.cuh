// table.cuh: a DFA table staged in shared memory, shared by the chunk walks
// (match.cuh) and spec_resolve.cu.
//
// A block stages the first R rows of a (n, k) int32 table. Each entry is
// held as the byte offset of its target row (state * rowb), rows padded to
// k | 1 words (rowb = (k | 1) * 4 bytes), so a step is one add and one
// shared load, and 32 lanes in 32 different states on one symbol fall on
// 32 banks (an even width of 20 words put s*20 + sym on 8 of 32). A step
// from a row >= R reads that row from the table in global memory (L2).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace table {
namespace {

// 16-byte loads in flight a thread while a block stages a table.
constexpr int kStageBatch = 8;

// (k | 1)^-1 mod 2^32: offset / 4 * inverse(k | 1) = state.
inline unsigned inverse(unsigned row) {
  unsigned inv = row;  // Newton: each step doubles the correct low bits
  for (int i = 0; i < 5; ++i) inv *= 2u - row * inv;
  return inv;
}

// The state of byte offset s.
__device__ __forceinline__ int state_of(int s, unsigned inv_row) {
  return (int)((unsigned)(s >> 2) * inv_row);
}

// The next offset from offset s on symbol a, s a staged row.
__device__ __forceinline__ int lds_step(const char *ts, int s, int a) {
  return *reinterpret_cast<const int32_t *>(ts + s + (a << 2));
}

// The next offset from offset s on symbol a, s any row: rows at or past
// byte offset roff (R rows) from the table tg in global memory.
__device__ __forceinline__ int any_step(const char *ts, const int32_t *tg,
                                        int s, int a, int roff,
                                        unsigned inv_row, int rowb, int k) {
  if (s < roff) return lds_step(ts, s, a);
  return __ldg(tg + state_of(s, inv_row) * k + a) * rowb;
}

// Stage rows [0, rows) of table tab (n, k) into dst, each entry as the byte
// offset of its target row, rows padded to `row` words; the threads of the
// block share the work, kStageBatch 16-byte loads in flight each where tvec
// says tab is 16-byte aligned (the callers set it where the tables are
// aligned and n * k % 4 == 0, so every table of a bank is).
__device__ __forceinline__ void stage(const int32_t *tab, int32_t *dst,
                                      int rows, int k, int row, int rowb,
                                      bool tvec) {
  const int total = rows * k;
  const int nv = tvec ? total >> 2 : 0;  // 16-byte loads, then the rest
  const int4 *tv = reinterpret_cast<const int4 *>(tab);
  for (int i0 = threadIdx.x; i0 < nv; i0 += kStageBatch * blockDim.x) {
    int4 v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < nv) v[u] = __ldg(tv + i);
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < nv) {
        int s = 4 * i / k, c = 4 * i - s * k;
        const int e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          dst[s * row + c] = e[x] * rowb;
          if (++c == k) {
            c = 0;
            ++s;
          }
        }
      }
    }
  }
  for (int i = 4 * nv + threadIdx.x; i < total; i += blockDim.x) {
    const int s = i / k;
    dst[s * row + (i - s * k)] = __ldg(tab + i) * rowb;
  }
}

}  // namespace
}  // namespace table
