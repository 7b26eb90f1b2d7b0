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
// The scan, the census and each stream piece launch it once per group.
// With starts (P, n_starts) lane q of pattern p walks from starts[p, q]:
// the speculative scan's m-lane pass, out (P, D*C, m) read as the
// reference's exits (P, D, C, m) by spec_resolve.cu (it replaces that
// stage 1 of src/repro/speculative/executor.py:94, XLA, not Pallas).
//
// The walk, what bounds it and its design are in match.cuh, shared with
// match_chunks.cu: symbols staged per warp as bytes, several chains a
// thread, shared rows padded to k | 1 words, the first R rows of a large
// delta staged and the rest read from L2, a pattern-fastest grid. The walks
// from explicit starts are their own instantiations, chunk-major only (32
// kernels in all).

#include "match.cuh"

extern "C" int match_bank_chunks_launch(const void *tables, const void *chunks,
                                        const void *starts, void *out, int P,
                                        int n, int k, long long B, int L,
                                        int n_starts, const void *plan,
                                        void *stream) {
  return starts ? match::run<true>(tables, chunks, starts, out, P, n, k, B,
                                  L, n_starts, (const int *)plan, stream)
                : match::run<false>(tables, chunks, nullptr, out, P, n, k, B,
                                   L, n_starts, (const int *)plan, stream);
}

extern "C" const char *match_bank_chunks_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
