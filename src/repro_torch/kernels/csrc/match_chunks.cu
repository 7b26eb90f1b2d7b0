// match_chunks: every chunk run through one table from every start state —
// the chunk transition functions of the single-pattern matchers.
//
// Replaces the Pallas kernel src/repro/kernels/match_scan.py::match_chunks_pallas
// (_match_kernel, _chunk_block_body). The TPU kernel turned each step into
// two one-hot MXU contractions; that was a TPU choice and is not carried
// over: here a step is one table lookup.
//
// Computes out[b, q] = table walked from state q over chunks[b, :] for
// table (n, k), chunks (B, L) -> (B, n) int32. Scanner.locate's first pass
// (4,096 chunks of 1,024 symbols, 87 lanes each) and the single-table
// executors run it.
//
// It is the P = 1, n_starts = n case of match_bank_chunks, on the same
// device code (match.cuh: what bounds the walk and the design). At locate's
// shape each warp takes one chunk: its 1,024 symbols staged as bytes, one
// word read a lane for four steps of its three chains (starts lane,
// lane + 32, lane + 64), the 87 x 21-word table in shared memory.

#include "match.cuh"

extern "C" int match_chunks_launch(const void *table, const void *chunks,
                                   void *out, int n, int k, long long B, int L,
                                   const void *plan, void *stream) {
  return match::run<false>(table, chunks, nullptr, out, 1, n, k, B, L, n,
                           (const int *)plan, stream);
}

extern "C" const char *match_chunks_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
