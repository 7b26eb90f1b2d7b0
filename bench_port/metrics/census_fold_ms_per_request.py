"""census_fold_ms_per_request: the host time of the block fold
(``scanner.census.fold``, a pass a pattern group: the blocks' SFA walk and
the rows fold that makes the shard's block mappings, as enqueued) over the
window's completed requests, in ms."""

from bench_port.harness.spans import ms_per_completed


def read(w):
    return ms_per_completed(w, "span.scanner.census.fold.ns")
