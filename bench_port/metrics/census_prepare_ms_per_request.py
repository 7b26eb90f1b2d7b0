"""census_prepare_ms_per_request: the host time of the census's preparation
(``scanner.census.prepare``: encoding, the symbol check, the block reshape,
the blocks' upload) over the window's completed requests, in ms."""

from bench_port.harness.spans import ms_per_completed


def read(w):
    return ms_per_completed(w, "span.scanner.census.prepare.ns")
