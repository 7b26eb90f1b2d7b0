"""census_windows_ms_per_request: the host time of the window scans
(``scanner.census.windows``, a pass a pattern group: the prefix and suffix
scans of the block mappings, the stitch and the hit lookup, as enqueued)
over the window's completed requests, in ms."""

from bench_port.harness.spans import ms_per_completed


def read(w):
    return ms_per_completed(w, "span.scanner.census.windows.ns")
