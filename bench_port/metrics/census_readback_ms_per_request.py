"""census_readback_ms_per_request: the host time of the census's read-back
(``scanner.census.readback``, a pass a pattern group: the host waits for the
device, copies the group's hits and fills its rows of the hit matrix) over
the window's completed requests, in ms."""

from bench_port.harness.spans import ms_per_completed


def read(w):
    return ms_per_completed(w, "span.scanner.census.readback.ns")
