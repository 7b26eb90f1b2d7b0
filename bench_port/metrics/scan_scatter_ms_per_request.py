"""scan_scatter_ms_per_request: the host time spent writing each batch's
hits into the request's (patterns, documents) matrix
(``scanner.scan.scatter``) over the window's completed requests, in ms."""

from bench_port.harness.spans import ms_per_completed


def read(w):
    return ms_per_completed(w, "span.scanner.scan.scatter.ns")
