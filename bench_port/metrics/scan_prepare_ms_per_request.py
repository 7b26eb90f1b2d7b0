"""scan_prepare_ms_per_request: the host time of the scan's preparation
(``scanner.scan.prepare``: encoding, one batch a document length, the
symbol check) over the window's completed requests, in ms."""

from bench_port.harness.spans import ms_per_completed


def read(w):
    return ms_per_completed(w, "span.scanner.scan.prepare.ns")
