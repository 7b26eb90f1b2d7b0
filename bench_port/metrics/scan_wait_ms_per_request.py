"""scan_wait_ms_per_request: the host time spent reading each batch's hits
back (``scanner.scan.readback``: the wait for the device, then the copy)
over the window's completed requests, in ms."""

from bench_port.harness.spans import ms_per_completed


def read(w):
    return ms_per_completed(w, "span.scanner.scan.readback.ns")
