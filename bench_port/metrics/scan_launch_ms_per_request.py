"""scan_launch_ms_per_request: the host time spent enqueueing each length
batch's upload and its walk and fold launches (``scanner.scan.launch``, a
span a batch and pattern group) over the window's completed requests, in
ms."""

from bench_port.harness.spans import ms_per_completed


def read(w):
    return ms_per_completed(w, "span.scanner.scan.launch.ns")
