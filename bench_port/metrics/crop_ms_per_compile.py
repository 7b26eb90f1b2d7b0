"""crop_ms_per_compile: the copies of a bucket's construction buffers to
the host and the per-pattern SFAs cut from them (``construction.crop``)
over the window's completed compiles, in ms."""

from bench_port.harness.spans import ms_per_completed


def read(w):
    return ms_per_completed(w, "span.construction.crop.ns")
