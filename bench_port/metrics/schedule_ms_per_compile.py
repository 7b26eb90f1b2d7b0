"""schedule_ms_per_compile: the host's work between construction rounds
(``construction.schedule``: the flags taken back, collision retries, the
blow-up check, the next round's patterns, bucket, buffers and index
uploads) over the window's completed compiles, in ms."""

from bench_port.harness.spans import ms_per_completed


def read(w):
    return ms_per_completed(w, "span.construction.schedule.ns")
