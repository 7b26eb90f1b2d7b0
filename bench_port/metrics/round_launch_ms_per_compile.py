"""round_launch_ms_per_compile: the construction rounds' own host time
(``construction.round``'s self time: enqueueing the round's gathers,
kernels and scatters, its compaction and read-back left out) over the
window's completed compiles, in ms."""

from bench_port.harness.spans import ms_per_completed


def read(w):
    return ms_per_completed(w, "span.construction.round.self_ns")
