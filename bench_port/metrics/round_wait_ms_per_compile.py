"""round_wait_ms_per_compile: the host time the construction rounds wait on
the device: the compaction's boolean selections
(``construction.round.compact``) and the flags' read-back
(``construction.round.readback``), over the window's completed compiles,
in ms."""

from bench_port.harness.spans import ms_per_completed


def read(w):
    return ms_per_completed(w, "span.construction.round.compact.ns",
                            "span.construction.round.readback.ns")
