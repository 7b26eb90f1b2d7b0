"""match_bank_chunks_roofline: the least time the chip could take for every launch of
``match_bank_chunks`` in the traced window, from each launch's shapes
(``bench_port/roofline/match_bank_chunks.py``), over the kernel's traced device time,
in %."""

from bench_port.harness.window import roofline_pct


def read(w):
    return roofline_pct(w, "match_bank_chunks")
