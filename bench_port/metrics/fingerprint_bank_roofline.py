"""fingerprint_bank_roofline: the least time the chip could take for every launch of
``fingerprint_bank`` in the traced window, from each launch's shapes
(``bench_port/roofline/fingerprint_bank.py``), over the kernel's traced device time,
in %."""

from bench_port.harness.window import roofline_pct


def read(w):
    return roofline_pct(w, "fingerprint_bank")
