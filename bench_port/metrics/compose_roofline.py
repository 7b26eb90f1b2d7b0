"""compose_roofline: the least time the chip could take for every call of
``ops.compose`` in the traced window (the stacked ``compose_fold_kernel``
with one combine a launch), from each call's shapes
(``bench_port/roofline/compose.py``), over that instantiation's traced
device time, in %."""

from bench_port.harness.instances import instance_roofline_pct


def read(w):
    return instance_roofline_pct(w, "compose")
