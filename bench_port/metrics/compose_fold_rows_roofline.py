"""compose_fold_rows_roofline: the least time the chip could take for every
call of ``ops.compose_fold_rows`` in the traced window (the rows form of
``compose_fold_kernel``, the SFA scan's chunk fold), from each call's shapes
(``bench_port/roofline/compose_fold_rows.py``), over that instantiation's
traced device time, in %."""

from bench_port.harness.instances import instance_roofline_pct


def read(w):
    return instance_roofline_pct(w, "compose_fold_rows")
