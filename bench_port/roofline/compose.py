"""Work of one ``ops.compose`` call: one function-monoid combine,
``out[b, q] = g[b, f[b, q]]`` over (B, n) mapping vectors, launched as the
stacked instantiation of ``compose_fold_kernel`` with m = 1.

Bytes: f and g read once and the output written once, ``3 x 4 x B x n``, as
``chip_smoke.py``'s kernel table counts them; no arithmetic is counted (a
gather). The three wrappers of ``kernels/csrc/compose.cu`` launch one
library, so this wrapper's launches are found in the trace by their
instantiation's name (``INSTANCE``) and counted by the wrapper's own
counter (:mod:`bench_port.harness.instances`).
"""

FACTS = ()
INSTANCE = "compose_fold_kernel<false>"


def work(rec) -> tuple:
    """-> (bytes, int32 operations) the call's inputs need."""
    B, n = rec["args"][0]
    return 3 * 4 * B * n, 0
