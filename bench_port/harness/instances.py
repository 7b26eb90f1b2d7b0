"""The roofline share of one instantiation of a kernel that several of the
program's wrappers launch.

``ops.compose``, ``ops.compose_fold`` and ``ops.compose_fold_rows`` all
launch the one ``compose`` library (``launches.compose`` counts them
together), as two instantiations of ``compose_fold_kernel``: the stacked
form (``<false>``: ``compose``, ``compose_fold``) and the rows form
(``<true>``: ``compose_fold_rows``). So
:func:`~bench_port.harness.window.roofline_pct`, which holds a kernel's
traced launches against ``launches.<wrapper>`` and matches a kernel by
``name<``, cannot tell them apart. Here a wrapper's calls are held against
its own counter ``kernels.<wrapper>.calls`` (one launch a call on a card)
and its time is that of the trace's kernels whose demangled name holds the
instantiation (the roofline module's ``INSTANCE``).
"""

from __future__ import annotations

import sys

from bench_port.harness.window import least_seconds, load_reader, peaks


def instance_time(trace, instance: str) -> tuple:
    """(launches, seconds) of the traced kernels whose name holds
    ``instance`` (a name with its template arguments)."""
    calls = secs = 0
    for key, (c, s) in trace.kernels.items():
        if instance in key:
            calls += c
            secs += s
    return calls, secs


def instance_roofline_pct(w, wrapper: str):
    """The share of its roofline that ``ops.<wrapper>``'s launches reach in
    the traced window, in %: the least time of every call recorded
    (``bench_port/roofline/<wrapper>.py``) over the traced time of the
    wrapper's instantiation. None without a trace or a recorded call, and,
    with a line on standard error, where the wrapper's calls
    (``kernels.<wrapper>.calls``), its recorded calls and the traced
    launches of its instantiation are not one number: another wrapper then
    launched the same instantiation, or the trace dropped events."""
    if w.trace is None:
        return None
    mod = load_reader("roofline", wrapper)
    recs = [rec for k, rec in w.launches if k == wrapper]
    traced, secs = instance_time(w.trace, mod.INSTANCE)
    calls = w.counters.get(f"kernels.{wrapper}.calls", 0)
    if not recs or not traced or secs <= 0:
        return None
    if not traced == calls == len(recs):
        print(f"[trace] {wrapper}: {traced} traced launches of "
              f"{mod.INSTANCE}, {calls} calls, {len(recs)} recorded: "
              "no roofline", file=sys.stderr, flush=True)
        return None
    pk = peaks()
    return 100.0 * sum(least_seconds(*mod.work(r), pk) for r in recs) / secs
