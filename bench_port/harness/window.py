"""What a run's measured window leaves for the metric readers, and the
readers themselves.

A metric named ``<name>`` in ``BENCHMARK.json`` is read by
``bench_port/metrics/<name>.py``, whose ``read(w)`` takes a :class:`Window`
and returns a number, or ``None`` where it finds nothing to read (the
harness then leaves the metric out of the result line). A name with a part
after a dot (``device_idle_pct.scan``) that has no file of its own is read by
the file of the part before the first dot (``device_idle_pct.py``): one
quantity split by the end-to-end metric it moves. Which cells report a
metric is ``BENCHMARK.json``'s to say (its ``workloads``), not the
reader's.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent          # bench_port/


@dataclass
class Window:
    seconds: float            # the window's length on the host's clock
    setup_s: float            # the run's set-up, process start to window
    completed: int = 0        # requests (or compiles) completed
    work: float = 0           # residues scanned, compiles completed, ...
    latencies: list = field(default_factory=list)   # s, completed ones
    counters: dict = field(default_factory=dict)    # program's, deltas
    launches: list = field(default_factory=list)    # traced: (kernel, rec)
    trace: object = None      # traced: a trace.TraceSummary


def load_reader(folder: str, name: str):
    """The module ``bench_port/<folder>/<name>.py``, or, where a dotted
    ``name`` has no file of its own, ``<the part before the first dot>.py``."""
    path = HERE / folder / f"{name}.py"
    if not path.exists():
        path = HERE / folder / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_port.{folder}.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metric(name: str, w: Window):
    return load_reader("metrics", name).read(w)


def peaks() -> dict:
    return json.loads((HERE / "roofline" / "peaks.json").read_text())


def least_seconds(nbytes: float, ops: float, pk: dict) -> float:
    """The least time the chip could take: the larger of the bytes over the
    memory's rate and the int32 operations over the ALUs' rate."""
    return max(nbytes / pk["hbm_bytes_per_s"], ops / pk["int32_ops_per_s"])


def roofline_pct(w: Window, kernel: str):
    """A kernel's share of its roofline in the traced window, in %: the
    least time of every launch recorded, from the work its inputs need
    (``bench_port/roofline/<kernel>.py``), over the traced time of the
    kernel's device events. None without a trace, without launches, where a
    launch's work cannot be counted, or where the trace holds another number
    of the kernel's launches than the program made (a trace that dropped
    events would read too high)."""
    if w.trace is None:
        return None
    mod = load_reader("roofline", kernel)
    recs = [rec for k, rec in w.launches if k == kernel]
    calls, secs = w.trace.kernel_time(mod.TRACE_NAMES)
    launched = w.counters.get(f"launches.{kernel}", 0)
    if not recs or not calls or secs <= 0:
        return None
    works = [mod.work(rec) for rec in recs]
    why = (f"{calls} traced launches, {launched} made" if calls != launched
           else f"{works.count(None)} launches without the facts to count"
           if None in works else None)
    if why:
        print(f"[trace] {kernel}: {why}: no roofline", file=sys.stderr,
              flush=True)
        return None
    pk = peaks()
    return 100.0 * sum(least_seconds(*wk, pk) for wk in works) / secs


def idle_pct(w: Window):
    """The share of the traced window in which no kernel, copy or fill ran
    on the device (the union of the profiler's device events), in %."""
    if w.trace is None or w.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.trace.busy_s / w.trace.window_s)
