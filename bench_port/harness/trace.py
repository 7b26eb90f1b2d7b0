"""Reading a ``torch.profiler`` trace of the traced window.

From the trace: the device's busy time (the union of the intervals in which
a kernel, copy or fill ran on the device), the device time and count of
each kernel by name, and the idle gaps between device operations, each put
down to what the host's main thread was doing at the gap's middle (its
innermost open operation or span). The window's length is the host's,
taken by the caller.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: dict = field(default_factory=dict)   # name -> [calls, seconds]
    device_ops: list = field(default_factory=list)   # [[name, seconds]]
    idle_gaps: list = field(default_factory=list)    # [[host op, seconds]]
    n_device_events: int = 0

    def kernel_time(self, names) -> tuple:
        """(calls, seconds) of the kernels whose name contains one of
        ``names`` (a kernel's name in a trace is its demangled signature)."""
        calls = secs = 0
        for key, (c, s) in self.kernels.items():
            if any(f"{n}<" in key or f"{n}(" in key for n in names):
                calls += c
                secs += s
        return calls, secs


def _union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def summarize(prof, window_s: float, top: int = 10) -> TraceSummary:
    """The summary of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    events = prof.events()
    dev, host = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                dev.append((tr.start, tr.end, e.name))
        elif e.device_type == DeviceType.CPU:
            host.append((tr.start, tr.end, e.name, e.thread))
    kernels: dict = {}
    for a, b, name in dev:
        c = kernels.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += (b - a) * 1e-6
    busy = _union((a, b) for a, b, _ in dev) * 1e-6
    by_time = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    device_ops = [[name[:120], secs] for name, (_, secs) in by_time[:top]]
    return TraceSummary(window_s=window_s, busy_s=busy, kernels=kernels,
                        device_ops=device_ops,
                        idle_gaps=_idle_gaps(dev, host, top),
                        n_device_events=len(dev))


def _idle_gaps(dev, host, top: int) -> list:
    """Idle time between device operations, summed by the host operation
    open at each gap's middle on the thread that issued most host work."""
    if not dev or not host:
        return []
    threads: dict = {}
    for h in host:
        threads[h[3]] = threads.get(h[3], 0) + 1
    tid = max(threads, key=threads.get)
    ops = sorted((a, b, name) for a, b, name, t in host if t == tid)
    starts = [a for a, _, _ in ops]
    spans = sorted((a, b) for a, b, _ in dev)
    gaps, end = [], spans[0][1]
    for a, b in spans[1:]:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    sums: dict = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid) - 1
        name = "(no host operation)"
        # the innermost open operation: the last started of those open
        for j in range(i, max(-1, i - 10_000), -1):
            if ops[j][1] >= mid:
                name = ops[j][2]
                break
        sums[name] = sums.get(name, 0.0) + (g1 - g0) * 1e-6
    return [[n[:120], s] for n, s in
            sorted(sums.items(), key=lambda kv: -kv[1])[:top]]
