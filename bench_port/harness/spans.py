"""The program's per-span totals as a time per completed call.

The program adds each closed span's duration to its counter
``span.<name>.ns`` and the duration less its direct children's to
``span.<name>.self_ns`` (``repro_torch.obs``); the window holds their deltas.
A program without those spans has no such counter, and its readers then
find nothing to read.
"""

from __future__ import annotations


def ms_per_completed(w, *counters):
    """The sum of the window's deltas of ``counters`` (ns) over its
    completed requests or compiles, in ms; None without a completed one or
    where the program has none of the counters."""
    found = [w.counters[c] for c in counters if c in w.counters]
    if not w.completed or not found:
        return None
    return sum(found) / w.completed / 1e6
