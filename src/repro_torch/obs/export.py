"""Exporters: Prometheus-style text exposition and JSONL event logs.

Two formats, two audiences:

* :func:`render_prometheus` — the text scrape format the
  :class:`repro_torch.scanservice.TelemetryServer` ``/metrics`` endpoint serves.
  Dots in metric names become underscores; histograms emit cumulative
  ``_bucket{le=...}`` series plus ``_sum``/``_count``; registered ``help``
  descriptions emit as ``# HELP`` lines. :func:`parse_prometheus` inverts
  it (used by round-trip tests and tooling that diffs scrapes; HELP
  lines are ignored on the way back).
* :func:`write_jsonl` / :func:`read_jsonl` — append-only event logs for
  offline analysis: the flight recorder appends one snapshot record per
  step, and span dumps ride the same format.
"""

from __future__ import annotations

import json
import os
import socket
import time


def _prom_name(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def _escape_help(text: str) -> str:
    # Prometheus exposition-format escaping for HELP lines.
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    # ints render bare; floats use repr (shortest round-trippable form)
    if isinstance(v, int) or (isinstance(v, float) and v.is_integer()):
        return str(int(v))
    return repr(float(v))


def render_prometheus(snapshot: dict, help_texts: dict | None = None) -> str:
    """Render a :meth:`MetricsRegistry.snapshot` dict as Prometheus text.

    Counters (ints) and gauges (floats) are told apart by Python type —
    the snapshot preserves it. Histogram buckets are cumulated here; the
    snapshot stores per-bucket counts. ``help_texts`` maps metric names
    (dotted, as in the snapshot) to ``# HELP`` descriptions — pass
    ``MetricsRegistry.help_texts()`` (the ``repro_torch.obs`` module-level
    wrapper does) to emit what ``counter/gauge/histogram(name, help=...)``
    registered.
    """
    help_texts = help_texts or {}
    lines = []
    for name in sorted(snapshot):
        v = snapshot[name]
        pname = _prom_name(name)
        if name in help_texts:
            lines.append(f"# HELP {pname} {_escape_help(help_texts[name])}")
        if isinstance(v, dict):  # histogram
            lines.append(f"# TYPE {pname} histogram")
            cum = 0
            for edge, c in zip(v["edges"], v["counts"]):
                cum += c
                lines.append(f'{pname}_bucket{{le="{_fmt(edge)}"}} {cum}')
            cum += v["counts"][len(v["edges"])]
            lines.append(f'{pname}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{pname}_sum {_fmt(v['sum'])}")
            lines.append(f"{pname}_count {v['count']}")
        elif isinstance(v, bool):
            raise TypeError(f"metric {name!r} has bool value")
        elif isinstance(v, int):
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {v}")
        else:
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_fmt(v)}")
    return "\n".join(lines) + ("\n" if lines else "")


def parse_prometheus(text: str) -> dict:
    """Invert :func:`render_prometheus` (for its output only — not a general
    Prometheus parser). Returns a snapshot-shaped dict keyed by the
    underscored names; histogram counts are de-cumulated back to per-bucket.
    """
    types: dict = {}
    samples: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        key, val = line.rsplit(" ", 1)
        samples[key] = val

    out: dict = {}
    for name, kind in types.items():
        if kind == "counter":
            out[name] = int(samples[name])
        elif kind == "gauge":
            out[name] = float(samples[name])
        else:  # histogram
            edges, cums = [], []
            prefix = f'{name}_bucket{{le="'
            for key, val in samples.items():
                if key.startswith(prefix):
                    edge = key[len(prefix):-2]  # strip trailing "}
                    if edge != "+Inf":
                        edges.append(float(edge))
                    cums.append((float("inf") if edge == "+Inf"
                                 else float(edge), int(val)))
            cums.sort()
            edges.sort()
            counts, prev = [], 0
            for _, c in cums:
                counts.append(c - prev)
                prev = c
            out[name] = {
                "edges": edges,
                "counts": counts,
                "sum": float(samples[f"{name}_sum"]),
                "count": int(samples[f"{name}_count"]),
            }
    return out


def write_jsonl(path, records, mode: str = "a") -> None:
    """Append records (dicts) to a JSONL file, one per line."""
    with open(path, mode) as f:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True) + "\n")


def read_jsonl(path) -> list:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def snapshot_record(snapshot: dict, *, label: str | None = None,
                    kind: str = "metrics") -> dict:
    """Wrap a snapshot as one JSONL event record with a wall-clock stamp
    and the writing process's ``host``/``pid`` — the attribution a merged
    fleet view (:mod:`repro_torch.obs.aggregate`) preserves per source."""
    rec = {"kind": kind, "ts": time.time(), "host": socket.gethostname(),
           "pid": os.getpid(), "metrics": snapshot}
    if label is not None:
        rec["label"] = label
    return rec


def span_records(spans) -> list:
    """Render Span objects (or their to_json dicts) as JSONL event records."""
    out = []
    for s in spans:
        d = s if isinstance(s, dict) else s.to_json()
        out.append({"kind": "span", **d})
    return out
