"""Cross-process snapshot aggregation: N worker snapshots -> one fleet view.

The metrics registry is per-process, but the serving story is N hosts
draining one corpus: each worker's :meth:`MetricsRegistry.snapshot` (or
:func:`snapshot_delta`) is one shard of the fleet's telemetry, and this
module is the merge operation that makes them one view:

* **counters** sum — work done anywhere is work done;
* **histograms** add bucket-wise (``sum``/``count`` too). Merging only
  makes sense over identical bucket layouts, so an edge mismatch *raises* —
  two processes that registered different edges under one name are
  publishing incompatible schemas, and silently aligning them would corrupt
  every percentile read off the result;
* **gauges** are levels, not totals, so the merge policy is per metric:
  ``last`` (default — latest writer wins, e.g. a hit rate), ``max`` (e.g.
  ``scheduler.max_coalesced``, a running max already), or ``sum`` (e.g.
  ``cache.sfa.bytes`` — per-process residency adds up to fleet residency).
  :data:`DEFAULT_GAUGE_POLICIES` carries the known non-``last`` metrics;
  callers override per name via ``gauge_policies``.

:func:`merge_records` lifts the merge from bare snapshots to the JSONL
records :func:`repro_torch.obs.snapshot_record` emits (and the flight recorder
appends), preserving per-``host``/``pid`` attribution in a ``sources``
table — the merged view still answers "which worker did what".

The module doubles as a CLI::

    python -m repro_torch.obs.aggregate worker0.jsonl worker1.jsonl ... \
        [--format json|prom] [--prefix jobs] [-o fleet.json]

merging every metrics/flight record from the given JSONL files (span
records are passed over) into one fleet snapshot, rendered as a fleet
JSON record or as Prometheus text. Torn trailing lines — a killed worker's
last write — are skipped, not fatal: aggregation is exactly the tool you
reach for after a crash.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .export import render_prometheus

GAUGE_POLICIES = ("last", "max", "sum")

#: Gauge metrics whose fleet merge is not last-write-wins. Extend via the
#: ``gauge_policies`` argument rather than editing in place.
DEFAULT_GAUGE_POLICIES = {
    "scheduler.max_coalesced": "max",
    "cache.sfa.bytes": "sum",
}


def _is_counter(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _kind_name(v) -> str:
    if isinstance(v, dict):
        return "histogram"
    return "counter" if _is_counter(v) else "gauge"


def merge_snapshots(snapshots, *, gauge_policy: str = "last",
                    gauge_policies: dict | None = None) -> dict:
    """Merge snapshot dicts into one (see module docstring for semantics).

    ``snapshots`` merge in order — under the ``last`` gauge policy the
    final occurrence of a name wins, so pass workers' snapshots oldest
    first when order matters. A name carrying different metric kinds
    across snapshots raises ``TypeError``; histograms with different
    bucket edges raise ``ValueError``.
    """
    if gauge_policy not in GAUGE_POLICIES:
        raise ValueError(
            f"gauge_policy must be one of {GAUGE_POLICIES}, "
            f"got {gauge_policy!r}"
        )
    policies = dict(DEFAULT_GAUGE_POLICIES)
    if gauge_policies:
        for name, pol in gauge_policies.items():
            if pol not in GAUGE_POLICIES:
                raise ValueError(
                    f"gauge policy for {name!r} must be one of "
                    f"{GAUGE_POLICIES}, got {pol!r}"
                )
            policies[name] = pol

    out: dict = {}
    for snap in snapshots:
        for name, v in snap.items():
            if isinstance(v, bool):
                raise TypeError(f"metric {name!r} has bool value")
            cur = out.get(name)
            if cur is not None and _kind_name(cur) != _kind_name(v):
                raise TypeError(
                    f"metric {name!r} is a {_kind_name(cur)} in one snapshot "
                    f"and a {_kind_name(v)} in another; refusing to merge"
                )
            if isinstance(v, dict):  # histogram
                edges = [float(e) for e in v["edges"]]
                counts = list(v["counts"])
                if len(counts) != len(edges) + 1:
                    raise ValueError(
                        f"histogram {name!r} has {len(counts)} counts for "
                        f"{len(edges)} edges (want edges+1)"
                    )
                if cur is None:
                    out[name] = {"edges": edges, "counts": counts,
                                 "sum": float(v["sum"]),
                                 "count": int(v["count"])}
                else:
                    if cur["edges"] != edges:
                        raise ValueError(
                            f"histogram {name!r} bucket edges differ across "
                            f"snapshots ({cur['edges']} vs {edges}); merging "
                            "mismatched layouts would corrupt percentiles"
                        )
                    cur["counts"] = [a + b
                                     for a, b in zip(cur["counts"], counts)]
                    cur["sum"] += float(v["sum"])
                    cur["count"] += int(v["count"])
            elif _is_counter(v):
                out[name] = v if cur is None else cur + v
            else:  # gauge
                v = float(v)
                if cur is None:
                    out[name] = v
                else:
                    pol = policies.get(name, gauge_policy)
                    out[name] = {"last": v, "max": max(cur, v),
                                 "sum": cur + v}[pol]
    return out


def merge_records(records, *, gauge_policy: str = "last",
                  gauge_policies: dict | None = None,
                  prefix: str | None = None) -> dict:
    """Merge :func:`snapshot_record`-shaped records into one fleet record.

    Only records carrying a ``metrics`` dict participate (span records pass
    through untouched, i.e. are ignored); they are ordered by ``ts`` before
    merging so the ``last`` gauge policy means "latest wall clock", not
    "last file on the command line". The result keeps per-process
    attribution: ``sources`` lists each distinct (host, pid) with its
    record count and the labels it reported under.

    ``prefix`` restricts the merged metrics to one namespace
    (``prefix`` itself or ``prefix.*``) — e.g. ``"jobs"`` for the
    deterministic per-shard corpus-job counters.
    """
    metric_recs = sorted(
        (r for r in records if isinstance(r, dict)
         and isinstance(r.get("metrics"), dict)),
        key=lambda r: r.get("ts", 0.0),
    )
    snaps = []
    for r in metric_recs:
        snap = r["metrics"]
        if prefix:
            snap = {k: v for k, v in snap.items()
                    if k == prefix or k.startswith(prefix + ".")}
        snaps.append(snap)
    merged = merge_snapshots(snaps, gauge_policy=gauge_policy,
                             gauge_policies=gauge_policies)
    sources: dict = {}
    for r in metric_recs:
        key = (r.get("host"), r.get("pid"))
        src = sources.setdefault(key, {
            "host": r.get("host"), "pid": r.get("pid"),
            "records": 0, "labels": [],
        })
        src["records"] += 1
        label = r.get("label")
        if label is not None and label not in src["labels"]:
            src["labels"].append(label)
    return {
        "kind": "fleet",
        "ts": max((r.get("ts", 0.0) for r in metric_recs), default=0.0),
        "n_records": len(metric_recs),
        "sources": list(sources.values()),
        "metrics": merged,
    }


def read_records(path) -> list:
    """All parseable JSONL records in ``path``, skipping torn lines (a
    killed writer's final append) instead of failing the whole merge."""
    out = []
    try:
        text = Path(path).read_text()
    except OSError:
        return out
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.aggregate",
        description="Merge JSONL metric snapshots from N worker processes "
                    "into one fleet snapshot.",
    )
    ap.add_argument("paths", nargs="+", metavar="FILE.jsonl",
                    help="snapshot/flight JSONL files (span records ignored)")
    ap.add_argument("--format", choices=("json", "prom"), default="json",
                    help="fleet record JSON (default) or Prometheus text")
    ap.add_argument("--gauge-policy", choices=GAUGE_POLICIES, default="last",
                    help="default merge policy for gauges (per-metric "
                         "defaults in DEFAULT_GAUGE_POLICIES still apply)")
    ap.add_argument("--prefix", default=None,
                    help="restrict to one metric namespace (e.g. 'jobs')")
    ap.add_argument("-o", "--out", default=None,
                    help="output path (default: stdout)")
    args = ap.parse_args(argv)

    records = []
    for path in args.paths:
        if not Path(path).exists():
            print(f"aggregate: no such file: {path}", file=sys.stderr)
            return 1
        records.extend(read_records(path))
    try:
        fleet = merge_records(records, gauge_policy=args.gauge_policy,
                              prefix=args.prefix)
    except (TypeError, ValueError) as e:
        print(f"aggregate: {e}", file=sys.stderr)
        return 1
    if not fleet["n_records"]:
        print("aggregate: no metric records found in "
              f"{len(args.paths)} file(s)", file=sys.stderr)
        return 2

    if args.format == "prom":
        text = render_prometheus(fleet["metrics"])
    else:
        text = json.dumps(fleet, indent=1, sort_keys=True) + "\n"
    if args.out is None:
        sys.stdout.write(text)
    else:
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
