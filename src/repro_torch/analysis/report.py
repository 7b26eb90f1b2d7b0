"""Re-analyze saved dry-run cells and render their markdown tables.

Every dry-run cell saves its per-device trace counts
(``results/dryrun_torch/<cell>.json``, ``trace_stats``); this tool re-applies
the roofline (``roofline_terms``, H100 constants) to them, so a change of
constants never requires tracing the cells again, and renders the tables
``PERF.md`` records. The roofline terms are estimates, not measurements.
A cell's memory is a rank's arguments plus the step's temporaries
(``temp_gb``: the eager high-water mark of the live tensors the step
makes, ``analysis/trace.py``; not XLA's buffer assignment), and "(NO)"
marks a sum past the card's 80 GB.

Usage:
  python -m repro_torch.analysis.report --reanalyze   # refresh JSONs' rooflines
  python -m repro_torch.analysis.report --tables      # print markdown tables
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def reanalyze(results_dir: Path = RESULTS) -> None:
    import dataclasses

    from ..config import SHAPES
    from ..configs import get_config
    from .roofline import roofline_terms

    for jf in sorted(results_dir.glob("*.json")):
        data = json.loads(jf.read_text())
        if data.get("status") != "ok":
            continue
        st = data["trace_stats"]
        shape = SHAPES[data["shape"]]
        if data.get("global_batch"):            # a cut batch (--global-batch)
            shape = dataclasses.replace(shape,
                                        global_batch=data["global_batch"])
        roof = roofline_terms(
            get_config(data["arch"]), shape,
            per_device_flops=st["flops"],
            per_device_bytes=st["traffic_bytes"],
            per_device_coll_bytes=st["coll_operand_bytes"],
            n_chips=data["n_devices"],
        )
        data["roofline"] = roof.to_json()
        jf.write_text(json.dumps(data, indent=2))
        r = data["roofline"]
        print(f"{jf.stem:55s} dom={r['dominant']:10s} "
              f"c={r['compute_s']:.3e} m={r['memory_s']:.3e} "
              f"x={r['collective_s']:.3e} useful={r['useful_ratio']:.2f}")


def _cell(d: dict) -> str:
    """One cell: a rank's argument GB and the step's temporaries (where
    the cell has them) and whether they fit 80 GB, the dominant roofline
    term and the three terms (estimates, seconds), per-device FLOPs and
    collectives."""
    if d.get("status") == "skipped":
        return "skipped"
    if d.get("status") != "ok":
        return "FAILED"
    m, r, st = d["memory"], d["roofline"], d["trace_stats"]
    temp = ("" if m.get("temp_gb") is None
            else f" + {m['temp_gb']:.2f} GB temp")
    return (f"{m['argument_gb']:.2f} GB{temp}"
            f"{'' if m['fits_80gb'] else ' (NO)'}; "
            f"{r['dominant']}: c {r['compute_s']:.3g} / m {r['memory_s']:.3g}"
            f" / x {r['collective_s']:.3g} s; {st['flops']:.2e} FLOPs, "
            f"{st['coll_count']} coll. {st['coll_operand_bytes'] / 1e9:.3g}"
            f" GB")


def tables(results_dir: Path = RESULTS) -> str:
    """The single-pod cells, an architecture a row and a shape a column."""
    cells: dict = {}
    for jf in sorted(results_dir.glob("*__pod.json")):
        d = json.loads(jf.read_text())
        cells.setdefault(d["arch"], {})[d["shape"]] = d
    shapes = sorted({s for row in cells.values() for s in row})
    lines = ["| arch | " + " | ".join(shapes) + " |",
             "|---|" + "---|" * len(shapes)]
    for arch, row in sorted(cells.items()):
        lines.append(f"| {arch} | " + " | ".join(
            _cell(row[s]) if s in row else "—" for s in shapes) + " |")
    return "\n".join(lines)


def multipod_table(results_dir: Path = RESULTS) -> str:
    lines = [
        "| arch | shape | status | args GB | collectives (count) |",
        "|---|---|---|---|---|",
    ]
    for jf in sorted(results_dir.glob("*__multipod.json")):
        d = json.loads(jf.read_text())
        if d.get("status") == "skipped":
            lines.append(f"| {d['arch']} | {d['shape']} | skipped | — | — |")
            continue
        if d.get("status") != "ok":
            lines.append(f"| {d['arch']} | {d['shape']} | FAILED | | |")
            continue
        per_op = d["trace_stats"]["per_op"]
        ops = ", ".join(f"{k}×{v['count']}" for k, v in sorted(per_op.items()))
        lines.append(f"| {d['arch']} | {d['shape']} | ok | "
                     f"{d['memory']['argument_gb']:.2f} | {ops} |")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reanalyze", action="store_true")
    ap.add_argument("--tables", action="store_true")
    ap.add_argument("--dir", default=str(RESULTS))
    args = ap.parse_args()
    d = Path(args.dir)
    if args.reanalyze:
        reanalyze(d)
    if args.tables:
        print(tables(d))
        print()
        print(multipod_table(d))


if __name__ == "__main__":
    main()
