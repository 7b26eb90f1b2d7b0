"""The readers of the program's per-span totals: each on a synthetic window,
and all of them in traced runs of the tiny cells on the CPU."""

import json

import pytest

from bench_port import run
from bench_port.harness.window import Window, read_metric

SCAN = {
    "scan_prepare_ms_per_request": ("span.scanner.scan.prepare.ns",),
    "scan_launch_ms_per_request": ("span.scanner.scan.launch.ns",),
    "scan_wait_ms_per_request": ("span.scanner.scan.readback.ns",),
    "scan_scatter_ms_per_request": ("span.scanner.scan.scatter.ns",),
}
COMPILE = {
    "round_launch_ms_per_compile": ("span.construction.round.self_ns",),
    "round_wait_ms_per_compile": ("span.construction.round.compact.ns",
                                  "span.construction.round.readback.ns"),
    "schedule_ms_per_compile": ("span.construction.schedule.ns",),
    "crop_ms_per_compile": ("span.construction.crop.ns",),
}
# Every counter a reader could be given, and what it must not read: the
# other spans' totals, and a span's self time where it reads the whole.
DECOYS = {"span.scanner.scan.ns": 7_000_000,
          "span.scanner.scan.prepare.self_ns": 1,
          "span.construction.round.ns": 9_000_000,
          "span.construction.round.compact.self_ns": 1,
          "kernels.match_bank_chunks.calls": 5}


@pytest.mark.parametrize("name,counters", [*SCAN.items(), *COMPILE.items()])
def test_each_reader_on_a_synthetic_window(name, counters):
    deltas = {c: 1_500_000 * (i + 1) for i, c in enumerate(counters)}
    w = Window(seconds=2.0, setup_s=1.0, completed=4,
               counters={**DECOYS, **deltas})
    want = sum(deltas.values()) / 4 / 1e6
    assert read_metric(name, w) == pytest.approx(want)
    # no completed request or compile; a program without the spans
    assert read_metric(name, Window(seconds=2.0, setup_s=1.0,
                                    counters=w.counters)) is None
    assert read_metric(name, Window(seconds=2.0, setup_s=1.0, completed=4,
                                    counters=dict(DECOYS))) is None


def test_the_new_metrics_are_declared_as_their_layers_are():
    spec = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    scan_layer = per_layer["walk_launches_per_request"]
    compile_layer = per_layer["rounds_per_compile"]
    for names, like in ((SCAN, scan_layer), (COMPILE, compile_layer)):
        for name in names:
            m = per_layer[name]
            assert (m["unit"], m["better"], m["source"]) == \
                ("ms", "lower", "program_counter")
            assert (m["layer"], m["moves"], m["workloads"]) == \
                (like["layer"], like["moves"], like["workloads"])


@pytest.mark.parametrize("cell,names", [("tiny.scan", SCAN),
                                        ("tiny.compile", COMPILE)])
def test_a_traced_run_reports_the_span_metrics(tiny, cell, names):
    bench, bp = tiny
    out = run.run(bench, cell, 2**31 + 29, 0.4, True, device="cpu",
                  root=bp, t_start=0.0)
    assert out["correct"] is True, out
    got = out["metrics"]
    assert set(names) <= set(got)
    assert all(got[n]["unit"] == "ms" and got[n]["value"] > 0
               for n in names)
