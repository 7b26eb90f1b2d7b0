"""The reader of the scan path's pad share, ``scan_pad_pct``: on synthetic
windows, and its declaration beside the scan layer's other metrics."""

import json

import pytest

from bench_port import run
from bench_port.harness.window import Window, read_metric

SCAN_CELLS = ["prosite23_sfa20k.swissprot_scan",
              "prosite23_sfa20k.reads_scan"]


def test_scan_pad_pct_reads_the_two_counters():
    w = Window(seconds=2.0, setup_s=1.0, completed=3,
               counters={"engine.scan_symbols": 819_200 * 3,
                         "engine.scan_pad_symbols": 98_304 * 3,
                         "kernels.match_bank_chunks.calls": 3})
    assert read_metric("scan_pad_pct", w) == pytest.approx(12.0)
    w.counters["engine.scan_pad_symbols"] = 0
    assert read_metric("scan_pad_pct", w) == 0.0


@pytest.mark.parametrize("counters,completed", [
    ({}, 3),                                       # a program without them
    ({"engine.scan_symbols": 500}, 3),             # no pad counter
    ({"engine.scan_symbols": 0, "engine.scan_pad_symbols": 0}, 3),
    ({"engine.scan_symbols": 500, "engine.scan_pad_symbols": 60}, 0),
], ids=["absent", "pad absent", "nothing scanned", "none completed"])
def test_scan_pad_pct_reads_nothing_where_there_is_nothing(counters,
                                                           completed):
    w = Window(seconds=2.0, setup_s=1.0, completed=completed,
               counters=counters)
    assert read_metric("scan_pad_pct", w) is None


def test_scan_pad_pct_is_declared_as_its_layer_is():
    spec = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    m, like = per_layer["scan_pad_pct"], per_layer["walk_launches_per_request"]
    assert (m["unit"], m["better"], m["source"]) == \
        ("%", "lower", "program_counter")
    assert (m["layer"], m["moves"], m["workloads"]) == \
        (like["layer"], like["moves"], like["workloads"])
    assert m["workloads"] == SCAN_CELLS


def test_a_traced_run_reports_the_pad_share(tiny):
    bench, bp = tiny
    out = run.run(bench, "tiny.scan", 2**31 + 41, 0.4, True, device="cpu",
                  root=bp, t_start=0.0)
    assert out["correct"] is True, out
    got = out["metrics"]["scan_pad_pct"]
    assert got["unit"] == "%" and 0 < got["value"] < 100
