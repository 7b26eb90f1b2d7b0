"""The windowed-census cell on the CPU at a small shard: the driver's
answers against the plain reference, the reference against a walk of each
window written here, planted faults and the 8-bit control caught, and the
cell's metric readers (span totals, ``compose`` calls, the two rooflines of
``compose_fold_kernel``)."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from bench_port import control, run
from bench_port.drivers import census
from bench_port.harness import inputs, trace
from bench_port.harness.port import Port
from bench_port.harness.window import Window, read_metric
from bench_port.reference.census import n_windows, window_hits
from bench_port.reference.prosite import compile_prosite
from bench_port.reference.scan import BankTables

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CELL = "prosite23_census384.census_windows"
TINY = "tinyc.census_windows"
SPANS = {
    "census_prepare_ms_per_request": "span.scanner.census.prepare.ns",
    "census_fold_ms_per_request": "span.scanner.census.fold.ns",
    "census_windows_ms_per_request": "span.scanner.census.windows.ns",
    "census_readback_ms_per_request": "span.scanner.census.readback.ns",
}
NEW = [*SPANS, "compose_launches_per_request", "compose_roofline",
       "compose_fold_rows_roofline", "device_idle_pct.census"]
FALSE = ("void (anonymous namespace)::compose_fold_kernel<false>(int const*,"
         " int const*, int const*, int*, long long, int, int, int, int, int,"
         " int)")
TRUE = FALSE.replace("<false>", "<true>")


@pytest.fixture
def tinyc(tmp_path):
    """A benchmark folder with the census configuration cut to the first 8
    bundled signatures (their SFAs up to 2,821 states) and a mix of
    2^12-residue shards, and ``BENCHMARK.json``'s contents with the cell
    ``tinyc.census_windows`` named wherever the census cell is.
    -> (bench dict, folder)."""
    bp = tmp_path / "bp"
    (bp / "configs").mkdir(parents=True)
    (bp / "traffic" / "compositions").mkdir(parents=True)
    lines = (BENCH / "configs" / "prosite23.patterns.txt").read_text()
    (bp / "configs" / "tinyc.patterns.txt").write_text(
        "".join(lines.splitlines(True)[:8]))
    cfg = json.loads((BENCH / "configs" / "prosite23_census384.json")
                     .read_text())
    cfg.update(name="tinyc", patterns="tinyc.patterns.txt")
    (bp / "configs" / "tinyc.json").write_text(json.dumps(cfg))
    shutil.copy(BENCH / "traffic" / "compositions" / "swissprot.json",
                bp / "traffic" / "compositions")
    mix = json.loads((BENCH / "traffic" / "census_windows.json").read_text())
    mix.update(shard_residues=1 << 12, pool=3, trace_seconds=0.3)
    (bp / "traffic" / "tinyc.json").write_text(json.dumps(mix))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tinyc",
                             "file": "bp/configs/tinyc.json"})
    bench["workloads"].append({"name": TINY, "config": "tinyc",
                               "traffic": "tinyc", "chips": 1})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY)
    return bench, bp


def one_run(bench, bp, trace=False, seconds=0.5):
    return run.run(bench, TINY, 2**31 + 47, seconds, trace, device="cpu",
                   root=bp, t_start=0.0)


def driver(bench, bp, seed=3):
    cell = inputs.load_cell(bench, TINY, bp)
    return census.Driver(cell, inputs.load_bank(cell, bp / "_cache"), seed)


def walk(table, accepting, start, codes):
    s = start
    for c in codes:
        s = table[s, c]
    return bool(accepting[s])


# --------------------------------------------------------------------------
# Traffic, reference, driver
# --------------------------------------------------------------------------


def test_the_mix_is_the_documented_shard():
    mix = json.loads((BENCH / "traffic" / "census_windows.json").read_text())
    cfg = json.loads((BENCH / "configs" / "prosite23_census384.json")
                     .read_text())
    assert (mix["kind"], mix["form"], mix["shard_residues"]) == \
        ("census", "array", 1 << 22)
    assert cfg["census"] == {"window": 384, "stride": 48}
    assert cfg["plan"] == {"mode": "sfa", "sfa_state_budget": 20000}
    assert cfg["patterns"] == "prosite23.patterns.txt"
    assert cfg["reduced"] == []
    assert n_windows(1 << 22, 384, 48) == 87_374


def test_a_shard_pool_is_a_function_of_the_seed(tinyc):
    bench, bp = tinyc
    traffic = inputs.load_cell(bench, TINY, bp).traffic
    a, b = census.shard_pool(traffic, 2**31 + 5), census.shard_pool(
        traffic, 2**31 + 5)
    c = census.shard_pool(traffic, 6)
    assert len(a) == 3 and all(s.shape == (1 << 12,) for s in a)
    assert all(s.dtype == np.int32 and s.min() >= 0 and s.max() < 20
               for s in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert not np.array_equal(a[0], a[1])


def test_the_reference_is_a_walk_of_every_window():
    rows = inputs.read_patterns(BENCH / "configs" / "prosite23.patterns.txt")
    dfas = [compile_prosite(p) for _, p in rows[:6]]
    tables = BankTables([d.table for d in dfas], [d.accepting for d in dfas],
                        [d.start for d in dfas], "cpu")
    seq = np.random.default_rng(4).integers(0, 20, 700).astype(np.int32)
    window, stride = 96, 16
    got = window_hits(tables, seq, window, stride, block=5)
    W = (700 - window) // stride + 1
    assert got.shape == (6, W)
    for p, d in enumerate(dfas):
        for i in range(W):
            assert got[p, i] == walk(d.table, d.accepting, d.start,
                                     seq[i * stride:i * stride + window])
    assert window_hits(tables, seq[:95], window, stride).shape == (6, 0)


def test_the_drivers_answers_equal_the_reference(tinyc):
    bench, bp = tinyc
    drv = driver(bench, bp)
    drv.start(Port({"mode": "sfa", "sfa_state_budget": 20000}, "cpu"))
    b = drv.bank
    ref = BankTables(b.tables, b.accepting, b.starts, "cpu")
    for i in range(3):
        work, (j, hits) = drv.call(i)
        assert work == 1 << 12 and j == i
        want = window_hits(ref, drv.pool[j], 384, 48)
        assert want.shape == (8, 78) and 0 < want.sum() < want.size
        assert np.array_equal(hits, want)
    assert drv.compare([drv.call(i)[1] for i in range(3)],
                       "cpu") == {"hit_mismatches": 0}


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_correct_on_the_cpu(tinyc, trace):
    bench, bp = tinyc
    out = one_run(bench, bp, trace)
    assert out["correct"] is True, out
    assert out["failed"] == 0 and out["attempted"] >= 2
    assert out["checks"] == {"hit_mismatches": {"value": 0, "limit": 0},
                             "failed_requests": {"value": 0, "limit": 0}}
    got = out["metrics"]
    if not trace:
        assert set(got) == {"scan_residues_per_s", "setup_s"}
        return
    # every span metric, 7 compose calls a request (one pattern group: 3 +
    # 3 scan steps and the stitch); no device, so no roofline
    assert set(SPANS) | {"compose_launches_per_request",
                         "device_idle_pct.census"} <= set(got)
    assert got["compose_launches_per_request"]["value"] == 7.0
    assert all(got[n]["value"] > 0 for n in SPANS)
    assert "compose_roofline" not in got
    assert "compose_fold_rows_roofline" not in got


def break_census(monkeypatch, how):
    from repro_torch.engine import scanner as S

    orig = S.Scanner.census_windows
    first = {}

    def census_windows(self, seq, window, stride=None):
        res = orig(self, seq, window, stride)
        hits = res.hits.copy()
        if how == "shifted_a_block":
            hits[:, 1:] = res.hits[:, :-1]
        elif how == "half_left_out":
            hits[:, hits.shape[1] // 2:] = False
        elif how == "stale":
            hits = first.setdefault("hits", hits)
        return S.ScanResult(hits=hits, ids=res.ids)

    monkeypatch.setattr(S.Scanner, "census_windows", census_windows)


@pytest.mark.parametrize("how", ["shifted_a_block", "half_left_out",
                                 "stale"])
def test_a_fault_in_the_timed_path_is_not_correct(tinyc, monkeypatch, how):
    bench, bp = tinyc
    break_census(monkeypatch, how)
    out = one_run(bench, bp, seconds=0.8)
    assert out["attempted"] >= 3
    assert out["correct"] is False, out
    assert out["checks"]["hit_mismatches"]["value"] > 0


def test_an_answer_of_the_wrong_shape_counts_whole(tinyc):
    bench, bp = tinyc
    drv = driver(bench, bp)
    assert drv.compare([(0, np.zeros((8, 77), bool))], "cpu") == \
        {"hit_mismatches": 8 * 78}


def test_the_control_comes_out_not_correct(tinyc):
    bench, bp = tinyc
    out = control.control(bench, TINY, 5, "cpu", bp)
    assert out["hit_mismatches"] > 0


# --------------------------------------------------------------------------
# Metric readers
# --------------------------------------------------------------------------


def summary(kernels):
    return trace.TraceSummary(window_s=4.0, busy_s=1.0, kernels=kernels)


@pytest.mark.parametrize("name", NEW)
def test_each_reader_reads_nothing_without_its_counters(name):
    w = Window(seconds=2.0, setup_s=1.0, completed=4,
               counters={"span.scanner.scan.prepare.ns": 5_000_000,
                         "kernels.match_bank_chunks.calls": 9})
    assert read_metric(name, w) is None


@pytest.mark.parametrize("name,counter", SPANS.items())
def test_each_span_reader_on_a_synthetic_window(name, counter):
    decoys = {c: 1 for c in SPANS.values() if c != counter}
    w = Window(seconds=2.0, setup_s=1.0, completed=4,
               counters={**decoys, counter: 6_000_000,
                         "span.scanner.census.ns": 9_000_000})
    assert read_metric(name, w) == pytest.approx(1.5)


def test_compose_launches_per_request():
    w = Window(seconds=1.0, setup_s=1.0, completed=5,
               counters={"kernels.compose.calls": 35,
                         "kernels.compose_fold_rows.calls": 5})
    assert read_metric("compose_launches_per_request", w) == 7.0
    w.completed = 0
    assert read_metric("compose_launches_per_request", w) is None


def rooflines_window(n_compose=7, n_rows=1):
    """A traced window of one census request by hand: 7 ``compose`` calls of
    (B, n) = (1,000, 87) and one rows fold of 23 x 2,000 x 8 over 87 states,
    each instantiation traced for twice its least time."""
    from bench_port.harness.window import least_seconds, peaks

    pk = peaks()
    B, n, P, D, m = 1000, 87, 23, 2000, 8
    comp = {"args": [(B, n), (B, n)], "kwargs": {}, "out": (B, n)}
    rows = {"args": [(P, 7184, n), (P, D, m)], "kwargs": {},
            "out": (P, D, n)}
    t_comp = least_seconds(3 * 4 * B * n, 0, pk) * 7 * 2
    t_rows = least_seconds(4 * (P * D * n + P * D * m), 0, pk) * 2
    return Window(
        seconds=1.0, setup_s=1.0, completed=1,
        counters={"kernels.compose.calls": n_compose,
                  "kernels.compose_fold_rows.calls": n_rows,
                  "launches.compose": 8},
        launches=[("compose", comp)] * 7 + [("compose_fold_rows", rows)],
        trace=summary({FALSE: [7, t_comp], TRUE: [1, t_rows],
                       "void m::walk_kernel<4, 1>(Args)": [1, 5.0]}))


def test_the_rooflines_count_a_hand_made_launch_record():
    w = rooflines_window()
    assert read_metric("compose_roofline", w) == pytest.approx(50.0)
    assert read_metric("compose_fold_rows_roofline", w) == pytest.approx(50.0)


def test_the_rooflines_read_none_where_the_counts_differ(capsys):
    # a compose_fold launch shares <false>'s name: 8 traced, 7 calls
    assert read_metric("compose_roofline", rooflines_window(n_compose=6)) \
        is None
    assert read_metric("compose_fold_rows_roofline",
                       rooflines_window(n_rows=2)) is None
    assert "no roofline" in capsys.readouterr().err
    w = rooflines_window()
    w.trace = None
    assert read_metric("compose_roofline", w) is None
    w = rooflines_window()
    w.launches = []
    assert read_metric("compose_fold_rows_roofline", w) is None


def test_the_census_entries_of_benchmark_json():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    assert cells[CELL]["config"] == "prosite23_census384"
    assert cells[CELL]["chips"] == 1
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["scan_residues_per_s"]["workloads"][-1] == CELL
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["moves"] == "scan_residues_per_s"
        assert m["workloads"][0] == CELL
    assert per_layer["compose_fold_rows_roofline"]["workloads"] == \
        [CELL, "prosite23_sfa20k.reads_scan"]
    layer = {per_layer[n]["layer"] for n in [*SPANS,
                                             "compose_launches_per_request"]}
    assert len(layer) == 1
