"""The yardstick's arithmetic: the metric readers, the roofline counts, the
trace summary, and ``BENCHMARK.json`` against the contract it is held to."""

import json
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from bench_port.harness import trace, window
from bench_port.harness.window import Window, load_reader, read_metric

BENCH = Path(__file__).resolve().parents[1]
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())


def summary(kernels, busy=1.0, win=4.0):
    return trace.TraceSummary(window_s=win, busy_s=busy, kernels=kernels)


def test_end_to_end_readers():
    w = Window(seconds=2.0, setup_s=7.5, completed=4,
               work=1000, latencies=[0.1, 0.2, 0.3, 0.4, 0.5])
    assert read_metric("scan_residues_per_s", w) == 500.0
    assert read_metric("setup_s", w) == 7.5
    c = Window(seconds=3.0, setup_s=1.0, completed=12)
    assert read_metric("compile_s", c) == 0.25
    assert read_metric("compile_s", Window(seconds=3.0, setup_s=1)) is None


def test_counter_readers():
    w = Window(seconds=1, setup_s=1, completed=4,
               counters={"kernels.match_bank_chunks.calls": 12})
    assert read_metric("walk_launches_per_request", w) == 3.0
    c = Window(seconds=1, setup_s=1, completed=5,
               counters={"construction.rounds": 400})
    assert read_metric("rounds_per_compile", c) == 80.0


def test_idle_share_reads_a_trace_under_every_name():
    w = Window(seconds=4, setup_s=1, trace=summary({}, 1, 4))
    for name in ("device_idle_pct.scan", "device_idle_pct.compile",
                 "device_idle_pct.serve"):
        assert read_metric(name, w) == 75.0
    w.trace = None
    assert read_metric("device_idle_pct.scan", w) is None


def test_a_dotted_name_without_a_file_reads_with_its_base(tmp_path,
                                                          monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "q.py").write_text("def read(w):\n    return 1\n")
    (tmp_path / "metrics" / "q.own.py").write_text(
        "def read(w):\n    return 2\n")
    monkeypatch.setattr(window, "HERE", tmp_path)
    w = Window(seconds=1, setup_s=1)
    assert read_metric("q.any", w) == 1
    assert read_metric("q.own", w) == 2
    assert read_metric("q", w) == 1


def test_the_readers_name_no_kind_of_cell():
    for f in (BENCH / "metrics").glob("*.py"):
        src = f.read_text()
        assert "kind" not in src and "workload" not in src, f.name


def test_match_bank_chunks_work():
    mod = load_reader("roofline", "match_bank_chunks")
    rows = np.asarray([5, 7])
    enum = {"args": [(2, 8, 20), (100, 6), 8], "kwargs": {},
            "out": (2, 100, 8), "true_rows": rows}
    assert mod.work(enum) == (4 * (12 * 20 + 600 + 12 * 100),
                              2 * 12 * 100 * 6)
    sfa = {"args": [(2, 8, 20), (100, 6), 1], "kwargs": {},
           "out": (2, 100, 1), "true_rows": rows}
    assert mod.work(sfa) == (4 * (12 * 20 + 600 + 2 * 100),
                             2 * 2 * 100 * 6)
    spec = {"args": [(2, 8, 20), (100, 6), 3, (2, 3)], "kwargs": {},
            "out": (2, 100, 3), "true_rows": rows}
    assert mod.work(spec) == (4 * (12 * 20 + 600 + 6 * 100 + 6),
                              2 * 6 * 100 * 6)


def rnd(live, n_true, tile=128):
    return {"live_rows": np.asarray(live), "n_true": np.asarray(n_true),
            "tile": tile}


def test_construction_kernels_work():
    exp = load_reader("roofline", "expand_bank")
    # a bucket of 4: two live patterns (9 and 6 states, 128 and 3 live
    # frontier rows), a pattern done and a padding row
    r = rnd([128, 3, 0, 0], [9, 6, 5, 9])
    rec = {"args": [(4, 9, 20), (4, 128, 9), (4, 5)], "kwargs": {},
           "out": (4, 2560, 9), "round": r}
    want = (9 * 20 + 128 * 9 + 5 + 128 * 20 * (9 + 5)
            + 6 * 20 + 3 * 6 + 3 + 3 * 20 * (6 + 3))
    assert exp.work(rec) == (4 * want, 0)
    assert exp.work({**rec, "round": None}) is None
    fp = load_reader("roofline", "fingerprint_bank")
    rec = {"args": [(4, 2560, 5), (4, 5, 2), (4, 4)], "kwargs": {},
           "out": (4, 2560, 2), "round": r}
    rows = (128 * 20, 3 * 20)
    words = (5, 3)
    assert fp.work(rec) == (
        sum(4 * (n * w + w * 2 + 4 + n * 2) for n, w in zip(rows, words)),
        sum(n * (w * 324 + 484) for n, w in zip(rows, words)))
    assert fp.work({**rec, "round": None}) is None


def test_padding_adds_no_counted_work():
    exp = load_reader("roofline", "expand_bank")
    fp = load_reader("roofline", "fingerprint_bank")
    a = rnd([7], [5])
    b = rnd([7, 0, 0, 0], [5, 5, 5, 5])      # a bucket padded to 4, n to 9
    small = {"args": [(1, 5, 20), (1, 128, 5), (1, 3)], "kwargs": {},
             "round": a}
    big = {"args": [(4, 9, 20), (4, 128, 9), (4, 5)], "kwargs": {},
           "round": b}
    assert exp.work(small) == exp.work(big)
    assert (fp.work({"args": [(1, 2560, 3)], "round": a})
            == fp.work({"args": [(4, 2560, 5)], "round": b}))


def test_roofline_share_and_its_refusals():
    r = rnd([1], [2])
    recs = [("expand_bank", {"args": [(1, 2, 20), (1, 1, 2), None],
                             "kwargs": {}, "out": (1, 20, 2),
                             "round": r})] * 4
    nbytes = 4 * (40 + 2 + 40)
    pk = window.peaks()
    least = 4 * window.least_seconds(nbytes, 0, pk)
    name = "void (anonymous namespace)::expand_bank_kernel<1>(int const*)"
    w = Window(seconds=1, setup_s=1, launches=recs,
               counters={"launches.expand_bank": 4},
               trace=summary({name: [4, least * 2]}))
    assert window.roofline_pct(w, "expand_bank") == pytest.approx(50.0)
    w.launches = recs[:3] + [("expand_bank", {**recs[0][1], "round": None})]
    assert window.roofline_pct(w, "expand_bank") is None  # not countable
    w.launches = recs
    w.counters["launches.expand_bank"] = 5          # the trace lost one
    assert window.roofline_pct(w, "expand_bank") is None
    w.trace = None
    assert window.roofline_pct(w, "expand_bank") is None


def test_least_time_is_the_larger_bound():
    pk = {"hbm_bytes_per_s": 2.0, "int32_ops_per_s": 4.0}
    assert window.least_seconds(10, 8, pk) == 5.0
    assert window.least_seconds(2, 40, pk) == 10.0


def test_trace_union_and_idle_gaps():
    assert trace._union([(0, 2), (1, 3), (5, 6)]) == 4
    dev = [(0, 10, "k"), (40, 50, "k"), (60, 70, "k")]
    host = [(0, 100, "scanner.scan", 1), (12, 38, "aten::copy_", 1),
            (51, 52, "x", 2)]
    gaps = dict(trace._idle_gaps(dev, host, 10))
    assert gaps == pytest.approx({"aten::copy_": 30e-6,
                                  "scanner.scan": 10e-6})


def test_kernel_time_matches_whole_names():
    s = summary({"void m::walk_kernel<4, 1>(Args)": [3, 1.0],
                 "void at::native::walk_kernelish(int)": [1, 9.0],
                 "fingerprint_bank_kernel(unsigned const*)": [2, 0.5]})
    assert s.kernel_time(("walk_kernel",)) == (3, 1.0)
    assert s.kernel_time(("fingerprint_bank_kernel",)) == (2, 0.5)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench_port"]
    assert SPEC["command"] == ["python3", "bench_port/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [x["name"] for x in SPEC["configs"] + SPEC["workloads"]
             + metrics]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    cells = {w["name"]: w for w in SPEC["workloads"]}
    assert all(w["chips"] == 1 for w in cells.values())
    assert all(len(w["why"]) <= 200 for w in cells.values())
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    for cell in cells:
        mine = [m for m in SPEC["end_to_end"]
                if cell in m.get("workloads", [cell])]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        assert any(cell in m.get("workloads", [cell])
                   for m in SPEC["per_layer"])
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert all(cell in e2e[m["moves"]].get("workloads", [cell])
                   for cell in m["workloads"])


def test_every_name_is_found_by_its_files():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(load_reader("metrics", m["name"]).read), m["name"]
        if m["name"].endswith("_roofline"):
            kernel = m["name"][:-len("_roofline")]
            assert callable(load_reader("roofline", kernel).work)
    for w in SPEC["workloads"]:
        t = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                       .read_text())
        assert (BENCH / "drivers" / f"{t['kind']}.py").exists()
    for c in SPEC["configs"]:
        cfg = json.loads((BENCH.parent / c["file"]).read_text())
        assert (BENCH.parent / c["file"]).parent.joinpath(
            cfg["patterns"]).exists()
        assert cfg["reduced"] == c["reduced"]


def test_round_facts_by_hand():
    import torch

    from bench_port.harness.port import round_facts

    masks = torch.tensor([[-1, -1, 0xFFFF, 0], [-1, 0, 0, 0],
                          [-1, -1, -1, -1]], dtype=torch.int32)
    f = round_facts(torch.tensor([300, 9, 4]), torch.tensor([100, 8, 4]),
                    torch.tensor([True, True, False]), masks, 128)
    assert list(f["live_rows"]) == [128, 1, 0]
    assert list(f["n_true"]) == [5, 2, 8]
    assert f["tile"] == 128


def test_kernel_names_are_read_from_the_programs_sources():
    from bench_port.harness.port import kernel_names

    names = kernel_names()
    assert {"walk_kernel", "expand_bank_kernel",
            "fingerprint_bank_kernel"} <= set(names)
    for n in load_reader("roofline", "match_bank_chunks").TRACE_NAMES:
        assert n in names


def test_recorded_rounds_count_each_sfa_state_once():
    """Each SFA state is expanded once, as one live frontier row of one
    round: the rows the facts count over a bank's rounds are its states."""
    from repro_torch.construction import batched

    from bench_port.harness import inputs
    from bench_port.harness.port import Port

    rows = inputs.read_patterns(BENCH / "configs" / "prosite23.patterns.txt")
    from bench_port.reference.prosite import compile_prosite

    dfas = [compile_prosite(p) for _, p in rows[:8]]
    bank = inputs.Bank(ids=[i for i, _ in rows[:8]],
                       tables=[d.table for d in dfas],
                       accepting=[d.accepting for d in dfas],
                       starts=[d.start for d in dfas])
    port = Port({"mode": "sfa", "sfa_state_budget": 4000}, "cpu", "off")
    needs = {"expand_bank": ("round",), "fingerprint_bank": ("round",)}
    with port.record_launches(needs) as log:
        res = batched.construct_bank(
            list(port.dfas(bank).values()), max_states=4000, tile=16,
            expand_backend="kernel", fingerprint_backend="kernel",
            device="cpu")
    assert not res.blown.any()
    exp = [r for k, r in log if k == "expand_bank"]
    fps = [r for k, r in log if k == "fingerprint_bank"]
    assert len(exp) == len(fps) == res.stats.rounds
    live = sum(int(r["round"]["live_rows"].sum()) for r in exp)
    assert live == sum(s.n_states for s in res.sfas)
    sizes = {len(t) for t in bank.tables}
    assert all(set(r["round"]["n_true"]) <= sizes for r in exp)
    assert all(r["round"]["live_rows"].max() <= 16 for r in exp)
    mod = load_reader("roofline", "fingerprint_bank")
    assert all(mod.work(r)[1] > 0 for r in fps)
