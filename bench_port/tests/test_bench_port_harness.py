"""Runs of the harness on the CPU at a small size: cells found by name, the
control and planted faults in the program's timed path caught."""

import json

import numpy as np
import pytest

from bench_port import control, run


def one_run(bench, bp, cell, trace=False, seconds=0.4):
    return run.run(bench, cell, 2**31 + 11, seconds, trace, device="cpu",
                   root=bp, t_start=0.0)


@pytest.mark.parametrize("cell", ["tiny.scan", "tiny.compile"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_cell_added_by_files_and_entries_runs_correct(tiny, cell, trace):
    bench, bp = tiny
    out = one_run(bench, bp, cell, trace)
    assert out["correct"] is True, out
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in out["checks"].values())
    kind = cell.split(".")[1]
    metrics = set(out["metrics"])
    if trace:
        assert {"device_idle_pct." + kind} <= metrics
        assert "setup_s" not in metrics
        assert out["device"]["window_s"] > 0
    else:
        e2e = {"scan_residues_per_s"} if kind == "scan" else {"compile_s"}
        assert metrics == e2e | {"setup_s"}
    json.dumps(out)


@pytest.mark.parametrize("cell", ["tiny.scan", "tiny.compile"])
def test_the_control_comes_out_not_correct(tiny, cell):
    bench, bp = tiny
    # 8-bit ids: the tiny bank's DFAs are small, its largest SFAs are not
    if cell == "tiny.compile":
        cfg = bp / "configs" / "tiny.json"
        c = json.loads(cfg.read_text())
        c["plan"]["sfa_state_budget"] = 20000
        cfg.write_text(json.dumps(c))
        out = control.control(bench, cell, 5, "cpu", bp)
        assert out["sfa_mismatches"] > 0
    else:
        (bp / "configs" / "tiny.patterns.txt").write_text(
            "BIG\tK-x(6)-Y-x-[ALW]\n")      # a 289-state DFA
        t = json.loads((bp / "traffic" / "tiny_scan.json").read_text())
        t["docs"], t["lengths"] = 2000, {"dist": "fixed", "value": 400}
        (bp / "traffic" / "tiny_scan.json").write_text(json.dumps(t))
        out = control.control(bench, cell, 5, "cpu", bp)
        assert out["hit_mismatches"] > 0


def break_scan(monkeypatch, how):
    from repro_torch.engine import scanner as S

    orig = S.Scanner.scan
    first = {}

    def scan(self, docs):
        res = orig(self, docs)
        hits = res.hits.copy()
        if how == "altered":
            hits[0, 0] = not hits[0, 0]
        elif how == "half_left_out":
            D = hits.shape[1]
            part = orig(self, docs[: D // 2]).hits
            hits = np.zeros_like(hits)
            hits[:, : D // 2] = part
        elif how == "state_unchanged":
            hits = first.setdefault("hits", hits)
        return S.ScanResult(hits=hits, ids=res.ids)

    monkeypatch.setattr(S.Scanner, "scan", scan)


def break_compile(monkeypatch, how):
    from repro_torch.construction.types import SFA
    from repro_torch.engine import scanner as S

    orig = S.construct_bank

    def construct_bank(dfas, **kw):
        res = orig(dfas, **kw)
        for p, s in enumerate(res.sfas):
            if s is None:
                continue
            if how == "altered":
                d = s.delta.copy()
                d[0, 0] = (d[0, 0] + 1) % s.n_states
                res.sfas[p] = SFA(s.mappings, d, s.fingerprints, s.dfa,
                                  s.stats)
                break
            if how == "half_left_out" and p % 2:
                res.sfas[p] = None
                res.blown[p] = True
            if how == "state_unchanged":      # the closure never advances
                k = s.delta.shape[1]
                res.sfas[p] = SFA(s.mappings[:1], np.zeros((1, k), np.int32),
                                  s.fingerprints[:1], s.dfa, s.stats)
        return res

    monkeypatch.setattr(S, "construct_bank", construct_bank)


@pytest.mark.parametrize("how", ["altered", "half_left_out",
                                 "state_unchanged"])
@pytest.mark.parametrize("cell", ["tiny.scan", "tiny.compile"])
def test_a_fault_in_the_timed_path_is_not_correct(tiny, monkeypatch, cell,
                                                  how):
    bench, bp = tiny
    (break_scan if cell == "tiny.scan" else break_compile)(monkeypatch, how)
    out = one_run(bench, bp, cell, seconds=0.6)
    assert out["correct"] is False, out
    assert max(c["value"] for c in out["checks"].values()) > 0


def test_main_refuses_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "prosite23_sfa20k.compile", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_a_tiny_cell_on_the_card(tiny):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    bench, bp = tiny
    out = run.run(bench, "tiny.scan", 3, 0.5, True, device="cuda", root=bp,
                  t_start=0.0)
    assert out["correct"] is True
    assert out["device"]["busy_s"] > 0
