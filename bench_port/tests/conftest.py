"""Shared set-up of the benchmark's CPU tests: the repository's root and
``src/`` on the path, the ``cuda`` marker, one torch thread a process (the
suite runs several worker processes at once), and a tiny tree of cells."""

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

BENCH = ROOT / "bench_port"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(tmp_path):
    """A benchmark folder ``bp/`` under ``tmp_path`` with one small
    configuration (8 bundled signatures, budget 64, plan auto) and a scan
    and a compile mix, and ``BENCHMARK.json``'s contents with two cells on
    them, ``tiny.scan`` and ``tiny.compile``, added by entries alone.
    -> (bench dict, folder)."""
    bp = tmp_path / "bp"
    (bp / "configs").mkdir(parents=True)
    (bp / "traffic" / "compositions").mkdir(parents=True)
    lines = (BENCH / "configs" / "prosite23.patterns.txt").read_text()
    (bp / "configs" / "tiny.patterns.txt").write_text(
        "".join(lines.splitlines(True)[:8]))
    (bp / "configs" / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "patterns": "tiny.patterns.txt",
         "plan": {"mode": "auto", "sfa_state_budget": 64}}))
    shutil.copy(BENCH / "traffic" / "compositions" / "swissprot.json",
                bp / "traffic" / "compositions")
    (bp / "traffic" / "tiny_scan.json").write_text(json.dumps(
        {"kind": "scan", "docs": 24,
         "lengths": {"dist": "lognormal", "mu": 3.0, "sigma": 0.6,
                     "min": 2, "max": 200, "length_seed": 1},
         "form": "str", "composition": "swissprot", "pool": 3,
         "check_answers": 3, "trace_seconds": 0.2}))
    (bp / "traffic" / "tiny_compile.json").write_text(json.dumps(
        {"kind": "compile", "orders": 2, "order_seed": 2, "cache": "off", "check_answers": 2,
         "trace_seconds": 0.2}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "file": "bp/configs/tiny.json"})
    bench["workloads"] += [
        {"name": "tiny.scan", "config": "tiny", "traffic": "tiny_scan",
         "chips": 1},
        {"name": "tiny.compile", "config": "tiny", "traffic": "tiny_compile",
         "chips": 1}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = "scan" if any("scan" in w for w in m["workloads"]) \
                else "compile"
            m["workloads"].append(f"tiny.{kind}")
    return bench, bp
