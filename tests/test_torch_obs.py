"""The port's observability (``repro_torch.obs``) against the reference's.

Mirrors ``tests/test_obs.py`` and ``tests/test_telemetry.py``: the registry,
the exporters, tracing, the flight recorder, aggregation and the telemetry
server are copies of the reference's modules, so the same operations give
the same snapshots, the same Prometheus text and the same merged records in
both packages. The port's instrumentation is held to the reference's by one
compile and scan of the bundled bank plus a 702-state pattern (budget 512,
so 18 SFA, 5 enumeration and 1 speculative pattern; cache off) in each
package: the ``engine.*``, ``construction.*``, ``speculative.*`` and
``cache.sfa.*`` values and the set of span names are equal. Wall-time
histograms are left out of that comparison (they time the run), and so are
the ``kernels.*`` counters: the reference counts jit trace events, the port
counts wrapper calls.
"""

import json
import os
import socket
import subprocess
import sys
import urllib.error
from urllib.request import urlopen

import pytest

torch = pytest.importorskip("torch")

from _strategies import given, settings, st  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

import numpy as np  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.core.dfa import random_dfa as jrandom_dfa  # noqa: E402
from repro.core.prosite import load_bank as jload_bank  # noqa: E402
from repro.engine import ChunkPolicy as JChunkPolicy  # noqa: E402
from repro.engine import ConstructionPolicy as JConstructionPolicy  # noqa: E402
from repro.engine import ScanPlan as JScanPlan  # noqa: E402
from repro.engine import Scanner as JScanner  # noqa: E402
from repro.obs import aggregate as jaggregate  # noqa: E402
from repro.obs.flight import read_flight as jread_flight  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.construction import SFACache  # noqa: E402
from repro_torch.core.dfa import random_dfa  # noqa: E402
from repro_torch.core.prosite import load_bank, synthetic_protein  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    ChunkPolicy,
    ConstructionPolicy,
    ScanPlan,
    Scanner,
)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    parse_prometheus,
    render_prometheus,
    snapshot_delta,
)
from repro_torch.obs.aggregate import main as aggregate_main  # noqa: E402
from repro_torch.obs.aggregate import merge_records, merge_snapshots  # noqa: E402
from repro_torch.obs.export import (  # noqa: E402
    read_jsonl,
    snapshot_record,
    span_records,
    write_jsonl,
)
from repro_torch.obs.flight import FlightRecorder, read_flight  # noqa: E402
from repro_torch.obs.registry import MetricsRegistry, ObsState  # noqa: E402
from repro_torch.obs.tracing import _NOOP_SPAN  # noqa: E402
from repro_torch.scanservice import (  # noqa: E402
    BatchScheduler,
    ScanService,
    TelemetryServer,
)

CPU = "cpu"
PATTERNS = ["PS00016", "PS00005"]


@pytest.fixture(autouse=True)
def obs_enabled():
    """Every test starts and ends with observability on (the default)."""
    obs.enable()
    yield
    obs.enable()


@pytest.fixture(scope="module")
def docs():
    return [synthetic_protein(120, seed=i) for i in range(4)]


def _plan(cache):
    return ScanPlan(device=CPU, construction=ConstructionPolicy(
        cache=cache, method="batched"))


# --------------------------------------------------------------------------
# Registry and exporters: the same operations, the same output
# --------------------------------------------------------------------------


def _exercise(registry):
    """One fixed series of registry operations."""
    registry.counter("t.prom.hits", help="counted things").inc(42)
    registry.gauge("t.prom.rate", help="a level").set(0.75)
    h = registry.histogram("t.prom.wall", edges=(0.1, 1.0),
                           help="a spread\nsecond line")
    for v in (0.05, 0.5, 3.0, 1.0):
        h.observe(v)
    registry.counter("t.prom.hits", help="a later description").inc()


def test_registry_and_prometheus_text_match_reference():
    from repro.obs.export import render_prometheus as jrender
    from repro.obs.registry import MetricsRegistry as JMetricsRegistry

    mine, theirs = MetricsRegistry(ObsState()), JMetricsRegistry()
    _exercise(mine)
    _exercise(theirs)
    assert mine.snapshot() == theirs.snapshot()
    text = render_prometheus(mine.snapshot(), mine.help_texts())
    assert text == jrender(theirs.snapshot(), theirs.help_texts())
    assert "# HELP t_prom_hits counted things" in text
    assert 't_prom_wall_bucket{le="1"} 3' in text    # le: v == edge counts
    back = parse_prometheus(text)
    assert back["t_prom_hits"] == 43 and back["t_prom_rate"] == 0.75
    assert back["t_prom_wall"]["counts"] == [1, 2, 1]
    with pytest.raises(TypeError):
        mine.gauge("t.prom.hits")
    with pytest.raises(ValueError):
        mine.histogram("t.prom.wall", edges=(0.1, 2.0))


def test_snapshot_delta_reset_and_disabled_noops():
    obs.counter("t.obsdelta.a").inc(3)
    before = obs.snapshot("t.obsdelta")
    obs.counter("t.obsdelta.a").inc(2)
    obs.histogram("t.obsdelta.h", edges=(1.0,)).observe(0.5)
    delta = snapshot_delta(before, obs.snapshot("t.obsdelta"))
    assert delta["t.obsdelta.a"] == 2 and delta["t.obsdelta.h"]["count"] == 1
    obs.disable()
    try:
        obs.counter("t.obsdelta.a").inc(10)
        assert obs.span("a") is obs.span("b") is _NOOP_SPAN
        with obs.span("t.obs.off") as handle:
            assert handle is None and obs.current_trace_id() is None
    finally:
        obs.enable()
    assert obs.counter("t.obsdelta.a").value == 5
    obs.registry.reset()
    assert obs.snapshot("t.obsdelta")["t.obsdelta.a"] == 0


def test_jsonl_records_and_host_attribution(tmp_path):
    path = tmp_path / "events.jsonl"
    obs.counter("t.jsonl.c").inc(7)
    with obs.span("t.jsonl.span", k=1):
        pass
    write_jsonl(path, [snapshot_record(obs.snapshot("t.jsonl"), label="x")])
    write_jsonl(path, span_records(
        s for s in obs.recent_spans(10) if s.name == "t.jsonl.span"))
    records = read_jsonl(path)
    assert records[0]["metrics"]["t.jsonl.c"] == 7
    assert records[0]["host"] == socket.gethostname()
    assert records[0]["pid"] == os.getpid()
    assert records[-1]["name"] == "t.jsonl.span"
    assert records[-1]["attrs"] == {"k": 1}


# --------------------------------------------------------------------------
# Tracing, and its bridge into torch.profiler
# --------------------------------------------------------------------------


def test_span_nesting_trace_inheritance_and_errors():
    with obs.span("t.span.outer") as outer:
        assert obs.current_trace_id() == outer.trace_id
        with obs.span("t.span.inner") as inner:
            assert inner.trace_id == outer.trace_id
            assert inner.parent_id == outer.span_id
        with obs.span("t.span.rerooted", trace_id="t-explicit") as re:
            assert re.trace_id == "t-explicit"
    assert obs.current_trace_id() is None
    names = [s["name"] for s in obs.trace_summary(outer.trace_id)["spans"]]
    assert names == ["t.span.outer", "t.span.inner"]
    with pytest.raises(RuntimeError):
        with obs.span("t.span.err"):
            raise RuntimeError("boom")
    sp = obs.recent_spans(1)[0]
    assert sp.name == "t.span.err" and sp.attrs["error"] == "RuntimeError"


def test_spans_bridge_into_torch_profiler():
    """``configure(profiler_annotations=True)`` opens a
    ``torch.profiler.record_function`` per span, so spans are events of a
    ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile

    obs.configure(profiler_annotations=True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with obs.span("t.bridge.outer"):
                with obs.span("t.bridge.inner"):
                    torch.ones(4).sum()
    finally:
        obs.configure(profiler_annotations=False)
    keys = {e.key for e in prof.key_averages()}
    assert {"t.bridge.outer", "t.bridge.inner"} <= keys


# --------------------------------------------------------------------------
# Aggregation and the flight recorder, across the packages
# --------------------------------------------------------------------------


def test_merge_snapshots_and_records_match_reference():
    h = {"edges": [1.0, 2.0], "counts": [1, 0, 2], "sum": 7.0, "count": 3}
    snaps = [{"c": 3, "g": 1.5, "h": h},
             {"c": 4, "g": 2.5, "h": {"edges": [1.0, 2.0],
                                      "counts": [0, 5, 1], "sum": 9.0,
                                      "count": 6}},
             {"scheduler.max_coalesced": 9.0}]
    for kw in ({}, {"gauge_policy": "max"}, {"gauge_policies": {"g": "sum"}}):
        assert merge_snapshots(snaps, **kw) == \
            jaggregate.merge_snapshots(snaps, **kw)
    r1 = snapshot_record({"c": 1, "g": 10.0}, label="w0")
    r2 = snapshot_record({"c": 2, "g": 20.0}, label="w1")
    r1["host"], r1["pid"], r1["ts"] = "hostA", 1, 200.0
    r2["host"], r2["pid"], r2["ts"] = "hostB", 2, 100.0
    recs = [r1, r2, {"kind": "span", "name": "x"}]
    fleet = merge_records(recs)
    assert fleet == jaggregate.merge_records(recs)
    assert fleet["metrics"] == {"c": 3, "g": 10.0}
    with pytest.raises(TypeError):
        merge_snapshots([{"x": 1}, {"x": 1.5}])


def test_aggregate_cli_and_module(tmp_path, capsys):
    w0, w1 = tmp_path / "w0.jsonl", tmp_path / "w1.jsonl"
    write_jsonl(w0, [snapshot_record({"jobs.n": 3, "other": 1.0})])
    write_jsonl(w1, [snapshot_record({"jobs.n": 4})])
    with open(w1, "a") as f:
        f.write('{"torn": ')            # a killed writer's partial line
    out = tmp_path / "fleet.json"
    assert aggregate_main([str(w0), str(w1), "-o", str(out)]) == 0
    assert json.loads(out.read_text())["metrics"]["jobs.n"] == 7
    assert aggregate_main([str(w0), str(w1), "--format", "prom",
                           "--prefix", "jobs"]) == 0
    assert parse_prometheus(capsys.readouterr().out) == {"jobs_n": 7}
    assert aggregate_main([str(tmp_path / "nope.jsonl")]) == 1
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run(
        [sys.executable, "-W", "error::RuntimeWarning",
         "-m", "repro_torch.obs.aggregate", str(w0)],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": os.path.abspath(src)})
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["metrics"]["jobs.n"] == 3


def test_flight_recorder_trail_reads_in_both_packages(tmp_path):
    path = tmp_path / "flight" / "flight.jsonl"
    obs.counter("t.flight.pre").inc(5)       # before the recorder
    fr = FlightRecorder(path, label="worker", max_bytes=600, max_files=3)
    obs.counter("t.flight.c").inc(2)
    with obs.span("t.flight.span"):
        pass
    rec = fr.record(shard=3)
    assert rec["metrics"]["t.flight.c"] == 2
    assert "t.flight.pre" not in rec["metrics"]
    assert fr.record(force=False) is None
    for i in range(30):                      # rotate
        obs.counter("t.flight.c").inc()
        fr.record(i=i)
    with open(path, "a") as f:
        f.write('{"kind": "flight", "metr')  # the kill -9 tail
    mine, theirs = read_flight(path), jread_flight(path)
    assert mine == theirs
    flights = [r for r in mine if r["kind"] == "flight"]
    assert [r["i"] for r in flights if "i" in r][-1] == 29
    merged = merge_records(flights, prefix="t.flight")
    assert merged["metrics"]["t.flight.c"] == sum(
        r["metrics"].get("t.flight.c", 0) for r in flights)


@settings(max_examples=10, deadline=None)
@given(shards=st.lists(
    st.lists(st.tuples(st.integers(min_value=0, max_value=2),
                       st.integers(min_value=1, max_value=50)),
             min_size=0, max_size=5),
    min_size=1, max_size=4))
def test_merged_shard_deltas_equal_whole_run_snapshot(shards):
    start = obs.snapshot("t.prop")
    prev, deltas = start, []
    for ops_ in shards:
        for which, amount in ops_:
            obs.counter(f"t.prop.c{which}").inc(amount)
            obs.histogram("t.prop.h", edges=(8.0, 32.0)).observe(
                float(amount))
        cur = obs.snapshot("t.prop")
        deltas.append(snapshot_delta(prev, cur))
        prev = cur
    assert merge_snapshots(deltas) == snapshot_delta(
        start, obs.snapshot("t.prop"))


# --------------------------------------------------------------------------
# The port's instrumentation
# --------------------------------------------------------------------------


def test_scan_bit_identical_obs_on_off_and_kernel_calls(docs):
    before = obs.snapshot("kernels")
    on = Scanner.compile(PATTERNS, _plan(SFACache()))
    hits_on = on.scan(docs).hits
    assert on.last_trace_id is not None and "last trace" in on.describe()
    moved = snapshot_delta(before, obs.snapshot("kernels"))
    # one count a wrapper call (the plain versions on the CPU), no launch
    assert moved["kernels.match_bank_chunks.calls"] >= 1
    assert moved["kernels.compose_fold_rows.calls"] >= 1
    assert all(v == 0 for v in ops.launches.values())
    obs.disable()
    try:
        off = Scanner.compile(PATTERNS, _plan(SFACache()))
        hits_off = off.scan(docs).hits
        assert off.last_trace_id is None
    finally:
        obs.enable()
    assert np.array_equal(hits_on, hits_off)


def test_trace_id_propagates_submit_to_construction(docs):
    before = obs.snapshot("construction")
    sched = BatchScheduler(_plan(SFACache()))      # cold: flush constructs
    ticket = sched.submit(PATTERNS, docs)
    assert ticket.trace_id is not None
    sched.flush()
    ticket.result()
    assert sched.last_trace_id == ticket.trace_id
    summ = obs.trace_summary(ticket.trace_id)
    assert {"scheduler.submit", "scheduler.flush", "scanner.compile",
            "construct_bank"} <= {s["name"] for s in summ["spans"]}
    delta = snapshot_delta(before, obs.snapshot("construction"))
    assert delta["construction.banks"] >= 1
    assert delta["construction.rounds"] >= 1


def _get(url):
    with urlopen(url, timeout=10) as resp:
        return resp.status, resp.read().decode("utf-8")


def test_telemetry_server_endpoints(tmp_path, docs):
    cache = SFACache()
    with ScanService(tmp_path / "store", plan=_plan(cache),
                     cache=cache) as svc:
        srv = svc.serve_telemetry()
        ticket = svc.submit(PATTERNS, docs)
        svc.flush()
        ticket.result()
        status, body = _get(f"{srv.url}/metrics")
        assert status == 200
        assert parse_prometheus(body)["scheduler_requests"] >= 1
        health = json.loads(_get(f"{srv.url}/healthz")[1])
        assert health["status"] == "ok"
        assert health["scheduler"]["requests"] >= 1
        assert health["store"]["root"] == str(tmp_path / "store")
        traces = json.loads(_get(f"{srv.url}/traces?limit=5")[1])
        assert any("scheduler.flush" in t["names"] for t in traces["traces"])
        with pytest.raises(urllib.error.HTTPError):
            _get(f"{srv.url}/nope")
        m = svc.metrics()
        assert m["trace"]["trace_id"] == ticket.trace_id
    assert svc.telemetry is None and not srv.running


def test_instrumentation_matches_reference_on_bundled_bank():
    """One compile and one scan of the bundled bank plus a 702-state DFA
    (budget 512, cache off) in each package: equal counters, gauges and
    span names (wall-time histograms and ``kernels.*`` aside, see the
    module docstring)."""
    n_chunks = 4
    docs = [synthetic_protein(96, seed=i) for i in range(4)]
    bank, jbank = load_bank(), jload_bank()
    pats = {**{bank.ids[i]: bank.dfa(i) for i in range(bank.n_patterns)},
            "R702": random_dfa(702, 20, seed=7)}
    jpats = {**{jbank.ids[i]: jbank.dfa(i) for i in range(jbank.n_patterns)},
             "R702": jrandom_dfa(702, 20, seed=7)}

    def measured(o):
        snap = o.snapshot()
        keep = {k: v for k, v in snap.items()
                if k.split(".")[0] in ("engine", "construction",
                                       "speculative", "cache")
                and not isinstance(v, dict)}
        return keep, {s.name for s in o.recent_spans(4096)}

    obs.reset()
    port = Scanner.compile(pats, ScanPlan(
        device=CPU, chunking=ChunkPolicy(n_chunks=n_chunks),
        construction=ConstructionPolicy(cache="off")))
    got = port.scan(docs)
    mine, my_spans = measured(obs)
    jobs.reset()
    ref = JScanner.compile(jpats, JScanPlan(
        chunking=JChunkPolicy(n_chunks=n_chunks),
        construction=JConstructionPolicy(cache="off")))
    want = ref.scan(docs)
    theirs, their_spans = measured(jobs)
    modes = list(port.pattern_modes.values())
    assert (modes.count("sfa"), modes.count("enumeration"),
            modes.count("speculative")) == (18, 5, 1)
    assert np.array_equal(got.hits, want.hits)
    assert mine["speculative.total_chunks"] > 0
    assert mine["construction.rounds"] == port.construction_report.rounds
    theirs = {k: v for k, v in theirs.items()
              if not k.startswith("cache.rounds.")}   # no twin in the port
    assert mine == theirs
    assert my_spans == their_spans
    assert {"scanner.compile", "construct_bank", "construct_bank.bucket",
            "construction.round", "scanner.scan",
            "speculative.scan"} <= my_spans
