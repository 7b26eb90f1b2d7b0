"""The port's observability (``repro_torch.obs``) against the reference's.

Mirrors ``tests/test_obs.py`` and ``tests/test_telemetry.py``: the registry,
the exporters, tracing, the flight recorder, aggregation and the telemetry
server are copies of the reference's modules, so the same operations give
the same snapshots, the same Prometheus text and the same merged records in
both packages. The port's instrumentation is held to the reference's by one
compile and scan of the bundled bank plus a 702-state pattern (budget 512,
so 18 SFA, 5 enumeration and 1 speculative pattern; cache off) in each
package: the ``engine.*``, ``construction.*``, ``speculative.*`` and
``cache.sfa.*`` values are equal, and the port's span names are the
reference's plus the spans it opens around its scan and construction steps
(``NEW_SPANS``, kept in the ring buffer) and inside their loops
(``LOOP_SPANS``, totals only). Wall-time histograms and the port's
``span.*`` totals are left out of that comparison (they time the run), and
so are the ``kernels.*`` counters: the reference counts jit trace events,
the port counts wrapper calls.
"""

import contextvars
import json
import os
import socket
import subprocess
import sys
import threading
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

#: Spans the port opens around its scan and construction steps, beyond the
#: reference's names.
NEW_SPANS = {
    "scanner.scan.prepare", "speculative.profile", "scanner.compile.groups",
    "construction.setup", "construction.crop",
}
#: Loop spans the port opens inside those loops: totals, no record.
LOOP_SPANS = {
    "scanner.scan.launch", "scanner.scan.readback", "scanner.scan.scatter",
    "construction.schedule", "construction.round.compact",
    "construction.round.readback",
}


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


def _dur(s):
    return s.t_end_ns - s.t_start_ns


def test_span_totals_count_calls_ns_and_self_ns():
    """Each closed span adds to ``span.<name>.{calls,ns,self_ns}``; self
    time leaves out direct children on the same thread only: a span
    re-rooted on a fresh thread and one whose parent is this thread's span
    (a copied context) are not taken off their parent's self time."""
    before = obs.snapshot("span.t.tot")
    box = {}

    def fresh_thread(trace_id):
        with obs.span("t.tot.thread", trace_id=trace_id) as s:
            box["fresh"] = s

    def copied_context():
        with obs.span("t.tot.thread") as s:
            box["copied"] = s

    with obs.span("t.tot.outer") as outer:
        with obs.span("t.tot.inner") as a:
            pass
        with obs.span("t.tot.inner") as b:
            with obs.span("t.tot.leaf") as leaf:
                torch.ones(8).sum()
        ctx = contextvars.copy_context()
        for th in (threading.Thread(target=fresh_thread,
                                    args=(outer.trace_id,)),
                   threading.Thread(target=ctx.run, args=(copied_context,))):
            th.start()
            th.join()
    fresh, copied = box["fresh"], box["copied"]
    assert fresh.parent_id is None and fresh.trace_id == outer.trace_id
    assert copied.parent_id == outer.span_id
    d = snapshot_delta(before, obs.snapshot("span.t.tot"))
    got = {k: d.get(f"span.t.tot.{k}", 0) for k in (
        "outer.calls", "outer.ns", "outer.self_ns", "inner.calls",
        "inner.ns", "inner.self_ns", "leaf.calls", "leaf.ns",
        "leaf.self_ns", "thread.calls", "thread.ns", "thread.self_ns")}
    threads = _dur(fresh) + _dur(copied)
    assert got == {
        "outer.calls": 1, "outer.ns": _dur(outer),
        "outer.self_ns": _dur(outer) - _dur(a) - _dur(b),
        "inner.calls": 2, "inner.ns": _dur(a) + _dur(b),
        "inner.self_ns": _dur(a) + _dur(b) - _dur(leaf),
        "leaf.calls": 1, "leaf.ns": _dur(leaf), "leaf.self_ns": _dur(leaf),
        "thread.calls": 2, "thread.ns": threads, "thread.self_ns": threads,
    }
    assert isinstance(obs.snapshot()["span.t.tot.outer.ns"], int)

    obs.disable()
    try:
        with obs.span("t.tot.outer"):
            with obs.span("t.tot.inner"):
                pass
    finally:
        obs.enable()
    assert snapshot_delta(before, obs.snapshot("span.t.tot")) == d
    obs.reset()
    assert set(obs.snapshot("span.t.tot").values()) == {0}


def test_span_totals_lose_nothing_across_threads():
    """Threads closing spans of one name at once, from its first close on,
    bind one set of counters and lose no update; a reset zeroes them."""
    n_threads, n_spans = 8, 300
    go = threading.Barrier(n_threads)
    durs = [0] * n_threads

    def work(t):
        go.wait()
        for _ in range(n_spans):
            with obs.span("t.race.leaf", trace_id=f"t.race.{t}") as sp:
                pass
            durs[t] += _dur(sp)

    before = obs.snapshot("span.t.race")
    threads = [threading.Thread(target=work, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    d = snapshot_delta(before, obs.snapshot("span.t.race"))
    assert d == {"span.t.race.leaf.calls": n_threads * n_spans,
                 "span.t.race.leaf.ns": sum(durs),
                 "span.t.race.leaf.self_ns": sum(durs)}
    obs.reset()
    assert set(obs.snapshot("span.t.race").values()) == {0}


def test_exported_spans_lie_on_the_profilers_clock():
    """An exported span's ``t_start_unix_ns``/``t_end_unix_ns`` fall inside
    its bridged ``record_function`` event on the profiler's clock
    (``trace_start_ns() + time_range · 1000``), within 200 µs at each
    end. The bridge's own cost stays out of the totals: a leaf's ``ns`` is
    its interval, an enclosing span's less its children's annotations."""
    from torch.profiler import ProfilerActivity, profile

    before = obs.snapshot("span.t.clock")
    obs.configure(profiler_annotations=True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with obs.span("t.clockwarm"):       # the bridge's first call
                pass
            for _ in range(2):
                with obs.span("t.clock.outer"):
                    with obs.span("t.clock.inner", k=1):
                        torch.ones(64).sum()
    finally:
        obs.configure(profiler_annotations=False)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = sorted((e for e in prof.events()
                     if e.name.startswith("t.clock.")),
                    key=lambda e: e.time_range.start)
    spans = sorted((s.to_json() for s in obs.recent_spans(16)
                    if s.name.startswith("t.clock.")),
                   key=lambda r: r["t_start_unix_ns"])
    assert [e.name for e in events] == [r["name"] for r in spans]
    assert len(spans) == 4
    tol = 200_000
    for e, r in zip(events, spans):
        a = t0 + e.time_range.start * 1000
        b = t0 + e.time_range.end * 1000
        assert a - tol <= r["t_start_unix_ns"] <= a + tol, (e.name, a, r)
        assert b - tol <= r["t_end_unix_ns"] <= b + tol, (e.name, b, r)
        assert r["t_start_unix_ns"] < r["t_end_unix_ns"]
        assert r["t_end_unix_ns"] - r["t_start_unix_ns"] == \
            pytest.approx(r["wall_s"] * 1e9, abs=1)
    d = snapshot_delta(before, obs.snapshot("span.t.clock"))
    durs = {n: sum(_dur(s) for s in obs.recent_spans(16) if s.name == n)
            for n in ("t.clock.outer", "t.clock.inner")}
    assert d["span.t.clock.inner.ns"] == d["span.t.clock.inner.self_ns"] \
        == durs["t.clock.inner"]
    assert 0 < d["span.t.clock.outer.ns"] < durs["t.clock.outer"]
    assert d["span.t.clock.outer.ns"] - d["span.t.clock.outer.self_ns"] \
        == d["span.t.clock.inner.ns"]


def test_loop_spans_add_to_the_totals_and_keep_no_record():
    """A loop span hands its passes to ``span.<name>.*`` when the span it
    was made in closes, counts as that span's direct child (a span closed
    inside it is its child, and is not taken off the enclosing span twice)
    and keeps no record in the ring buffer. Made with no span open, or used
    after its span closed, it hands each pass over at its exit; disabled,
    it is the shared no-op span."""
    before = obs.snapshot("span.t.loop")
    with obs.span("t.loop.outer") as outer:
        step = obs.loop_span("t.loop.step")
        for i in range(3):
            with step:
                if i == 1:
                    with obs.span("t.loop.inner") as inner:
                        torch.ones(8).sum()
        mid = snapshot_delta(before, obs.snapshot("span.t.loop"))
    assert mid.get("span.t.loop.step.calls", 0) == 0
    d = snapshot_delta(before, obs.snapshot("span.t.loop"))
    assert inner.parent_id == outer.span_id
    assert d["span.t.loop.step.calls"] == 3
    assert d["span.t.loop.inner.ns"] == _dur(inner)
    assert d["span.t.loop.step.ns"] - d["span.t.loop.step.self_ns"] \
        == _dur(inner)
    assert d["span.t.loop.outer.ns"] == _dur(outer)
    assert d["span.t.loop.outer.ns"] - d["span.t.loop.outer.self_ns"] \
        == d["span.t.loop.step.ns"] > _dur(inner)
    kept = {sp.name for sp in obs.recent_spans(4096)
            if sp.trace_id == outer.trace_id}
    assert kept == {"t.loop.outer", "t.loop.inner"}

    with step:                      # its span has closed
        pass
    top = obs.loop_span("t.loop.top")
    with top:
        pass
    d = snapshot_delta(before, obs.snapshot("span.t.loop"))
    assert d["span.t.loop.step.calls"] == 4
    assert d["span.t.loop.top.calls"] == 1
    assert d["span.t.loop.top.ns"] == d["span.t.loop.top.self_ns"] > 0

    obs.disable()
    try:
        off = obs.loop_span("t.loop.off")
        with off:
            pass
    finally:
        obs.enable()
    assert off is _NOOP_SPAN
    assert "span.t.loop.off.calls" not in obs.snapshot("span.t.loop")


def test_loop_spans_bridge_into_the_profiler_outside_their_totals():
    """Bridged, a loop span is a ``record_function`` event of each pass,
    and no annotation's cost reaches its totals or its span's."""
    from torch.profiler import ProfilerActivity, profile

    before = obs.snapshot("span.t.lbridge")
    obs.configure(profiler_annotations=True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with obs.span("t.lbridge.outer") as outer:
                step = obs.loop_span("t.lbridge.step")
                for _ in range(2):
                    with step:
                        with obs.span("t.lbridge.inner") as inner:
                            torch.ones(64).sum()
    finally:
        obs.configure(profiler_annotations=False)
    names = [e.name for e in prof.events() if e.name.startswith("t.lbridge")]
    assert names.count("t.lbridge.step") == 2
    d = snapshot_delta(before, obs.snapshot("span.t.lbridge"))
    assert d["span.t.lbridge.step.calls"] == 2
    assert d["span.t.lbridge.step.ns"] - d["span.t.lbridge.step.self_ns"] \
        == d["span.t.lbridge.inner.ns"]
    assert d["span.t.lbridge.outer.ns"] - d["span.t.lbridge.outer.self_ns"] \
        == d["span.t.lbridge.step.ns"]
    # The step's and the inner spans' annotations lie inside the outer
    # span's interval and outside its total.
    assert 0 < d["span.t.lbridge.outer.ns"] < _dur(outer)
    assert d["span.t.lbridge.inner.ns"] < 2 * _dur(inner) + _dur(outer)


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


def _span_calls(before):
    d = snapshot_delta(before, obs.snapshot("span"))
    return {k[len("span."):-len(".calls")]: v for k, v in d.items()
            if k.endswith(".calls")}


def test_scan_spans_one_a_batch_and_group():
    """Documents of three lengths: one prepare span a scan, and a launch, a
    readback and a scatter pass for each length batch and pattern group,
    counted in the totals and kept out of the ring buffer."""
    sc = Scanner.compile(PATTERNS + ["PS00001"], _plan(SFACache()))
    docs = [synthetic_protein(L, seed=i)
            for i, L in enumerate([40, 96, 40, 130, 96, 40])]
    before = obs.snapshot("span")
    hits = sc.scan(docs).hits
    calls = _span_calls(before)
    G = len(sc.groups)
    assert calls == {"scanner.scan": 1, "scanner.scan.prepare": 1,
                     "scanner.scan.launch": 3 * G,
                     "scanner.scan.readback": 3 * G,
                     "scanner.scan.scatter": 3 * G}
    summ = obs.trace_summary(sc.last_trace_id)
    assert summ["spans"][0]["attrs"] == {"patterns": 3, "docs": 6}
    assert [s["name"] for s in summ["spans"]] == ["scanner.scan",
                                                 "scanner.scan.prepare"]
    d = snapshot_delta(before, obs.snapshot("span"))
    loops = sum(d[f"span.scanner.scan.{n}.ns"]
                for n in ("launch", "readback", "scatter"))
    assert d["span.scanner.scan.ns"] - d["span.scanner.scan.self_ns"] \
        == d["span.scanner.scan.prepare.ns"] + loops
    assert hits.shape == (3, 6)


def test_compile_spans_one_a_round_and_results_obs_off():
    """A batched compile: exactly one compact and one readback pass a
    construction round, one schedule pass before each round and one after
    the last (which finds nothing left to run), a set-up and a crop span a
    bucket, and the same SFAs with observability off."""
    before = obs.snapshot("span")
    rounds0 = obs.snapshot("construction").get("construction.rounds", 0)
    on = Scanner.compile(PATTERNS, _plan(SFACache()))
    calls = _span_calls(before)
    rounds = obs.snapshot("construction")["construction.rounds"] - rounds0
    assert rounds == on.construction_report.rounds > 1
    assert (calls["construction.round"] == calls["construction.round.compact"]
            == calls["construction.round.readback"] == rounds)
    assert calls["construction.setup"] == calls["construction.crop"] == 1
    assert calls["construction.schedule"] == rounds + 1
    assert calls["scanner.compile.groups"] == calls["scanner.compile"] == 1
    obs.disable()
    try:
        off = Scanner.compile(PATTERNS, _plan(SFACache()))
    finally:
        obs.enable()
    assert len(on.groups) == len(off.groups)
    for g, h in zip(on.groups, off.groups):
        assert g.mode == h.mode and torch.equal(g.tables, h.tables)
        if g.mode == "sfa":
            assert torch.equal(g.deltas, h.deltas)
            assert torch.equal(g.sfa_maps, h.sfa_maps)


def test_service_trace_keeps_its_buckets_after_a_scan_of_many_lengths(
        tmp_path):
    """A flush that compiles in size buckets and then scans documents of
    1,400 distinct lengths (4,200 loop passes, more than the ring buffer's
    4,096 records) still finds its whole trace in the ring:
    ``ScanService.metrics()`` reads one bucket a ``construct_bank.bucket``
    span, and the trace's wall covers the compile."""
    cache = SFACache()
    plan = ScanPlan(device=CPU, construction=ConstructionPolicy(
        cache=cache, method="batched", bucketing="size"))
    pats = [random_dfa(n, 20, seed=s)
            for s, n in enumerate([5] * 4 + [24] * 4)]
    docs = [synthetic_protein(L, seed=L) for L in range(1, 1401)]
    before = obs.snapshot("span")
    with ScanService(tmp_path / "store", plan=plan, cache=cache) as svc:
        ticket = svc.submit(pats, docs)
        svc.flush()
        res = ticket.result()
        m = svc.metrics()
    assert res.hits.shape == (8, 1400)
    calls = _span_calls(before)
    assert calls["scanner.scan.launch"] >= 1400
    buckets = m["trace"]["construction_buckets"]
    assert m["trace"]["trace_id"] == ticket.trace_id
    assert len(buckets) == calls["construct_bank.bucket"] >= 2
    assert sum(b["n_patterns"] for b in buckets) == 8
    names = {s["name"] for s in m["trace"]["spans"]}
    assert {"scheduler.flush", "scanner.compile", "construct_bank",
            "scanner.scan"} <= names
    compile_wall = max(s["wall_s"] for s in m["trace"]["spans"]
                       if s["name"] == "scanner.compile")
    assert m["trace"]["wall_s"] >= compile_wall


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
    span names, the port's names being the reference's plus exactly the
    spans it opens around and inside its scan and construction loops
    (wall-time histograms, ``kernels.*`` and the ``span.*`` totals aside,
    see the module docstring)."""
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

    def totalled(o):
        return {k[len("span."):-len(".calls")] for k, v in o.snapshot().items()
                if k.startswith("span.") and k.endswith(".calls") and v}

    obs.reset()
    port = Scanner.compile(pats, ScanPlan(
        device=CPU, chunking=ChunkPolicy(n_chunks=n_chunks),
        construction=ConstructionPolicy(cache="off")))
    got = port.scan(docs)
    mine, my_spans = measured(obs)
    my_totalled = totalled(obs)
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
    assert my_spans == their_spans | NEW_SPANS
    assert my_totalled == my_spans | LOOP_SPANS
    assert not their_spans & (NEW_SPANS | LOOP_SPANS)
    assert {"scanner.compile", "construct_bank", "construct_bank.bucket",
            "construction.round", "scanner.scan",
            "speculative.scan"} <= my_spans
