"""The port's single-pattern path against the reference's, bit for bit.

``construct_sfa`` (every engine and store toggle), ``construct_bank``'s
loop method and the ``auto`` rule, the function monoid's scans, the
single-table executors, and the scanner's one-sequence entry points
``locate``, ``census_windows`` and ``stream`` / ``open_stream``. Same
inputs through both packages, made with numpy from a seed; every path is
integer arithmetic, so the tolerance is equality. Everything runs on the
CPU, where the kernel wrappers take their plain versions.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.construction import construct_bank as jconstruct_bank  # noqa: E402
from repro.construction import construct_sfa as jconstruct_sfa  # noqa: E402
from repro.core import matching as jmatching  # noqa: E402
from repro.core import monoid as jmonoid  # noqa: E402
from repro.core.dfa import example_fa as jexample_fa  # noqa: E402
from repro.core.dfa import random_dfa as jrandom_dfa  # noqa: E402
from repro.core.prosite import load_bank as jload_bank  # noqa: E402
from repro.engine import ChunkPolicy as JChunkPolicy  # noqa: E402
from repro.engine import ConstructionPolicy as JConstructionPolicy  # noqa: E402
from repro.engine import ScanPlan as JScanPlan  # noqa: E402
from repro.engine import Scanner as JScanner  # noqa: E402
from repro.engine import executors as JX  # noqa: E402
from repro_torch.construction import (  # noqa: E402
    FingerprintCollision,
    SFACache,
    StateBlowup,
    construct_bank,
    construct_sfa,
    resolve_method,
)
from repro_torch.construction.stores import SortedFingerprintStore  # noqa: E402
from repro_torch.construction.types import SFAStats  # noqa: E402
from repro_torch.core import matching, monoid  # noqa: E402
from repro_torch.core.dfa import example_fa, random_dfa  # noqa: E402
from repro_torch.core.fingerprint import BarrettConstants  # noqa: E402
from repro_torch.core.prosite import (  # noqa: E402
    compile_prosite,
    load_bank,
    synthetic_protein,
)
from repro_torch.engine import (  # noqa: E402
    ChunkPolicy,
    ConstructionPolicy,
    ScanPlan,
    Scanner,
)
from repro_torch.engine import executors as X  # noqa: E402

CPU = "cpu"
PATTERNS = ("PS00001", "PS00006", "SYN00002")   # 6, 9 and 17 DFA states

# (engine, store toggles): every engine and, for the sequential engine,
# every membership store (hash chain, fingerprint scan, exhaustive).
ENGINES = [
    ("vectorized", {}),
    ("sequential", {}),
    ("sequential", dict(use_hashing=False)),
    ("sequential", dict(use_hashing=False, use_fingerprints=False)),
    ("jax", {}),
]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_sfa_equal(a, b, ctx=""):
    assert a.delta.dtype == b.delta.dtype == np.int32, ctx
    assert np.array_equal(a.mappings, b.mappings), ctx
    assert np.array_equal(a.delta, b.delta), ctx
    assert a.fingerprints.dtype == b.fingerprints.dtype == np.uint32, ctx
    assert np.array_equal(a.fingerprints, b.fingerprints), ctx


def _stat_fields(s):
    return (s.engine, s.rounds, s.candidates, s.fp_compares,
            s.exact_compares, s.collisions_detected)


# --------------------------------------------------------------------------
# The function monoid's scans
# --------------------------------------------------------------------------


@pytest.mark.parametrize("axis,length", [(0, 1), (0, 7), (1, 8), (2, 5)])
def test_scans_match_reference(axis, length):
    rng = np.random.default_rng(axis * 10 + length)
    shape = [3, 4, 4]
    shape[axis] = length
    xs = rng.integers(0, 9, size=(*shape, 9)).astype(np.int32)
    FN, JFN = monoid.function_monoid(), jmonoid.function_monoid()
    flipped = monoid.Monoid(lambda a, b: FN.combine(b, a), FN.identity)
    jflipped = jmonoid.Monoid(lambda a, b: JFN.combine(b, a), JFN.identity)
    cases = [
        (monoid.scan(FN, _t(xs), axis=axis),
         jmonoid.scan(JFN, jnp.asarray(xs), axis=axis)),
        (monoid.scan(FN, _t(xs), axis=axis, reverse=True),
         jmonoid.scan(JFN, jnp.asarray(xs), axis=axis, reverse=True)),
        (monoid.scan(flipped, _t(xs), axis=axis, reverse=True),
         jmonoid.scan(jflipped, jnp.asarray(xs), axis=axis, reverse=True)),
        (monoid.exclusive_scan(FN, _t(xs), axis=axis),
         jmonoid.exclusive_scan(JFN, jnp.asarray(xs), axis=axis)),
    ]
    for got, want in cases:
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_combine_flattens_broadcasts_and_keeps_int32():
    rng = np.random.default_rng(4)
    f = rng.integers(0, 6, size=(2, 3, 6)).astype(np.int32)
    g = rng.integers(0, 6, size=(6,)).astype(np.int32)
    FN = monoid.function_monoid()
    got = FN.combine(_t(f), _t(g))
    assert got.shape == (2, 3, 6) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), g[f])
    ident = FN.identity(_t(f))
    assert torch.equal(FN.combine(_t(f), ident), _t(f))
    with pytest.raises(TypeError):
        FN.combine(_t(f).to(torch.int64), _t(f).to(torch.int64))


# --------------------------------------------------------------------------
# Matching primitives and the single-table executors
# --------------------------------------------------------------------------


def test_sequential_oracles_and_accept_trace_match_reference():
    d, jd = example_fa(), jexample_fa()
    rng = np.random.default_rng(2)
    syms = rng.integers(0, d.n_symbols, size=300).astype(np.int32)
    assert matching.match_sequential(d, syms) == \
        jmatching.match_sequential(jd, syms)
    assert np.array_equal(matching.match_ends_sequential(d, syms),
                          jmatching.match_ends_sequential(jd, syms))
    chunks = syms.reshape(6, 50)
    entry = rng.integers(0, d.n_states, size=6).astype(np.int32)
    got = matching.chunk_accept_trace(_t(d.table), _t(d.accepting),
                                      _t(chunks), _t(entry))
    for c in range(6):
        want = jmatching.chunk_accept_trace(
            jnp.asarray(jd.table), jnp.asarray(jd.accepting),
            jnp.asarray(chunks[c]), jnp.asarray(entry[c]))
        assert np.array_equal(got[c].numpy(), np.asarray(want))


def test_find_matches_parallel_equals_trace():
    """Mirror of tests/test_matching.py::test_find_matches_parallel_equals_trace."""
    d = example_fa()
    text = synthetic_protein(512, seed=5)
    text = text[:100] + "RG" + text[102:]
    syms = d.encode(text)
    flags = X.find_matches_parallel(_t(d.table), _t(d.accepting), _t(syms),
                                    d.start, 8)
    want = matching.match_ends_sequential(d, syms)
    assert flags.any()
    assert np.array_equal(flags.numpy(), want)
    jflags = JX.find_matches_parallel(
        jnp.asarray(d.table), jnp.asarray(d.accepting), jnp.asarray(syms),
        d.start, 8)
    assert np.array_equal(flags.numpy(), np.asarray(jflags))


def test_accepts_parallel_handles_ragged_lengths():
    """Mirror of tests/test_matching.py::test_accepts_parallel_handles_ragged_lengths,
    with and without the SFA."""
    d = compile_prosite("R-G-D")
    sfa = construct_sfa(d, device=CPU)
    for L in [5, 17, 64, 100, 129]:
        text = synthetic_protein(L, seed=L)
        for s in (None, sfa):
            assert X.accepts_parallel(d, text, n_chunks=8, sfa=s,
                                      device=CPU) == d.accepts(text), L
    planted = synthetic_protein(50, seed=1) + "RGD"
    assert X.accepts_parallel(d, planted, n_chunks=8, device=CPU)
    assert X.accepts_parallel(d, planted, n_chunks=8, sfa=sfa, device=CPU)


@pytest.mark.parametrize("seed", [0, 1])
def test_single_and_bank_executors_match_reference(seed):
    k = 5
    dfa, jdfa = random_dfa(4, k, seed=seed), jrandom_dfa(4, k, seed=seed)
    sfa = construct_sfa(dfa, device=CPU)
    rng = np.random.default_rng(seed)
    syms = rng.integers(0, k, size=64).astype(np.int32)
    got = X.match_parallel_enumeration(_t(dfa.table), _t(syms), 4)
    want = JX.match_parallel_enumeration(jnp.asarray(jdfa.table),
                                         jnp.asarray(syms), 4)
    assert np.array_equal(got.numpy(), np.asarray(want))
    got = X.match_parallel_sfa(_t(sfa.delta), _t(sfa.mappings), _t(syms), 4)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(got[dfa.start]) == dfa.run(syms)

    sc = Scanner.compile([dfa, random_dfa(3, k, seed=seed + 9)], device=CPU,
                         mode="sfa", sfa_state_budget=10_000)
    g = sc.groups[0]
    jwant = JX.match_bank_parallel(jnp.asarray(g.tables.numpy()),
                                   jnp.asarray(syms), 4)
    got = X.match_bank_parallel(g.tables, _t(syms), 4)
    assert np.array_equal(got.numpy(), np.asarray(jwant))
    got = X.match_bank_parallel_sfa(g.deltas, g.sfa_maps, _t(syms), 4)
    jgot = JX.match_bank_parallel_sfa(jnp.asarray(g.deltas.numpy()),
                                      jnp.asarray(g.sfa_maps.numpy()),
                                      jnp.asarray(syms), 4)
    assert np.array_equal(got.numpy(), np.asarray(jgot))
    assert np.array_equal(got.numpy(), np.asarray(jwant))


@pytest.mark.parametrize("B,m", [(1, 1), (9, 3), (16, 4), (11, 8)])
def test_sliding_window_mappings_match_reference(B, m):
    rng = np.random.default_rng(B * m)
    maps = rng.integers(0, 7, size=(2, B, 7)).astype(np.int32)
    got = X.sliding_window_mappings(_t(maps), m)
    want = JX.sliding_window_mappings(jnp.asarray(maps), m)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # and each window composed on its own
    FN = monoid.function_monoid()
    for w in range(B - m + 1):
        one = monoid.reduce(FN, _t(maps[:, w:w + m]), axis=1)
        assert torch.equal(got[:, w], one)


# --------------------------------------------------------------------------
# Single-pattern construction
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_sfas():
    """The reference's SFA of every (pattern, engine) case, built once."""
    out = {}
    for pid in PATTERNS:
        d = jload_bank([pid]).dfa(0)
        for i, (engine, kw) in enumerate(ENGINES):
            out[pid, i] = jconstruct_sfa(d, engine=engine, **kw)
    return out


@pytest.mark.parametrize("case", range(len(ENGINES)),
                         ids=["vectorized", "sequential-hash",
                              "sequential-scan", "sequential-exhaustive",
                              "jax"])
@pytest.mark.parametrize("pid", PATTERNS)
def test_construct_sfa_matches_reference(reference_sfas, pid, case):
    engine, kw = ENGINES[case]
    d = load_bank([pid]).dfa(0)
    got = construct_sfa(d, engine=engine, device=CPU, **kw)
    want = reference_sfas[pid, case]
    _assert_sfa_equal(got, want, (pid, engine, kw))
    assert _stat_fields(got.stats) == _stat_fields(want.stats)


def test_construct_sfa_options_and_blowup():
    d = load_bank(["PS00006"]).dfa(0)                 # 78 SFA states
    with pytest.raises(StateBlowup):
        construct_sfa(d, max_states=40, device=CPU)
    with pytest.raises(StateBlowup):
        construct_sfa(d, engine="sequential", max_states=40)
    with pytest.raises(ValueError):
        construct_sfa(d, engine="xla", device=CPU)
    # the cache answers a seen DFA and a known blowup without constructing
    cache = SFACache()
    first = construct_sfa(d, cache=cache, device=CPU)
    assert construct_sfa(d, cache=cache, device=CPU) is first
    assert (cache.info.hits, cache.info.misses) == (1, 1)
    with pytest.raises(StateBlowup, match="cached blowup"):
        construct_sfa(d, max_states=40, cache=cache, device=CPU)
    with pytest.raises(ValueError):
        construct_sfa(d, cache="bogus", device=CPU)
    # the tile changes the round count, never the SFA
    small = construct_sfa(d, tile=7, device=CPU)
    _assert_sfa_equal(small, construct_sfa(d, device=CPU))
    # poly_index picks the retry sequence's base, as in the reference
    other = construct_sfa(d, poly_index=2, device=CPU)
    jother = jconstruct_sfa(jload_bank(["PS00006"]).dfa(0), poly_index=2)
    _assert_sfa_equal(other, jother)


def test_sorted_store_raises_on_collisions():
    """Force collisions: fingerprints of a constant fold weight of zero are
    all equal, so distinct candidates collide against the known set and
    inside one tile, as in the reference store."""
    consts = BarrettConstants.cached()
    stats = SFAStats(engine="vectorized")
    store = SortedFingerprintStore(stats, consts, 4, CPU)
    store._weights = torch.zeros_like(store._weights)
    store.fps = store._fp64(store.mappings)
    with pytest.raises(FingerprintCollision, match="collisions detected"):
        store.assign(torch.tensor([[1, 0, 2, 3]], dtype=torch.int32))
    assert stats.collisions_detected == 1
    stats = SFAStats(engine="vectorized")
    store = SortedFingerprintStore(stats, consts, 4, CPU)
    fresh = torch.tensor([[1, 1, 1, 1], [2, 2, 2, 2]], dtype=torch.int32)
    store._weights = torch.zeros_like(store._weights)
    store.fps = torch.tensor([7], dtype=torch.int64)   # no known-set hit
    with pytest.raises(FingerprintCollision, match="intra-round"):
        store.assign(fresh)
    assert stats.collisions_detected == 1


def test_construct_bank_loop_matches_reference():
    k = 6
    sizes = (3, 5, 4, 9)
    dfas = [random_dfa(n, k, seed=40 + n) for n in sizes]
    jdfas = [jrandom_dfa(n, k, seed=40 + n) for n in sizes]
    for engine in ("vectorized", "sequential"):
        got = construct_bank(dfas, max_states=300, method="loop",
                             engine=engine, device=CPU)
        want = jconstruct_bank(jdfas, max_states=300, method="loop",
                               engine=engine)
        assert got.stats.method == want.stats.method == "loop"
        assert np.array_equal(got.blown, want.blown) and got.blown.any()
        assert got.stats.rounds == want.stats.rounds
        assert np.array_equal(got.stats.pattern_rounds,
                              want.stats.pattern_rounds)
        assert np.array_equal(got.stats.pattern_candidates,
                              want.stats.pattern_candidates)
        for a, b in zip(got.sfas, want.sfas):
            assert (a is None) == (b is None)
            if a is not None:
                _assert_sfa_equal(a, b)
    # the batched method gives the same SFAs
    batched = construct_bank(dfas, max_states=300, method="batched",
                             device=CPU)
    for a, b in zip(got.sfas, batched.sfas):
        if a is not None:
            _assert_sfa_equal(a, b)


def test_auto_method_rule():
    assert [resolve_method("auto", p) for p in (1, 3, 4, 9)] == [
        "loop", "loop", "batched", "batched"]
    assert resolve_method("batched", 1) == "batched"
    with pytest.raises(ValueError):
        resolve_method("sharded", 2)
    dfas = [random_dfa(3, 4, seed=s) for s in range(4)]
    assert construct_bank(dfas[:3], method="auto",
                          device=CPU).stats.method == "loop"
    assert construct_bank(dfas, method="auto",
                          device=CPU).stats.method == "batched"


@pytest.mark.parametrize("ids", [PATTERNS[1:2], PATTERNS],
                         ids=["one pattern", "three patterns"])
def test_compile_fewer_than_four_patterns_loops_like_reference(ids):
    """Below four patterns ``method="auto"`` loops, as the reference's
    scanner does (a port that always batched reported "batched" here): the
    same report (method, rounds, constructed, blown) and the same SFAs."""
    port = Scanner.compile(load_bank(list(ids)), device=CPU,
                           construction=ConstructionPolicy(cache="off"))
    ref = JScanner.compile(jload_bank(list(ids)), JScanPlan(
        construction=JConstructionPolicy(cache="off")))
    got, want = port.construction_report, ref.construction_report
    assert got.method == want.method == "loop"
    assert (got.rounds, got.constructed, got.blown) == (
        want.rounds, want.constructed, want.blown)
    (g,), (jg,) = port.groups, ref.groups
    assert g.mode == jg.mode == "sfa"
    assert np.array_equal(g.deltas.numpy(), np.asarray(jg.deltas))
    assert np.array_equal(g.sfa_maps.numpy(), np.asarray(jg.sfa_maps))
    assert np.array_equal(g.sfa_states, np.asarray(jg.sfa_states))


@pytest.mark.parametrize("method,engine", [("batched", "vectorized"),
                                           ("loop", "sequential"),
                                           ("loop", "jax")])
def test_compile_with_every_method_and_engine_gives_one_sfa(method, engine):
    ids = list(PATTERNS[:2])
    port = Scanner.compile(load_bank(ids), device=CPU,
                           construction=ConstructionPolicy(method=method,
                                                           engine=engine,
                                                           cache="off"))
    ref = JScanner.compile(jload_bank(ids), JScanPlan(
        construction=JConstructionPolicy(cache="off", method=method,
                                         engine=engine)))
    assert port.construction_report.method == method
    assert (port.construction_report.rounds
            == ref.construction_report.rounds)
    assert np.array_equal(port.groups[0].deltas.numpy(),
                          np.asarray(ref.groups[0].deltas))


# --------------------------------------------------------------------------
# The scanner's one-sequence entry points
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scanners():
    """Two bundled patterns (one SFA group) and a bank with both scan modes
    (SFA and enumeration groups at budget 40), in each package."""
    chunking = dict(n_chunks=4, block_len=8)
    out = {}
    for name, ids, budget in (("pair", ["PS00016", "PS00001"], 512),
                              ("mixed", ["PS00001", "PS00006", "SYN00002",
                                         "PS00016"], 40)):
        port = Scanner.compile(load_bank(ids), device=CPU,
                               sfa_state_budget=budget,
                               chunking=ChunkPolicy(**chunking),
                               construction=ConstructionPolicy(cache="off"))
        ref = JScanner.compile(jload_bank(ids), JScanPlan(
            sfa_state_budget=budget, chunking=JChunkPolicy(**chunking),
            construction=JConstructionPolicy(cache="off")))
        out[name] = (port, ref)
    assert set(out["mixed"][0].pattern_modes.values()) == {"sfa",
                                                           "enumeration"}
    return out


@pytest.mark.parametrize("name", ["pair", "mixed"])
def test_locate_and_accepts_match_reference(scanners, name):
    port, ref = scanners[name]
    text = synthetic_protein(403, seed=7)              # ragged: 403 % 4 = 3
    text = text[:50] + "RGD" + text[53:]
    for p in range(port.n_patterns):
        got = port.locate(text, p)
        assert np.array_equal(got, ref.locate(text, p)), p
        d = port._dfas[p]
        assert np.array_equal(got, matching.match_ends_sequential(
            d, d.encode(text)))
    assert np.array_equal(port.locate(text, port.ids[0]),
                          port.locate(text, 0))
    assert np.array_equal(port.accepts(text), ref.accepts(text))
    with pytest.raises(ValueError):
        port.locate(text)                        # a bank needs the pattern
    single = Scanner.compile("R-G-D", device=CPU)
    assert single.locate(text)[52] and single.accepts(text) is True


@pytest.mark.parametrize("window,stride", [(24, 1), (24, 6), (40, 8),
                                           (60, 60)])
@pytest.mark.parametrize("name", ["pair", "mixed"])
def test_census_windows_match_reference_and_materialized(scanners, name,
                                                         window, stride):
    port, ref = scanners[name]
    seq = synthetic_protein(400, seed=42)
    got = port.census_windows(seq, window, stride)
    assert np.array_equal(got.hits, ref.census_windows(seq, window,
                                                       stride).hits)
    n_win = (len(seq) - window) // stride + 1
    naive = port.scan([seq[i * stride: i * stride + window]
                       for i in range(n_win)])
    assert got.hits.shape == (port.n_patterns, n_win)
    assert np.array_equal(got.hits, naive.hits)
    assert np.array_equal(got.counts, naive.counts)


def test_census_windows_validation_and_edges(scanners):
    """Mirror of tests/test_scanservice.py::test_census_windows_validation_and_edges."""
    port, _ = scanners["pair"]
    with pytest.raises(ValueError):
        port.census_windows("ACDEF", window=4, stride=3)
    with pytest.raises(ValueError):
        port.census_windows("ACDEF", window=0)
    empty = port.census_windows("ACD", window=8)
    assert empty.hits.shape == (2, 0)
    whole = port.census_windows("ACDEFGHIKL", window=10)
    assert np.array_equal(whole.hits, port.scan(["ACDEFGHIKL"]).hits)


@pytest.mark.parametrize("seed,sizes", [(0, (1,)), (1, (57, 3, 20)),
                                        (2, (16, 16)), (3, (5, 40, 1, 9))])
@pytest.mark.parametrize("backend", ["kernel", "reference"])
def test_stream_equals_scan_on_concatenation(seed, sizes, backend):
    """Mirror of tests/test_engine.py::test_stream_equals_scan_on_concatenation,
    against the reference's stream as well."""
    k = 5
    dfas = [random_dfa(3 + i, k, seed=seed * 3 + i) for i in range(2)]
    jdfas = [jrandom_dfa(3 + i, k, seed=seed * 3 + i) for i in range(2)]
    sc = Scanner.compile(dfas, device=CPU, sfa_state_budget=10_000,
                         backend=backend,
                         chunking=ChunkPolicy(n_chunks=2, block_len=8))
    jsc = JScanner.compile(jdfas, JScanPlan(
        sfa_state_budget=10_000, chunking=JChunkPolicy(n_chunks=2,
                                                       block_len=8)))
    rng = np.random.default_rng(seed)
    total = 8 * (2 * 8) + int(rng.integers(0, 23))  # 8 blocks + a tail
    corpus = rng.integers(0, k, size=total).astype(np.int32)
    pieces, lo, i = [], 0, 0
    while lo < total:
        hi = min(total, lo + sizes[i % len(sizes)])
        pieces.append(corpus[lo:hi])
        lo, i = hi, i + 1
    res = sc.stream(pieces)
    want = jsc.stream(pieces)
    assert res.n_symbols == total
    assert np.array_equal(res.mapping, sc.mapping(corpus))
    assert np.array_equal(res.mapping, want.mapping)
    assert np.array_equal(res.final_states, want.final_states)
    assert np.array_equal(res.accepted, sc.scan([corpus]).hits[:, 0])
    assert np.array_equal(res.accepted, want.accepted)


def test_stream_session_push_api_and_reuse_errors():
    """Mirror of tests/test_engine.py::test_stream_session_push_api_and_reuse_errors."""
    sc = Scanner.compile("R-G-D", device=CPU,
                         chunking=ChunkPolicy(n_chunks=2, block_len=8))
    text = synthetic_protein(200, seed=0) + "RGD"
    sess = sc.open_stream()
    for i in range(0, len(text), 31):
        sess.feed(text[i: i + 31])
    res = sess.finish()
    assert res.accepts is True
    assert res.single
    with pytest.raises(RuntimeError):
        sess.feed("AAA")
    with pytest.raises(RuntimeError):
        sess.finish()
    sess = sc.open_stream()
    with pytest.raises(ValueError):
        sess.feed(np.zeros((2, 2), dtype=np.int32))
    with pytest.raises(ValueError):
        sess.feed(np.asarray([0, 20]))
    empty = sc.open_stream().finish()
    assert empty.n_symbols == 0 and empty.accepts is False


def test_stream_matches_scan_on_long_corpus(scanners):
    """Mirror of tests/test_engine.py::test_stream_matches_scan_on_long_corpus."""
    port, ref = scanners["mixed"]
    text = synthetic_protein(4 * 8 * 11 + 7, seed=3)    # 11 full blocks
    res = port.stream(text[i: i + 100] for i in range(0, len(text), 100))
    assert np.array_equal(res.accepted, port.scan([text]).hits[:, 0])
    assert np.array_equal(res.mapping, port.mapping(text))
    assert np.array_equal(res.mapping, ref.mapping(text))


def test_describe_and_plan_fields(scanners):
    port, _ = scanners["mixed"]
    text = port.describe()
    assert "via batched" in text and "group[sfa]" in text
    assert "group[enumeration]" in text
    assert ChunkPolicy().block_len == 256
    assert ConstructionPolicy().method == "auto"
    assert ConstructionPolicy().engine == "vectorized"
    for bad in (dict(chunking=ChunkPolicy(block_len=0)),
                dict(construction=ConstructionPolicy(method="sharded")),
                dict(construction=ConstructionPolicy(engine="xla"))):
        with pytest.raises(ValueError):
            ScanPlan(**bad).validate()
