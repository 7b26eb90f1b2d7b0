"""The port's ``distribution="shard_map"`` against the reference's, at world
size 1.

Mirrors the reference's mesh tests (``tests/test_engine.py``,
``test_construction.py``, ``test_speculative.py``, ``test_scanservice.py``,
``test_matching.py`` and ``test_multipattern.py``), run as the reference's
own tests run them: one XLA device, a one-device mesh. The port runs on a
one-rank gloo world on the CPU (``make_mesh`` starts it); every result —
hits, census, SFAs and their stats, ``SpeculationStats``, job outputs — is
held equal to the reference's, bit for bit. Sharding itself is exercised at
world size 2 in ``test_torch_distributed_ws2.py``.
"""

from dataclasses import asdict

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.compat import make_mesh as jmake_mesh  # noqa: E402
from repro.construction import construct_bank as jconstruct_bank  # noqa: E402
from repro.core import monoid as JM  # noqa: E402
from repro.core.dfa import example_fa as jexample_fa  # noqa: E402
from repro.core.dfa import random_dfa as jrandom_dfa  # noqa: E402
from repro.core.multipattern import PatternBank as JPatternBank  # noqa: E402
from repro.engine import ChunkPolicy as JChunkPolicy  # noqa: E402
from repro.engine import ConstructionPolicy as JConstructionPolicy  # noqa: E402
from repro.engine import ScanPlan as JScanPlan  # noqa: E402
from repro.engine import Scanner as JScanner  # noqa: E402
from repro.engine import executors as JX  # noqa: E402
from repro.scanservice import CorpusJob as JCorpusJob  # noqa: E402
from repro.scanservice import CorpusManifest as JCorpusManifest  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.construction import SFACache, construct_bank  # noqa: E402
from repro_torch.core import monoid as M  # noqa: E402
from repro_torch.core.dfa import example_fa, random_dfa  # noqa: E402
from repro_torch.core.multipattern import PatternBank  # noqa: E402
from repro_torch.core.prosite import synthetic_protein  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    ChunkPolicy,
    ConstructionPolicy,
    ScanPlan,
    Scanner,
)
from repro_torch.engine import executors as X  # noqa: E402
from repro_torch.mesh import (  # noqa: E402
    axis_rank,
    axis_size,
    make_mesh,
    mesh_size,
)
from repro_torch.scanservice import CorpusJob, CorpusManifest  # noqa: E402
from repro_torch.speculative import (  # noqa: E402
    distributed_speculative_finals_fn,
    speculative_bank_finals,
)

CPU = "cpu"
SERVICE_PATTERNS = ["PS00016", "PS00005", "PS00001", "PS00006"]


def _random_docs(seed, n_docs, length, k):
    rng = np.random.default_rng(seed)
    return rng.integers(0, k, size=(n_docs, length)).astype(np.int32)


def _assert_sfas_equal(got, want):
    assert np.array_equal(got.blown, np.asarray(want.blown))
    assert got.stats.rounds == want.stats.rounds
    assert np.array_equal(got.stats.retries, want.stats.retries)
    assert np.array_equal(got.stats.pattern_rounds, want.stats.pattern_rounds)
    for a, b in zip(got.sfas, want.sfas):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a.delta, b.delta)
            assert np.array_equal(a.mappings, b.mappings)
            assert np.array_equal(a.fingerprints, b.fingerprints)


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh((1,), ("data",), device=CPU)


@pytest.fixture(scope="module")
def mesh2d():
    return make_mesh((1, 1), ("data", "model"), device=CPU)


# --------------------------------------------------------------------------
# Meshes and plans
# --------------------------------------------------------------------------


def test_mesh_helpers_and_checks(mesh2d):
    assert mesh2d.device_type == CPU and mesh_size(mesh2d) == 1
    assert axis_size(mesh2d, "model") == 1 and axis_rank(mesh2d, "data") == 0
    with pytest.raises(ValueError, match="no axis"):
        axis_size(mesh2d, "pattern")
    with pytest.raises(ValueError, match="ranks"):
        make_mesh((2,), ("data",), device=CPU)
    with pytest.raises(ValueError):
        make_mesh((1,), ("data", "model"), device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh((1,), ("data",))


def test_plan_checks(mesh1):
    """The reference's plan checks, with backend='kernel' in the place of
    'xla': a bad distribution, and shard_map on the reference backend."""
    with pytest.raises(ValueError):
        JScanPlan(distribution="pmap").validate()
    with pytest.raises(ValueError):
        ScanPlan(distribution="pmap", device=CPU).validate()
    with pytest.raises(ValueError):
        JScanPlan(distribution="shard_map", backend="reference").validate()
    with pytest.raises(ValueError, match="backend='kernel'"):
        ScanPlan(distribution="shard_map", backend="reference",
                 device=CPU).validate()
    with pytest.raises(ValueError):
        JConstructionPolicy(distribution="pmap").validate()
    with pytest.raises(ValueError):
        ConstructionPolicy(distribution="pmap").validate()
    # the mesh and the plan's device must agree; nothing moves the work
    with pytest.raises(ValueError, match="mesh"):
        ScanPlan(distribution="shard_map", mesh=mesh1).validate()
    with pytest.raises(ValueError, match="mesh"):
        ScanPlan(construction=ConstructionPolicy(
            distribution="shard_map", mesh=mesh1)).validate()
    with pytest.raises(ValueError, match="mesh"):
        construct_bank([random_dfa(3, 4, seed=0)] * 4, device=CPU,
                       distribution="shard_map", mesh=_FakeMesh("cuda"))
    plan = ScanPlan(distribution="shard_map", mesh=mesh1, device=CPU)
    assert plan.validate().data_axis == "data"
    assert ConstructionPolicy().pattern_axis == "pattern"


class _FakeMesh:
    def __init__(self, device_type):
        self.device_type = device_type


# --------------------------------------------------------------------------
# Scans (tests/test_engine.py)
# --------------------------------------------------------------------------


def test_shard_map_distribution_matches_local(mesh1):
    k = 6
    dfas = [random_dfa(4 + i, k, seed=50 + i) for i in range(3)]
    jdfas = [jrandom_dfa(4 + i, k, seed=50 + i) for i in range(3)]
    docs = _random_docs(5, 4, 32, k)
    plan = ScanPlan(mode="auto", sfa_state_budget=10_000, device=CPU,
                    chunking=ChunkPolicy(n_chunks=4))
    jplan = JScanPlan(mode="auto", sfa_state_budget=10_000,
                      chunking=JChunkPolicy(n_chunks=4))
    local = Scanner.compile(dfas, plan).scan(docs).hits
    dist = Scanner.compile(dfas, plan.with_(distribution="shard_map",
                                            mesh=mesh1))
    jdist = JScanner.compile(jdfas, jplan.with_(
        distribution="shard_map", mesh=jmake_mesh((1,), ("data",))))
    assert np.array_equal(dist.scan(docs).hits, local)
    assert np.array_equal(dist.scan(docs).hits, jdist.scan(docs).hits)
    # mapping, accepts, locate and stream, as the reference's under a mesh
    assert np.array_equal(dist.mapping(docs[0]), jdist.mapping(docs[0]))
    assert np.array_equal(dist.accepts(docs[1]), jdist.accepts(docs[1]))
    assert np.array_equal(dist.locate(docs[2], 1), jdist.locate(docs[2], 1))
    flat = docs.reshape(-1)
    a, b = dist.stream([flat[:50], flat[50:]]), jdist.stream(
        [flat[:50], flat[50:]])
    assert np.array_equal(a.mapping, b.mapping)
    assert np.array_equal(a.accepted, b.accepted)
    assert "shard_map" in dist.describe()


@pytest.mark.parametrize("mode", ["sfa", "enumeration"])
def test_mesh_scan_of_ragged_docs_walks_no_ragged_tail(mesh1, mode,
                                                       monkeypatch):
    """A list of docs of lengths 0-50 on the mesh: one batch a length, each
    padded with the pad symbol to a multiple of n_chunks, so nothing walks
    symbol by symbol. A batch shorter than n_chunks walks locally; the hits
    and mappings are the JAX package's under its one-device mesh."""
    def no_sequential_walk(*args):
        raise AssertionError("a mesh walk went symbol by symbol")

    monkeypatch.setattr(X, "advance_states_sequential", no_sequential_walk)
    k = 6
    dfas = [random_dfa(n, k, seed=80 + n) for n in (3, 5, 4)]
    jdfas = [jrandom_dfa(n, k, seed=80 + n) for n in (3, 5, 4)]
    rng = np.random.default_rng(12)
    lengths = [0, 1, 3, 8, 13, 13, 37, 50]
    docs = [rng.integers(0, k, L).astype(np.int32) for L in lengths]
    port = Scanner.compile(dfas, ScanPlan(
        mode=mode, sfa_state_budget=10_000, device=CPU,
        distribution="shard_map", mesh=mesh1))
    ref = JScanner.compile(jdfas, JScanPlan(
        mode=mode, sfa_state_budget=10_000, distribution="shard_map",
        mesh=jmake_mesh((1,), ("data",))))
    before = obs.snapshot()
    got = port.scan(docs)
    calls = (obs.snapshot()["kernels.match_bank_chunks.calls"]
             - before.get("kernels.match_bank_chunks.calls", 0))
    assert calls == len(port.groups) * len(set(lengths) - {0})
    assert np.array_equal(got.hits, ref.scan(docs).hits)
    for doc in docs[1:3] + docs[4:5]:
        assert np.array_equal(port.mapping(doc), ref.mapping(doc))


def test_mesh_none_spans_the_world():
    """``mesh=None`` builds the mesh over the whole world: one rank here,
    the reference's one-device mesh."""
    dfas = [random_dfa(5, 4, seed=3)]
    sc = Scanner.compile(dfas, ScanPlan(distribution="shard_map", device=CPU))
    assert sc.mesh is not None and mesh_size(sc.mesh) == 1
    assert sc.mesh.mesh_dim_names == ("data",)
    docs = _random_docs(1, 2, 24, 4)
    jsc = JScanner.compile([jrandom_dfa(5, 4, seed=3)],
                           JScanPlan(distribution="shard_map"))
    assert np.array_equal(sc.scan(docs).hits, jsc.scan(docs).hits)


def test_census_windows_under_a_mesh(mesh1):
    seq = synthetic_protein(300, seed=4)
    plan = ScanPlan(mode="enumeration", device=CPU, distribution="shard_map",
                    mesh=mesh1, chunking=ChunkPolicy(n_chunks=4))
    port = Scanner.compile(SERVICE_PATTERNS, plan)
    ref = JScanner.compile(SERVICE_PATTERNS, JScanPlan(
        mode="enumeration", distribution="shard_map",
        mesh=jmake_mesh((1,), ("data",)), chunking=JChunkPolicy(n_chunks=4)))
    got, want = port.census_windows(seq, 48, 16), ref.census_windows(
        seq, 48, 16)
    assert np.array_equal(got.hits, want.hits)


def test_executors_match_scanner(mesh2d):
    k = 6
    dfas = [random_dfa(n, k, seed=70 + n) for n in (3, 5, 4)]
    jbank = JPatternBank.from_dfas([jrandom_dfa(n, k, seed=70 + n)
                                    for n in (3, 5, 4)])
    tables, accepting, starts = PatternBank.from_dfas(dfas).to(CPU)
    jt, ja, js = jbank.device_arrays()
    rng = np.random.default_rng(7)
    syms = rng.integers(0, k, size=64).astype(np.int32)
    corpus = rng.integers(0, k, size=(4, 32)).astype(np.int32)
    jmesh = jmake_mesh((1, 1), ("data", "model"))

    dist_maps = X.distributed_bank_matcher(mesh2d)(
        tables, torch.from_numpy(syms), 4)
    assert np.array_equal(dist_maps.numpy(), np.asarray(
        JX.distributed_bank_matcher(jmesh)(jt, jnp.asarray(syms), 4)))
    assert torch.equal(dist_maps, X.match_bank_parallel(
        tables, torch.from_numpy(syms), 4))

    sc = Scanner.compile(dfas, ScanPlan(mode="enumeration", device=CPU,
                                        chunking=ChunkPolicy(n_chunks=4)))
    c = torch.from_numpy(corpus)
    hits = X.bank_hits(tables, accepting, starts, c, 4)
    counts = X.census_bank(tables, accepting, starts, c, 4)
    dist_counts = X.distributed_census_fn(mesh2d, n_chunks=4)(
        tables, accepting, starts, c)
    assert np.array_equal(hits.numpy(), np.asarray(
        JX.bank_hits(jt, ja, js, jnp.asarray(corpus), 4)))
    assert np.array_equal(hits.numpy(), sc.scan(corpus).hits)
    jcounts = np.asarray(JX.census_bank(jt, ja, js, jnp.asarray(corpus), 4))
    assert counts.dtype == dist_counts.dtype == torch.int32
    assert np.array_equal(counts.numpy(), jcounts)
    assert np.array_equal(dist_counts.numpy(), jcounts)
    assert np.array_equal(dist_counts.numpy(), np.asarray(
        JX.distributed_census_fn(jmesh, n_chunks=4)(
            jt, ja, js, jnp.asarray(corpus))))


# --------------------------------------------------------------------------
# Executors (tests/test_matching.py, tests/test_multipattern.py)
# --------------------------------------------------------------------------


def test_distributed_match_single_device_mesh(mesh1):
    d, jd = example_fa(), jexample_fa()
    text = synthetic_protein(1024, seed=9)[:1000] + "RG" + "A" * 22
    syms = d.encode(text)
    got = X.distributed_match_fn(mesh1, d.table.shape)(
        torch.from_numpy(d.table), torch.from_numpy(syms), sub_chunks=8)
    want = JX.distributed_match_fn(jmake_mesh((1,), ("data",)),
                                   jd.table.shape)(
        jnp.asarray(jd.table), jnp.asarray(syms), sub_chunks=8)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(got[d.start]) == d.run(syms)


def test_throughput_matcher(mesh1):
    d, jd = example_fa(), jexample_fa()
    rows, want = [], []
    for i in range(4):
        t = synthetic_protein(128, seed=i)
        if i % 2:
            t = t[:60] + "RG" + t[62:]
        rows.append(d.encode(t))
        want.append(d.accepts(t))
    batch = np.stack(rows)
    got = X.throughput_matcher(mesh1, start=d.start)(
        torch.from_numpy(d.table), torch.from_numpy(d.accepting),
        torch.from_numpy(batch))
    ref = JX.throughput_matcher(jmake_mesh((1,), ("data",)),
                                start=jd.start)(
        jnp.asarray(jd.table), jnp.asarray(jd.accepting), jnp.asarray(batch))
    assert got.dtype == torch.bool
    assert [bool(x) for x in got] == want
    assert np.array_equal(got.numpy(), np.asarray(ref))


def _random_banks(seed, sizes, k=6):
    seeds = [seed * 31 + i for i in range(len(sizes))]
    return (PatternBank.from_dfas([random_dfa(n, k, seed=s)
                                   for n, s in zip(sizes, seeds)]),
            JPatternBank.from_dfas([jrandom_dfa(n, k, seed=s)
                                    for n, s in zip(sizes, seeds)]))


def test_distributed_bank_matcher_single_device(mesh2d):
    bank, jbank = _random_banks(11, (3, 6, 9, 4))
    tables, _, _ = bank.to(CPU)
    syms = np.random.default_rng(11).integers(
        0, bank.n_symbols, size=128).astype(np.int32)
    got = X.distributed_bank_matcher(mesh2d)(tables, torch.from_numpy(syms),
                                             sub_chunks=8)
    want = JX.distributed_bank_matcher(jmake_mesh((1, 1), ("data", "model")))(
        jnp.asarray(jbank.tables), jnp.asarray(syms), sub_chunks=8)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, X.match_bank_parallel(tables,
                                                  torch.from_numpy(syms), 8))


def test_distributed_census_single_device(mesh2d):
    bank, jbank = _random_banks(13, (2, 5, 11, 3, 7))
    corpus = np.random.default_rng(13).integers(
        0, bank.n_symbols, size=(4, 32)).astype(np.int32)
    args = bank.to(CPU)
    got = X.distributed_census_fn(mesh2d, n_chunks=4)(
        *args, torch.from_numpy(corpus))
    want = JX.distributed_census_fn(jmake_mesh((1, 1), ("data", "model")),
                                    n_chunks=4)(
        *jbank.device_arrays(), jnp.asarray(corpus))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, X.census_bank(*args, torch.from_numpy(corpus), 4))


def test_shard_reduce_and_exclusive_scan(mesh1):
    """One element a rank: at world size 1 the reduce is the element and
    the exclusive scan the identity, as the reference's in ``shard_map``."""
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 7, size=(3, 7)).astype(np.int32))
    FN = M.function_monoid()
    assert torch.equal(M.shard_reduce(FN, x, mesh1, "data"),
                       M.reduce(FN, x[None], axis=0))
    assert torch.equal(M.shard_exclusive_scan(FN, x, mesh1, "data"),
                       M.exclusive_scan(FN, x[None], axis=0)[0])
    assert torch.equal(M.shard_exclusive_scan(FN, x, mesh1, "data"),
                       torch.arange(7, dtype=torch.int32).expand(3, 7))
    from repro.compat import shard_map
    from jax.sharding import PartitionSpec as P

    jx = jnp.asarray(x.numpy())
    jred = shard_map(lambda e: JM.shard_reduce(JM.function_monoid(), e,
                                               "data"),
                     mesh=jmake_mesh((1,), ("data",)), in_specs=P(),
                     out_specs=P())(jx)
    assert np.array_equal(np.asarray(jred), x.numpy())


# --------------------------------------------------------------------------
# Construction (tests/test_construction.py)
# --------------------------------------------------------------------------


def test_bank_methods_and_shard_map_agree(mesh1):
    """batched == loop == shard_map-distributed batched, bit for bit, and
    equal to the reference's sharded construction."""
    sizes = (3, 5, 4, 2)
    dfas = [random_dfa(n, 5, seed=200 + i) for i, n in enumerate(sizes)]
    jdfas = [jrandom_dfa(n, 5, seed=200 + i) for i, n in enumerate(sizes)]
    pmesh = make_mesh((1,), ("pattern",), device=CPU)
    batched = construct_bank(dfas, max_states=2000, tile=32, device=CPU)
    loop = construct_bank(dfas, max_states=2000, method="loop", device=CPU)
    sharded = construct_bank(dfas, max_states=2000, tile=32, device=CPU,
                             distribution="shard_map", mesh=pmesh)
    world = construct_bank(dfas, max_states=2000, tile=32, device=CPU,
                           distribution="shard_map")
    jsharded = jconstruct_bank(jdfas, max_states=2000, tile=32,
                               distribution="shard_map",
                               mesh=jmake_mesh((1,), ("pattern",)))
    assert batched.stats.method == "batched" and loop.stats.method == "loop"
    for got in (batched, sharded, world):
        _assert_sfas_equal(got, jsharded)
    for a, b in zip(loop.sfas, batched.sfas):
        assert np.array_equal(a.delta, b.delta)


def test_sharded_bucketed_construction_with_blowups_and_retries():
    """A bucketed bank with blowups and a forced collision: the sharded
    rounds give the reference's verdicts, retries and SFAs."""
    sizes = (2, 3, 3, 4, 9, 10, 9, 10)
    dfas = [random_dfa(n, 4, seed=300 + i) for i, n in enumerate(sizes)]
    jdfas = [jrandom_dfa(n, 4, seed=300 + i) for i, n in enumerate(sizes)]

    def weight_fn(module):
        def fn(p, attempt, n_words, consts):
            w = np.asarray(module(n_words, consts)).astype(np.uint32)
            if p == 2 and attempt == 0:
                w = np.zeros_like(w)        # every state collides
            return w
        return fn

    from repro.core.fingerprint import fold_weights_u32 as jfold
    from repro_torch.core.fingerprint import fold_weights_u32

    got = construct_bank(dfas, max_states=100, tile=16, device=CPU,
                         bucketing="size", distribution="shard_map",
                         _weight_fn=weight_fn(
                             lambda w, c: fold_weights_u32(w, c).numpy()))
    want = jconstruct_bank(jdfas, max_states=100, tile=16, bucketing="size",
                           distribution="shard_map",
                           mesh=jmake_mesh((1,), ("pattern",)),
                           _weight_fn=weight_fn(jfold))
    assert got.blown.any() and got.stats.retries[2] == 1
    assert len(got.stats.buckets) == len(want.stats.buckets) > 1
    _assert_sfas_equal(got, want)


def test_scanner_shard_map_construction_matches_local():
    dfas = [random_dfa(3 + i, 5, seed=40 + i) for i in range(4)]
    jdfas = [jrandom_dfa(3 + i, 5, seed=40 + i) for i in range(4)]
    docs = np.random.default_rng(3).integers(0, 5, size=(3, 32)).astype(
        np.int32)
    local = Scanner.compile(dfas, ScanPlan(device=CPU, construction=(
        ConstructionPolicy(cache="off", method="batched"))))
    sharded = Scanner.compile(dfas, ScanPlan(
        device=CPU, construction=ConstructionPolicy(
            cache="off", method="batched", distribution="shard_map",
            mesh=make_mesh((1,), ("pattern",), device=CPU))))
    jsharded = JScanner.compile(jdfas, JScanPlan(
        construction=JConstructionPolicy(
            cache="off", method="batched", distribution="shard_map",
            mesh=jmake_mesh((1,), ("pattern",)))))
    assert np.array_equal(local.scan(docs).hits, sharded.scan(docs).hits)
    assert np.array_equal(local.mapping(docs[0]), sharded.mapping(docs[0]))
    assert np.array_equal(sharded.scan(docs).hits, jsharded.scan(docs).hits)
    assert sharded.construction_report.rounds == \
        jsharded.construction_report.rounds


# --------------------------------------------------------------------------
# Speculation (tests/test_speculative.py)
# --------------------------------------------------------------------------


def test_speculative_shard_map_equals_local(mesh1):
    patterns = ["PS00007", "PS00010"]
    docs = _random_docs(5, 4, 96, 20)
    plan = ScanPlan(mode="speculative", device=CPU)
    local = Scanner.compile(patterns, plan).scan(docs)
    dist = Scanner.compile(patterns, plan.with_(
        distribution="shard_map", mesh=mesh1)).scan(docs)
    jdist = JScanner.compile(patterns, JScanPlan(
        mode="speculative", distribution="shard_map",
        mesh=jmake_mesh((1,), ("data",)))).scan(docs)
    assert np.array_equal(local.hits, dist.hits)
    assert np.array_equal(dist.hits, jdist.hits)
    assert asdict(dist.speculation) == asdict(local.speculation) == asdict(
        jdist.speculation)


def test_distributed_speculative_finals_fn_equals_local(mesh1):
    bank, _ = _random_banks(17, (6, 9))
    tables = torch.from_numpy(bank.tables)
    spec = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    starts = torch.from_numpy(bank.starts)
    corpus = torch.from_numpy(_random_docs(2, 6, 40, bank.n_symbols))
    got = distributed_speculative_finals_fn(mesh1, n_chunks=4, max_rounds=2)(
        tables, spec, starts, corpus)
    want = speculative_bank_finals(tables, spec, starts, corpus, 4, 2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# The scan service (tests/test_scanservice.py)
# --------------------------------------------------------------------------


def test_corpus_job_shard_map_distribution_matches_local(tmp_path):
    docs = [synthetic_protein(160, seed=i) for i in range(4)]
    cache = SFACache()

    def plan(**kw):
        return ScanPlan(device=CPU, construction=ConstructionPolicy(
            cache=cache, method="batched"), **kw)

    man = CorpusManifest.from_docs(docs, shard_docs=2)
    local = CorpusJob(SERVICE_PATTERNS, man, tmp_path / "loc", plan())
    local.run()
    dist = CorpusJob(SERVICE_PATTERNS, man, tmp_path / "dist",
                     plan(distribution="shard_map"))
    dist.run()
    ref = JCorpusJob(SERVICE_PATTERNS, JCorpusManifest.from_docs(
        docs, shard_docs=2), tmp_path / "ref", JScanPlan(
            distribution="shard_map"))
    ref.run()
    assert np.array_equal(local.aggregate().hits, dist.aggregate().hits)
    assert dist.aggregate().hits.tobytes() == ref.aggregate().hits.tobytes()
    # the digest leaves the plan out: a job begun local resumes under a mesh
    assert dist.digest() == local.digest() == ref.digest()
    begun = CorpusJob(SERVICE_PATTERNS, man, tmp_path / "moved", plan())
    assert begun.run(max_shards=1).scanned == 1
    moved = CorpusJob(SERVICE_PATTERNS, man, tmp_path / "moved",
                      plan(distribution="shard_map"))
    rep = moved.run()
    assert rep.done_before == 1 and rep.complete
    assert moved.aggregate().hits.tobytes() == ref.aggregate().hits.tobytes()
    assert moved.census().tobytes() == ref.census().tobytes()


def test_scan_service_under_a_mesh(tmp_path):
    """``Scanner.service`` takes a shard_map plan through the Scanner: a
    coalesced answer equals the reference's direct scan."""
    docs = [synthetic_protein(160, seed=i) for i in range(4)]
    plan = ScanPlan(device=CPU, distribution="shard_map")
    with Scanner.service(tmp_path / "store", plan=plan) as svc:
        assert svc.plan.distribution == "shard_map"
        t = svc.submit(SERVICE_PATTERNS[:2], docs)
        svc.flush()
        got = t.result()
    want = JScanner.compile(SERVICE_PATTERNS[:2]).scan(docs)
    assert np.array_equal(got.hits, want.hits)
