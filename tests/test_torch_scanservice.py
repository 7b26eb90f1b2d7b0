"""The port's construction cache and scan service against the reference's.

Mirrors ``tests/test_scanservice.py``, and checks that the two packages
share their on-disk state: ``dfa_cache_key`` is the reference's byte for
byte, an SFA artifact or a blowup marker written by either package's
``ArtifactStore`` loads in the other's, a persisted hot-state profile is
read by either, and a ``CorpusJob`` begun by the reference resumes in the
port with an aggregate byte-identical to the reference's straight run. The
port runs on the CPU throughout (``device="cpu"``).
"""

from dataclasses import asdict

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import numpy as np  # noqa: E402

from repro.construction import SFACache as JSFACache  # noqa: E402
from repro.construction import construct_sfa as jconstruct_sfa  # noqa: E402
from repro.construction import dfa_cache_key as jdfa_cache_key  # noqa: E402
from repro.core.dfa import random_dfa as jrandom_dfa  # noqa: E402
from repro.core.prosite import load_bank as jload_bank  # noqa: E402
from repro.engine import ConstructionPolicy as JConstructionPolicy  # noqa: E402
from repro.engine import ScanPlan as JScanPlan  # noqa: E402
from repro.engine import Scanner as JScanner  # noqa: E402
from repro.engine import SpeculationPolicy as JSpeculationPolicy  # noqa: E402
from repro.scanservice import ArtifactStore as JArtifactStore  # noqa: E402
from repro.scanservice import CorpusJob as JCorpusJob  # noqa: E402
from repro.scanservice import CorpusManifest as JCorpusManifest  # noqa: E402
from repro_torch.construction import (  # noqa: E402
    SFACache,
    construct_sfa,
    dfa_cache_key,
    shared_cache,
)
from repro_torch.core.dfa import random_dfa  # noqa: E402
from repro_torch.core.prosite import load_bank, synthetic_protein  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    ChunkPolicy,
    ConstructionPolicy,
    ScanPlan,
    Scanner,
    SpeculationPolicy,
)
from repro_torch.scanservice import (  # noqa: E402
    STORE_VERSION,
    ArtifactStore,
    BatchScheduler,
    CorpusJob,
    CorpusManifest,
    ScanService,
    scan_shard,
)
from repro_torch.speculative import HotStateProfile  # noqa: E402

CPU = "cpu"
PATTERNS = ["PS00016", "PS00005", "PS00001", "PS00006"]


@pytest.fixture(scope="module")
def docs():
    return [synthetic_protein(160, seed=i) for i in range(6)]


def _plan(cache, **kw):
    return ScanPlan(device=CPU, construction=ConstructionPolicy(
        cache=cache, method="batched", **kw))


def _jplan(cache, **kw):
    return JScanPlan(construction=JConstructionPolicy(
        cache=cache, method="batched", **kw))


def _assert_sfa_equal(a, b):
    assert np.array_equal(a.mappings, b.mappings)
    assert np.array_equal(a.delta, b.delta)
    assert np.array_equal(a.fingerprints, b.fingerprints)
    assert np.array_equal(a.dfa.table, b.dfa.table)
    assert np.array_equal(a.dfa.accepting, b.dfa.accepting)
    assert (a.dfa.start, a.dfa.alphabet) == (b.dfa.start, b.dfa.alphabet)


# --------------------------------------------------------------------------
# The key and the artifacts, across the packages
# --------------------------------------------------------------------------


def test_dfa_cache_key_matches_reference():
    bank, jbank = load_bank(), jload_bank()
    assert bank.n_patterns == 23
    for p in range(bank.n_patterns):
        assert dfa_cache_key(bank.dfa(p)) == jdfa_cache_key(jbank.dfa(p))
    d, jd = random_dfa(40, 7, seed=2), jrandom_dfa(40, 7, seed=2)
    assert dfa_cache_key(d, 0x1B) == jdfa_cache_key(jd, 0x1B)
    assert dfa_cache_key(d, 0x8D) == jdfa_cache_key(jd, 0x8D)
    assert ConstructionPolicy().cache == "shared"
    assert shared_cache() is shared_cache()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_artifacts_load_in_the_other_package(tmp_path, writer):
    """An SFA and a blowup marker written by one package's ArtifactStore
    load, equal, in the other's; a fresh cache over the store answers both
    without constructing."""
    pid, blown_pid = "PS00016", "PS00006"
    d, jd = load_bank([pid]).dfa(0), jload_bank([pid]).dfa(0)
    key = dfa_cache_key(d)
    blown_key = dfa_cache_key(load_bank([blown_pid]).dfa(0))
    if writer == "reference":
        sfa = jconstruct_sfa(jd)
        out, inn = JArtifactStore(tmp_path), ArtifactStore(tmp_path)
    else:
        sfa = construct_sfa(d, device=CPU)
        out, inn = ArtifactStore(tmp_path), JArtifactStore(tmp_path)
    out.put_sfa(key, sfa)
    out.put_blowup(blown_key, 40)
    kind, got = inn.get(key)
    assert kind == "sfa"
    _assert_sfa_equal(got, sfa)
    assert inn.get(blown_key) == ("blowup", 40)
    assert sorted(inn.keys()) == sorted([key, blown_key])
    assert STORE_VERSION == 1
    if writer == "reference":       # the port's cache over the foreign store
        cache = SFACache(backing=ArtifactStore(tmp_path))
        kind, hit = cache.lookup(d, max_states=512)
        assert kind == "sfa" and cache.info.disk_hits == 1
        _assert_sfa_equal(hit, sfa)
        blown = load_bank([blown_pid]).dfa(0)
        assert cache.lookup(blown, max_states=40) == ("blowup", None)
        assert cache.lookup(blown, max_states=100) == (None, None)


def test_reference_store_warms_a_port_compile(tmp_path, docs):
    """A store filled by the reference's compile answers the port's whole
    compile: zero rounds, the same modes and hits."""
    store = tmp_path / "store"
    jsc = JScanner.compile(PATTERNS, _jplan(JSFACache(), store=str(store)))
    assert jsc.construction_report.rounds > 0
    sc = Scanner.compile(PATTERNS, _plan(SFACache(), store=str(store)))
    r = sc.construction_report
    assert (r.rounds, r.constructed, r.cache_hits) == (0, 0, len(PATTERNS))
    assert sc.pattern_modes == jsc.pattern_modes
    assert np.array_equal(sc.scan(docs).hits, jsc.scan(docs).hits)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_hot_state_profiles_load_in_the_other_package(tmp_path, writer):
    """profile_source='store': the profile one package samples and persists
    is the one the other reads back, and both scan alike."""
    d, jd = random_dfa(40, 5, seed=11), jrandom_dfa(40, 5, seed=11)
    corpus = np.random.default_rng(12).integers(0, 5, (3, 64)).astype(
        np.int32)
    store = str(tmp_path)
    port_plan = ScanPlan(
        mode="speculative", device=CPU,
        construction=ConstructionPolicy(cache="off", store=store),
        speculation=SpeculationPolicy(profile_source="store"))
    ref_plan = JScanPlan(
        mode="speculative",
        construction=JConstructionPolicy(cache="off", store=store),
        speculation=JSpeculationPolicy(profile_source="store"))
    first, second = ((JScanner.compile([jd], ref_plan),
                      Scanner.compile([d], port_plan))
                     if writer == "reference" else
                     (Scanner.compile([d], port_plan),
                      JScanner.compile([jd], ref_plan)))
    r1 = first.scan(corpus)
    keys = ArtifactStore(tmp_path).profile_keys()
    assert keys == [dfa_cache_key(d)]
    persisted = ArtifactStore(tmp_path).get_profile(keys[0])
    r2 = second.scan(corpus)
    g = next(g for g in second.groups if g.mode == "speculative")
    assert np.array_equal(
        np.asarray(g._spec_profile)[0][: len(persisted["states"])],
        np.asarray(persisted["states"], dtype=np.int32))
    assert np.array_equal(r1.hits, r2.hits)
    assert asdict(r1.speculation) == asdict(r2.speculation)


def test_store_profile_roundtrip_and_isolation(tmp_path):
    store = ArtifactStore(tmp_path)
    prof = HotStateProfile(states=np.asarray([3, 1], dtype=np.int32),
                           weights=np.asarray([0.7, 0.2]), sample_len=10)
    store.put_profile("ab" + "0" * 62, prof.to_json())
    assert store.get_profile("ab" + "0" * 62)["states"] == [3, 1]
    assert store.get_profile("cd" + "0" * 62) is None
    assert len(store) == 0 and store.keys() == []
    assert list(store.entries()) == []
    assert store.profile_keys() == ["ab" + "0" * 62]
    store._profile_path("ab" + "0" * 62).write_text("{broken")
    assert store.get_profile("ab" + "0" * 62) is None


# --------------------------------------------------------------------------
# The cache tiers in the port
# --------------------------------------------------------------------------


def test_cold_then_warm_process_zero_rounds(tmp_path, docs):
    cold = SFACache(backing=ArtifactStore(tmp_path / "store"))
    sc1 = Scanner.compile(PATTERNS, _plan(cold))
    r1 = sc1.construction_report
    assert r1.rounds > 0 and r1.cache_misses == len(PATTERNS)
    warm = SFACache(backing=ArtifactStore(tmp_path / "store"))
    sc2 = Scanner.compile(PATTERNS, _plan(warm))
    r2 = sc2.construction_report
    assert r2.rounds == 0 and r2.constructed == 0
    assert r2.cache_hits == len(PATTERNS)
    assert warm.info.disk_hits == len(PATTERNS)
    assert np.array_equal(sc1.scan(docs).hits, sc2.scan(docs).hits)
    fresh = SFACache(backing=ArtifactStore(tmp_path / "store"))
    assert fresh.preload() == len(PATTERNS)
    assert fresh.info.disk_hits == len(PATTERNS)


def test_corrupt_artifacts_are_misses_not_fatal(tmp_path):
    store = ArtifactStore(tmp_path)
    d = random_dfa(5, 4, seed=1)
    key = dfa_cache_key(d)
    store.put_sfa(key, construct_sfa(d, device=CPU))
    assert store.get(key) is not None
    store._payload_path(key).write_bytes(b"PK\x03\x04 truncated")
    assert store.get(key) is None
    store._sidecar_path(key).write_text("{not json")
    assert store.get(key) is None


# --------------------------------------------------------------------------
# Coalescing scheduler and the service
# --------------------------------------------------------------------------


def test_coalesced_results_bit_identical_to_per_request(docs):
    cache = SFACache()
    with ScanService(plan=_plan(cache), cache=cache) as svc:
        requests = [(PATTERNS[:2], docs[:3]), (PATTERNS[1:], docs[2:]),
                    ([PATTERNS[0], PATTERNS[3]], [docs[0], docs[5]])]
        tickets = [svc.submit(p, d) for p, d in requests]
        assert svc.flush() == len(requests)
        stats = svc.scheduler.stats
        assert stats.flushes == 1 and stats.union_docs == len(docs)
        assert stats.union_patterns == len(PATTERNS)
        for t, (p, d) in zip(tickets, requests):
            want = Scanner.compile(p, _plan(cache)).scan(d)
            got = t.result()
            assert got.batch_size == len(requests) and got.ids == want.ids
            assert np.array_equal(got.hits, want.hits)
        assert svc.metrics()["cache"]["hits"] > 0


def test_scheduler_counts_speculative_patterns(tmp_path):
    big = random_dfa(150, 20, seed=21)
    doc = "ACDEFGHIKLMNPQRSTVWY" * 5
    plan = ScanPlan(mode="auto", sfa_state_budget=5, device=CPU)
    with ScanService(store_dir=tmp_path, plan=plan) as svc:
        assert svc.plan.speculation.profile_source == "store"
        res = svc.submit([big, "PS00016"], [doc]).result()
        assert res.hits.shape == (2, 1)
        assert svc.scheduler.stats.speculative_patterns == 1
    want = JScanner.compile([jrandom_dfa(150, 20, seed=21), "PS00016"],
                            JScanPlan(mode="enumeration")).scan([doc])
    assert np.array_equal(res.hits, want.hits)
    with ScanService(plan=ScanPlan(device=CPU)) as svc:
        assert svc.plan.speculation.profile_source == "sample"
    explicit = ScanPlan(device=CPU, speculation=SpeculationPolicy(
        profile_source=[0, 1]))
    with ScanService(store_dir=tmp_path, plan=explicit) as svc:
        assert list(svc.plan.speculation.profile_source) == [0, 1]


def test_scheduler_validation_and_close(docs):
    with pytest.raises(ValueError):
        BatchScheduler(driver="fiber")
    sched = BatchScheduler(_plan(SFACache()))
    with pytest.raises(ValueError):
        sched.submit([], docs[0])
    with pytest.raises(TypeError):
        sched.submit([object()], docs[0])
    sched.close()
    with pytest.raises(RuntimeError):
        sched.submit(PATTERNS[0], docs[0])


def test_scanner_service_hook_end_to_end(tmp_path, docs):
    plan = ScanPlan(device=CPU, chunking=ChunkPolicy(bucket=True))
    with Scanner.service(tmp_path / "store", plan=plan) as svc:
        t = svc.submit(PATTERNS[:2], docs[:2])
        svc.flush()
        first = t.result()
    with Scanner.service(tmp_path / "store", plan=plan) as svc2:
        assert svc2.warm_start() >= 2
        sc = svc2.scanner(PATTERNS[:2])
        assert sc.construction_report.rounds == 0
        assert np.array_equal(sc.scan(docs[:2]).hits, first.hits)


# --------------------------------------------------------------------------
# Resumable corpus jobs
# --------------------------------------------------------------------------


def test_corpus_job_kill_and_resume_byte_identical(tmp_path, docs):
    cache = SFACache()
    man = CorpusManifest.from_docs(docs, shard_docs=2)
    job = CorpusJob(PATTERNS, man, tmp_path / "interrupted", _plan(cache))
    rep = job.run(max_shards=1)             # "killed" after one shard
    assert rep.scanned == 1 and not rep.complete
    with pytest.raises(RuntimeError):
        job.aggregate()
    del job
    resumed = CorpusJob(PATTERNS, man, tmp_path / "interrupted", _plan(cache))
    rep2 = resumed.run()
    assert rep2.done_before == 1 and rep2.scanned == 2 and rep2.complete
    straight = CorpusJob(PATTERNS, man, tmp_path / "straight", _plan(cache))
    assert straight.run().complete
    a, b = resumed.aggregate(), straight.aggregate()
    assert a.hits.tobytes() == b.hits.tobytes()
    assert resumed.census().tobytes() == straight.census().tobytes()
    want = straight.flight_totals()["metrics"]
    assert resumed.flight_totals()["metrics"] == want
    assert want["jobs.items_scanned"] == len(docs)
    flat = Scanner.compile(PATTERNS, _plan(cache)).scan(docs)
    assert np.array_equal(a.hits, flat.hits)
    other = CorpusManifest.from_docs(docs[:4], shard_docs=2)
    with pytest.raises(ValueError):         # a foreign work directory
        CorpusJob(PATTERNS, other, tmp_path / "straight", _plan(cache))


def test_reference_job_resumes_in_the_port(tmp_path, docs):
    """The reference runs two shards of a job and stops; the port resumes
    the same work directory (the digest is the reference's) and its
    aggregate is byte-identical to the reference's straight run."""
    man = CorpusManifest.from_docs(docs, shard_docs=2)
    jman = JCorpusManifest.from_docs(docs, shard_docs=2)
    assert man.digest() == jman.digest()
    jplan = _jplan(JSFACache())
    begun = JCorpusJob(PATTERNS, jman, tmp_path / "job", jplan)
    assert begun.run(max_shards=2).scanned == 2
    resumed = CorpusJob(PATTERNS, man, tmp_path / "job", _plan(SFACache()))
    assert resumed.digest() == begun.digest()
    rep = resumed.run()
    assert (rep.done_before, rep.scanned, rep.complete) == (2, 1, True)
    straight = JCorpusJob(PATTERNS, jman, tmp_path / "straight", jplan)
    straight.run()
    assert resumed.aggregate().hits.tobytes() == \
        straight.aggregate().hits.tobytes()
    assert resumed.census().tobytes() == straight.census().tobytes()


def test_corpus_job_streaming_and_window_paths(tmp_path):
    cache = SFACache()
    mix = [synthetic_protein(L, seed=L) for L in (30, 500, 64, 700)]
    man = CorpusManifest.from_docs(mix, shard_docs=4)
    sc = Scanner.compile(PATTERNS, _plan(cache))
    assert np.array_equal(scan_shard(sc, man, 0, stream_threshold=200),
                          sc.scan(mix).hits)
    seq = synthetic_protein(600, seed=7)
    wman = CorpusManifest.sliding(seq, window=48, stride=16, shard_windows=9)
    job = CorpusJob(PATTERNS, wman, tmp_path / "wj", _plan(cache))
    job.run(max_shards=1)
    job = CorpusJob(PATTERNS, wman, tmp_path / "wj", _plan(cache))
    job.run()
    whole = sc.census_windows(seq, 48, 16)
    assert np.array_equal(job.aggregate().hits, whole.hits)
    assert job.census().tobytes() == whole.counts.tobytes()
