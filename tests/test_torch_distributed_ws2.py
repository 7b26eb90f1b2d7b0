"""``distribution="shard_map"`` at world size 2: two gloo ranks on the CPU.

World size 1 never splits anything. Here a module fixture spawns two ranks
once (``tests/_torch_dist_worker.py``: a ``file://`` rendezvous under
``tmp_path``, one intra-op thread each); they run every case with the
documents, patterns, chunks or symbols sharded over the mesh, and rank 0
writes the results. Each test then holds one case equal, bit for bit, to
the port's local path and to the reference's local path on the same
inputs. An odd document count must raise the reference's ``ValueError``.

A hung collective must fail these tests, not run into the suite's clock:
the ranks get :data:`TIMEOUT_S` in all and are terminated after it.
"""

import multiprocessing
import os
import pickle
import time
from dataclasses import astuple
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import _torch_dist_worker as W  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.compat import make_mesh as jmake_mesh  # noqa: E402
from repro.construction import construct_bank as jconstruct_bank  # noqa: E402
from repro.core import monoid as JM  # noqa: E402
from repro.core.dfa import example_fa as jexample_fa  # noqa: E402
from repro.core.dfa import random_dfa as jrandom_dfa  # noqa: E402
from repro.core.fingerprint import fold_weights_u32 as jfold  # noqa: E402
from repro.core.multipattern import PatternBank as JPatternBank  # noqa: E402
from repro.engine import ChunkPolicy as JChunkPolicy  # noqa: E402
from repro.engine import ConstructionPolicy as JConstructionPolicy  # noqa: E402
from repro.engine import ScanPlan as JScanPlan  # noqa: E402
from repro.engine import Scanner as JScanner  # noqa: E402
from repro.engine import SpeculationPolicy as JSpeculationPolicy  # noqa: E402
from repro.engine import executors as JX  # noqa: E402
from repro.scanservice import CorpusJob as JCorpusJob  # noqa: E402
from repro.scanservice import CorpusManifest as JCorpusManifest  # noqa: E402
from repro_torch.construction import construct_bank  # noqa: E402
from repro_torch.core import monoid as M  # noqa: E402
from repro_torch.core.dfa import example_fa, random_dfa  # noqa: E402
from repro_torch.core.multipattern import PatternBank  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    ChunkPolicy,
    ConstructionPolicy,
    Scanner,
    SpeculationPolicy,
)
from repro_torch.engine import executors as X  # noqa: E402

CPU = "cpu"
TIMEOUT_S = 180
SRC = str(Path(__file__).resolve().parent.parent / "src")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn both ranks once; -> {case: ("ok", result) | ("error", ...)}."""
    out = tmp_path_factory.mktemp("ws2")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=W.run,
                         args=(r, str(out / "rendezvous"), str(out), SRC))
             for r in range(W.WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.terminate()
        p.join(timeout=10)
    if hung:
        pytest.fail(f"{len(hung)} rank(s) still running after {TIMEOUT_S} s "
                    "(a hung collective); terminated")
    codes = [p.exitcode for p in procs]
    if codes != [0] * W.WORLD:
        pytest.fail(f"ranks exited with {codes}")
    with open(os.path.join(out, "results.pkl"), "rb") as f:
        return pickle.load(f)


def _result(ranks, case):
    status, *rest = ranks[case]
    assert status == "ok", rest
    return rest[0]


def _dfas(seeds, k):
    return ([random_dfa(n, k, seed=s) for n, s in seeds],
            [jrandom_dfa(n, k, seed=s) for n, s in seeds])


# --------------------------------------------------------------------------
# Scanner
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["sfa", "enumeration"])
def test_scanner_scan(ranks, mode):
    got = _result(ranks, f"scan_{mode}")
    seeds, k, docs = W.scan_inputs()
    dfas, jdfas = _dfas(seeds, k)
    local = Scanner.compile(dfas, mode=mode, sfa_state_budget=10_000,
                            device=CPU, chunking=ChunkPolicy(n_chunks=4),
                            construction=ConstructionPolicy(cache="off"))
    ref = JScanner.compile(jdfas, JScanPlan(
        mode=mode, sfa_state_budget=10_000,
        chunking=JChunkPolicy(n_chunks=4),
        construction=JConstructionPolicy(cache="off")))
    assert got["modes"] == [mode]
    assert np.array_equal(got["hits"], local.scan(docs).hits)
    assert np.array_equal(got["hits"], ref.scan(docs).hits)
    assert np.array_equal(got["census"], ref.census(docs))


def test_scanner_speculative(ranks):
    """Hits and SpeculationStats: the shards' hit and repaired counts sum
    and their rounds take the max, as the reference's psum and pmax."""
    got = _result(ranks, "scan_speculative")
    docs = W.spec_inputs()
    for name, pol, jpol in (
            ("sampled", SpeculationPolicy(), JSpeculationPolicy()),
            ("adversarial",
             SpeculationPolicy(profile_source=[40, 41], max_repair_rounds=1),
             JSpeculationPolicy(profile_source=[40, 41],
                                max_repair_rounds=1))):
        hits, stats = got[name]
        local = Scanner.compile(W.SPEC_PATTERNS, mode="speculative",
                                device=CPU, speculation=pol).scan(docs)
        ref = JScanner.compile(W.SPEC_PATTERNS, JScanPlan(
            mode="speculative", speculation=jpol)).scan(docs)
        assert np.array_equal(hits, local.hits) and np.array_equal(
            hits, ref.hits), name
        assert stats == astuple(local.speculation) == astuple(
            ref.speculation), name
    assert got["adversarial"][1][4] > 0         # lanes fell back


def test_census_windows_odd_block_count(ranks):
    seq, window, stride = W.windows_inputs()
    blocks = (len(seq) - window) // stride + window // stride
    assert blocks % W.WORLD                    # the mesh path pads a row
    got = _result(ranks, "census_windows")
    local = Scanner.compile(W.SERVICE_PATTERNS, mode="enumeration",
                            device=CPU, chunking=ChunkPolicy(n_chunks=4))
    ref = JScanner.compile(W.SERVICE_PATTERNS, JScanPlan(
        mode="enumeration", chunking=JChunkPolicy(n_chunks=4)))
    assert np.array_equal(got, local.census_windows(seq, window,
                                                    stride).hits)
    assert np.array_equal(got, ref.census_windows(seq, window, stride).hits)


def test_odd_doc_count_raises_the_references_error(ranks):
    """scan of 3 docs, and mapping / accepts of one, raise the reference's
    ValueError on a 2-rank mesh; locate and stream stay local and equal, and
    so does the mapping of a 3-symbol doc, as in the reference, which walks
    no head below n_chunks."""
    got = _result(ranks, "odd_doc_count")
    msg = ("shard_map distribution needs doc count ({}) divisible by the "
           "mesh's data size (2)")
    assert got["errors"] == [msg.format(3), msg.format(1), msg.format(1)]
    seeds, k, docs = W.scan_inputs()
    dfas, jdfas = _dfas(seeds, k)
    local = Scanner.compile(dfas, mode="enumeration", device=CPU,
                            chunking=ChunkPolicy(n_chunks=4))
    flat = docs.reshape(-1)
    streamed = local.stream([flat[:100], flat[100:]])
    assert np.array_equal(got["locate"], local.locate(flat, 2))
    assert np.array_equal(got["stream"][0], streamed.mapping)
    assert np.array_equal(got["stream"][1], streamed.accepted)
    jlocal = JScanner.compile(jdfas, JScanPlan(
        mode="enumeration", chunking=JChunkPolicy(n_chunks=4)))
    assert np.array_equal(got["short"], local.mapping(docs[0][:3]))
    assert np.array_equal(got["short"], jlocal.mapping(docs[0][:3]))


# --------------------------------------------------------------------------
# Construction: the pattern axis sharded, padded buckets
# --------------------------------------------------------------------------


@pytest.mark.parametrize("P", [4, 5])
def test_construct_bank_sharded(ranks, P):
    got = _result(ranks, f"construct_p{P}")
    seeds, k = W.construct_inputs(P)
    dfas, jdfas = _dfas(seeds, k)
    local = W.sfa_result(construct_bank(
        dfas, max_states=W.MAX_STATES, tile=16, device=CPU,
        _weight_fn=W.forced_collision))

    def jweights(p, attempt, n_words, consts):
        w = np.asarray(jfold(n_words, consts))
        return np.zeros_like(w) if (p, attempt) == (1, 0) else w

    ref = W.sfa_result(jconstruct_bank(jdfas, max_states=W.MAX_STATES,
                                       tile=16, _weight_fn=jweights))
    assert got["retries"][1] == 1 and got["blown"].any()
    for want in (local, ref):
        for key in ("blown", "retries", "pattern_rounds",
                    "pattern_candidates"):
            assert np.array_equal(got[key], want[key]), key
        assert got["rounds"] == want["rounds"]
        for a, b in zip(got["sfas"], want["sfas"]):
            assert (a is None) == (b is None)
            if a is not None:
                for x, y in zip(a, b):
                    assert np.array_equal(x, y)


def test_scanner_with_sharded_construction(ranks):
    got = _result(ranks, "scanner_construction")
    seeds, k, docs = W.scan_inputs()
    dfas, jdfas = _dfas(seeds, k)
    local = Scanner.compile(dfas, device=CPU,
                            chunking=ChunkPolicy(n_chunks=4),
                            construction=ConstructionPolicy(
                                cache="off", method="batched"))
    ref = JScanner.compile(jdfas, JScanPlan(
        chunking=JChunkPolicy(n_chunks=4),
        construction=JConstructionPolicy(cache="off", method="batched")))
    assert got["rounds"] == local.construction_report.rounds == \
        ref.construction_report.rounds
    assert np.array_equal(got["hits"], local.scan(docs).hits)
    assert np.array_equal(got["hits"], ref.scan(docs).hits)


# --------------------------------------------------------------------------
# The scan service
# --------------------------------------------------------------------------


def test_corpus_job_killed_and_resumed(ranks, tmp_path):
    got = _result(ranks, "corpus_job")
    docs = W.job_inputs()
    ref = JCorpusJob(W.SERVICE_PATTERNS,
                     JCorpusManifest.from_docs(docs, shard_docs=2),
                     tmp_path / "ref", JScanPlan())
    ref.run()
    local = Scanner.compile(W.SERVICE_PATTERNS, device=CPU).scan(docs)
    assert got["first"] == 1 and got["done_before"] == 1
    assert got["hits"].tobytes() == ref.aggregate().hits.tobytes()
    assert got["hits"].tobytes() == local.hits.tobytes()
    assert got["census"].tobytes() == ref.census().tobytes()


# --------------------------------------------------------------------------
# Executors and the monoid across ranks
# --------------------------------------------------------------------------


def test_distributed_match_fn(ranks):
    got = _result(ranks, "match_fn")
    table, text, _ = W.match_inputs()
    syms = example_fa().encode(text)
    local = X.match_parallel_enumeration(torch.from_numpy(table),
                                         torch.from_numpy(syms), 16)
    ref = JX.match_parallel_enumeration(jnp.asarray(table),
                                        jnp.asarray(syms), 16)
    assert np.array_equal(got, local.numpy())
    assert np.array_equal(got, np.asarray(ref))
    assert sorted(got.tolist()) == list(range(6))     # still a permutation


def test_throughput_matcher(ranks):
    got = _result(ranks, "throughput_matcher")
    d, jd = example_fa(), jexample_fa()
    _, _, rows = W.match_inputs()
    assert got.dtype == bool
    assert got.tolist() == [d.accepts(t) for t in rows] == [
        False, True, False, False]
    ref = JX.throughput_matcher(jmake_mesh((1,), ("data",)), start=jd.start)(
        jnp.asarray(jd.table), jnp.asarray(jd.accepting),
        jnp.asarray(np.stack([jd.encode(t) for t in rows])))
    assert np.array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("shape", ["2x1", "1x2"])
def test_distributed_bank_matcher_and_census(ranks, shape):
    """(2, 1) shards the symbols and the corpus, (1, 2) the patterns."""
    got = _result(ranks, f"bank_matcher_{shape}")
    seeds, k, syms, corpus = W.bank_inputs()
    dfas, jdfas = _dfas(seeds, k)
    tables, accepting, starts = PatternBank.from_dfas(dfas).to(CPU)
    jt, ja, js = JPatternBank.from_dfas(jdfas).device_arrays()
    local = X.match_bank_parallel(tables, torch.from_numpy(syms), 16)
    ref = JX.match_bank_parallel(jt, jnp.asarray(syms), 16)
    assert np.array_equal(got["maps"], local.numpy())
    assert np.array_equal(got["maps"], np.asarray(ref))
    counts = X.census_bank(tables, accepting, starts,
                           torch.from_numpy(corpus), 4)
    jcounts = JX.census_bank(jt, ja, js, jnp.asarray(corpus), 4)
    assert got["counts"].dtype == np.int32
    assert np.array_equal(got["counts"], counts.numpy())
    assert np.array_equal(got["counts"], np.asarray(jcounts))


def test_shard_reduce_and_exclusive_scan(ranks):
    """Rank i's exclusive scan is the combine of ranks [0, i); both ranks
    hold the whole reduce."""
    got = _result(ranks, "shard_monoid")
    xs = W.monoid_inputs()
    FN = M.function_monoid()
    total = M.reduce(FN, torch.from_numpy(xs), axis=0)
    prefix = M.exclusive_scan(FN, torch.from_numpy(xs), axis=0)
    jtotal = JM.reduce(JM.function_monoid(), jnp.asarray(xs), axis=0)
    jprefix = JM.exclusive_scan(JM.function_monoid(), jnp.asarray(xs),
                                axis=0)
    for r in range(W.WORLD):
        assert np.array_equal(got["reduce"][r], total.numpy())
        assert np.array_equal(got["reduce"][r], np.asarray(jtotal))
        assert np.array_equal(got["exclusive"][r], prefix[r].numpy())
        assert np.array_equal(got["exclusive"][r], np.asarray(jprefix[r]))
    assert not np.array_equal(got["exclusive"][0], got["exclusive"][1])
