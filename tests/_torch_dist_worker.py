"""One rank of the world-size-2 tests (``test_torch_distributed_ws2.py``).

``run`` joins a two-rank gloo world through a ``file://`` rendezvous, runs
every case of :data:`CASES` in order on the CPU — every rank issues the same
collectives in the same order — and rank 0 pickles the results (or each
case's error) to ``results.pkl``. The inputs come from numpy seeds through
the ``*_inputs`` functions, which the tests call too, for the local paths
of both packages. This module imports neither jax nor pytest: it is what a
spawned rank imports.
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys

import numpy as np

CPU = "cpu"
WORLD = 2
SERVICE_PATTERNS = ["PS00016", "PS00005", "PS00001", "PS00006"]
SPEC_PATTERNS = ["PS00007", "PS00010"]


def random_docs(seed, n_docs, length, k):
    rng = np.random.default_rng(seed)
    return rng.integers(0, k, size=(n_docs, length)).astype(np.int32)


def scan_inputs():
    """(DFA sizes and seeds, k, docs): 6 docs of 42 symbols, n_chunks 4,
    so every doc has a ragged tail of 2."""
    return [(3, 11), (5, 12), (4, 13), (6, 14)], 6, random_docs(5, 6, 42, 6)


def spec_inputs():
    return random_docs(6, 4, 96, 20)


MAX_STATES = 300


def construct_inputs(P: int):
    """P random DFAs of 3..9 states over 5 symbols; pattern 1's first
    polynomial is forced to collide and the 9-state one blows the
    ``MAX_STATES`` budget."""
    sizes = [3, 4, 5, 9, 7][:P]
    return [(n, 400 + i) for i, n in enumerate(sizes)], 5


def windows_inputs():
    """310 symbols, window 48, stride 16: 17 windows, 19 blocks (odd)."""
    return random_docs(8, 1, 310, 20)[0], 48, 16


def job_inputs():
    from repro_torch.core.prosite import synthetic_protein

    return [synthetic_protein(160, seed=i) for i in range(4)]


def match_inputs():
    """(table, text, rows) of the one-table matchers. Every symbol of the
    6-state table permutes the states, so no input synchronises them and
    the order in which chunk functions combine shows in the result. Of the
    four rows only row 1 holds the planted ``RG`` of ``example_fa``."""
    from repro_torch.core.prosite import synthetic_protein

    rng = np.random.default_rng(21)
    table = np.stack([rng.permutation(6) for _ in range(20)],
                     axis=1).astype(np.int32)
    text = synthetic_protein(1024, seed=9)
    rows = []
    for i in (0, 2, 4, 5):                 # seeds without a match
        t = synthetic_protein(128, seed=i)
        rows.append(t[:60] + "RG" + t[62:] if i == 2 else t)
    return table, text, rows


def bank_inputs():
    """(sizes and seeds, k, symbols, corpus) of the bank matchers."""
    seeds = [(n, 11 * 31 + i) for i, n in enumerate((3, 6, 9, 4))]
    rng = np.random.default_rng(11)
    return (seeds, 6, rng.integers(0, 6, size=128).astype(np.int32),
            rng.integers(0, 6, size=(4, 32)).astype(np.int32))


def monoid_inputs():
    """One (3, 7) mapping element per rank."""
    return np.random.default_rng(3).integers(
        0, 7, size=(WORLD, 3, 7)).astype(np.int32)


def forced_collision(p, attempt, n_words, consts):
    from repro_torch.core.fingerprint import fold_weights_u32

    w = fold_weights_u32(n_words, consts).numpy()
    return np.zeros_like(w) if (p, attempt) == (1, 0) else w


def sfa_result(res) -> dict:
    """A BankConstructionResult as plain arrays."""
    return dict(
        blown=res.blown, rounds=res.stats.rounds,
        retries=res.stats.retries, pattern_rounds=res.stats.pattern_rounds,
        pattern_candidates=res.stats.pattern_candidates,
        sfas=[None if s is None else (s.delta, s.mappings, s.fingerprints)
              for s in res.sfas])


def spec_stats(st) -> tuple:
    return (st.total_chunks, st.hit_chunks, st.repaired_chunks,
            st.repair_rounds, st.fallback_lanes)


# --------------------------------------------------------------------------
# The cases (each the same on every rank)
# --------------------------------------------------------------------------


def _scan(mode):
    from repro_torch.core.dfa import random_dfa
    from repro_torch.engine import ChunkPolicy, ConstructionPolicy, Scanner

    seeds, k, docs = scan_inputs()
    sc = Scanner.compile(
        [random_dfa(n, k, seed=s) for n, s in seeds], mode=mode,
        sfa_state_budget=10_000, device=CPU, distribution="shard_map",
        chunking=ChunkPolicy(n_chunks=4),
        construction=ConstructionPolicy(cache="off"))
    res = sc.scan(docs)
    return dict(hits=res.hits, census=sc.census(docs),
                modes=sorted(set(sc.pattern_modes.values())))


def case_scan_sfa():
    return _scan("sfa")


def case_scan_enumeration():
    return _scan("enumeration")


def case_scan_speculative():
    from repro_torch.engine import Scanner, SpeculationPolicy

    docs = spec_inputs()
    out = {}
    for name, pol in (("sampled", SpeculationPolicy()),
                      ("adversarial", SpeculationPolicy(
                          profile_source=[40, 41], max_repair_rounds=1))):
        res = Scanner.compile(SPEC_PATTERNS, mode="speculative", device=CPU,
                              distribution="shard_map",
                              speculation=pol).scan(docs)
        out[name] = (res.hits, spec_stats(res.speculation))
    return out


def _construct(P):
    from repro_torch.construction import construct_bank
    from repro_torch.core.dfa import random_dfa

    seeds, k = construct_inputs(P)
    return sfa_result(construct_bank(
        [random_dfa(n, k, seed=s) for n, s in seeds], max_states=MAX_STATES,
        tile=16, device=CPU, distribution="shard_map",
        _weight_fn=forced_collision))


def case_construct_p4():
    return _construct(4)


def case_construct_p5():
    return _construct(5)


def case_scanner_construction():
    from repro_torch.core.dfa import random_dfa
    from repro_torch.engine import ChunkPolicy, ConstructionPolicy, Scanner

    seeds, k, docs = scan_inputs()
    sc = Scanner.compile(
        [random_dfa(n, k, seed=s) for n, s in seeds], device=CPU,
        distribution="shard_map", chunking=ChunkPolicy(n_chunks=4),
        construction=ConstructionPolicy(cache="off", method="batched",
                                        distribution="shard_map"))
    return dict(hits=sc.scan(docs).hits,
                rounds=sc.construction_report.rounds)


def case_census_windows():
    from repro_torch.engine import ChunkPolicy, Scanner

    seq, window, stride = windows_inputs()
    sc = Scanner.compile(SERVICE_PATTERNS, mode="enumeration", device=CPU,
                         distribution="shard_map",
                         chunking=ChunkPolicy(n_chunks=4))
    return sc.census_windows(seq, window, stride).hits


def case_corpus_job(workdir):
    import torch.distributed as dist

    from repro_torch.engine import ScanPlan
    from repro_torch.scanservice import CorpusJob, CorpusManifest

    man = CorpusManifest.from_docs(job_inputs(), shard_docs=2)
    plan = ScanPlan(device=CPU, distribution="shard_map")
    # Each rank checkpoints to a directory of its own; the first run stops
    # after one shard, as a killed job does, and a new job resumes it.
    where = os.path.join(workdir, f"job{dist.get_rank()}")
    first = CorpusJob(SERVICE_PATTERNS, man, where, plan).run(max_shards=1)
    resumed = CorpusJob(SERVICE_PATTERNS, man, where, plan)
    rep = resumed.run()
    return dict(first=first.scanned, done_before=rep.done_before,
                hits=resumed.aggregate().hits, census=resumed.census())


def case_match_fn(meshes):
    import torch

    from repro_torch.core.dfa import example_fa
    from repro_torch.engine import executors as X

    table, text, _ = match_inputs()
    return X.distributed_match_fn(meshes["data"], table.shape)(
        torch.from_numpy(table),
        torch.from_numpy(example_fa().encode(text)), sub_chunks=8).numpy()


def case_throughput_matcher(meshes):
    import torch

    from repro_torch.core.dfa import example_fa
    from repro_torch.engine import executors as X

    d = example_fa()
    _, _, rows = match_inputs()
    batch = np.stack([d.encode(t) for t in rows])
    return X.throughput_matcher(meshes["data"], start=d.start)(
        torch.from_numpy(d.table), torch.from_numpy(d.accepting),
        torch.from_numpy(batch)).numpy()


def _bank_matchers(mesh):
    import torch

    from repro_torch.core.dfa import random_dfa
    from repro_torch.core.multipattern import PatternBank
    from repro_torch.engine import executors as X

    seeds, k, syms, corpus = bank_inputs()
    tables, accepting, starts = PatternBank.from_dfas(
        [random_dfa(n, k, seed=s) for n, s in seeds]).to(CPU)
    maps = X.distributed_bank_matcher(mesh)(tables, torch.from_numpy(syms),
                                            sub_chunks=8)
    counts = X.distributed_census_fn(mesh, n_chunks=4)(
        tables, accepting, starts, torch.from_numpy(corpus))
    return dict(maps=maps.numpy(), counts=counts.numpy())


def case_bank_matcher_2x1(meshes):
    return _bank_matchers(meshes["2x1"])


def case_bank_matcher_1x2(meshes):
    return _bank_matchers(meshes["1x2"])


def case_shard_monoid(meshes):
    import torch

    from repro_torch.core import monoid as M
    from repro_torch.mesh import all_gather, axis_rank

    mesh = meshes["data"]
    x = torch.from_numpy(monoid_inputs()[axis_rank(mesh, "data")])
    FN = M.function_monoid()
    red = M.shard_reduce(FN, x, mesh, "data")
    exc = M.shard_exclusive_scan(FN, x, mesh, "data")
    return dict(reduce=all_gather(red[None], mesh, "data").numpy(),
                exclusive=all_gather(exc[None], mesh, "data").numpy())


def case_odd_doc_count():
    """The reference's ValueError of scan, mapping and accepts on a doc
    count the mesh does not divide; locate and stream run locally, and so
    does the mapping of a doc shorter than n_chunks, which raises
    nothing."""
    from repro_torch.core.dfa import random_dfa
    from repro_torch.engine import ChunkPolicy, Scanner

    seeds, k, docs = scan_inputs()
    sc = Scanner.compile([random_dfa(n, k, seed=s) for n, s in seeds],
                         mode="enumeration", device=CPU,
                         distribution="shard_map",
                         chunking=ChunkPolicy(n_chunks=4))
    errors = []
    for call in (lambda: sc.scan(docs[:3]), lambda: sc.mapping(docs[0]),
                 lambda: sc.accepts(docs[0])):
        try:
            call()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    flat = docs.reshape(-1)
    streamed = sc.stream([flat[:100], flat[100:]])
    return dict(errors=errors, locate=sc.locate(flat, 2),
                stream=(streamed.mapping, streamed.accepted),
                short=sc.mapping(docs[0][:3]))


CASES = ("scan_sfa", "scan_enumeration", "scan_speculative", "construct_p4",
         "construct_p5", "scanner_construction", "census_windows",
         "corpus_job", "match_fn", "throughput_matcher", "bank_matcher_2x1",
         "bank_matcher_1x2", "shard_monoid", "odd_doc_count")


def run(rank: int, init_file: str, out_dir: str, src: str) -> None:
    """One rank: join the world, run every case, rank 0 writes results."""
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist

    # One intra-op thread a rank, as tests/_torch_threads.py does for a
    # test process: two ranks share the machine with the suite's workers.
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    from repro_torch.mesh import make_mesh

    meshes = {"data": make_mesh((WORLD,), ("data",), device=CPU),
              "2x1": make_mesh((2, 1), ("data", "model"), device=CPU),
              "1x2": make_mesh((1, 2), ("data", "model"), device=CPU)}
    results = {}
    for name in CASES:
        fn = globals()[f"case_{name}"]
        args = {"corpus_job": (out_dir,)}.get(name)
        if args is None:
            args = (meshes,) if fn.__code__.co_argcount else ()
        try:
            results[name] = ("ok", fn(*args))
        except Exception as e:  # recorded for the test, which reports it
            results[name] = ("error", type(e).__name__, str(e))
    if rank == 0:
        with open(os.path.join(out_dir, "results.pkl"), "wb") as f:
            pickle.dump(results, f)
    dist.destroy_process_group()
