"""The port's ``Scanner`` and executors against the reference's.

The whole slice: ``Scanner.compile(load_bank(), device="cpu")`` gives the
reference ``Scanner``'s hits, census and mappings with both scan modes in
play; and the port's executors, fed the reference's own stacked tables
through ``repro_torch.interop``, give the reference executors' mappings.
"""

from dataclasses import asdict

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.dfa import random_dfa as jrandom_dfa  # noqa: E402
from repro.core.prosite import load_bank as jload_bank  # noqa: E402
from repro.engine import ChunkPolicy as JChunkPolicy  # noqa: E402
from repro.engine import ConstructionPolicy as JConstructionPolicy  # noqa: E402
from repro.engine import ScanPlan as JScanPlan  # noqa: E402
from repro.engine import Scanner as JScanner  # noqa: E402
from repro.engine import SpeculationPolicy as JSpeculationPolicy  # noqa: E402
from repro.engine import executors as JX  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.construction import StateBlowup  # noqa: E402
from repro_torch.core.dfa import random_dfa  # noqa: E402
from repro_torch.core.prosite import load_bank, synthetic_protein  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    ChunkPolicy,
    ConstructionPolicy,
    ScanPlan,
    Scanner,
    SpeculationPolicy,
)
from repro_torch.engine import executors as X  # noqa: E402
from repro_torch.engine.scanner import (  # noqa: E402
    SCAN_LADDER_RATIO,
    _reference_doc_mappings,
)
from repro_torch.interop import bank_from_arrays, sfa_stack_from_arrays  # noqa: E402

N_CHUNKS = 4
# Lengths 48 and 40 split into whole chunks; 37 leaves a ragged tail; 3 is
# all tail; the empty doc has no symbols at all.
DOCS = ([synthetic_protein(48, seed=i) for i in range(3)]
        + [synthetic_protein(37, seed=9), synthetic_protein(40, seed=4),
           synthetic_protein(3, seed=5), ""])


@pytest.fixture(scope="module")
def scanners():
    """The bundled bank compiled once by each package, default budget. Both
    construct without their process-wide SFA caches, so each construction
    report is its own whatever ran before in the process."""
    port = Scanner.compile(load_bank(), device="cpu",
                           chunking=ChunkPolicy(n_chunks=N_CHUNKS),
                           construction=ConstructionPolicy(cache="off"))
    ref = JScanner.compile(jload_bank(), JScanPlan(
        mode="auto", backend="xla", chunking=JChunkPolicy(n_chunks=N_CHUNKS),
        construction=JConstructionPolicy(cache="off")))
    return port, ref


def test_scanner_bit_identical_to_reference_on_bundled_bank(scanners):
    port, ref = scanners
    assert {"sfa", "enumeration"} == set(port.pattern_modes.values())
    assert port.pattern_modes == ref.pattern_modes
    got, want = port.scan(DOCS), ref.scan(DOCS)
    assert got.ids == want.ids
    assert np.array_equal(got.hits, want.hits)
    assert np.array_equal(port.census(DOCS), ref.census(DOCS))
    for doc in (DOCS[0], DOCS[3], DOCS[5]):
        assert np.array_equal(port.mapping(doc), ref.mapping(doc))
    assert np.array_equal(port.accepts(DOCS[1]), ref.accepts(DOCS[1]))
    r = port.construction_report
    assert (r.rounds, r.blown, r.constructed) == (
        ref.construction_report.rounds, 5, 18)


def test_reference_backend_and_corpus_array_agree(scanners):
    port, _ = scanners
    rng = np.random.default_rng(11)
    corpus = rng.integers(0, 20, size=(6, 44)).astype(np.int32)
    want = port.scan(list(corpus)).hits
    assert np.array_equal(port.scan(corpus).hits, want)
    reference = Scanner.compile(load_bank(), device="cpu",
                                backend="reference",
                                chunking=ChunkPolicy(n_chunks=N_CHUNKS))
    assert np.array_equal(reference.scan(corpus).hits, want)
    assert np.array_equal(reference.mapping(corpus[0]),
                          port.mapping(corpus[0]))


@pytest.mark.parametrize("mode", ["sfa", "enumeration"])
def test_forced_modes_match_reference(mode):
    k = 6
    dfas = [random_dfa(n, k, seed=70 + n) for n in (3, 5, 4)]
    jdfas = [jrandom_dfa(n, k, seed=70 + n) for n in (3, 5, 4)]
    rng = np.random.default_rng(5)
    docs = [rng.integers(0, k, size=L).astype(np.int32) for L in (32, 30, 9)]
    port = Scanner.compile(dfas, device="cpu", mode=mode,
                           sfa_state_budget=10_000,
                           chunking=ChunkPolicy(n_chunks=4, bucket=True,
                                                bucket_edges=(4, 8)))
    ref = JScanner.compile(jdfas, JScanPlan(
        mode=mode, sfa_state_budget=10_000,
        chunking=JChunkPolicy(n_chunks=4)))
    assert set(port.pattern_modes.values()) == {mode}
    if mode == "enumeration":                        # DFA sizes 3, 4 | 5
        assert len(port.groups) == 2
    assert np.array_equal(port.scan(docs).hits, ref.scan(docs).hits)
    assert np.array_equal(port.mapping(docs[1]), ref.mapping(docs[1]))


def test_executors_fed_through_interop_match_reference(scanners):
    """The reference's own stacked tables, deltas and SFA mapping stacks,
    carried over as NumPy, through both packages' executors."""
    _, ref = scanners
    rng = np.random.default_rng(3)
    corpus = rng.integers(0, 20, size=(5, 32)).astype(np.int32)
    checked = set()
    for g in ref.groups:
        bank = bank_from_arrays(
            np.asarray(g.tables), g.bank.accepting, g.bank.starts,
            g.bank.n_states, g.bank.ids, g.bank.alphabet)
        tables, accepting, starts = bank.to("cpu")
        ct = torch.from_numpy(corpus)
        if g.mode == "sfa":
            deltas, maps, sizes = sfa_stack_from_arrays(
                np.asarray(g.deltas), np.asarray(g.sfa_maps), g.sfa_states,
                device="cpu")
            assert np.array_equal(sizes, g.sfa_states)
            got = X.bank_doc_mappings_sfa(deltas, maps, ct, N_CHUNKS)
            want = JX.bank_doc_mappings_sfa(g.deltas, g.sfa_maps,
                                            jnp.asarray(corpus), N_CHUNKS)
        else:
            got = X.bank_doc_mappings(tables, ct, N_CHUNKS)
            want = JX.bank_doc_mappings(g.tables, jnp.asarray(corpus),
                                        N_CHUNKS)
        assert np.array_equal(got.numpy(), np.asarray(want))
        hits = X.hits_of_mappings(got, accepting, starts)
        want_hits = np.asarray(JX._hits_of_mappings(
            want, jnp.asarray(g.bank.accepting), jnp.asarray(g.bank.starts)))
        assert np.array_equal(hits.numpy(), want_hits)
        checked.add(g.mode)
    assert checked == {"sfa", "enumeration"}


def test_sequential_tail_helpers_match_reference():
    rng = np.random.default_rng(8)
    tables = rng.integers(0, 7, size=(3, 7, 5)).astype(np.int32)
    mapping = rng.integers(0, 7, size=(3, 7)).astype(np.int32)
    states = rng.integers(0, 7, size=(3, 4)).astype(np.int32)
    syms = rng.integers(0, 5, size=9).astype(np.int32)
    tail = rng.integers(0, 5, size=(4, 6)).astype(np.int32)
    assert np.array_equal(X.compose_sequential(tables, mapping, syms),
                          JX.compose_sequential(tables, mapping, syms))
    got = X.advance_states_sequential(torch.from_numpy(tables),
                                      torch.from_numpy(states),
                                      torch.from_numpy(tail))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(),
                          JX.advance_states_sequential(tables, states, tail))


def test_auto_blowup_tiers():
    """Budget blowups: mode='sfa' raises StateBlowup, a small DFA falls
    back to enumeration, and a blowup of a DFA with >= 128 states goes to
    auto's speculative tier, whose scan equals the reference's."""
    small = random_dfa(8, 8, seed=1)
    with pytest.raises(StateBlowup):
        Scanner.compile([small], device="cpu", mode="sfa",
                        sfa_state_budget=12)
    sc = Scanner.compile([small], device="cpu", sfa_state_budget=12)
    assert sc.pattern_modes == {"pattern_0": "enumeration"}
    big = random_dfa(130, 4, seed=2)
    sc = Scanner.compile([big], device="cpu", sfa_state_budget=16)
    assert sc.pattern_modes == {"pattern_0": "speculative"}
    ref = JScanner.compile([jrandom_dfa(130, 4, seed=2)],
                           JScanPlan(sfa_state_budget=16))
    docs = np.random.default_rng(2).integers(0, 4, (3, 70)).astype(np.int32)
    got, want = sc.scan(docs), ref.scan(docs)
    assert np.array_equal(got.hits, want.hits)
    assert asdict(got.speculation) == asdict(want.speculation)


def test_plan_validation():
    assert ScanPlan().device == "cuda" and ScanPlan().backend == "kernel"
    assert ConstructionPolicy().cache == "shared"
    for bad in (dict(backend="xla"), dict(backend="pallas"),
                dict(mode="parallel"),
                dict(device="tpu"), dict(sfa_state_budget=0),
                dict(construction=ConstructionPolicy(cache="private")),
                dict(construction=ConstructionPolicy(store=42)),
                dict(chunking=ChunkPolicy(n_chunks=0))):
        with pytest.raises(ValueError):
            ScanPlan(**bad).validate()
    with pytest.raises(ValueError):
        Scanner.compile("RG", device="cpu").scan([np.asarray([0, 25])])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Scanner.compile("RG")


def test_interop_validates_arrays():
    tables = np.zeros((2, 3, 20), dtype=np.int32)
    with pytest.raises(ValueError):
        bank_from_arrays(tables + 3, np.zeros((2, 3), bool), [0, 0])
    with pytest.raises(ValueError):
        bank_from_arrays(tables, np.zeros((2, 4), bool), [0, 0])
    with pytest.raises(ValueError):
        sfa_stack_from_arrays(np.zeros((1, 2, 20)), np.zeros((1, 3, 4)), [2])
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            sfa_stack_from_arrays(np.zeros((1, 2, 20), np.int32),
                                  np.zeros((1, 2, 4), np.int32), [2])
    bank = bank_from_arrays(tables, np.zeros((2, 3), bool), [0, 0])
    assert bank.n_patterns == 2 and list(bank.n_states) == [3, 3]


# --------------------------------------------------------------------------
# Scan's length ladder: docs of neighbouring lengths share one batch, padded
# with the neutral pad symbol k to a multiple of n_chunks
# --------------------------------------------------------------------------

LADDER_K = 6
# The edge cases around n_chunks = 8, then 24 distinct lengths over rungs
# 48..304 of the ladder (rung tops 56, 72, 96, 120, 152, 192, 240, 304).
LADDER_LENGTHS = ([0, 1, 3, 7, 8, 9, 37, 40, 48]
                  + sorted(np.random.default_rng(21).choice(
                      np.arange(49, 300), 24, replace=False).tolist()))


def _ladder_docs(seed=0, lengths=LADDER_LENGTHS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, LADDER_K, size=L).astype(np.int32)
            for L in lengths]


def _ladder_scanner(mode, **plan):
    """Small random DFAs under a forced mode; ``"mixed"`` is auto mode with
    a budget that leaves one SFA, sends two DFAs to enumeration and the
    40-state one to speculation."""
    sizes = (3, 5, 4, 40) if mode == "mixed" else (3, 5, 4)
    dfas = [random_dfa(n, LADDER_K, seed=90 + n) for n in sizes]
    if mode == "mixed":
        return Scanner.compile(dfas, device="cpu", mode="auto",
                               sfa_state_budget=60,
                               speculation=SpeculationPolicy(auto_states=20),
                               **plan)
    return Scanner.compile(dfas, device="cpu", mode=mode,
                           sfa_state_budget=10_000, **plan)


def _jax_ladder_scanner(mode):
    """:func:`_ladder_scanner`'s bank and plan in the JAX package."""
    sizes = (3, 5, 4, 40) if mode == "mixed" else (3, 5, 4)
    dfas = [jrandom_dfa(n, LADDER_K, seed=90 + n) for n in sizes]
    if mode == "mixed":
        return JScanner.compile(dfas, JScanPlan(
            mode="auto", sfa_state_budget=60,
            speculation=JSpeculationPolicy(auto_states=20)))
    return JScanner.compile(dfas, JScanPlan(mode=mode,
                                            sfa_state_budget=10_000))


def _walked_hits(scanner, docs):
    """Each doc walked alone through the host tables, symbol by symbol."""
    hits = np.zeros((scanner.n_patterns, len(docs)), dtype=bool)
    for g in scanner.groups:
        for d, doc in enumerate(docs):
            maps = _reference_doc_mappings(g.bank.tables,
                                           np.asarray(doc)[None])[:, 0]
            finals = maps[np.arange(len(g.indices)), g.bank.starts]
            hits[g.indices, d] = g.bank.accepting[
                np.arange(len(g.indices)), finals]
    return hits


def _ladder_tops(top, n_chunks=8):
    """The ladder's rung tops up to ``top``, restated: each the last times
    the ratio, rounded up to a multiple of n_chunks."""
    tops = [n_chunks]
    while tops[-1] < top:
        tops.append(max(tops[-1] + n_chunks,
                        int(np.ceil(np.ceil(tops[-1] * SCAN_LADDER_RATIO)
                                    / n_chunks)) * n_chunks))
    return tops


def _counted(fn, *names):
    before = obs.snapshot()
    out = fn()
    after = obs.snapshot()
    return out, [after.get(n, 0) - before.get(n, 0) for n in names]


@pytest.mark.parametrize("mode", ["sfa", "enumeration", "speculative",
                                  "mixed"])
def test_ladder_scan_equals_reference_backend_and_walks(mode):
    """Docs of lengths 0-48 around n_chunks and 24 distinct lengths over
    eight rungs, and a 2-D array of a length no multiple of n_chunks: the
    ``reference`` backend's hits (one batch a length) and each doc walked
    alone, and the JAX package's scanner on the same DFAs and plan, bit
    for bit; speculation's stats stay the exact-length scan's and the JAX
    package's."""
    port = _ladder_scanner(mode)
    ref = _ladder_scanner(mode, backend="reference")
    jax_ref = _jax_ladder_scanner(mode)
    assert port.pattern_modes == jax_ref.pattern_modes
    if mode == "mixed":
        assert set(port.pattern_modes.values()) == {
            "sfa", "enumeration", "speculative"}
    docs = _ladder_docs()
    got, want, jwant = port.scan(docs), ref.scan(docs), jax_ref.scan(docs)
    assert np.array_equal(got.hits, want.hits)
    assert np.array_equal(got.hits, jwant.hits)
    assert np.array_equal(got.hits, _walked_hits(port, docs))
    assert got.hits.any() and not got.hits.all()
    arr = np.random.default_rng(4).integers(
        0, LADDER_K, size=(9, 50)).astype(np.int32)
    got2, want2, jwant2 = port.scan(arr), ref.scan(arr), jax_ref.scan(arr)
    assert np.array_equal(got2.hits, want2.hits)
    assert np.array_equal(got2.hits, jwant2.hits)
    assert np.array_equal(got2.hits, _walked_hits(port, list(arr)))
    if mode in ("speculative", "mixed"):
        assert got.speculation.total_chunks > 0
        for a, b in ((got, want), (got, jwant), (got2, want2),
                     (got2, jwant2)):
            assert asdict(a.speculation) == asdict(b.speculation)


@pytest.mark.parametrize("mode", ["sfa", "enumeration", "speculative"])
def test_ladder_refuses_the_pad_symbol(mode):
    """The pad symbol k is the scanner's, never the user's: a doc holding it
    is refused before any padding, in a list and in a 2-D array."""
    port = _ladder_scanner(mode)
    assert port.n_symbols == LADDER_K
    bad = np.asarray([0, 1, LADDER_K, 2], dtype=np.int32)
    with pytest.raises(ValueError, match="symbols must lie"):
        port.scan([np.zeros(9, np.int32), bad])
    with pytest.raises(ValueError, match="symbols must lie"):
        port.scan(np.stack([bad, bad]))


@pytest.mark.parametrize("mode", ["sfa", "enumeration", "speculative"])
def test_ladder_launches_one_walk_a_rung(mode):
    """N docs of distinct lengths: one walk a group for each occupied rung
    in modes sfa and enumeration, and pad symbols as the ladder implies; a
    speculative group walks each ladder batch a length at a time (its chunk
    statistics are the reference's), so a bank of speculative groups alone
    walks no pad."""
    lengths = LADDER_LENGTHS[4:]                      # 8 and up, distinct
    docs = _ladder_docs(1, lengths)
    port = _ladder_scanner(mode)
    assert len(port.groups) == 1
    res, (calls, pads, real) = _counted(
        lambda: port.scan(docs), "kernels.match_bank_chunks.calls",
        "engine.scan_pad_symbols", "engine.scan_symbols")
    assert real == sum(lengths)
    if mode == "speculative":
        assert pads == 0
        assert res.speculation.fallback_lanes == 0
        assert calls == len(lengths)
        return
    tops = _ladder_tops(max(lengths))
    rungs = {}
    for L in lengths:
        rungs.setdefault(np.searchsorted(tops, L), []).append(L)
    assert calls == len(rungs) < len(lengths)
    assert len(rungs) >= 3
    want = sum(len(ls) * (-(-max(ls) // 8) * 8) - sum(ls)
               for ls in rungs.values())
    assert pads == want > 0


def test_ladder_pads_a_2d_array_on_the_device():
    """A 2-D array is one batch: 50 symbols a row walk as 56, one launch."""
    port = _ladder_scanner("sfa")
    arr = np.random.default_rng(6).integers(
        0, LADDER_K, size=(12, 50)).astype(np.int32)
    _, (calls, pads, real) = _counted(
        lambda: port.scan(arr), "kernels.match_bank_chunks.calls",
        "engine.scan_pad_symbols", "engine.scan_symbols")
    assert (calls, pads, real) == (1, 12 * 6, 12 * 50)


@pytest.mark.parametrize("mode", ["sfa", "enumeration", "speculative"])
def test_one_sequence_paths_keep_exact_lengths(mode):
    """``mapping``, ``locate`` and ``census_windows`` of one sequence, each
    walked as one batch padded with the pad symbol to a multiple of
    n_chunks: the ``reference`` backend's results, which compose at the
    docs' own lengths, on the ladder's docs."""
    port = _ladder_scanner(mode)
    ref = _ladder_scanner(mode, backend="reference")
    docs = _ladder_docs(2)
    for doc in docs[1:10] + docs[-2:]:
        assert np.array_equal(port.mapping(doc), ref.mapping(doc))
        for p in range(port.n_patterns):
            assert np.array_equal(port.locate(doc, p), ref.locate(doc, p))
    seq = np.concatenate(docs[-3:])
    for window, stride in ((48, 8), (40, 40), (37, 37)):
        assert np.array_equal(port.census_windows(seq, window, stride).hits,
                              ref.census_windows(seq, window, stride).hits)


def _no_sequential_walk(*args, **kwargs):
    raise AssertionError("a walk outside speculation went symbol by symbol")


@pytest.mark.parametrize("mode", ["sfa", "enumeration"])
def test_one_sequence_paths_walk_no_ragged_tail(mode, monkeypatch):
    """``mapping`` of docs of 1, 13 and 50 symbols at n_chunks 8,
    ``census_windows`` at strides 37 and 8, and a stream whose ``finish``
    has a ragged tail each walk one batch padded with the pad symbol: one
    ``match_bank_chunks`` walk a group and call, none symbol by symbol, and
    the JAX package's results."""
    monkeypatch.setattr(X, "advance_states_sequential", _no_sequential_walk)
    port, ref = _ladder_scanner(mode), _jax_ladder_scanner(mode)
    assert port.plan.chunking.n_chunks == 8
    walks = len(port.groups)
    rng = np.random.default_rng(41)

    def walked(fn):
        out, (calls,) = _counted(fn, "kernels.match_bank_chunks.calls")
        assert calls == walks
        return out

    for L in (1, 13, 50):
        doc = rng.integers(0, LADDER_K, L).astype(np.int32)
        assert np.array_equal(walked(lambda: port.mapping(doc)),
                              ref.mapping(doc))
    seq = rng.integers(0, LADDER_K, 400).astype(np.int32)
    for window, stride in ((37, 37), (48, 8)):
        got = walked(lambda: port.census_windows(seq, window, stride))
        assert np.array_equal(got.hits,
                              ref.census_windows(seq, window, stride).hits)
    super_len = port.plan.chunking.n_chunks * port.plan.chunking.block_len
    pieces = [seq[:300], rng.integers(0, LADDER_K, super_len).astype(
        np.int32), seq[300:313]]
    sess = port.open_stream()
    for piece in pieces:
        sess.feed(piece)
    assert len(sess._buf) == 313 and 313 % 8
    got = walked(sess.finish)
    want = ref.stream(pieces)
    assert np.array_equal(got.mapping, want.mapping)
    assert np.array_equal(got.accepted, want.accepted)


@pytest.mark.parametrize("bank", ["sfa", "default_512"])
def test_census_windows_in_place_equal_materialised_windows(bank, scanners):
    """``census_windows`` at window = 8 strides over a sequence whose last
    tile of 8 blocks is partial (66 blocks): the scan of the materialised
    windows, on SFA groups alone and on the bundled bank's default plan
    (budget 512: SFA and enumeration groups); each group makes 7 combines
    into the window workspace (3 suffix steps, 3 prefix steps, the stitch),
    all of the ``compose`` calls, and folds its blocks once (the SFA
    groups' rows fold; an enumeration group's one ``compose_fold``)."""
    if bank == "sfa":
        port = _ladder_scanner("sfa")
        seq = np.random.default_rng(42).integers(
            0, LADDER_K, 400).astype(np.int32)
    else:
        port = scanners[0]
        seq = synthetic_protein(400, seed=42)
    window, stride = 48, 6
    n_win = (len(seq) - window) // stride + 1
    assert (n_win + 7) % 8
    got, (combines, composes, folds, rows_folds) = _counted(
        lambda: port.census_windows(seq, window, stride),
        "engine.window_combines_in_place", "kernels.compose.calls",
        "kernels.compose_fold.calls", "kernels.compose_fold_rows.calls")
    naive = port.scan([seq[i * stride: i * stride + window]
                       for i in range(n_win)])
    assert got.hits.shape == (port.n_patterns, n_win)
    assert np.array_equal(got.hits, naive.hits)
    modes = [g.mode for g in port.groups]
    assert combines == composes == 7 * len(modes)
    assert (folds, rows_folds) == (modes.count("enumeration"),
                                   modes.count("sfa"))
    if bank == "sfa":
        assert folds == 0


# --------------------------------------------------------------------------
# Encoding: a request's strings joined and looked up in the scanner's symbol
# table at once, over their code points
# --------------------------------------------------------------------------

AMINO = "ACDEFGHIKLMNPQRSTVWY"


def _dict_encode(alphabet, text):
    """The per-character dict lookup the table stands in for."""
    sym = {c: i for i, c in enumerate(alphabet)}
    return np.asarray([sym[c] for c in text], dtype=np.int32)


def _text(alphabet, rng, length):
    return "".join(np.asarray(list(alphabet))[rng.integers(
        0, len(alphabet), length)])


def _as_text(scanner, symbols):
    return "".join(scanner.alphabet[s] for s in symbols)


@pytest.mark.parametrize("length", [0, 1, 2, 19, 20, 333, 1024, 2000])
def test_encode_equals_dict_and_reference(scanners, length):
    port, ref = scanners
    assert port.alphabet == AMINO
    text = _text(AMINO, np.random.default_rng(length), length)
    got = port.encode(text)
    assert got.dtype == np.int32 and got.shape == (length,)
    assert np.array_equal(got, _dict_encode(AMINO, text))
    assert np.array_equal(got, np.asarray(ref.encode(text)))


def test_encoded_str_and_array_docs_equal_each_alone(scanners):
    """Strings of lengths 0-2,000, the empty string and one character mixed
    with int32 arrays: each string's symbols are its own encode's and the
    reference's, each array passes through as int32."""
    port, ref = scanners
    rng = np.random.default_rng(31)
    strs = [_text(AMINO, rng, L) for L in rng.integers(0, 2001, 40)]
    arrs = [rng.integers(0, 20, L).astype(np.int64) for L in (0, 5, 77)]
    docs = (["", "W"] + strs[:10] + [arrs[0]] + strs[10:30] + arrs[1:]
            + strs[30:] + [""])
    enc = port._encoded(docs)
    assert len(enc) == len(docs)
    for d, e, want in zip(docs, enc, ref._encode_docs(docs)):
        assert e.dtype == np.int32
        assert np.array_equal(e, np.asarray(want))
        assert np.array_equal(e, port.encode(d) if isinstance(d, str) else d)
    assert [len(e) for e in port._encoded("MKV")] == [3]


@pytest.mark.parametrize("which", ["ladder", "proteins"])
def test_ladder_batches_of_strings_equal_those_of_arrays(scanners, which):
    """The ladder's batches of a list of strings are those of the same docs
    handed pre-encoded as int32 arrays: rows, widths, pad and lengths."""
    if which == "ladder":
        port = _ladder_scanner("sfa")
        ints = _ladder_docs(7)
    else:
        port = scanners[0]
        rng = np.random.default_rng(2531)
        lengths = np.clip(rng.lognormal(5.70, 0.60, 256).astype(int), 2, None)
        ints = [rng.integers(0, 20, L).astype(np.int32) for L in lengths]
    strs = [_as_text(port, d) for d in ints]
    got, want = port._batches(strs), port._batches(ints)
    assert len(got) == len(want) >= 3
    for (gi, gc, gl), (wi, wc, wl) in zip(got, want):
        assert np.array_equal(gi, wi) and np.array_equal(gl, wl)
        assert gc.dtype == wc.dtype == np.int32
        assert gc.shape == wc.shape and np.array_equal(gc, wc)
        assert gc.shape[1] % port.plan.chunking.n_chunks == 0
        for row, d in zip(gc, gi):
            assert np.array_equal(row[:len(ints[d])], ints[d])
            assert (row[len(ints[d]):] == port.n_symbols).all()


@pytest.mark.parametrize("mode", ["sfa", "enumeration", "speculative",
                                  "mixed"])
def test_scan_of_str_and_array_docs_equals_reference_backend(mode):
    port = _ladder_scanner(mode)
    ref = _ladder_scanner(mode, backend="reference")
    ints = _ladder_docs(3)
    docs = [_as_text(port, d) if i % 2 else d for i, d in enumerate(ints)]
    got = port.scan(docs)
    assert np.array_equal(got.hits, ref.scan(docs).hits)
    assert np.array_equal(got.hits, port.scan(ints).hits)
    assert got.hits.any() and not got.hits.all()


def _bad_docs(case):
    """Docs holding a character outside the amino-acid alphabet, and the
    first such character."""
    rng = np.random.default_rng(17)
    docs = [_text(AMINO, rng, 60) for _ in range(250)]
    if case == "200th_string":
        docs[199] = docs[199][:20] + "B" + docs[199][20:] + "Z"
        docs[230] = "X" + docs[230]
        return docs, "B"
    bad = {"lowercase": "k", "X": "X", "non_ascii": "é",
           "astral": "\U0001d538"}[case]
    return [docs[0][:31] + bad + docs[0][31:] + "x"], bad


@pytest.mark.parametrize("case", ["lowercase", "X", "non_ascii", "astral",
                                  "200th_string"])
def test_unknown_character_raises_the_references_key_error(scanners, case):
    port, ref = scanners
    docs, first = _bad_docs(case)
    for call in (lambda s: s.scan(docs), lambda s: s.encode("".join(docs)),
                 lambda s: s.mapping(docs[-1] if len(docs) == 1 else
                                     docs[199])):
        with pytest.raises(KeyError) as mine:
            call(port)
        with pytest.raises(KeyError) as theirs:
            call(ref)
        assert mine.value.args == theirs.value.args == (first,)


@pytest.mark.parametrize("source", ["regex", "random"])
def test_non_ascii_alphabet_encodes_as_the_dict_does(source):
    """An alphabet of characters past ASCII (one beyond the basic plane):
    the table gives the dict's symbols, and its KeyError for a character
    outside it, and scans of strings equal those of the symbols."""
    from repro_torch.core.dfa import compile_dfa

    if source == "regex":
        alphabet = "aαβγЖ\U0001d538"
        dfa = compile_dfa("βγ", alphabet)
    else:
        dfa = random_dfa(6, 40, seed=3)
        alphabet = dfa.alphabet
        assert max(map(ord, alphabet)) > 127
    assert dfa.alphabet == alphabet
    port = Scanner.compile([dfa], device="cpu",
                           chunking=ChunkPolicy(n_chunks=N_CHUNKS))
    rng = np.random.default_rng(8)
    strs = [_text(alphabet, rng, L) for L in (0, 1, 7, 40, 333)]
    for s in strs:
        assert np.array_equal(port.encode(s), _dict_encode(alphabet, s))
        assert np.array_equal(port.encode(s), dfa.encode(s))
    ints = [_dict_encode(alphabet, s) for s in strs]
    assert np.array_equal(port.scan(strs).hits, port.scan(ints).hits)
    for bad in ("Z", "δ", "\U0001d539", "\ud800"):
        with pytest.raises(KeyError) as e:
            port.encode(strs[3] + bad + alphabet)
        assert e.value.args == (bad,)
