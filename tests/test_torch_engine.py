"""The port's ``Scanner`` and executors against the reference's.

The whole slice: ``Scanner.compile(load_bank(), device="cpu")`` gives the
reference ``Scanner``'s hits, census and mappings with both scan modes in
play; and the port's executors, fed the reference's own stacked tables
through ``repro_torch.interop``, give the reference executors' mappings.
"""

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
from repro.engine import executors as JX  # noqa: E402
from repro_torch.construction import StateBlowup  # noqa: E402
from repro_torch.core.dfa import random_dfa  # noqa: E402
from repro_torch.core.prosite import load_bank, synthetic_protein  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    ChunkPolicy,
    ConstructionPolicy,
    ScanPlan,
    Scanner,
)
from repro_torch.engine import executors as X  # noqa: E402
from repro_torch.interop import bank_from_arrays, sfa_stack_from_arrays  # noqa: E402

N_CHUNKS = 4
# Lengths 48 and 40 split into whole chunks; 37 leaves a ragged tail; 3 is
# all tail; the empty doc has no symbols at all.
DOCS = ([synthetic_protein(48, seed=i) for i in range(3)]
        + [synthetic_protein(37, seed=9), synthetic_protein(40, seed=4),
           synthetic_protein(3, seed=5), ""])


@pytest.fixture(scope="module")
def scanners():
    """The bundled bank compiled once by each package, default budget. The
    reference constructs without its process-wide SFA cache, so its
    construction report is its own whatever ran before in the process."""
    port = Scanner.compile(load_bank(), device="cpu",
                           chunking=ChunkPolicy(n_chunks=N_CHUNKS))
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
                np.asarray(g.deltas), np.asarray(g.sfa_maps), g.sfa_states)
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
    """Budget blowups: mode='sfa' raises StateBlowup, and a blowup of a
    DFA with >= 128 states (auto's speculative tier, not ported yet) raises
    NotImplementedError instead of scanning it some other way."""
    small = random_dfa(8, 8, seed=1)
    with pytest.raises(StateBlowup):
        Scanner.compile([small], device="cpu", mode="sfa",
                        sfa_state_budget=12)
    sc = Scanner.compile([small], device="cpu", sfa_state_budget=12)
    assert sc.pattern_modes == {"pattern_0": "enumeration"}
    big = random_dfa(130, 4, seed=2)
    with pytest.raises(NotImplementedError, match="speculative"):
        Scanner.compile([big], device="cpu", sfa_state_budget=16)


def test_plan_validation():
    assert ScanPlan().device == "cuda" and ScanPlan().backend == "kernel"
    for bad in (dict(backend="xla"), dict(backend="pallas"),
                dict(mode="speculative"),
                dict(device="tpu"), dict(sfa_state_budget=0),
                dict(construction=ConstructionPolicy(cache="shared")),
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
    bank = bank_from_arrays(tables, np.zeros((2, 3), bool), [0, 0])
    assert bank.n_patterns == 2 and list(bank.n_states) == [3, 3]
