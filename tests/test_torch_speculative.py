"""The port's speculative scanning against the reference's.

Mirrors ``tests/test_speculative.py``: speculation moves *work*, never
*results*. Each case runs the same patterns and documents, made from a
numpy seed, through both packages' ``Scanner`` (the port on the CPU, where
the kernel wrappers take their plain versions) and holds the hit matrices
and the :class:`SpeculationStats` equal, field for field. The executor's
two stages are also held, on their own, against
``repro.speculative.speculative_bank_finals`` on all five outputs.
"""

from dataclasses import asdict

import pytest

torch = pytest.importorskip("torch")

from _strategies import given, settings, st  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.dfa import DFA as JDFA  # noqa: E402
from repro.core.dfa import random_dfa as jrandom_dfa  # noqa: E402
from repro.core.prosite import load_bank as jload_bank  # noqa: E402
from repro.engine import ChunkPolicy as JChunkPolicy  # noqa: E402
from repro.engine import ConstructionPolicy as JConstructionPolicy  # noqa: E402
from repro.engine import ScanPlan as JScanPlan  # noqa: E402
from repro.engine import Scanner as JScanner  # noqa: E402
from repro.engine import SpeculationPolicy as JSpeculationPolicy  # noqa: E402
from repro.speculative import profile_hot_states as jprofile  # noqa: E402
from repro.speculative import speculative_bank_finals as jfinals  # noqa: E402
from repro.speculative import stack_profile_states as jstack  # noqa: E402
from repro_torch.core.dfa import DFA, random_dfa  # noqa: E402
from repro_torch.core.prosite import load_bank, synthetic_protein  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    ChunkPolicy,
    ConstructionPolicy,
    ScanPlan,
    Scanner,
    SpeculationPolicy,
)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.speculative import (  # noqa: E402
    HotStateProfile,
    SpeculationStats,
    distributed_speculative_finals_fn,
    profile_hot_states,
    speculative_bank_finals,
    stack_profile_states,
)

CPU = "cpu"


def _random_docs(seed, n_docs, length, k):
    rng = np.random.default_rng(seed)
    return rng.integers(0, k, size=(n_docs, length)).astype(np.int32)


def _two_state_dfa(cls, n_states=6, k=4):
    """Only states {0, 1} are reachable (they alternate on every symbol);
    states 2..n-1 exist so a profile can speculate unreachable ones."""
    table = np.zeros((n_states, k), dtype=np.int32)
    table[0, :] = 1
    table[1, :] = 0
    for s in range(2, n_states):
        table[s, :] = s
    accepting = np.zeros(n_states, dtype=bool)
    accepting[1] = True
    return cls(table=table, start=0, accepting=accepting, alphabet="abcd"[:k])


def _pair(patterns, jpatterns, mode="speculative", speculation=None,
          **plan):
    """The same patterns compiled by each package under one plan."""
    spec = speculation or {}
    port = Scanner.compile(patterns, ScanPlan(
        mode=mode, device=CPU, speculation=SpeculationPolicy(**spec),
        construction=ConstructionPolicy(cache="off"), **plan))
    jplan = {k: (JChunkPolicy(**vars(v)) if isinstance(v, ChunkPolicy) else v)
             for k, v in plan.items()}
    jref = JScanner.compile(jpatterns, JScanPlan(
        mode=mode, speculation=JSpeculationPolicy(**spec),
        construction=JConstructionPolicy(cache="off"), **jplan))
    return port, jref


def _assert_same_scan(port, jref, docs):
    got, want = port.scan(docs), jref.scan(docs)
    assert np.array_equal(got.hits, want.hits)
    assert isinstance(got.speculation, SpeculationStats)
    assert asdict(got.speculation) == asdict(want.speculation)
    return got


# --------------------------------------------------------------------------
# Policy validation
# --------------------------------------------------------------------------


def test_speculation_policy_validation():
    for bad in [dict(m=0), dict(sample_frac=0.0), dict(sample_frac=1.5),
                dict(max_sample=0), dict(max_repair_rounds=0),
                dict(auto_states=0), dict(profile_source="magic"),
                dict(profile_source=42)]:
        with pytest.raises(ValueError):
            SpeculationPolicy(**bad).validate()
        with pytest.raises(ValueError):         # as the reference refuses it
            JSpeculationPolicy(**bad).validate()
    assert asdict(SpeculationPolicy()) == asdict(JSpeculationPolicy())
    assert ScanPlan(mode="speculative").validate().speculation.m == 8
    pol = SpeculationPolicy().with_(m=4, profile_source="store")
    assert (pol.m, pol.profile_source) == (4, "store")
    SpeculationPolicy(profile_source=[0, 1, 2]).validate()
    SpeculationPolicy(profile_source={"p": [0]}).validate()


# --------------------------------------------------------------------------
# Bit-identity: bundled bank, random DFAs, forced misspeculation
# --------------------------------------------------------------------------


def test_bundled_bank_bit_identity():
    """mode='speculative' on the full bundled bank: the reference's hits and
    stats, and the port's own enumeration scan's hits."""
    docs = [synthetic_protein(60 + 17 * i, seed=i) for i in range(8)]
    port, jref = _pair(load_bank(), jload_bank(),
                       chunking=ChunkPolicy(n_chunks=4))
    got = _assert_same_scan(port, jref, docs)
    en = Scanner.compile(load_bank(), device=CPU, mode="enumeration",
                         chunking=ChunkPolicy(n_chunks=4))
    assert np.array_equal(got.hits, en.scan(docs).hits)
    assert got.speculation.total_chunks > 0
    assert port.last_speculation is got.speculation
    assert "speculation" in port.describe()


@settings(max_examples=6, deadline=None)
@given(
    seed=st.integers(min_value=0, max_value=10_000),
    n_states=st.integers(min_value=2, max_value=40),
    m=st.integers(min_value=1, max_value=6),
    sample_frac=st.floats(min_value=0.01, max_value=1.0),
)
def test_speculative_equals_reference_random(seed, n_states, m, sample_frac):
    """Random DFAs, ragged doc lengths (sub-chunk and empty docs too), any
    m and sample size: the reference's hits and stats."""
    k = 5
    dfas = [random_dfa(n_states, k, seed=seed + j) for j in range(3)]
    jdfas = [jrandom_dfa(n_states, k, seed=seed + j) for j in range(3)]
    rng = np.random.default_rng(seed)
    docs = [rng.integers(0, k, size=int(L)).astype(np.int32)
            for L in [0, 3, 17, 64, 64, 129]]
    port, jref = _pair(dfas, jdfas,
                       speculation=dict(m=m, sample_frac=sample_frac))
    s = _assert_same_scan(port, jref, docs).speculation
    assert s.repaired_chunks <= s.total_chunks
    if s.fallback_lanes == 0:
        assert s.hit_chunks + s.repaired_chunks == s.total_chunks


@pytest.mark.parametrize("max_rounds,fallback", [(8, False), (1, True)],
                         ids=["repairs everything", "repair bound falls back"])
def test_forced_misspeculation(max_rounds, fallback):
    """An unreachable-state profile forces a 0% hit rate: every chunk is
    repaired, or, with a bound too small to converge, unresolved lanes take
    the enumeration fallback — the reference's hits and stats either way."""
    docs = _random_docs(0, 4, 80, 4)           # 80 = 10 per chunk x 8 chunks
    port, jref = _pair(
        [_two_state_dfa(DFA)], [_two_state_dfa(JDFA)],
        speculation=dict(m=2, profile_source=np.asarray([2, 3]),
                         max_repair_rounds=max_rounds))
    s = _assert_same_scan(port, jref, docs).speculation
    assert s.hit_chunks == 0 and s.repair_rounds == max_rounds
    assert (s.fallback_lanes > 0) == fallback
    if not fallback:
        assert s.repaired_chunks == s.total_chunks


def test_perfect_profile_hits_everything():
    docs = _random_docs(2, 3, 40, 4)
    port, jref = _pair(
        [_two_state_dfa(DFA, n_states=4)], [_two_state_dfa(JDFA, n_states=4)],
        speculation=dict(m=4, profile_source=np.arange(4)))
    s = _assert_same_scan(port, jref, docs).speculation
    assert s.hit_rate == 1.0 and s.repair_rounds == 0
    assert s.repaired_chunks == 0 and s.fallback_lanes == 0


def test_explicit_profile_sources():
    docs = _random_docs(3, 2, 40, 4)
    port, jref = _pair({"p": _two_state_dfa(DFA)}, {"p": _two_state_dfa(JDFA)},
                       speculation=dict(m=2, profile_source={"p": [0, 1]}))
    _assert_same_scan(port, jref, docs)
    with pytest.raises(ValueError, match="missing pattern"):
        Scanner.compile({"p": _two_state_dfa(DFA)}, ScanPlan(
            mode="speculative", device=CPU,
            speculation=SpeculationPolicy(profile_source={"q": [0]}))
        ).scan(docs)
    with pytest.raises(ValueError, match="non-empty"):
        Scanner.compile({"p": _two_state_dfa(DFA)}, ScanPlan(
            mode="speculative", device=CPU,
            speculation=SpeculationPolicy(profile_source=[]))).scan(docs)


# --------------------------------------------------------------------------
# The executor on its own: both stages against the reference's five outputs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_executor_matches_reference_five_outputs(seed):
    """``match_bank_chunks(starts=)`` then ``spec_resolve`` (their plain
    versions, through the wrappers) against the reference's
    ``speculative_bank_finals``: finals, resolved, hits, repairs, rounds —
    with hits, repairs and unresolved lanes all occurring over the cases."""
    rng = np.random.default_rng(seed)
    P, n, k = 3, int(rng.integers(4, 30)), 4
    D, C, Lc, m = 5, 6, int(rng.integers(1, 9)), int(rng.integers(1, 5))
    tables = rng.integers(0, n, size=(P, n, k)).astype(np.int32)
    spec = rng.integers(0, n, size=(P, m)).astype(np.int32)
    starts = rng.integers(0, n, size=P).astype(np.int32)
    corpus = rng.integers(0, k, size=(D, C * Lc)).astype(np.int32)
    max_rounds = int(rng.integers(1, 4))
    want = [np.asarray(x) for x in jfinals(
        *(jnp.asarray(a) for a in (tables, spec, starts, corpus)),
        n_chunks=C, max_rounds=max_rounds)]
    t = [torch.from_numpy(a) for a in (tables, spec, starts, corpus)]
    got = speculative_bank_finals(*t, n_chunks=C, max_rounds=max_rounds)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), b)
    # the m-lane pass alone is the reference's chunk walk from each state
    exits = ops.match_bank_chunks(t[0], t[3].view(D * C, Lc), m, t[1])
    walk = ref.match_bank_chunks(t[0], t[3].view(D * C, Lc), n)
    assert torch.equal(exits, walk.gather(
        2, t[1].to(torch.int64)[:, None, :].expand(P, D * C, m)))


def test_executor_cases_cover_repairs_and_fallback():
    """The cases above do reach every branch: a hit-all, a repair-all and
    an unresolved case, checked here against the reference too."""
    dfa = _two_state_dfa(DFA)
    tables = torch.from_numpy(dfa.table[None].copy())
    corpus = torch.from_numpy(_random_docs(4, 3, 40, 4))
    starts = torch.zeros(1, dtype=torch.int32)
    for spec, rounds, resolved in (([0, 1], 8, True), ([2, 3], 8, True),
                                   ([2, 3], 2, False)):
        sp = torch.tensor([spec], dtype=torch.int32)
        got = speculative_bank_finals(tables, sp, starts, corpus, 8, rounds)
        want = jfinals(jnp.asarray(tables.numpy()), jnp.asarray(sp.numpy()),
                       jnp.asarray(starts.numpy()),
                       jnp.asarray(corpus.numpy()), n_chunks=8,
                       max_rounds=rounds)
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b))
        assert bool(got[1].all()) == resolved
    # the mesh path on a one-rank CPU world: the same five outputs
    from repro_torch.mesh import make_mesh

    dist_fn = distributed_speculative_finals_fn(
        make_mesh((1,), ("data",), device=CPU), n_chunks=8, max_rounds=2)
    sp = torch.tensor([[2, 3]], dtype=torch.int32)
    for a, b in zip(dist_fn(tables, sp, starts, corpus),
                    speculative_bank_finals(tables, sp, starts, corpus, 8, 2)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# Streaming
# --------------------------------------------------------------------------


def test_stream_equals_scan_speculative():
    """stream() under speculation carries exact states across blocks: the
    reference stream's finals, accepts and stats; no mapping by design."""
    ids = ["PS00001", "PS00007", "PS00010"]
    text = synthetic_protein(7000, seed=42)
    pieces = [text[i:i + 1234] for i in range(0, len(text), 1234)]
    port, jref = _pair(load_bank(ids), jload_bank(ids))
    rs, js = port.stream(pieces), jref.stream(pieces)
    assert rs.mapping is None and js.mapping is None
    assert np.array_equal(rs.final_states, js.final_states)
    assert np.array_equal(rs.accepted, js.accepted)
    assert asdict(rs.speculation) == asdict(js.speculation)
    assert rs.speculation.total_chunks > 0
    assert np.array_equal(rs.accepted, port.scan([text]).hits[:, 0])


def test_misspeculated_stream_still_exact():
    rng = np.random.default_rng(9)
    syms = rng.integers(0, 4, size=5000).astype(np.int32)
    port, jref = _pair(
        [_two_state_dfa(DFA)], [_two_state_dfa(JDFA)],
        speculation=dict(m=2, profile_source=np.asarray([2, 3]),
                         max_repair_rounds=1))
    rs = port.stream([syms[:2600], syms[2600:]])
    js = jref.stream([syms[:2600], syms[2600:]])
    assert np.array_equal(rs.final_states, js.final_states)
    assert np.array_equal(rs.accepted, js.accepted)
    assert asdict(rs.speculation) == asdict(js.speculation)
    assert rs.speculation.fallback_lanes > 0


def _stream_case(case):
    """(port scanner, reference scanner, pieces) of one stream case on the
    702-free small bank: a random 40-state DFA beside a PROSITE pattern,
    both speculative, blocks of 4 chunks x 16 symbols."""
    rng = np.random.default_rng(5)
    chunking = dict(n_chunks=4, block_len=16)
    spec = {}
    if case == "hitting profile":         # every state speculated
        spec = dict(m=40)
    elif case == "forced repairs":        # states no walk enters
        spec = dict(m=2, profile_source={"R40": np.asarray([38, 39]),
                                         "PS00001": np.asarray([0, 1])})
    elif case == "forced fallback":
        spec = dict(m=2, profile_source={"R40": np.asarray([38, 39]),
                                         "PS00001": np.asarray([0, 1])},
                    max_repair_rounds=1)
    table = rng.integers(0, 38, size=(40, 20)).astype(np.int32)
    acc = np.zeros(40, dtype=bool)
    acc[::3] = True
    alphabet = load_bank(["PS00001"]).alphabet
    port_pats = {"PS00001": load_bank(["PS00001"]).dfa(0),
                 "R40": DFA(table=table, start=0, accepting=acc,
                            alphabet=alphabet)}
    ref_pats = {"PS00001": jload_bank(["PS00001"]).dfa(0),
                "R40": JDFA(table=table, start=0, accepting=acc,
                            alphabet=alphabet)}
    port, jref = _pair(port_pats, ref_pats, speculation=spec,
                       chunking=ChunkPolicy(**chunking))
    syms = rng.integers(0, 20, size=1000).astype(np.int32)
    if case == "partial last block":      # 1000 = 15 blocks + 40 symbols
        cuts = [0, 64 * 3, 64 * 15, 1000]
    else:                                 # uneven pieces, blocks across them
        cuts = [0, 7, 150, 151, 613, 1000]
    return port, jref, [syms[a:b] for a, b in zip(cuts, cuts[1:])]


@pytest.mark.parametrize("case", ["uneven pieces", "partial last block",
                                  "hitting profile", "forced repairs",
                                  "forced fallback"])
def test_speculative_stream_equals_reference(case):
    """The port's speculative stream (one chained resolve a piece) against
    the reference's (one executor call a block): final states, accept flags
    and every SpeculationStats field."""
    port, jref, pieces = _stream_case(case)
    rs, js = port.stream(pieces), jref.stream(pieces)
    assert np.array_equal(rs.final_states, js.final_states)
    assert np.array_equal(rs.accepted, js.accepted)
    assert asdict(rs.speculation) == asdict(js.speculation)
    st = rs.speculation
    assert st.total_chunks == 2 * 4 * (1000 // 64)
    if case == "hitting profile":
        assert st.hit_chunks > 0 and st.fallback_lanes == 0
    if case == "forced repairs":
        assert st.repaired_chunks > 0 and st.fallback_lanes == 0
    if case == "forced fallback":
        assert st.repair_rounds == 1 and st.fallback_lanes > 0


def test_stream_resolves_once_a_piece_and_group():
    """One chained spec_resolve call a piece and speculative group, however
    many blocks the piece completes, and none for a piece that completes
    no block; the per-doc form is not called."""
    port, _, pieces = _stream_case("uneven pieces")
    n_spec = sum(g.mode == "speculative" for g in port.groups)
    assert n_spec >= 1
    calls = ops._CALLS["spec_resolve_chain"]
    one = ops._CALLS["spec_resolve"]
    before, before_one = calls.value, one.value
    sess = port.open_stream()
    done = fed = 0
    for piece in pieces:
        fed += len(piece)
        blocks_before = done
        sess.feed(piece)
        done = fed // 64
        want = n_spec if done > blocks_before else 0
        assert calls.value - before == want
        before = calls.value
    res = sess.finish()
    assert one.value == before_one
    assert res.speculation.total_chunks == 2 * 4 * (1000 // 64)


# --------------------------------------------------------------------------
# auto-mode tiering
# --------------------------------------------------------------------------


def test_auto_tier_routes_by_dfa_size():
    """auto's blowup tier: budget-blowing patterns go speculative iff their
    DFA has >= auto_states states, as in the reference, and the mixed scan
    equals the reference's and enumeration's."""
    pats = {"big": random_dfa(150, 20, seed=3),
            "small": random_dfa(30, 20, seed=4)}
    jpats = {"big": jrandom_dfa(150, 20, seed=3),
             "small": jrandom_dfa(30, 20, seed=4)}
    port, jref = _pair(pats, jpats, mode="auto", sfa_state_budget=5)
    assert port.pattern_modes == jref.pattern_modes == {
        "big": "speculative", "small": "enumeration"}
    docs = _random_docs(6, 3, 100, 20)
    got = _assert_same_scan(port, jref, docs)
    en = Scanner.compile(pats, device=CPU, mode="enumeration")
    assert np.array_equal(got.hits, en.scan(docs).hits)
    lowered = Scanner.compile(pats, ScanPlan(
        mode="auto", sfa_state_budget=5, device=CPU,
        speculation=SpeculationPolicy(auto_states=20)))
    assert lowered.pattern_modes["small"] == "speculative"


# --------------------------------------------------------------------------
# Profiler
# --------------------------------------------------------------------------


def test_profiler_top_m_and_stacking():
    """The profiler is a copy of the reference's NumPy pass: the same
    profiles, JSON and stacks."""
    dfa = _two_state_dfa(DFA, n_states=6)
    tables = dfa.table[None].astype(np.int32)
    sample = np.zeros(99, dtype=np.int32)     # alternates 0 -> 1 -> 0 -> ...
    [prof] = profile_hot_states(tables, np.asarray([0]), sample, m=3)
    assert set(prof.states[:2]) == {0, 1} and prof.states[2] == 2
    assert prof.weights[0] >= prof.weights[1] > prof.weights[2] == 0.0
    back = HotStateProfile.from_json(prof.to_json())
    assert np.array_equal(back.states, prof.states)
    stacked = stack_profile_states([back], m=5, n_max=4)
    assert stacked.shape == (1, 5) and stacked.max() <= 3
    assert HotStateProfile.from_json({"garbage": 1}) is None
    rng = np.random.default_rng(5)
    bank = rng.integers(0, 9, size=(4, 9, 3)).astype(np.int32)
    sample = rng.integers(0, 3, size=300).astype(np.int32)
    starts = np.arange(4, dtype=np.int32)
    for m in (2, 12):
        got = profile_hot_states(bank, starts, sample, m)
        want = jprofile(bank, starts, sample, m)
        assert [p.to_json() for p in got] == [p.to_json() for p in want]
        assert np.array_equal(stack_profile_states(got, 7, 9),
                              jstack(want, 7, 9))
