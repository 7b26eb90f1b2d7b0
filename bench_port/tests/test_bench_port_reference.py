"""The plain reference against the program's CPU path at a small size, and
against a direct walk of each DFA."""

from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port.harness import inputs
from bench_port.harness.port import Port
from bench_port.reference import sfa as ref_sfa
from bench_port.reference.prosite import compile_prosite
from bench_port.reference.scan import BankTables

BENCH = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def bank():
    rows = inputs.read_patterns(BENCH / "configs" / "prosite23.patterns.txt")
    dfas = [compile_prosite(p) for _, p in rows]
    return inputs.Bank(ids=[i for i, _ in rows],
                       tables=[d.table for d in dfas],
                       accepting=[d.accepting for d in dfas],
                       starts=[d.start for d in dfas])


def walk(table, accepting, start, codes):
    s = start
    for c in codes:
        s = table[s, c]
    return bool(accepting[s])


def test_reference_scan_is_the_dfa_walk(bank):
    rng = np.random.default_rng(0)
    lengths = rng.integers(0, 40, 30)
    codes = rng.integers(0, 20, (30, 40)).astype(np.int32)
    hits = BankTables(bank.tables, bank.accepting, bank.starts,
                      "cpu").hits(codes, lengths, block=100)
    for p in range(len(bank)):
        for d in range(30):
            assert hits[p, d] == walk(bank.tables[p], bank.accepting[p],
                                      bank.starts[p], codes[d, :lengths[d]])


def test_reference_scan_equals_the_program_on_the_cpu(bank):
    port = Port({"mode": "auto", "sfa_state_budget": 64}, "cpu", "off")
    scanner = port.compile(port.dfas(bank))
    letters = np.asarray(list(inputs.ALPHABET))
    rng = np.random.default_rng(1)
    lengths = rng.integers(1, 60, 40)
    codes = rng.integers(0, 20, (40, 60)).astype(np.int32)
    docs = ["".join(letters[codes[d, :lengths[d]]]) for d in range(40)]
    want = BankTables(bank.tables, bank.accepting, bank.starts,
                      "cpu").hits(codes, lengths)
    assert np.array_equal(Port.scan(scanner, docs), want)
    assert np.array_equal(Port.scan(scanner, codes[:, :7]),
                          BankTables(bank.tables, bank.accepting,
                                     bank.starts, "cpu").hits(
                              codes[:, :7], np.full(40, 7)))


@pytest.mark.parametrize("budget", [16, 300])
def test_reference_sfas_equal_the_programs_on_the_cpu(bank, budget):
    port = Port({"mode": "auto", "sfa_state_budget": budget}, "cpu", "off")
    order = np.random.default_rng(budget).permutation(len(bank))
    got = Port.sfas(port.compile(port.dfas(bank, order)))
    want = ref_sfa.construct_bank(bank.tables, budget)
    assert sum(w.blown for w in want) > 0
    for p, pid in enumerate(bank.ids):
        assert ref_sfa.same(ref_sfa.RefSFA(*got[pid]), want[p]), pid


def test_reference_sfa_closes_the_paper_example():
    # "contains RG" over the amino acids: 3 DFA states
    d = compile_prosite("R-G")
    s = ref_sfa.construct(d.table, 100)
    assert not s.blown
    assert np.array_equal(s.mappings[0], np.arange(d.n_states))
    k = d.table.shape[1]
    for i in range(len(s.delta)):
        for a in range(k):
            assert np.array_equal(s.mappings[s.delta[i, a]],
                                  d.table[s.mappings[i], a])
    assert ref_sfa.construct(d.table, len(s.delta) - 1).blown


def test_the_control_breaks_only_what_needs_more_than_8_bits(bank):
    small = [t for t in bank.tables if len(t) < 256]
    assert all(ref_sfa.same(a, b) for a, b in zip(
        ref_sfa.construct_bank(small, 255),
        ref_sfa.construct_bank(small, 255, np.uint8)))
    # an SFA past 256 states wraps its ids
    big = max(bank.tables, key=len)
    full = ref_sfa.construct(big, 20000)
    assert len(full.delta) > 256
    assert not ref_sfa.same(ref_sfa.construct(big, 20000, np.uint8), full)
    low = BankTables(bank.tables, bank.accepting, bank.starts, "cpu",
                     dtype=torch.uint8)
    assert low.table.dtype == torch.uint8


def test_the_sfa_walk_is_the_dfa_walk_and_8_bit_ids_break_it(bank):
    """The scan control walks each pattern's SFA as the paper scans; at full
    width that is the DFA walk, with ids held in 8 bits it is not (the
    bundled DFAs all have fewer than 256 states, their SFAs up to 7,184)."""
    assert max(len(t) for t in bank.tables) < 256
    rng = np.random.default_rng(7)
    lengths = rng.integers(100, 400, 48)
    codes = rng.integers(0, 20, (48, 400)).astype(np.int32)
    want = BankTables(bank.tables, bank.accepting, bank.starts,
                      "cpu").hits(codes, lengths)
    args = list(zip(bank.tables, bank.accepting, bank.starts))
    full = [ref_sfa.walk_tables(t, a, s, 20000) for t, a, s in args]
    assert all(s == 0 for _, _, s in full)
    assert np.array_equal(BankTables(*zip(*full), "cpu").hits(
        codes, lengths), want)
    low = [ref_sfa.walk_tables(t, a, s, 20000, np.uint8) for t, a, s in args]
    got = BankTables(*zip(*low), "cpu", dtype=torch.uint8).hits(codes,
                                                                lengths)
    assert np.count_nonzero(got != want) > 0
    # a pattern whose SFA blows is walked as its DFA
    t, a, s = args[0]
    blown = ref_sfa.walk_tables(t, a, s, 1)
    assert blown[0] is t or np.array_equal(blown[0], t)
    assert blown[2] == s
