"""The benchmark's inputs: traffic drawn from the seed as the mixes state,
the same work for every seed, the DFA cache."""

import json
from pathlib import Path

import numpy as np
import pytest

from bench_port.harness import inputs

BENCH = Path(__file__).resolve().parents[1]


def mix(name):
    """The traffic mix ``name`` as a cell on it reads it."""
    bench = {"workloads": [{"name": "c", "config": "x", "traffic": name,
                            "chips": 1}],
             "configs": [{"name": "x",
                          "file": "bench_port/configs/prosite23_sfa20k.json"}]}
    return inputs.load_cell(bench, "c").traffic


def small(traffic, pool=2, docs=64):
    return {**traffic, "pool": pool, "docs": docs}


@pytest.mark.parametrize("name", ["reads_scan", "swissprot_scan"])
def test_a_scan_pool_is_a_function_of_the_seed(name):
    t = small(mix(name))
    a, b, c = (inputs.scan_pool(t, s) for s in (2**31 + 5, 2**31 + 5, 7))
    for x, y in zip(a, b):
        assert np.array_equal(x.codes, y.codes)
        assert np.array_equal(x.lengths, y.lengths)
    assert any(not np.array_equal(x.codes, z.codes) for x, z in zip(a, c))
    # every seed deals each request the same lengths, in another order
    la = sorted(tuple(np.sort(r.lengths)) for r in a)
    lc = sorted(tuple(np.sort(r.lengths)) for r in c)
    assert la == lc


def test_every_seed_sends_requests_of_the_same_sizes():
    t = small(mix("swissprot_scan"), pool=4, docs=256)
    sizes = [sorted((r.residues, len(set(r.lengths)))
                    for r in inputs.scan_pool(t, s))
             for s in (1, 2**31 + 77, 5_000_000_000)]
    assert sizes[0] == sizes[1] == sizes[2]
    assert len({x for x, _ in sizes[0]}) > 1     # the requests differ


def test_reads_are_one_array_of_50_residues_a_read():
    t = mix("reads_scan")
    assert (t["docs"], t["lengths"]["value"], t["form"]) == (16384, 50,
                                                              "array")
    (r,) = inputs.scan_pool(small(t, pool=1), 3)
    assert r.docs.shape == (64, 50) and r.docs.dtype == np.int32
    assert r.residues == 64 * 50
    assert r.docs.min() >= 0 and r.docs.max() < 20


def test_proteins_are_str_with_swissprot_lengths():
    t = mix("swissprot_scan")
    assert (t["docs"], t["form"]) == (256, "str")
    lens = inputs.doc_lengths(t, 256 * 16)
    assert 280 <= np.median(lens) <= 320 and 330 <= lens.mean() <= 390
    assert lens.min() >= 2 and lens.max() <= 35213
    (r,) = inputs.scan_pool(small(t, pool=1, docs=256), 11)
    assert [len(d) for d in r.docs] == list(r.lengths)
    assert 150 <= len(set(r.lengths)) <= 256      # ~210 distinct lengths
    letters = "ACDEFGHIKLMNPQRSTVWY"
    assert r.docs[0] == "".join(letters[c] for c in r.codes[0, :r.lengths[0]])


def test_residues_follow_the_composition():
    t = mix("reads_scan")
    (r,) = inputs.scan_pool({**t, "pool": 1, "docs": 4096}, 1)
    counts = np.bincount(r.codes.ravel(), minlength=20) / r.codes.size
    shares = t["composition_percent"]
    want = np.asarray([shares[a] for a in inputs.ALPHABET])
    want = want / want.sum()
    assert np.abs(counts - want).max() < 0.003
    assert abs(counts[inputs.ALPHABET.index("L")] - want[9]) < 0.003


def test_compile_orders_are_permutations_from_the_seed():
    t = mix("compile")
    a = inputs.compile_orders(t, 50, 9)
    assert len(a) == t["orders"]
    assert all(sorted(o) == list(range(50)) for o in a)
    assert all(np.array_equal(x, y)
               for x, y in zip(a, inputs.compile_orders(t, 50, 9)))
    assert len({tuple(o) for o in a}) == len(a)


def test_every_seed_compiles_the_same_orders_in_turn():
    t = mix("compile")
    runs = [[tuple(o) for o in inputs.compile_orders(t, 50, s)]
            for s in range(12)]
    assert all(sorted(r) == sorted(runs[0]) for r in runs)
    # the seed picks the order the loop starts from; the cycle is one
    firsts = {r[0] for r in runs}
    assert len(firsts) > 1
    for r in runs:
        i = runs[0].index(r[0])
        assert r == runs[0][i:] + runs[0][:i]


def test_the_reservoir_keeps_k_answers_drawn_from_the_seed():
    r = inputs.Reservoir(3, 5)
    for i in range(100):
        r.offer(i)
    s = inputs.Reservoir(3, 5)
    for i in range(100):
        s.offer(i)
    assert r.items == s.items and len(r.items) == 3
    assert r.seen == 100


def test_the_bundled_bank_states_its_simplified_accession():
    cfg = json.loads((BENCH / "configs" / "prosite23_sfa20k.json")
                     .read_text())
    rows = dict(inputs.read_patterns(BENCH / "configs" / cfg["patterns"]))
    assert len(rows) == 23
    assert rows["PS00007"] == "[RK]-x(2)-[DE]-x(3)-Y"
    assert "PS00007" in cfg["source"]
    assert any("PS00007" in a and "x(2,3)" in a for a in cfg["assumed"])


def test_the_dfa_cache_round_trips(tiny, tmp_path):
    bench, bp = tiny
    cell = inputs.load_cell(bench, "tiny.scan", bp)
    a = inputs.load_bank(cell, tmp_path / "cache")
    assert len(list((tmp_path / "cache").glob("dfas-*.npz"))) == 1
    b = inputs.load_bank(cell, tmp_path / "cache")
    assert a.ids == b.ids and a.starts == b.starts
    assert all(np.array_equal(x, y) for x, y in zip(a.tables, b.tables))
    assert all(np.array_equal(x, y) for x, y in zip(a.accepting,
                                                    b.accepting))
