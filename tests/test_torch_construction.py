"""The port's ``construct_bank`` against the reference's, bit for bit.

Same DFAs through both packages: the port must give the same δ_s, state
order, mappings and fingerprints, and the same blowup, retry and round
verdicts — on all 23 bundled signatures, across capacity growth, under a
forced fingerprint collision, and bucketed or not.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import numpy as np  # noqa: E402

from repro.construction import construct_bank as jconstruct_bank  # noqa: E402
from repro.construction import round_schedule as jround_schedule  # noqa: E402
from repro.core.dfa import random_dfa as jrandom_dfa  # noqa: E402
from repro.core.fingerprint import fold_weights_u32 as jfold_weights  # noqa: E402
from repro.core.prosite import load_bank as jload_bank  # noqa: E402
from repro_torch.construction import (  # noqa: E402
    StateBlowup,
    construct_bank,
    round_schedule,
)
from repro_torch.core.dfa import random_dfa  # noqa: E402
from repro_torch.core.fingerprint import fold_weights_u32  # noqa: E402
from repro_torch.core.prosite import load_bank  # noqa: E402

BUDGET = 512


def _assert_sfa_equal(a, b, ctx):
    assert a.delta.dtype == b.delta.dtype == np.int32, ctx
    assert np.array_equal(a.mappings, b.mappings), ctx
    assert np.array_equal(a.delta, b.delta), ctx
    assert a.fingerprints.dtype == b.fingerprints.dtype == np.uint32, ctx
    assert np.array_equal(a.fingerprints, b.fingerprints), ctx


def _assert_results_equal(got, want):
    assert np.array_equal(got.blown, want.blown)
    assert np.array_equal(got.stats.retries, want.stats.retries)
    assert np.array_equal(got.stats.pattern_rounds, want.stats.pattern_rounds)
    assert np.array_equal(got.stats.pattern_candidates,
                          want.stats.pattern_candidates)
    assert got.stats.rounds == want.stats.rounds
    for p, (a, b) in enumerate(zip(got.sfas, want.sfas)):
        assert (a is None) == (b is None), p
        if a is not None:
            _assert_sfa_equal(a, b, p)


@pytest.fixture(scope="module")
def banks():
    """The bundled bank constructed once by each package at budget 512."""
    got = construct_bank(load_bank(), max_states=BUDGET, device="cpu")
    want = jconstruct_bank(jload_bank(), max_states=BUDGET)
    return got, want


def test_bundled_bank_bit_identical_to_reference(banks):
    got, want = banks
    assert got.n_patterns == 23 and int(got.blown.sum()) == 5
    _assert_results_equal(got, want)


def test_bucketed_bank_bit_identical_to_unbucketed(banks):
    """Mirror of the reference test of the same name: the bundled bank
    auto-buckets (P=23, sizes 4..87) and equals the flat path, stats
    attribution included."""
    got, _ = banks
    buckets = got.stats.buckets
    assert len(buckets) >= 2
    assert sum(b.n_patterns for b in buckets) == 23
    assert got.stats.rounds == sum(b.rounds for b in buckets)
    assert sum(b.blown for b in buckets) == int(got.blown.sum())
    flat = construct_bank(load_bank(), max_states=BUDGET, bucketing="off",
                          device="cpu")
    assert not flat.stats.buckets
    assert np.array_equal(flat.blown, got.blown)
    assert np.array_equal(flat.stats.pattern_rounds, got.stats.pattern_rounds)
    assert np.array_equal(flat.stats.pattern_candidates,
                          got.stats.pattern_candidates)
    for p in range(23):
        if got.sfas[p] is not None:
            _assert_sfa_equal(flat.sfas[p], got.sfas[p], p)


def test_capacity_growth_is_bit_exact():
    """Mirror of ``test_bank_capacity_growth_is_bit_exact``: seed 103's SFA
    has ~5.4k states, so construction crosses several capacity tiers."""
    kw = dict(max_states=6000, tile=64)
    got = construct_bank([random_dfa(3, 5, seed=100),
                          random_dfa(6, 5, seed=103)], device="cpu", **kw)
    want = jconstruct_bank([jrandom_dfa(3, 5, seed=100),
                            jrandom_dfa(6, 5, seed=103)], **kw)
    assert not got.blown.any() and got.sfas[1].n_states > 2048
    _assert_results_equal(got, want)


def test_forced_collision_retries_only_the_collided_pattern():
    """Mirror of the reference test, through the ``_weight_fn`` seam: both
    packages retry pattern 1 alone and land on identical SFAs."""
    kw = dict(max_states=4000, tile=16)
    sizes = (4, 5, 3)

    def sabotaged(fold):
        def weights(p, attempt, n_words, consts):
            w = np.asarray(fold(n_words, consts)).astype(np.uint32)
            return np.zeros_like(w) if (p, attempt) == (1, 0) else w
        return weights

    dfas = [random_dfa(n, 5, seed=300 + i) for i, n in enumerate(sizes)]
    clean = construct_bank(dfas, device="cpu", **kw)
    got = construct_bank(dfas, device="cpu",
                         _weight_fn=sabotaged(fold_weights_u32), **kw)
    want = jconstruct_bank(
        [jrandom_dfa(n, 5, seed=300 + i) for i, n in enumerate(sizes)],
        _weight_fn=sabotaged(jfold_weights), **kw)
    assert list(got.stats.retries) == [0, 1, 0]
    assert got.stats.pattern_rounds[1] > clean.stats.pattern_rounds[1]
    assert got.stats.pattern_rounds[0] == clean.stats.pattern_rounds[0]
    _assert_sfa_equal(got.sfas[0], clean.sfas[0], 0)
    assert not np.array_equal(got.sfas[1].fingerprints,
                              clean.sfas[1].fingerprints)
    _assert_results_equal(got, want)


@pytest.mark.parametrize("fp_backend,expand_backend",
                         [("kernel", "plain"), ("plain", "kernel")])
def test_stage_backends_are_bit_identical(fp_backend, expand_backend):
    dfas = [random_dfa(n, 4, seed=40 + n) for n in (2, 3, 5)]
    base = construct_bank(dfas, max_states=400, tile=16, device="cpu")
    got = construct_bank(dfas, max_states=400, tile=16, device="cpu",
                         fingerprint_backend=fp_backend,
                         expand_backend=expand_backend)
    _assert_results_equal(got, base)


def test_blowup_flags_and_raise():
    dfas = [random_dfa(2, 8, seed=1), random_dfa(8, 8, seed=1)]
    res = construct_bank(dfas, max_states=12, tile=8, device="cpu")
    assert list(res.blown) == [False, True]
    assert res.sfas[0] is not None and res.sfas[1] is None
    want = jconstruct_bank([jrandom_dfa(2, 8, seed=1),
                            jrandom_dfa(8, 8, seed=1)], max_states=12, tile=8)
    _assert_results_equal(res, want)
    with pytest.raises(StateBlowup):
        construct_bank(dfas, max_states=12, tile=8, on_blowup="raise",
                       device="cpu")


@pytest.mark.parametrize("kw", [
    dict(tile=128, n=87, k=20, max_states=512, P=23),
    dict(tile=128, n=6, k=20, max_states=20000, P=13, bucket_growth=2),
    dict(tile=64, n=3, k=5, max_states=6000, P=2),
])
def test_round_schedule_matches_reference(kw):
    got, want = round_schedule(**kw), jround_schedule(**kw)
    assert (got.capacities, got.buckets) == (want.capacities, want.buckets)
    assert got.shapes == want.shapes


def test_input_validation_and_unported_options():
    d = [random_dfa(3, 4, seed=0)]
    with pytest.raises(ValueError):
        construct_bank([], device="cpu")
    with pytest.raises(ValueError):
        construct_bank(d, method="parallel", device="cpu")
    with pytest.raises(ValueError):
        construct_bank(d, fingerprint_backend="xla", device="cpu")
    with pytest.raises(ValueError):
        construct_bank(d, bucketing="sometimes", device="cpu")
    with pytest.raises(NotImplementedError):
        construct_bank(d, method="loop", device="cpu")
    with pytest.raises(NotImplementedError):
        construct_bank(d, distribution="shard_map", device="cpu")
    assert construct_bank(d, method="auto", device="cpu").sfas[0] is not None


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        construct_bank([random_dfa(3, 4, seed=0)])
