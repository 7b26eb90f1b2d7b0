"""The port's kernel wrappers and plain versions against the reference's
Pallas kernels (run in interpret mode, as ``tests/test_kernels.py`` runs
them). Equality throughout: every kernel is integer arithmetic.

On the CPU the wrappers dispatch to the plain versions; the CUDA kernels
themselves are held against the plain versions by the ``cuda``-marked tests
below and by ``chip_smoke.py`` on the card.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import monoid as jmonoid  # noqa: E402
from repro.core.fingerprint import BarrettConstants as JBarrett  # noqa: E402
from repro.core.fingerprint import pack_states_u32 as jpack  # noqa: E402
from repro.engine import executors as JX  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.clmul import fingerprint_bank_pallas  # noqa: E402
from repro.kernels.clmul import fingerprint_pallas  # noqa: E402
from repro.kernels.compose import compose_pallas  # noqa: E402
from repro.kernels.expand import expand_bank_pallas  # noqa: E402
from repro.kernels.match_scan import match_bank_chunks_pallas  # noqa: E402
from repro.kernels.match_scan import match_chunks_pallas  # noqa: E402
from repro.kernels.ref import match_chunks_ref  # noqa: E402
from repro.speculative import speculative_bank_finals as jfinals  # noqa: E402
from repro_torch.core.fingerprint import (  # noqa: E402
    BarrettConstants,
    fold_weights_u32,
    limbs_of,
    nth_poly_low,
    pack_states_u32,
    u32_to_i32,
)
from repro_torch.engine import executors as X  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.speculative import speculative_bank_finals  # noqa: E402


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _fp_inputs(P, B, W, seed):
    rng = np.random.default_rng(seed)
    return _u32(rng, (P, B, W)), _u32(rng, (P, W, 2)), _u32(rng, (P, 4))


def _match_inputs(P, n, k, B, L, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, size=(P, n, k)).astype(np.int32),
            rng.integers(0, k, size=(B, L)).astype(np.int32))


@pytest.mark.parametrize("P,B,W", [(1, 1, 1), (3, 17, 44)])
def test_fingerprint_bank_matches_pallas(P, B, W):
    words, weights, limbs = _fp_inputs(P, B, W, seed=P * 100 + B)
    want = np.asarray(fingerprint_bank_pallas(
        jnp.asarray(words), jnp.asarray(weights), jnp.asarray(limbs),
        block_b=64, interpret=True))
    got = ops.fingerprint_bank(_i32(words), _i32(weights), _i32(limbs))
    assert got.dtype == torch.int32 and got.shape == (P, B, 2)
    assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("B,T,n,k", [(1, 1, 2, 3), (2, 4, 5, 20),
                                     (3, 6, 13, 7)])
def test_expand_bank_matches_pallas(B, T, n, k):
    rng = np.random.default_rng(B * 10 + n)
    tables = rng.integers(0, n, size=(B, n, k)).astype(np.int32)
    ft = rng.integers(0, n, size=(B, T, n)).astype(np.int32)
    want = np.asarray(expand_bank_pallas(jnp.asarray(tables), jnp.asarray(ft),
                                         interpret=True))
    got = ops.expand_bank(torch.from_numpy(tables), torch.from_numpy(ft))
    assert got.shape == (B, T * k, n)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("B,T,n,k", [(1, 1, 1, 3), (2, 4, 6, 20),
                                     (3, 6, 13, 7), (2, 3, 87, 20)])
def test_expand_bank_words_match_reference(B, T, n, k):
    """The packed, masked words beside the candidates, against the
    reference's ``pack_states_u32(cand) & word_masks`` (odd and even n)."""
    rng = np.random.default_rng(B * 100 + n)
    tables = rng.integers(0, n, size=(B, n, k)).astype(np.int32)
    ft = rng.integers(0, n, size=(B, T, n)).astype(np.int32)
    masks = _u32(rng, (B, (n + 1) // 2))
    cand, words = ops.expand_bank(torch.from_numpy(tables),
                                  torch.from_numpy(ft), _i32(masks))
    want = np.asarray(expand_bank_pallas(jnp.asarray(tables), jnp.asarray(ft),
                                         interpret=True))
    assert np.array_equal(cand.numpy(), want)
    assert words.dtype == torch.int32 and words.shape == (B, T * k,
                                                          (n + 1) // 2)
    want_words = np.asarray(jpack(jnp.asarray(want))) & masks[:, None, :]
    assert np.array_equal(words.numpy().view(np.uint32), want_words)


@pytest.mark.parametrize("m", [1, 2, 9])
def test_compose_fold_matches_reference_reduce(m):
    """The stacked fold, with a first element and from the identity,
    against ``repro.core.monoid.reduce`` of the function monoid."""
    rng = np.random.default_rng(m)
    B, n = 5, 11
    xs = rng.integers(0, n, size=(B, m + 1, n)).astype(np.int32)
    JFN = jmonoid.function_monoid()
    want = np.asarray(jmonoid.reduce(JFN, jnp.asarray(xs), axis=1))
    got = ops.compose_fold(torch.from_numpy(xs[:, 0].copy()),
                           torch.from_numpy(xs[:, 1:].copy()))
    assert got.dtype == torch.int32 and got.shape == (B, n)
    assert np.array_equal(got.numpy(), want)
    want = np.asarray(jmonoid.reduce(JFN, jnp.asarray(xs[:, 1:]), axis=1))
    got = ops.compose_fold(None, torch.from_numpy(xs[:, 1:].copy()))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("P,S,n,D,n_chunks", [(1, 4, 3, 2, 1), (2, 9, 6, 3, 4),
                                              (3, 40, 13, 5, 8)])
def test_compose_fold_rows_matches_reference_sfa_fold(P, S, n, D, n_chunks):
    """The rows fold of the chunks' final SFA states, against the
    reference's ``bank_doc_mappings_sfa`` on the same stacks."""
    rng = np.random.default_rng(S)
    k, L = 20, 4 * n_chunks
    deltas = rng.integers(0, S, size=(P, S, k)).astype(np.int32)
    maps = rng.integers(0, n, size=(P, S, n)).astype(np.int32)
    corpus = rng.integers(0, k, size=(D, L)).astype(np.int32)
    want = np.asarray(JX.bank_doc_mappings_sfa(
        jnp.asarray(deltas), jnp.asarray(maps), jnp.asarray(corpus), n_chunks))
    d, mp, c = (torch.from_numpy(a) for a in (deltas, maps, corpus))
    finals = ops.match_bank_chunks(d, c.view(D * n_chunks, -1), 1)
    got = ops.compose_fold_rows(mp, finals.view(P, D, n_chunks))
    assert got.dtype == torch.int32 and got.shape == (P, D, n)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(X.bank_doc_mappings_sfa(d, mp, c, n_chunks), got)


@pytest.mark.parametrize("P,n,k,B,L", [(1, 3, 4, 2, 5), (2, 6, 5, 3, 8),
                                       (3, 16, 20, 5, 12),
                                       # n_starts = n - 1 = 31 and 33 and a
                                       # wide alphabet: the edges of the
                                       # CUDA walk's layouts, here the plain
                                       # version's (CPU tensors); the cuda
                                       # tests hold the kernel at them
                                       (2, 32, 5, 3, 6), (1, 34, 4, 2, 5),
                                       (2, 5, 300, 3, 4)])
def test_match_bank_chunks_matches_pallas(P, n, k, B, L):
    tables, chunks = _match_inputs(P, n, k, B, L, seed=n)
    want = np.asarray(match_bank_chunks_pallas(
        jnp.asarray(tables), jnp.asarray(chunks), block_b=2, interpret=True))
    t, c = torch.from_numpy(tables), torch.from_numpy(chunks)
    got = ops.match_bank_chunks(t, c)
    assert np.array_equal(got.numpy(), want)
    # n_starts = 1 is column 0 of the full walk (the SFA path's read)
    one = ops.match_bank_chunks(t, c, 1)
    assert one.shape == (P, B, 1)
    assert np.array_equal(one.numpy()[..., 0], want[..., 0])
    part = ops.match_bank_chunks(t, c, n - 1)
    assert np.array_equal(part.numpy(), want[..., : n - 1])


@pytest.mark.parametrize("B,n", [(1, 1), (3, 7), (5, 300)])
def test_compose_matches_pallas(B, n):
    rng = np.random.default_rng(B * 1000 + n)
    f = rng.integers(0, n, size=(B, n)).astype(np.int32)
    g = rng.integers(0, n, size=(B, n)).astype(np.int32)
    want = np.asarray(compose_pallas(jnp.asarray(f), jnp.asarray(g),
                                     block_q=128, interpret=True))
    got = ops.compose(torch.from_numpy(f), torch.from_numpy(g))
    assert got.dtype == torch.int32 and got.shape == (B, n)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.asarray(
        jops.compose(jnp.asarray(f), jnp.asarray(g), interpret=True)))


@pytest.mark.parametrize("n,k,B,L", [(1, 2, 1, 1), (3, 4, 2, 5), (6, 5, 3, 8),
                                     (16, 20, 5, 12), (31, 4, 2, 5),
                                     (33, 3, 3, 6), (5, 300, 3, 4)])
def test_match_chunks_matches_pallas(n, k, B, L):
    (table,), chunks = _match_inputs(1, n, k, B, L, seed=n + L)
    want = np.asarray(match_chunks_pallas(jnp.asarray(table),
                                          jnp.asarray(chunks), block_b=2,
                                          interpret=True))
    got = ops.match_chunks(torch.from_numpy(table), torch.from_numpy(chunks))
    assert got.dtype == torch.int32 and got.shape == (B, n)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,B,poly", [(1, 1, 0), (9, 40, 1), (87, 33, 2)])
def test_fingerprint_matches_pallas(n, B, poly):
    """Packed state vectors, fold weights and limbs made by the port, the
    fingerprints by both packages' kernels (the reference's through its
    ``ops.fingerprint`` wrapper, which makes its own weights)."""
    rng = np.random.default_rng(n * 10 + poly)
    states = torch.from_numpy(rng.integers(0, n, size=(B, n)).astype(np.int32))
    words = u32_to_i32(pack_states_u32(states)).contiguous()
    W = words.shape[1]
    c = BarrettConstants.cached(nth_poly_low(poly))
    weights = u32_to_i32(fold_weights_u32(W, c))
    limbs = u32_to_i32(torch.tensor(limbs_of(c), dtype=torch.int64))
    got = ops.fingerprint(words, weights, limbs)
    assert got.dtype == torch.int32 and got.shape == (B, 2)
    jwords = jnp.asarray(words.numpy().view(np.uint32))
    want = np.asarray(jops.fingerprint(
        jwords, JBarrett.cached(c.poly_low), block_b=16, interpret=True))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    want = np.asarray(fingerprint_pallas(
        jwords, jnp.asarray(weights.numpy().view(np.uint32)),
        jnp.asarray(limbs.numpy().view(np.uint32)), block_b=16,
        interpret=True))
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_cpu_dispatch_uses_plain_versions_and_counts_no_launch():
    ops.reset_launches()
    words, weights, limbs = _fp_inputs(2, 3, 2, seed=1)
    args = (_i32(words), _i32(weights), _i32(limbs))
    assert torch.equal(ops.fingerprint_bank(*args),
                       ref.fingerprint_bank(*args))
    tables, chunks = _match_inputs(2, 4, 3, 2, 3, seed=2)
    ops.match_bank_chunks(torch.from_numpy(tables), torch.from_numpy(chunks))
    t0, c = torch.from_numpy(tables[0]), torch.from_numpy(chunks)
    assert torch.equal(ops.match_chunks(t0, c), ref.match_chunks(t0, c))
    f = torch.from_numpy(np.ascontiguousarray(tables[:, :, 0]))
    assert torch.equal(ops.compose(f, f), ref.compose(f, f))
    gs = torch.from_numpy(np.ascontiguousarray(tables.transpose(0, 2, 1)))
    assert torch.equal(ops.compose_fold(f, gs), ref.compose_fold(f, gs))
    assert torch.equal(ops.compose_fold(None, gs), ref.compose_fold(None, gs))
    idx = torch.from_numpy(chunks[None].repeat(2, 0) % 4)
    t = torch.from_numpy(tables)
    assert torch.equal(ops.compose_fold_rows(t, idx),
                       ref.compose_fold_rows(t, idx))
    masks = f[:, :2].contiguous()
    assert all(torch.equal(a, b) for a, b in zip(
        ops.expand_bank(t, gs, masks), ref.expand_bank(t, gs, masks)))
    ops.fingerprint(args[0][0], args[1][0], args[2][0])
    spec = torch.from_numpy(tables[:, 0, :2].copy())
    exits = ops.match_bank_chunks(t, c, 2, spec)
    assert torch.equal(exits, ref.match_bank_chunks(t, c, 2, spec))
    got = ops.spec_resolve(t, spec, spec[:, 0].contiguous(), exits, c, 1, 1)
    want = ref.spec_resolve(t, spec, spec[:, 0].contiguous(), exits, c, 1, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(v == 0 for v in ops.launches.values())
    assert all(v == 0 for v in ops.form_launches.values())
    assert set(ops.launches) == set(build.KERNELS)


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity",
                                  "n_starts", "device", "folds and words",
                                  "speculative"])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    tables, chunks = _match_inputs(2, 4, 3, 2, 3, seed=3)
    t, c = torch.from_numpy(tables), torch.from_numpy(chunks)
    if case == "speculative":
        spec = torch.zeros((2, 3), dtype=torch.int32)
        exits = ops.match_bank_chunks(t, c, starts=spec)
        assert exits.shape == (2, 2, 3)
        with pytest.raises(ValueError):
            ops.match_bank_chunks(t, c, starts=spec[:1])
        with pytest.raises(ValueError):
            ops.match_bank_chunks(t, c, 2, spec)
        with pytest.raises(TypeError):
            ops.match_bank_chunks(t, c, starts=spec.to(torch.int64))
        starts = spec[:, 0].contiguous()
        with pytest.raises(ValueError):            # 2 chunks, 3 a doc
            ops.spec_resolve(t, spec, starts, exits, c, 3, 1)
        with pytest.raises(ValueError):
            ops.spec_resolve(t, spec, starts, exits[:, :1], c, 1, 1)
        with pytest.raises(ValueError):
            ops.spec_resolve(t, spec, starts[:1], exits, c, 1, 1)
        with pytest.raises(ValueError):
            ops.spec_resolve(t, spec, starts, exits, c, 1, -1)
        return
    if case == "dtype":
        with pytest.raises(TypeError):
            ops.match_bank_chunks(t.to(torch.int64), c)
        with pytest.raises(TypeError):
            ops.expand_bank(t, c[None].to(torch.int16))
    elif case == "shape":
        with pytest.raises(ValueError):
            ops.match_bank_chunks(t[0], c)
        with pytest.raises(ValueError):
            ops.fingerprint_bank(c[None], c[None], c)
        with pytest.raises(ValueError):
            ops.expand_bank(t, t)
        with pytest.raises(ValueError):
            ops.compose(c, c[:, :2].contiguous())
        with pytest.raises(ValueError):
            ops.match_chunks(t, c)
        with pytest.raises(ValueError):
            ops.fingerprint(c, c, c[0])
        with pytest.raises(ValueError):
            ops.fingerprint(c, c[:1].repeat(3, 1)[:, :2].contiguous(),
                            c[0, :2].contiguous())
        with pytest.raises(TypeError):
            ops.compose(c.to(torch.int64), c.to(torch.int64))
        with pytest.raises(TypeError):
            ops.match_chunks(t[0], c.to(torch.int16))
    elif case == "contiguity":
        with pytest.raises(ValueError):
            ops.match_bank_chunks(t.transpose(1, 2), c)
        with pytest.raises(ValueError):
            ops.compose(c.t(), c.t())
        with pytest.raises(ValueError):
            ops.match_chunks(t[0].t(), c)
    elif case == "n_starts":
        for bad in (0, 5):
            with pytest.raises(ValueError):
                ops.match_bank_chunks(t, c, bad)
    elif case == "device":
        with pytest.raises(ValueError):
            ops.match_bank_chunks(t.to("meta"), c.to("meta"))
        with pytest.raises(ValueError):
            ops.compose_fold(None, t.to("meta"))
    else:
        gs = t.transpose(1, 2).contiguous()                  # (2, 3, 4)
        f = gs[:, 0].contiguous()                            # (2, 4)
        idx = c[:, None].repeat(1, 5, 1) % 4                 # (2, 5, 3)
        masks = c[:, :2].contiguous()                        # (2, W = 2)
        with pytest.raises(TypeError):                       # dtype
            ops.compose_fold(f, gs.to(torch.int64))
        with pytest.raises(TypeError):
            ops.compose_fold(f.to(torch.int16), gs)
        with pytest.raises(TypeError):                       # idx not int32
            ops.compose_fold_rows(t, idx.to(torch.int64))
        with pytest.raises(TypeError):
            ops.expand_bank(t, gs, masks.to(torch.int64))
        with pytest.raises(ValueError):                      # rank
            ops.compose_fold(f, f)
        with pytest.raises(ValueError):
            ops.compose_fold_rows(t[0], idx)
        with pytest.raises(ValueError):
            ops.compose_fold_rows(t, idx[0])
        with pytest.raises(ValueError):                      # mismatched m
            ops.compose_fold(None, gs[:, :0].contiguous())
        with pytest.raises(ValueError):
            ops.compose_fold_rows(t, idx[:, :, :0].contiguous())
        with pytest.raises(ValueError):                      # f vs gs
            ops.compose_fold(f[:, :3].contiguous(), gs)
        with pytest.raises(ValueError):
            ops.compose_fold(f[:1].contiguous(), gs)
        with pytest.raises(ValueError):                      # idx vs stacks
            ops.compose_fold_rows(t, idx[:1].contiguous())
        with pytest.raises(ValueError):                      # word masks
            ops.expand_bank(t, gs, masks[:, :1].contiguous())
        with pytest.raises(ValueError):                      # contiguity
            ops.compose_fold(None, gs.transpose(1, 2))
        with pytest.raises(ValueError):
            ops.compose_fold_rows(t, idx.transpose(1, 2))


# The chunk walks' launch plan (csrc/match.cuh reads it as an int array),
# on an H100 (132 SMs; a block may opt in to 227 KB) and on a card whose
# blocks may opt in to 48 KB.
_SMS, _H100_SMEM = 132, 227 * 1024
_PLAN_SHAPES = {   # (P, n, k, B, L, n_starts) -> branch
    "sfa 512": ((18, 272, 20, 524_288, 48, 1), "smem"),
    "sfa 20000": ((23, 7184, 20, 524_288, 48, 1), "smem + L2"),
    "enumeration": ((5, 87, 20, 524_288, 48, 87), "smem"),
    "locate": ((1, 87, 20, 4096, 1024, 87), "smem"),
    "stream piece": ((23, 7184, 20, 256, 256, 1), "smem + L2"),
    "n_starts = n": ((2, 7184, 20, 4096, 48, 7184), "smem + L2"),
    "ragged": ((3, 13, 20, 1001, 7, 13), "smem"),
    "wide alphabet": ((3, 13, 300, 1001, 7, 1), "smem"),
    "k = 2, n_starts 31": ((1, 40, 2, 9, 5, 31), "smem"),
    "n_starts 33": ((1, 40, 2, 9, 5, 33), "smem"),
    # walks from explicit starts (the speculative pass): chunk-major at any
    # n_starts
    "starts, 24x702, m 8": ((24, 702, 20, 524_288, 48, 8), "smem"),
    "starts, m 1": ((1, 5, 20, 129, 1, 1), "smem"),
    "starts, m 32": ((2, 100, 20, 300, 48, 32), "smem"),
    "starts, m 40": ((2, 100, 20, 300, 48, 40), "smem"),
    "starts, m 100, wide": ((2, 3000, 300, 5000, 48, 100), "smem + L2"),
}


@pytest.mark.parametrize("limit", [_H100_SMEM, 48 * 1024])
@pytest.mark.parametrize("name", sorted(_PLAN_SHAPES))
def test_match_plan_covers_every_lane_within_the_budget(name, limit):
    (P, n, k, B, L, ns), branch = _PLAN_SHAPES[name]
    starts = name.startswith("starts")
    plan = ops.match_plan(P, n, k, B, L, ns, _SMS, limit, starts)
    if limit == _H100_SMEM:
        assert plan.branch == branch
    assert plan.rows + plan.global_rows == n and plan.rows >= 0
    # two blocks an SM, or one (twice the bytes) for a small launch or a
    # start-major walk over a table that does not fit beside the slabs;
    # never more than a block may opt in to
    small = P * -(-B // plan.chunks_per_warp) * plan.groups <= _SMS * 16
    major = ns >= 32 and not starts
    one_an_sm = small or (major
                          and n * (k | 1) * 4 > ops.MATCH_SMEM_BLOCK // 2)
    budget = min(ops.MATCH_SMEM_BLOCK * (2 if one_an_sm else 1), limit)
    assert plan.smem <= budget
    assert plan.smem == (plan.patterns * plan.rows * (k | 1)
                         + plan.threads // 32 * plan.slab_words
                         * plan.stride) * 4
    assert 1 <= plan.patterns <= P
    assert plan.sym_per_word == (4 if k <= 256 else 1)
    assert 1 <= plan.chains <= 3 and plan.stride % 2 == 1
    assert plan.slab_words <= max(1, ops.MATCH_WARP_WORDS // plan.stride)
    warps_words = plan.threads // 32 * plan.stride
    assert (plan.slab_words == 1
            or plan.slab_words * warps_words * 4 <= budget // 2)
    lanes = 32 * plan.chains
    if major:         # start-major: one chunk a warp, its starts in groups
        assert plan.one_chunk and plan.chunks_per_warp == 1
        assert plan.lanes_per_chunk == lanes
        assert (plan.groups - 1) * lanes < ns <= plan.groups * lanes
    else:             # chunk-major: whole chunks a warp, up to 32 starts of
        qw = min(ns, 32)   # each a warp task (explicit starts past 32)
        assert not plan.one_chunk and plan.chains <= 2
        assert plan.lanes_per_chunk == qw
        assert (plan.groups - 1) * qw < ns <= plan.groups * qw
        assert plan.chunks_per_warp == lanes // qw >= 1
    # a small launch spreads its patterns over SMs, one a block; otherwise
    # a block takes a group of them, the groups of even size
    groups = -(-P // plan.patterns)
    assert P - plan.patterns * (groups - 1) > plan.patterns - groups
    if small:
        assert plan.patterns == 1
    sym = plan.threads // 32 * plan.slab_words * plan.stride * 4
    assert plan.rows == min(n, (budget - sym) // (plan.patterns * (k | 1) * 4))
    if n * (k | 1) * 4 <= budget - sym:    # whole tables where one fits
        assert plan.global_rows == 0
    elif major or small:                   # else the first rows of one
        assert plan.patterns == 1
    else:                                  # or tables sharing the rows
        assert plan.rows >= min(n, ops.MATCH_MIN_ROWS)


def test_match_plan_chains_follow_the_work():
    def plan(*shape):
        return ops.match_plan(*shape, _SMS, _H100_SMEM)

    # chunk-major: two chains a thread where the warps fill the card, one
    # for a small launch (a stream piece)
    assert plan(18, 272, 20, 524_288, 48, 1).chains == 2
    assert plan(23, 7184, 20, 256, 256, 1).chains == 1
    assert plan(1, 272, 20, 64 * 1056, 48, 1).chains == 2
    assert plan(1, 272, 20, 64 * 1056 - 64, 48, 1).chains == 1
    # start-major: ceil(n_starts / 32) up to 3
    assert [plan(1, 200, 20, 10, 8, ns).chains
            for ns in (32, 33, 64, 87, 128, 200)] == [1, 2, 2, 3, 3, 3]
    assert plan(1, 200, 20, 10, 8, 200).groups == 3
    # walks from explicit starts: chunk-major whatever their number
    assert plan(1, 200, 20, 10, 8, 87).one_chunk
    many = ops.match_plan(1, 200, 20, 10, 8, 87, _SMS, _H100_SMEM, True)
    assert not many.one_chunk and many.groups == 3 and many.chains == 1
    assert ops.match_plan(24, 702, 20, 524_288, 48, 8, _SMS, _H100_SMEM,
                          True) == plan(24, 702, 20, 524_288, 48, 8)
    # start-major over a table too large to stage: 2 chains, one block an SM
    wide = plan(2, 7184, 20, 4096, 48, 7184)
    assert wide.chains == 2 and wide.smem > ops.MATCH_SMEM_BLOCK
    # a small launch (a stream piece): the warps its pattern needs, one
    # block an SM, rows for the walks that go deep
    piece = plan(23, 7184, 20, 256, 256, 1)
    assert piece.threads == 256 and piece.rows > 2 * 783
    # a slab holds all of a chunk where it fits, so the tables of a block
    # share one staging
    assert plan(5, 87, 20, 524_288, 48, 87).patterns == 5
    assert plan(5, 87, 20, 524_288, 48, 87).slab_words == 12


def test_build_names_one_library_per_source():
    paths = {build.library_path(n) for n in build.KERNELS}
    assert len(paths) == len(build.KERNELS)
    for n in build.KERNELS:
        assert (build.CSRC / f"{n}.cu").is_file()
        assert build.library_path(n).parent == build.BUILD_DIR


def test_library_name_follows_shared_headers(tmp_path, monkeypatch):
    """An edited ``.cuh`` header renames every library, so no stale build
    of a source that includes it is loaded."""
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build.library_path(n) for n in build.KERNELS}
    header = tmp_path / "clmul.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in build.KERNELS}
    assert all(before[n] != after[n] for n in build.KERNELS)
    assert '#include "clmul.cuh"' in (tmp_path / "fingerprint.cu").read_text()


# --------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode); "
                    "chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("P,B,W", [(3, 1000, 7), (6, 2560, 44)])
def test_fingerprint_bank_kernel_on_card(cuda, P, B, W):
    args = [_i32(a).to(cuda) for a in _fp_inputs(P, B, W, seed=B)]
    before = ops.launches["fingerprint_bank"]
    assert torch.equal(ops.fingerprint_bank(*args),
                       ref.fingerprint_bank(*args))
    assert ops.launches["fingerprint_bank"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,n", [(3, 37, 13), (6, 128, 87)])
def test_expand_bank_kernel_on_card(cuda, B, T, n):
    rng = np.random.default_rng(T)
    tables = torch.from_numpy(
        rng.integers(0, n, size=(B, n, 20)).astype(np.int32)).to(cuda)
    ft = torch.from_numpy(
        rng.integers(0, n, size=(B, T, n)).astype(np.int32)).to(cuda)
    assert torch.equal(ops.expand_bank(tables, ft), ref.expand_bank(tables, ft))


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_starts", [(87, 87), (87, 1), (7184, 7184),
                                        (7184, 1)])
def test_match_bank_chunks_kernel_on_card(cuda, n, n_starts):
    tables, chunks = _match_inputs(2, n, 20, 300, 48, seed=n)
    t, c = torch.from_numpy(tables).to(cuda), torch.from_numpy(chunks).to(cuda)
    assert torch.equal(ops.match_bank_chunks(t, c, n_starts),
                       ref.match_bank_chunks(t, c, n_starts))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,n", [(3, 37, 13), (2, 5, 6), (6, 128, 87)])
def test_expand_bank_words_kernel_on_card(cuda, B, T, n):
    rng = np.random.default_rng(T)
    tables, ft = (torch.from_numpy(rng.integers(0, n, size=s).astype(np.int32))
                  .to(cuda) for s in ((B, n, 20), (B, T, n)))
    masks = _i32(_u32(rng, (B, (n + 1) // 2))).to(cuda)
    before = ops.launches["expand_bank"]
    got = ops.expand_bank(tables, ft, masks)
    assert ops.launches["expand_bank"] == before + 1
    want = ref.expand_bank(tables, ft, masks)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_expand_bank_kernel_rejects_a_table_it_cannot_stage(cuda):
    # Rows padded to k | 1 = 21 words: (2800, 20) is 235,200 bytes staged,
    # over the H100's 232,448 (unpadded it would have been 224,000).
    n = 2800
    before = ops.launches["expand_bank"]
    with pytest.raises(ValueError, match="shared memory"):
        ops.expand_bank(torch.zeros((1, n, 20), dtype=torch.int32,
                                    device=cuda),
                        torch.zeros((1, 1, n), dtype=torch.int32, device=cuda))
    assert ops.launches["expand_bank"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(3, 87), (20_000, 87), (7, 9000)])
def test_compose_kernel_on_card(cuda, B, n):
    rng = np.random.default_rng(B)
    f, g = (torch.from_numpy(rng.integers(0, n, size=(B, n)).astype(np.int32))
            .to(cuda) for _ in range(2))
    before = ops.launches["compose"]
    assert torch.equal(ops.compose(f, g), ref.compose(f, g))
    assert ops.launches["compose"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,n,first", [(23, 32, 87, True),
                                         (1001, 9, 13, False),
                                         (7, 2, 9000, True)])
def test_compose_fold_kernel_on_card(cuda, B, m, n, first):
    rng = np.random.default_rng(B)
    gs = torch.from_numpy(
        rng.integers(0, n, size=(B, m, n)).astype(np.int32)).to(cuda)
    f = (torch.from_numpy(rng.integers(0, n, size=(B, n)).astype(np.int32))
         .to(cuda) if first else None)
    before = ops.launches["compose"]
    assert torch.equal(ops.compose_fold(f, gs), ref.compose_fold(f, gs))
    assert ops.launches["compose"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("P,S,n,D,m", [(23, 7184, 87, 300, 8),
                                       (3, 5, 13, 1001, 1), (2, 3, 700, 9, 3)])
def test_compose_fold_rows_kernel_on_card(cuda, P, S, n, D, m):
    rng = np.random.default_rng(D)
    stacks = torch.from_numpy(
        rng.integers(0, n, size=(P, S, n)).astype(np.int32)).to(cuda)
    idx = torch.from_numpy(
        rng.integers(0, S, size=(P, D, m)).astype(np.int32)).to(cuda)
    before = ops.launches["compose"]
    assert torch.equal(ops.compose_fold_rows(stacks, idx),
                       ref.compose_fold_rows(stacks, idx))
    assert ops.launches["compose"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,B,L", [(87, 4096, 64), (13, 1001, 7),
                                   (7184, 300, 48)])
def test_match_chunks_kernel_on_card(cuda, n, B, L):
    (table,), chunks = _match_inputs(1, n, 20, B, L, seed=n)
    t, c = torch.from_numpy(table).to(cuda), torch.from_numpy(chunks).to(cuda)
    assert torch.equal(ops.match_chunks(t, c), ref.match_chunks(t, c))


@pytest.mark.cuda
@pytest.mark.parametrize("B,W", [(1000, 7), (81_920, 44)])
def test_fingerprint_kernel_on_card(cuda, B, W):
    words, weights, limbs = (_i32(a).to(cuda)
                             for a in _fp_inputs(1, B, W, seed=B))
    args = (words[0], weights[0], limbs[0])
    assert torch.equal(ops.fingerprint(*args), ref.fingerprint(*args))


def _jax_walks(tables, chunks, n_starts):
    """The same walks through the JAX package's reference: each table's
    ``match_chunks_ref`` (every start state), its first ``n_starts``
    columns -> (P, B, n_starts) numpy."""
    c = jnp.asarray(chunks.cpu().numpy())
    return np.stack([np.asarray(match_chunks_ref(jnp.asarray(t), c))
                     [:, :n_starts] for t in tables.cpu().numpy()])


def _walk_case(cuda, P, n, k, B, L, n_starts, seed, lo=0, offset=0,
               jax_every=1):
    """Tables of entries in [lo, n), chunks (B, L) at ``offset`` int32s
    past an aligned allocation; walked by the kernel, the plain version and,
    on every ``jax_every``-th chunk, the JAX package's reference."""
    rng = np.random.default_rng(seed)
    tables = torch.from_numpy(
        rng.integers(lo, n, size=(P, n, k)).astype(np.int32)).to(cuda)
    flat = torch.from_numpy(
        rng.integers(0, k, size=offset + B * L).astype(np.int32)).to(cuda)
    chunks = flat[offset:].view(B, L)
    before = ops.launches["match_bank_chunks"]
    got = ops.match_bank_chunks(tables, chunks, n_starts)
    assert ops.launches["match_bank_chunks"] == before + 1
    assert torch.equal(got, ref.match_bank_chunks(tables, chunks, n_starts))
    assert np.array_equal(got[:, ::jax_every].cpu().numpy(), _jax_walks(
        tables, chunks[::jax_every], n_starts))


def _staged_rows(P, k, B, L, n_starts):
    """R: the rows the plan stages of a table too large to stage whole."""
    return ops.match_plan(P, 1 << 20, k, B, L, n_starts, ops._sm_count(0),
                          ops._smem_limit(0)).rows


@pytest.mark.cuda
@pytest.mark.parametrize("n_starts", [1, 87])
@pytest.mark.parametrize("where", ["top rows", "R rows", "R + 1 rows"])
def test_match_bank_chunks_kernel_rows_past_the_staged(cuda, where, n_starts):
    P, k, B, L = 2, 20, 300, 48
    R = _staged_rows(P, k, B, L, n_starts)
    if where == "top rows":     # every transition lands on a row >= R
        n, lo = R + 200, R
    else:
        n, lo = (R if where == "R rows" else R + 1), 0
    plan = ops.match_plan(P, n, k, B, L, n_starts, ops._sm_count(0),
                          ops._smem_limit(0))
    assert plan.rows == R and plan.global_rows == n - R
    _walk_case(cuda, P, n, k, B, L, n_starts, seed=n, lo=lo)


@pytest.mark.cuda
def test_match_bank_chunks_kernel_tables_share_a_block(cuda):
    # chunk-major walks of a launch too large to be small: a block stages
    # the first rows of several tables and walks each slab through them all
    P, n, k, B, L = 6, 1000, 20, 30_000, 48
    plan = ops.match_plan(P, n, k, B, L, 1, ops._sm_count(0),
                          ops._smem_limit(0))
    assert plan.patterns == P and 0 < plan.rows < n
    # the JAX reference walks every start of a chunk: every 10th chunk
    _walk_case(cuda, P, n, k, B, L, 1, seed=P, jax_every=10)


@pytest.mark.cuda
@pytest.mark.parametrize("n_starts", [1, 31, 32, 33, 87, 100])
def test_match_bank_chunks_kernel_n_starts(cuda, n_starts):
    _walk_case(cuda, 3, 100, 20, 1001, 48, n_starts, seed=n_starts)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,offset", [(1001, 7, 0), (333, 50, 0),
                                        (257, 48, 1), (129, 1, 0)])
@pytest.mark.parametrize("n_starts", [1, 13, 40])
def test_match_bank_chunks_kernel_ragged_chunks(cuda, B, L, offset,
                                                n_starts):
    # B off the warp's tile, L off 4 and 16, chunks off 16-byte alignment
    _walk_case(cuda, 2, 40, 20, B, L, n_starts, seed=B, offset=offset)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 256, 257, 300])
@pytest.mark.parametrize("n_starts", [1, 50])
def test_match_bank_chunks_kernel_alphabets(cuda, k, n_starts):
    # byte symbols up to k = 256, int32 symbols above
    assert ops.match_plan(2, 50, k, 500, 33, n_starts, _SMS,
                          _H100_SMEM).sym_per_word == (4 if k <= 256 else 1)
    _walk_case(cuda, 2, 50, k, 500, 33, n_starts, seed=k)


@pytest.mark.cuda
def test_match_chunks_kernel_at_locate_shape(cuda):
    (table,), chunks = _match_inputs(1, 87, 20, 4096, 1024, seed=87)
    t, c = torch.from_numpy(table).to(cuda), torch.from_numpy(chunks).to(cuda)
    before = ops.launches["match_chunks"]
    got = ops.match_chunks(t, c)
    assert ops.launches["match_chunks"] == before + 1
    assert torch.equal(got, ref.match_chunks(t, c))
    assert np.array_equal(got.cpu().numpy(), np.asarray(
        match_chunks_ref(jnp.asarray(table), jnp.asarray(chunks))))


@pytest.mark.cuda
@pytest.mark.parametrize("P,n,k,B,L,m", [(24, 702, 20, 4096, 48, 8),
                                         (3, 13, 20, 1001, 7, 8),
                                         (2, 3000, 20, 300, 48, 8),
                                         (2, 100, 20, 300, 48, 32),
                                         (2, 100, 20, 300, 48, 40),
                                         (2, 3000, 300, 500, 48, 100),
                                         (1, 5, 20, 129, 1, 1)])
def test_match_bank_chunks_kernel_explicit_starts(cuda, P, n, k, B, L, m):
    # the speculative pass: lane q of pattern p walks from starts[p, q],
    # on staged rows, past them (n = 3000), with int32 symbols (k = 300)
    # and past 32 starts (chunk-major, ceil(m / 32) warp tasks a chunk)
    rng = np.random.default_rng(n + m)
    tables, chunks = (torch.from_numpy(a).to(cuda)
                      for a in _match_inputs(P, n, k, B, L, seed=n))
    starts = torch.from_numpy(
        rng.integers(0, n, size=(P, m)).astype(np.int32)).to(cuda)
    plan = ops.match_plan_of(tables, chunks, m, from_starts=True)
    assert not plan.one_chunk and plan.groups == -(-m // 32)
    before = ops.launches["match_bank_chunks"]
    walks = ops.form_launches["match_bank_chunks.starts"]
    got = ops.match_bank_chunks(tables, chunks, m, starts)
    assert ops.launches["match_bank_chunks"] == before + 1
    assert ops.form_launches["match_bank_chunks.starts"] == walks + 1
    assert torch.equal(got, ref.match_bank_chunks(tables, chunks, m, starts))
    # the JAX package's walk from every state, at starts[p, q], on every
    # 8th chunk
    every = _jax_walks(tables, chunks[::8], n)
    assert np.array_equal(got[:, ::8].cpu().numpy(), np.take_along_axis(
        every, starts.cpu().numpy()[:, None, :].repeat(every.shape[1], 1),
        axis=2))


@pytest.mark.cuda
@pytest.mark.parametrize("profile,max_rounds", [("hit all", 8),
                                                ("miss all", 2),
                                                ("miss all", 8),
                                                ("sampled", 1)])
def test_spec_resolve_kernel_on_card(cuda, profile, max_rounds):
    P, n, k, D, C, Lc, m = 5, 40, 20, 3000, 8, 12, 8
    rng = np.random.default_rng(max_rounds)
    tables = rng.integers(0, n, size=(P, n, k)).astype(np.int32)
    if profile == "hit all":        # every state speculated
        tables %= m
        spec = np.tile(np.arange(m, dtype=np.int32), (P, 1))
    elif profile == "miss all":     # states the walks never enter
        tables %= n - m
        spec = np.tile(np.arange(n - m, n, dtype=np.int32), (P, 1))
    else:
        spec = rng.integers(0, n, size=(P, m)).astype(np.int32)
    t = torch.from_numpy(tables).to(cuda)
    sp = torch.from_numpy(spec).to(cuda)
    starts = torch.from_numpy(rng.integers(
        0, m if profile == "hit all" else n - m, size=P).astype(np.int32)
    ).to(cuda)
    chunks = torch.from_numpy(
        rng.integers(0, k, size=(D * C, Lc)).astype(np.int32)).to(cuda)
    exits = ops.match_bank_chunks(t, chunks, m, sp)
    before = ops.launches["spec_resolve"]
    got = ops.spec_resolve(t, sp, starts, exits, chunks, C, max_rounds)
    assert ops.launches["spec_resolve"] == before + 1
    want = ref.spec_resolve(t, sp, starts, exits, chunks, C, max_rounds)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # both launches through the port's executor, against the JAX
    # package's speculative_bank_finals: all five outputs
    corpus = chunks.view(D, C * Lc)
    both = speculative_bank_finals(t, sp, starts, corpus, C, max_rounds)
    jref = jfinals(*(jnp.asarray(x.cpu().numpy())
                     for x in (t, sp, starts, corpus)),
                   n_chunks=C, max_rounds=max_rounds)
    for a, b, c in zip(both, got, jref):
        assert torch.equal(a, b)
        assert np.array_equal(a.cpu().numpy(), np.asarray(c))
    hits, repaired = int(got[2]), int(got[3])
    if profile == "hit all":
        assert hits == P * D * C and repaired == 0
    elif profile == "miss all":
        assert hits == 0 and repaired == P * D * min(C, max_rounds)
        assert bool(got[1].all()) == (max_rounds >= C)


# --------------------------------------------------------------------------
# spec_resolve's chained form: a stream's blocks in one call
# --------------------------------------------------------------------------


def _chain_inputs(seed, P, n, k, D, C, Lc, m, profile="random"):
    """Tables, profile, starts, chunks and exits of a chained resolve: a
    profile that hits every chunk (tables on states 0 .. m-1), misses every
    chunk (tables never enter the m speculated states) or is random."""
    rng = np.random.default_rng(seed)
    hi = {"hit": m, "miss": n - m}.get(profile, n)
    tables = rng.integers(0, hi, size=(P, n, k)).astype(np.int32)
    if profile == "hit":
        spec = np.tile(np.arange(m, dtype=np.int32), (P, 1))
    elif profile == "miss":
        spec = np.tile(np.arange(n - m, n, dtype=np.int32), (P, 1))
    else:
        spec = rng.integers(0, n, size=(P, m)).astype(np.int32)
    starts = rng.integers(0, hi, size=P).astype(np.int32)
    chunks = rng.integers(0, k, size=(D * C, Lc)).astype(np.int32)
    t = [torch.from_numpy(a) for a in (tables, spec, starts, chunks)]
    exits = ref.match_bank_chunks(t[0], t[3], m, t[1])
    return t[0], t[1], t[2], exits, t[3]


def _reference_block_loop(tables, spec, starts, chunks, C, max_rounds):
    """The reference stream's loop over blocks: the JAX package's
    ``speculative_bank_finals`` on one block from the current states, an
    exact walk of the block for each lane it leaves unresolved, and the
    stats merged (sums; the most rounds)."""
    tab, sp = tables.numpy(), spec.numpy()
    ch = chunks.numpy()
    D = ch.shape[0] // C
    state = starts.numpy().copy()
    totals = np.zeros(4, dtype=np.int64)
    rows = np.arange(tab.shape[0])
    for d in range(D):
        block = ch[d * C:(d + 1) * C].reshape(1, -1)
        finals, resolved, hits, repaired, rounds = (np.asarray(x) for x in (
            jfinals(jnp.asarray(tab), jnp.asarray(sp), jnp.asarray(state),
                    jnp.asarray(block), n_chunks=C, max_rounds=max_rounds)))
        exact = state.copy()
        for sym in block[0]:
            exact = tab[rows, exact, sym]
        state = np.where(resolved[:, 0], finals[:, 0], exact).astype(np.int32)
        totals += [int(hits), int(repaired), 0, int((~resolved).sum())]
        totals[2] = max(totals[2], int(rounds))
    return state, totals


@pytest.mark.parametrize("case", [*(f"seed {s}" for s in range(6)),
                                  "one doc", "miss all", "max_rounds 0",
                                  "ragged Lc", "hit all"])
def test_spec_resolve_chain_equals_the_block_loop(case):
    """The chained form (its plain version, through the wrapper) against
    the reference stream's loop over blocks: the final states and the four
    totals."""
    seed = int(case.split()[-1]) if case.startswith("seed") else 11
    rng = np.random.default_rng(seed)
    P, n, k, D, C = 3, int(rng.integers(6, 30)), 4, 5, 4
    Lc, m, rounds = int(rng.integers(2, 9)), int(rng.integers(1, 5)), \
        int(rng.integers(1, 4))
    profile = "random"
    if case == "one doc":
        D = 1
    elif case == "miss all":
        profile, rounds = "miss", 2
    elif case == "max_rounds 0":
        rounds = 0
    elif case == "ragged Lc":
        Lc = 7
    elif case == "hit all":
        profile = "hit"
    tables, spec, starts, exits, chunks = _chain_inputs(
        seed, P, n, k, D, C, Lc, m, profile)
    got = ops.spec_resolve_chain(tables, spec, starts, exits, chunks, C,
                                 rounds)
    want = ref.spec_resolve_chain(tables, spec, starts, exits, chunks, C,
                                  rounds)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int64
    assert got[0].shape == (P,) and got[1].shape == (4,)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    state, totals = _reference_block_loop(tables, spec, starts, chunks, C,
                                          rounds)
    assert np.array_equal(got[0].numpy(), state)
    assert got[1].tolist() == totals.tolist()
    hits, repaired, most, fallback = totals.tolist()
    if profile == "hit":
        assert hits == P * D * C and repaired == fallback == 0
    if profile == "miss":
        assert hits == 0 and repaired == P * D * rounds
        assert fallback == P * D and most == rounds
    if rounds == 0:
        assert repaired == most == 0


def test_spec_resolve_chain_rejects_what_the_kernel_does_not_take():
    tables, spec, starts, exits, chunks = _chain_inputs(1, 2, 6, 4, 3, 2, 5,
                                                        3)
    ops.spec_resolve_chain(tables, spec, starts, exits, chunks, 2, 1)
    for bad in ((tables, spec, starts, exits, chunks, 4, 1),   # 6 % 4
                (tables, spec, starts, exits[:, :2], chunks, 2, 1),
                (tables, spec, starts[:1], exits, chunks, 2, 1),
                (tables, spec[:, :2], starts, exits, chunks, 2, 1),
                (tables, spec, starts, exits, chunks, 2, -1),
                (tables[0], spec, starts, exits, chunks, 2, 1),
                (tables, spec, starts, exits, chunks.to("meta"), 2, 1)):
        with pytest.raises(ValueError):
            ops.spec_resolve_chain(*bad)
    with pytest.raises(TypeError):
        ops.spec_resolve_chain(tables, spec, starts.to(torch.int64), exits,
                               chunks, 2, 1)
    with pytest.raises(ValueError):
        ops.spec_resolve_chain(tables, spec, starts, exits.transpose(0, 1)
                               .contiguous().transpose(0, 1), chunks, 2, 1)


@pytest.mark.parametrize("n,k,m,C,chained,limit", [
    (702, 20, 8, 8, False, 232448), (702, 20, 8, 8, True, 232448),
    (7184, 20, 8, 8, False, 232448), (7184, 20, 8, 8, True, 232448),
    (13, 4, 3, 4, True, 232448), (702, 20, 40, 8, True, 232448),
    (702, 20, 40, 8, False, 232448), (702, 20, 8, 8, False, 101376),
    (3000, 20, 300, 8, True, 232448)])
def test_resolve_plan_stages_within_the_budget(n, k, m, C, chained, limit):
    """``spec_resolve``'s shared layout: the profile, a chained group of
    exits (32 chunks at m = 8, at least one) or a slab of 32 docs' exits a
    warp where 16 of them fit their budget, and as many table rows as the
    block's budget holds, all of a 702 x 20 table."""
    plan = ops.resolve_plan(n, k, m, C, limit, chained)
    rowb = (k | 1) * 4
    budget = (limit if chained or plan.slab
              else min(ops.SPEC_SMEM_BLOCK, limit))
    assert plan.smem <= budget and plan.rows + plan.global_rows == n
    assert plan.rows == n or plan.smem + rowb > budget
    if chained:
        assert plan.group == max(1, min(32, ops.SPEC_GROUP_WORDS // m))
        assert plan.slab == 0 and plan.smem >= 4 * m * (1 + plan.group)
    else:
        assert plan.group == 0
        slabs = 16 * 4 * 32 * (C * m + 1)
        fits = slabs <= min(ops.SPEC_SLAB_BYTES,
                            limit - ops.SPEC_SMEM_BLOCK // 2)
        assert plan.slab == (32 * (C * m + 1) if fits else 0)
        assert plan.smem >= 16 * 4 * plan.slab
    if (n, k) == (702, 20) and limit == 232448:
        assert plan.branch == "smem"
    if n == 7184:
        assert plan.branch == "smem + L2"


@pytest.mark.cuda
@pytest.mark.parametrize("profile,m,n,Lc,rounds", [
    ("hit", 8, 702, 256, 8), ("miss", 8, 702, 256, 1),
    ("random", 8, 702, 256, 8), ("random", 3, 40, 7, 2),
    ("random", 40, 60, 12, 1), ("random", 8, 3000, 16, 3)])
def test_spec_resolve_chain_kernel_on_card(cuda, profile, m, n, Lc, rounds):
    """The chained kernel against its plain version and the reference
    stream's loop: one warp a pattern, a profile past 32 states (several
    ballots), tables past the shared budget (rows from L2), ragged Lc."""
    P, D, C = 3, 6, 8
    args = [x.to(cuda) for x in _chain_inputs(n, P, n, 20, D, C, Lc, m,
                                              profile)]
    before = (ops.launches["spec_resolve"],
              ops.form_launches["spec_resolve.chain"])
    got = ops.spec_resolve_chain(*args, C, rounds)
    assert (ops.launches["spec_resolve"],
            ops.form_launches["spec_resolve.chain"]) == (before[0] + 1,
                                                         before[1] + 1)
    want = ref.spec_resolve_chain(*args, C, rounds)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    tables, spec, starts, _, chunks = (x.cpu() for x in args)
    state, totals = _reference_block_loop(tables, spec, starts, chunks, C,
                                          rounds)
    assert np.array_equal(got[0].cpu().numpy(), state)
    assert got[1].tolist() == totals.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,Lc", [(3, 40, 7), (12, 40, 12), (4, 3000, 16),
                                    (8, 702, 48)])
def test_spec_resolve_kernel_forms_on_card(cuda, m, n, Lc):
    """The independent-docs kernel off its m = 8 path: m not a multiple of
    4 (exits loaded a word at a time), m > 8 (the profile in shared
    memory), a table past the block's budget (rows from L2) and the stream's
    table size."""
    P, D, C = 4, 1500, 8
    tables, spec, starts, _, chunks = (
        x.to(cuda) for x in _chain_inputs(m + n, P, n, 20, D, C, Lc, m))
    exits = ops.match_bank_chunks(tables, chunks, m, spec)
    for rounds in (0, 1, 8):
        got = ops.spec_resolve(tables, spec, starts, exits, chunks, C, rounds)
        want = ref.spec_resolve(tables, spec, starts, exits, chunks, C,
                                rounds)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
