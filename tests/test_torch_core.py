"""The port's core (``repro_torch.core``) against the reference's.

Same inputs, made with numpy from a seed, through both packages; every path
is integer arithmetic, so the tolerance is equality.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bucketing as jbucketing  # noqa: E402
from repro.core import fingerprint as jfp  # noqa: E402
from repro.core import matching as jmatching  # noqa: E402
from repro.core import monoid as jmonoid  # noqa: E402
from repro.core.prosite import load_bank as jload_bank  # noqa: E402
from repro_torch.core import bucketing, fingerprint as fp  # noqa: E402
from repro_torch.core import matching, monoid  # noqa: E402
from repro_torch.core.dfa import compile_dfa, random_dfa  # noqa: E402
from repro_torch.core.multipattern import PatternBank, census_sequential  # noqa: E402
from repro_torch.core.prosite import load_bank  # noqa: E402

POLYS = [fp.nth_poly_low(i) for i in range(3)]

# The reference's limb functions, jitted once per shape: eager dispatch of
# their unrolled bit loops costs seconds per call on the CPU.
_jclmul32 = jax.jit(jfp.clmul32)
_jclmul64 = jax.jit(jfp.clmul64)
_jbarrett = jax.jit(jfp.barrett_reduce_u32, static_argnums=1)
_jfingerprint_states = jax.jit(jfp.fingerprint_states, static_argnums=1)


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


@pytest.mark.parametrize("seed", [0, 1])
def test_clmul32_and_clmul64_match_reference(seed):
    rng = np.random.default_rng(seed)
    a, b, c, d = (_u32(rng, 64) for _ in range(4))
    t = [torch.from_numpy(x.astype(np.int64)) for x in (a, b, c, d)]
    hi, lo = fp.clmul32(t[0], t[1])
    jhi, jlo = _jclmul32(jnp.asarray(a), jnp.asarray(b))
    assert np.array_equal(hi.numpy(), np.asarray(jhi))
    assert np.array_equal(lo.numpy(), np.asarray(jlo))
    got = fp.clmul64((t[0], t[1]), (t[2], t[3]))
    want = _jclmul64((jnp.asarray(a), jnp.asarray(b)),
                       (jnp.asarray(c), jnp.asarray(d)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    for i in range(8):   # and the big-int oracle
        prod = fp.clmul_int(int(a[i]), int(b[i]))
        assert (int(hi[i]) << 32 | int(lo[i])) == prod


@pytest.mark.parametrize("sa,sb", [((5, 1), (1, 7)), ((3, 4), (4,)),
                                   ((4,), (3, 4)), ((2, 1, 3), (4, 1))])
def test_clmul32_broadcasts_like_the_reference(sa, sb):
    # the table is built from the smaller operand; neither operand need
    # have the broadcast shape. The reference's clmul32 takes operands of
    # one shape: it gets them broadcast.
    rng = np.random.default_rng(len(sa) * 10 + len(sb))
    a, b = _u32(rng, sa), _u32(rng, sb)
    hi, lo = fp.clmul32(torch.from_numpy(a.astype(np.int64)),
                        torch.from_numpy(b.astype(np.int64)))
    ja, jb = (jnp.asarray(np.ascontiguousarray(x))
              for x in np.broadcast_arrays(a, b))
    jhi, jlo = _jclmul32(ja, jb)
    assert hi.shape == np.broadcast_shapes(sa, sb)
    assert np.array_equal(hi.numpy(), np.asarray(jhi))
    assert np.array_equal(lo.numpy(), np.asarray(jlo))


@pytest.mark.parametrize("poly", POLYS)
def test_barrett_matches_int_oracle(poly):
    consts = fp.BarrettConstants.cached(poly)
    rng = np.random.default_rng(poly & 0xFFFF)
    limbs = _u32(rng, (4, 32)).astype(np.int64)
    got_hi, got_lo = fp.barrett_reduce_u32(
        tuple(torch.from_numpy(x) for x in limbs), consts)
    jconsts = jfp.BarrettConstants.cached(poly)
    want_hi, want_lo = _jbarrett(
        tuple(jnp.asarray(x.astype(np.uint32)) for x in limbs), jconsts)
    assert np.array_equal(got_hi.numpy(), np.asarray(want_hi))
    assert np.array_equal(got_lo.numpy(), np.asarray(want_lo))
    for j in range(4):
        a = sum(int(limbs[3 - i, j]) << (32 * i) for i in range(4))
        want = jfp.barrett_reduce_int(a, jconsts)
        assert (int(got_hi[j]) << 32 | int(got_lo[j])) == want


@pytest.mark.parametrize("n_words,poly", [(1, POLYS[0]), (7, POLYS[1]),
                                          (44, POLYS[2])])
def test_fold_weights_match_reference(n_words, poly):
    got = fp.fold_weights_u32(n_words, fp.BarrettConstants.cached(poly))
    want = jfp.fold_weights_u32(n_words, jfp.BarrettConstants.cached(poly))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1), (7, 2), (33, 3),
                                    (87, 4)])
def test_fingerprint_and_pack_agree_with_np_jax_int(n, seed):
    rng = np.random.default_rng(seed)
    states = rng.integers(0, 1 << 16, size=(4, n)).astype(np.int32)
    consts = fp.BarrettConstants.create()
    jconsts = jfp.BarrettConstants.create()
    packed = fp.pack_states_u32(torch.from_numpy(states))
    assert np.array_equal(
        packed.numpy(),
        np.asarray(jfp.pack_states_u32(jnp.asarray(states))).astype(np.int64))
    assert np.array_equal(packed.numpy(),
                          fp.pack_states_np(states).astype(np.int64))
    weights = fp.fold_weights_u32(packed.shape[-1], consts)
    hi, lo = fp.fingerprint_u32(packed, weights, consts)
    got = np.stack([hi.numpy(), lo.numpy()], axis=-1).astype(np.uint32)
    assert np.array_equal(got, jfp.fingerprint_states_np(states, jconsts))
    assert np.array_equal(got, np.asarray(
        _jfingerprint_states(jnp.asarray(states), jconsts)))
    assert np.array_equal(
        fp.fingerprint_states(torch.from_numpy(states), consts).numpy()
        .astype(np.uint32), got)
    for b in range(4):
        want = jfp.fingerprint_int(fp.pack_states_np(states)[b], jconsts)
        assert (int(got[b, 0]) << 32 | int(got[b, 1])) == want


def test_u32_int32_round_trip():
    vals = torch.tensor([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1])
    bits = fp.u32_to_i32(vals)
    assert bits.dtype == torch.int32
    assert bits.tolist() == [0, 1, (1 << 31) - 1, -(1 << 31), -1]
    assert torch.equal(fp.i32_to_u32(bits), vals)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_function_monoid_and_reduce_match_reference(seed):
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 9, size=(5, 3, 9)).astype(np.int32)
    FN, JFN = monoid.function_monoid(), jmonoid.function_monoid()
    got = FN.combine(torch.from_numpy(xs[0]), torch.from_numpy(xs[1]))
    assert np.array_equal(got.numpy(), np.asarray(
        JFN.combine(jnp.asarray(xs[0]), jnp.asarray(xs[1]))))
    for axis in (0, 1):
        got = monoid.reduce(FN, torch.from_numpy(xs), axis=axis)
        want = jmonoid.reduce(JFN, jnp.asarray(xs), axis=axis)
        assert np.array_equal(got.numpy(), np.asarray(want))
    ident = FN.identity(torch.from_numpy(xs[0]))
    assert torch.equal(FN.combine(ident, torch.from_numpy(xs[2])),
                       torch.from_numpy(xs[2]))


@pytest.mark.parametrize("seed", [0, 1])
def test_function_monoid_fold_matches_reference(seed):
    """``fold(first, xs)``: the first element then the stacked ones, in one
    call — the reference's reduce of them all; ``None`` starts from the
    identity. ``first`` (P, n) and ``xs`` (P, D, n), as in a stream piece."""
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 7, size=(3, 6, 7)).astype(np.int32)
    FN, JFN = monoid.function_monoid(), jmonoid.function_monoid()
    want = jmonoid.reduce(JFN, jnp.asarray(xs), axis=1)
    got = FN.fold(torch.from_numpy(xs[:, 0]), torch.from_numpy(xs[:, 1:]))
    assert np.array_equal(got.numpy(), np.asarray(want))
    got = FN.fold(None, torch.from_numpy(xs))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(FN.fold(None, torch.from_numpy(xs[0])).numpy(),
                          np.asarray(jmonoid.reduce(JFN, jnp.asarray(xs[0]))))


def _lm_elements(name: str, rng, L: int = 11):
    """A stack of L elements of the affine or softmax monoid, along axis 1
    (a leading batch axis of 2), f32, as numpy arrays."""
    if name == "affine":
        # mamba2's shape: a (B, L, H, 1, 1) broadcasts against b (B, L, H, N, P)
        return (rng.uniform(0.1, 1.0, (2, L, 3, 1, 1)).astype(np.float32),
                rng.normal(size=(2, L, 3, 4, 5)).astype(np.float32))
    # (m, s) (B, L, 6, 1) broadcast against o (B, L, 6, 4)
    return (rng.normal(size=(2, L, 6, 1)).astype(np.float32),
            rng.uniform(0.1, 2.0, (2, L, 6, 1)).astype(np.float32),
            rng.normal(size=(2, L, 6, 4)).astype(np.float32))


#: The LM monoids' scans group their combines as Hillis–Steele does, the
#: reference's as ``lax.associative_scan`` does: equal in exact arithmetic,
#: within f32 rounding here (measured below 1e-6 relative).
LM_MONOID_RTOL = 1e-5


@pytest.mark.parametrize("name", ["affine", "softmax"])
@pytest.mark.parametrize("how", ["scan", "scan_reverse", "exclusive_scan",
                                 "reduce"])
def test_lm_monoids_match_reference(name, how):
    rng = np.random.default_rng(len(name) + len(how))
    xs = _lm_elements(name, rng)
    M_ = getattr(monoid, f"{name}_monoid")()
    JM = getattr(jmonoid, f"{name}_monoid")()
    fn, kw = how.removesuffix("_reverse"), (
        {"reverse": True} if how.endswith("_reverse") else {})
    got = getattr(monoid, fn)(M_, tuple(torch.from_numpy(a) for a in xs),
                              axis=1, **kw)
    want = getattr(jmonoid, fn)(JM, tuple(jnp.asarray(a) for a in xs),
                                axis=1, **kw)
    assert isinstance(got, tuple) and len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        finite = np.isfinite(w)
        assert np.array_equal(finite, torch.isfinite(g).numpy())
        np.testing.assert_allclose(g.numpy()[finite], w[finite],
                                   rtol=LM_MONOID_RTOL, atol=1e-6)
    if how == "exclusive_scan":            # element 0 is the identity
        ident = M_.identity(tuple(torch.from_numpy(a[:, :1]) for a in xs))
        for g, i in zip(got, ident):
            assert torch.equal(g[:, :1], i)


def test_softmax_monoid_computes_softmax():
    """Chunked (m, s, o) combining == the direct softmax-weighted sum: 4
    chunks of 8 scores, each chunk's partial softmax one element."""
    rng = np.random.default_rng(5)
    sc = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    vc = torch.from_numpy(rng.normal(size=(4, 8, 3)).astype(np.float32))
    m = sc.amax(-1, keepdim=True)                               # (4, 1)
    p = torch.exp(sc - m)
    parts = (m, p.sum(-1, keepdim=True), (p[..., None] * vc).sum(-2))
    mt, st, ot = monoid.reduce(monoid.softmax_monoid(), parts, axis=0)
    want = torch.softmax(sc.reshape(-1), 0) @ vc.reshape(-1, 3)
    np.testing.assert_allclose((ot / st).numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert float(mt) == float(sc.max())


@pytest.mark.parametrize("n,k,L,seed", [(3, 4, 9, 0), (12, 20, 16, 1)])
def test_chunk_primitives_match_reference(n, k, L, seed):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, n, size=(n, k)).astype(np.int32)
    chunk = rng.integers(0, k, size=L).astype(np.int32)
    got = matching.chunk_mapping_enumeration(torch.from_numpy(table),
                                             torch.from_numpy(chunk))
    want = jmatching.chunk_mapping_enumeration(jnp.asarray(table),
                                               jnp.asarray(chunk))
    assert np.array_equal(got.numpy(), np.asarray(want))
    for start in (0, n - 1):
        got = matching.chunk_state_sfa(torch.from_numpy(table),
                                       torch.from_numpy(chunk), start)
        want = jmatching.chunk_state_sfa(jnp.asarray(table),
                                         jnp.asarray(chunk), start)
        assert int(got) == int(want)


def test_bundled_bank_compiles_to_the_reference_dfas():
    """The copied regex/DFA/PROSITE compilers give the reference's tables."""
    bank, jbank = load_bank(), jload_bank()
    assert bank.ids == jbank.ids
    for name in ("tables", "accepting", "starts", "n_states"):
        assert np.array_equal(getattr(bank, name), getattr(jbank, name))
    from repro.core.dfa import compile_dfa as jcompile_dfa

    for pat in ("RG", "A[CD]+E", "(L|I).{2}K?", "W"):
        d, jd = compile_dfa(pat), jcompile_dfa(pat)
        assert np.array_equal(d.table, jd.table)
        assert np.array_equal(d.accepting, jd.accepting)


def test_bank_to_device_and_census_oracle():
    bank = PatternBank.from_dfas([random_dfa(n, 5, seed=n) for n in (3, 6)])
    tables, accepting, starts = bank.to("cpu")
    assert tables.dtype == torch.int32 and tables.shape == (2, 6, 5)
    assert accepting.dtype == torch.bool and starts.dtype == torch.int64
    # self-loop padding of the smaller table
    assert np.array_equal(bank.tables[0, 3:], np.repeat(
        np.arange(3, 6, dtype=np.int32)[:, None], 5, axis=1))
    corpus = np.random.default_rng(0).integers(0, 5, size=(6, 11))
    want = np.asarray([sum(bool(bank.dfa(p).accepting[bank.dfa(p).run(r)])
                           for r in corpus) for p in range(2)])
    assert np.array_equal(census_sequential(bank, corpus), want)


@pytest.mark.parametrize("sizes", [[4, 4, 5, 87, 21, 9], [3, 200, 17]])
def test_bucketing_copy_matches_reference(sizes):
    for start, growth in ((8, 2), (4, 3)):
        edges = bucketing.geometric_edges(max(sizes), start=start,
                                          growth=growth)
        assert edges == jbucketing.geometric_edges(max(sizes), start=start,
                                                   growth=growth)
        parts = bucketing.partition_by_size(sizes, edges)
        assert parts == jbucketing.partition_by_size(sizes, edges)
        assert (bucketing.merge_small_buckets(parts, 2)
                == jbucketing.merge_small_buckets(parts, 2))
