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

from repro.kernels.clmul import fingerprint_bank_pallas  # noqa: E402
from repro.kernels.expand import expand_bank_pallas  # noqa: E402
from repro.kernels.match_scan import match_bank_chunks_pallas  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402


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


@pytest.mark.parametrize("P,n,k,B,L", [(1, 3, 4, 2, 5), (2, 6, 5, 3, 8),
                                       (3, 16, 20, 5, 12)])
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


def test_cpu_dispatch_uses_plain_versions_and_counts_no_launch():
    ops.reset_launches()
    words, weights, limbs = _fp_inputs(2, 3, 2, seed=1)
    args = (_i32(words), _i32(weights), _i32(limbs))
    assert torch.equal(ops.fingerprint_bank(*args),
                       ref.fingerprint_bank(*args))
    tables, chunks = _match_inputs(2, 4, 3, 2, 3, seed=2)
    ops.match_bank_chunks(torch.from_numpy(tables), torch.from_numpy(chunks))
    assert all(v == 0 for v in ops.launches.values())
    assert set(ops.launches) == set(build.KERNELS)


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity",
                                  "n_starts", "device"])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    tables, chunks = _match_inputs(2, 4, 3, 2, 3, seed=3)
    t, c = torch.from_numpy(tables), torch.from_numpy(chunks)
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
    elif case == "contiguity":
        with pytest.raises(ValueError):
            ops.match_bank_chunks(t.transpose(1, 2), c)
    elif case == "n_starts":
        for bad in (0, 5):
            with pytest.raises(ValueError):
                ops.match_bank_chunks(t, c, bad)
    else:
        with pytest.raises(ValueError):
            ops.match_bank_chunks(t.to("meta"), c.to("meta"))


def test_build_names_one_library_per_source():
    paths = {build.library_path(n) for n in build.KERNELS}
    assert len(paths) == len(build.KERNELS)
    for n in build.KERNELS:
        assert (build.CSRC / f"{n}.cu").is_file()
        assert build.library_path(n).parent == build.BUILD_DIR


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
def test_expand_bank_kernel_rejects_a_table_it_cannot_stage(cuda):
    n = 4096                     # a (4096, 20) table is 320 KB
    before = ops.launches["expand_bank"]
    with pytest.raises(ValueError, match="shared memory"):
        ops.expand_bank(torch.zeros((1, n, 20), dtype=torch.int32,
                                    device=cuda),
                        torch.zeros((1, 1, n), dtype=torch.int32, device=cuda))
    assert ops.launches["expand_bank"] == before
