"""The port's data pipeline and checkpoints against the reference package.

Data: ``synthetic_batch`` and ``protein_batch`` equal the reference's bit
for bit, labels and motif labels included (the port's PS00016 SFA built on
the CPU). Checkpoints: a tree written by either package restores in the
other with equal leaf names, shapes, dtypes and values; then the
reference's own invariants (keep-N, atomicity, async save, iterator
restore) on the port alone.
"""

import json

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.checkpoint import restore_tree as jrestore_tree  # noqa: E402
from repro.checkpoint import save_tree as jsave_tree  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import synthetic_batch as jsynthetic_batch  # noqa: E402
from repro.data.protein import ProteinCorpus as JProteinCorpus  # noqa: E402
from repro.data.protein import protein_batch as jprotein_batch  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager, latest_step, restore_tree, save_tree)
from repro_torch.data import DataConfig, make_pipeline  # noqa: E402
from repro_torch.data.pipeline import synthetic_batch  # noqa: E402
from repro_torch.data.protein import ProteinCorpus, protein_batch  # noqa: E402


def _cfg(cls=DataConfig, **kw):
    base = dict(vocab_size=256, seq_len=32, global_batch=4, seed=7)
    if cls is DataConfig:
        base["device"] = "cpu"
    base.update(kw)
    return cls(**base)


def _equal_batches(want: dict, got: dict) -> None:
    assert set(want) == set(got)
    for k, a in want.items():
        assert got[k].dtype == a.dtype and np.array_equal(got[k], a), k


# --------------------------------------------------------------------------
# data, against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, dict(row_start=2, rows_local=2),
                                dict(vocab_size=151_936, seq_len=100, seed=3)])
def test_synthetic_batch_matches_reference(kw):
    for step in (0, 1, 9):
        _equal_batches(jsynthetic_batch(_cfg(JDataConfig, **kw), step),
                       synthetic_batch(_cfg(**kw), step))


@pytest.fixture(scope="module")
def corpora():
    """PS00016's corpus in both packages (the port's SFA built on the CPU)."""
    return JProteinCorpus(), ProteinCorpus(device="cpu")


def test_protein_corpus_matches_reference(corpora):
    jcorpus, corpus = corpora
    assert np.array_equal(jcorpus.sfa.delta, corpus.sfa.delta)
    assert np.array_equal(jcorpus.sfa.mappings, corpus.sfa.mappings)
    jrng, rng = np.random.default_rng(0), np.random.default_rng(0)
    hits = 0
    for _ in range(20):
        (jseq, jlabel), (seq, label) = jcorpus.sample(jrng, 64), \
            corpus.sample(rng, 64)
        assert np.array_equal(jseq, seq) and jlabel == label
        text = "".join("ACDEFGHIKLMNPQRSTVWY"[i] for i in seq)
        assert corpus.dfa.accepts(text) == label
        hits += int(label)
    assert hits > 0  # planting works


@pytest.mark.parametrize("kw", [dict(vocab_size=21, seq_len=24),
                                dict(vocab_size=256, seq_len=48, row_start=1,
                                     rows_local=3)])
def test_protein_batch_matches_reference(corpora, kw):
    for step in (0, 5):
        want = jprotein_batch(_cfg(JDataConfig, source="protein", **kw), step)
        got = protein_batch(_cfg(source="protein", **kw), step)
        _equal_batches(want, got)
        assert got["tokens"].shape[1] == kw["seq_len"]
        assert got["motif_label"].shape == (got["tokens"].shape[0],)


@pytest.mark.cuda
def test_protein_batch_on_the_card_matches_reference():
    """PS00016's SFA built on the card (the ``fingerprint`` kernel
    launches), its batches the reference's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import ops

    before = ops.launches["fingerprint"]
    corpus = ProteinCorpus(device="cuda")
    assert ops.launches["fingerprint"] > before
    assert np.array_equal(corpus.sfa.delta, JProteinCorpus().sfa.delta)
    kw = dict(vocab_size=21, seq_len=24, source="protein")
    _equal_batches(jprotein_batch(_cfg(JDataConfig, **kw), 3),
                   protein_batch(_cfg(**dict(kw, device="cuda")), 3))


@pytest.mark.cuda
def test_checkpoint_restores_onto_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tree = _as_f32(_numpy_tree())
    jsave_tree(tmp_path, 5, jax.tree.map(jnp.asarray, tree))
    like = jax.tree.map(lambda t: torch.zeros_like(t, device="cuda"),
                        _to_torch(tree))
    got, _ = restore_tree(tmp_path, 5, like)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                 jax.tree_util.tree_leaves_with_path(got)):
        assert b.device.type == "cuda", path
        assert np.array_equal(_leaf_bits(a), _leaf_bits(b.cpu())), path


def test_protein_corpus_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    with pytest.raises(RuntimeError, match="cuda"):
        ProteinCorpus()


# --------------------------------------------------------------------------
# data, the reference's invariants on the port alone
# --------------------------------------------------------------------------


def test_iterator_restore_prefetch_and_shards():
    it = make_pipeline(_cfg(), prefetch=False)
    next(it)
    state = it.state()
    b1 = next(it)
    b2 = next(make_pipeline(_cfg(), prefetch=False).restore(state))
    assert np.array_equal(b1["tokens"], b2["tokens"])
    full = next(make_pipeline(_cfg(), prefetch=False))
    part = next(make_pipeline(_cfg(row_start=2, rows_local=2), prefetch=False))
    assert np.array_equal(full["tokens"][2:4], part["tokens"])
    sync = make_pipeline(_cfg(), prefetch=False)
    pre = make_pipeline(_cfg(), prefetch=True)
    try:
        for _ in range(3):
            assert np.array_equal(next(sync)["tokens"], next(pre)["tokens"])
    finally:
        pre.stop()


# --------------------------------------------------------------------------
# checkpoints, both directions
# --------------------------------------------------------------------------


def _numpy_tree():
    """Leaves of every kind a training tree holds: nested dicts (sorted
    names), a list (``idx<i>`` names), f32, bf16, int8 and int32."""
    rng = np.random.default_rng(0)
    return {
        "params": {"blocks": {"0_attn": {"wq": rng.normal(size=(2, 4, 3))},
                              "1_mlp": {"w_up": rng.normal(size=(2, 3, 5))}},
                   "embed": rng.normal(size=(6, 4)),
                   "final_norm": rng.normal(size=(4,))},
        "opt": {"m_q": rng.integers(-127, 128, (3, 256)).astype(np.int8),
                "m_s": rng.normal(size=(3, 1))},
        "extra": [rng.integers(0, 9, (5,)).astype(np.int32),
                  rng.normal(size=(2,)).astype(jnp.bfloat16)],
    }


def _as_f32(tree):
    return jax.tree.map(lambda a: a.astype(np.float32)
                        if a.dtype == np.float64 else a, tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    if tree.dtype == jnp.bfloat16:
        return torch.from_numpy(tree.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(tree)


def _leaf_bits(leaf) -> np.ndarray:
    """A leaf's bytes as an integer array (bf16 compared bit for bit)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy()
        return leaf.numpy()
    a = np.asarray(leaf)
    return a.view(np.int16) if a.dtype.kind == "V" else a


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return "bfloat16" if leaf.dtype.kind == "V" else str(leaf.dtype)


def test_checkpoint_written_by_reference_restores_in_port(tmp_path):
    tree = _as_f32(_numpy_tree())
    jsave_tree(tmp_path, 5, jax.tree.map(jnp.asarray, tree),
               extra={"data": {"step": 5, "seed": 7}})
    like = jax.tree.map(torch.zeros_like, _to_torch(tree))
    got, extra = restore_tree(tmp_path, 5, like)
    assert extra == {"data": {"step": 5, "seed": 7}}
    want = jax.tree_util.tree_leaves_with_path(tree)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in want] == [p for p, _ in got_leaves]
    for (path, a), (_, b) in zip(want, got_leaves):
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        assert tuple(b.shape) == a.shape and _dtype_name(b) == _dtype_name(a)
        assert np.array_equal(_leaf_bits(a), _leaf_bits(b)), path


def test_checkpoint_written_by_port_restores_in_reference(tmp_path):
    tree = _as_f32(_numpy_tree())
    save_tree(tmp_path / "port", 5, _to_torch(tree), extra={"k": [1, 2]})
    jsave_tree(tmp_path / "ref", 5, jax.tree.map(jnp.asarray, tree),
               extra={"k": [1, 2]})
    meta = [json.loads((tmp_path / d / "step_00000005" / "meta.json")
                       .read_text()) for d in ("port", "ref")]
    assert meta[0] == meta[1]                     # names, order, extra
    got, extra = jrestore_tree(tmp_path / "port", 5, tree)
    assert extra == {"k": [1, 2]}
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                 jax.tree_util.tree_leaves_with_path(got)):
        assert b.shape == a.shape and _dtype_name(b) == _dtype_name(a), path
        assert np.array_equal(_leaf_bits(a), _leaf_bits(b)), path


def test_manager_restores_onto_like_and_rejects_shardings(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    tree = _to_torch(_as_f32(_numpy_tree()))
    mgr.save(5, tree, extra={"data": {"step": 5, "seed": 7}})
    before = tree["params"]["embed"].clone()
    tree["params"]["embed"].add_(1.0)            # the save was a snapshot
    step, restored, extra = mgr.restore(tree)
    assert step == 5 and extra["data"]["step"] == 5
    assert torch.equal(restored["params"]["embed"], before)
    # shardings (a mesh's placements, tests/test_torch_sharded.py) must
    # match the like tree leaf for leaf
    with pytest.raises(AssertionError):
        mgr.restore(tree, shardings={"params": {"embed": None}})
    # a numpy like-tree restores as numpy, as in the reference
    arrays, _ = restore_tree(tmp_path, 5, {"params": {"embed": np.zeros(
        (6, 4), np.float32)}, "opt": None})
    assert isinstance(arrays["params"]["embed"], np.ndarray)


# --------------------------------------------------------------------------
# checkpoints, the reference's invariants on the port alone
# --------------------------------------------------------------------------


def _small():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones(3)},
            "opt": {"m": torch.zeros((3, 4))}}


def test_keep_n_garbage_collection(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in [1, 2, 3, 4]:
        mgr.save(s, _small())
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir())
    assert steps == [3, 4]


def test_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3, async_save=True)
    mgr.save(1, _small())
    mgr.wait()
    assert latest_step(tmp_path) == 1
    # the writer's errors surface on the next wait
    mgr.dir = tmp_path / "file"
    mgr.dir.write_text("not a directory")
    mgr.save(2, _small())
    with pytest.raises(OSError):
        mgr.wait()


def test_atomicity_no_partial_checkpoints(tmp_path):
    save_tree(tmp_path, 3, _small())
    # a stale tmp dir from a crashed save must not be visible as a checkpoint
    (tmp_path / "step_00000009.tmp").mkdir()
    assert latest_step(tmp_path) == 3
    assert JCheckpointManager(tmp_path).latest() == 3


def test_latest_of_empty_dir(tmp_path):
    assert latest_step(tmp_path / "nope") is None
    assert CheckpointManager(tmp_path / "nope2").restore(_small()) is None
