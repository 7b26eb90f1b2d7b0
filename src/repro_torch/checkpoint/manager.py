"""Async, atomic checkpointing in the reference's on-disk format.

Layout, as the reference's ``checkpoint/manager.py`` writes it:
``<dir>/step_<N>/`` holding one ``.npy`` per tree leaf plus ``meta.json``
(``{"step", "leaves", "extra"}``). A leaf's file name is its tree path
joined by ``__``: dict keys in sorted order (as ``jax.tree`` flattens a
dict), list and tuple items as ``idx<i>``. bf16 leaves are stored as the
reference stores them (raw 2-byte ``<V2`` records). A checkpoint written by
either package restores in the other, and needs only numpy to read.

Writes go to ``step_<N>.tmp`` and are atomically renamed, so a crashed
save never shadows a good checkpoint.

* **async**: the device→host copy happens synchronously (snapshot
  semantics: the optimizer updates its tensors in place right after), the
  file IO on a worker thread; ``wait()`` joins before the next save or
  program exit.
* **keep-N** garbage collection.

``restore_tree`` puts each leaf on the device of the matching leaf of the
``like`` tree (a numpy leaf restores as numpy), or, given ``shardings`` (a
tree of ``sharding.rules.Sharding``, ``Dist.shardings``), distributes it
onto its mesh and placements: a checkpoint written on one mesh restores
onto another, or onto one device (elastic).

On a mesh (a tree with ``DTensor`` leaves) every rank calls ``save``: each
joins the ``full_tensor()`` gathers, and rank 0 alone writes, in the same
format; ``wait`` ends in a barrier, so every rank sees the checkpoint once
it returns.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

_SEP = "__"


def _flatten_with_paths(tree, prefix: tuple = ()) -> list:
    """[(name, leaf)] in ``jax.tree``'s order; ``None`` is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"idx{i}", v) for i, v in enumerate(tree)]
    else:
        return [(_SEP.join(prefix), tree)]
    out = []
    for key, sub in items:
        out += _flatten_with_paths(sub, prefix + (key,))
    return out


def _unflatten_like(tree, leaves):
    """``tree``'s structure with its leaves taken from the iterator
    ``leaves`` in flattening order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten_like(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_like(v, leaves) for v in tree)
    return next(leaves)


def _is_dtensor(leaf) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(leaf, DTensor)


def _host_array(leaf) -> np.ndarray:
    """A host copy of ``leaf`` (never a view of it); a ``DTensor``'s whole
    value (a collective: every rank calls this)."""
    if _is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.array(leaf)


def save_tree(ckpt_dir: Path, step: int, tree, extra: dict | None = None) -> Path:
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    names = []
    for name, leaf in _flatten_with_paths(tree):
        np.save(tmp / f"{name}.npy", _host_array(leaf))
        names.append(name)
    meta = {"step": step, "leaves": names, "extra": extra or {}}
    (tmp / "meta.json").write_text(json.dumps(meta))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(ckpt_dir: Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [
        int(m.group(1))
        for p in ckpt_dir.iterdir()
        if (m := re.fullmatch(r"step_(\d+)", p.name)) and (p / "meta.json").exists()
    ]
    return max(steps) if steps else None


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:   # bf16 records
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _as_like(arr: np.ndarray, like):
    if not isinstance(like, torch.Tensor):
        return arr
    return _to_torch(arr).to(like.device)


def restore_tree(ckpt_dir: Path, step: int, like_tree, shardings=None) -> tuple:
    """Restore into the structure of ``like_tree`` -> (tree, extra). With
    ``shardings`` (a tree of ``Sharding``s shaped like ``like_tree``), each
    leaf is distributed onto its
    mesh and placements (every rank of the mesh calls this)."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    meta = json.loads((d / "meta.json").read_text())
    flat = _flatten_with_paths(like_tree)
    targets = ([t for _, t in _flatten_with_paths(shardings)]
               if shardings is not None else [None] * len(flat))
    assert len(targets) == len(flat), (len(targets), len(flat))
    leaves = []
    for (name, like), target in zip(flat, targets):
        arr = np.load(d / f"{name}.npy")
        want_shape = tuple(like.shape)
        assert tuple(arr.shape) == want_shape, (name, arr.shape, want_shape)
        leaves.append(_as_like(arr, like) if target is None
                      else target.place(_to_torch(arr)))
    return _unflatten_like(like_tree, iter(leaves)), meta["extra"]


class CheckpointManager:
    def __init__(self, ckpt_dir, keep: int = 3, async_save: bool = True):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._last_error: Exception | None = None
        self._mesh_save = False         # the last save was a mesh's

    def save(self, step: int, tree, extra: dict | None = None):
        # Snapshot to host synchronously so mutation after save() is safe.
        leaves = [leaf for _, leaf in _flatten_with_paths(tree)]
        on_mesh = any(_is_dtensor(leaf) for leaf in leaves)
        host_tree = _unflatten_like(tree, iter(
            [_host_array(leaf) for leaf in leaves]))
        self.wait()
        self._mesh_save = on_mesh

        def work():
            try:
                save_tree(self.dir, step, host_tree, extra)
                self._gc()
            except Exception as e:  # surfaced on next wait()
                self._last_error = e

        if on_mesh and dist.get_rank() != 0:
            pass                        # rank 0 writes
        elif self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self._raise_if_failed()
        if on_mesh and not self.async_save:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh_save:             # every rank sees rank 0's write
            self._mesh_save = False
            dist.barrier()
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err

    def latest(self) -> int | None:
        return latest_step(self.dir)

    def restore(self, like_tree, shardings=None, step: int | None = None):
        step = self.latest() if step is None else step
        if step is None:
            return None
        tree, extra = restore_tree(self.dir, step, like_tree, shardings)
        return step, tree, extra

    def _gc(self):
        steps = sorted(
            int(m.group(1))
            for p in self.dir.iterdir()
            if (m := re.fullmatch(r"step_(\d+)", p.name))
        )
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
