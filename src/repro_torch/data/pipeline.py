"""Deterministic, shardable, checkpointable data pipeline.

Batches are generated stateless-deterministically from ``(seed, step)`` with
a counter-based RNG (numpy Philox), so:
  * any host can produce exactly its shard of any step (shardable, no
    coordination, elastic to host-count changes);
  * the iterator "state" is just the step counter — checkpoints store one
    integer, restarts resume mid-epoch exactly (fault tolerance);
  * a background prefetch thread hides generation latency.

Two sources: pure synthetic LM tokens (zipf-ish unigram mix), and the
protein corpus (see ``data/protein.py``) whose labeling stage runs the
paper's SFA matcher — the technique embedded in the training stack.

A copy of the reference's module: batches are numpy, bit for bit the
reference's. One deliberate difference: ``DataConfig.device`` names where
the protein source constructs its SFA (the card by default, as every
entry point of the port; ``"cpu"`` to run without one).

On a mesh each rank makes only its rows (``local_rows``: ``row_start`` and
``rows_local`` from its data coordinate) and ``to_mesh`` joins them into
the global batch's ``DTensor``.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"          # synthetic | protein
    # sharding: this host produces rows [row_start, row_start + rows_local)
    row_start: int = 0
    rows_local: int = -1               # -1 = all rows
    prefetch: int = 2
    device: str = "cuda"               # where the protein source's SFA is built


def _rng_for(seed: int, step: int, row: int) -> np.random.Generator:
    return np.random.default_rng(np.random.Philox(key=seed, counter=[step, row, 0, 0]))


def synthetic_batch(cfg: DataConfig, step: int) -> dict:
    rows = cfg.global_batch if cfg.rows_local < 0 else cfg.rows_local
    toks = np.empty((rows, cfg.seq_len + 1), dtype=np.int32)
    for r in range(rows):
        rng = _rng_for(cfg.seed, step, cfg.row_start + r)
        # zipf-flavoured unigram stream with short repeated motifs so the
        # tiny-LM examples have learnable structure
        base = rng.zipf(1.3, size=cfg.seq_len + 1) % cfg.vocab_size
        motif = rng.integers(0, cfg.vocab_size, size=8)
        pos = rng.integers(0, cfg.seq_len - 8, size=max(cfg.seq_len // 64, 1))
        for p in pos:
            base[p : p + 8] = motif
        toks[r] = base.astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclass
class DataIterator:
    cfg: DataConfig
    step: int = 0
    _q: queue.Queue = field(default_factory=lambda: queue.Queue(maxsize=4), repr=False)
    _thread: threading.Thread | None = field(default=None, repr=False)
    _stop: threading.Event = field(default_factory=threading.Event, repr=False)

    def _make(self, step: int) -> dict:
        if self.cfg.source == "synthetic":
            return synthetic_batch(self.cfg, step)
        if self.cfg.source == "protein":
            from .protein import protein_batch

            return protein_batch(self.cfg, step)
        raise ValueError(self.cfg.source)

    # -- prefetching ---------------------------------------------------------
    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self._make(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        # drain
        while not self._q.empty():
            self._q.get_nowait()

    def __next__(self) -> dict:
        if self._thread is None:
            batch = self._make(self.step)
            self.step += 1
            return batch
        while True:
            step, batch = self._q.get()
            if step == self.step:        # discard stale prefetches after restore
                self.step += 1
                return batch

    def __iter__(self):
        return self

    # -- checkpointable state ---------------------------------------------------
    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def restore(self, state: dict):
        self.stop()
        self.step = int(state["step"])
        assert state.get("seed", self.cfg.seed) == self.cfg.seed, "seed mismatch"
        return self


def local_rows(dist, global_batch: int) -> tuple:
    """(row_start, rows_local) of this rank's rows of a global batch: its
    block by its data coordinate under the rules' ``batch`` placement (the
    reference's ``launch/train.py`` gives each host its rows by process).
    Ranks that share a data coordinate read the same rows; without a mesh,
    every row."""
    if dist is None or dist.mesh is None:
        return 0, global_batch
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    shape, offset = compute_local_shape_and_global_offset(
        (global_batch,), dist.mesh, dist.rules.placements(dist.mesh,
                                                          "batch"))
    return offset[0], shape[0]


def to_mesh(local, dist):
    """This rank's rows (a tensor, ``local_rows``' block) as the global
    batch's ``DTensor``, sharded by the rules' ``batch`` placement over the
    leading dim; the tensor itself without a mesh."""
    if dist is None or dist.mesh is None:
        return local
    from torch.distributed.tensor import DTensor

    from ..sharding.rules import mesh_device

    placements = dist.rules.placements(dist.mesh, "batch",
                                       *[None] * (local.dim() - 1))
    return DTensor.from_local(local.to(mesh_device(dist.mesh)), dist.mesh,
                              placements, run_check=False)


def make_pipeline(cfg: DataConfig, *, prefetch: bool = True) -> DataIterator:
    it = DataIterator(cfg)
    if prefetch:
        it.start()
    return it
