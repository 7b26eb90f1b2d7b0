"""Sharded corpus manifests: the unit of resumable scan work.

A manifest describes one corpus cut into shards — either a document corpus
(``kind="docs"``: explicit documents, ``shard_docs`` per shard) or a
windowed sequence (``kind="windows"``: all sliding windows of one long
sequence, ``shard_windows`` per shard — the genome-scan workload of Memeti &
Pllana's large-scale DNA studies). Shards are the checkpoint granularity of
:class:`repro_torch.scanservice.CorpusJob`: each one scans independently and its
hit matrix lands in its own atomic artifact, so a killed job resumes at the
first unfinished shard.

:func:`scan_shard` is the single execution path both job kinds share:

* document shards scan through ``Scanner.scan``, except documents at or
  above ``stream_threshold`` symbols, which go through the engine's
  streaming path (``Scanner.stream`` — fixed-shape ``(n_chunks, block_len)``
  blocks, memory high-water mark independent of document length);
* window shards scan through the prefix-scan census
  (``Scanner.census_windows``): each shard re-derives only its own slice of
  the sequence, and every stride-block's transition function is computed
  once per shard instead of once per overlapping window.

Both paths compute the same exact automaton semantics, so shard results are
bit-identical however the corpus is cut — the property that makes resumed
and uninterrupted runs byte-identical.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from ..engine import Scanner


@dataclass(frozen=True)
class CorpusManifest:
    """One corpus, sharded. Build via :meth:`from_docs` / :meth:`sliding`."""

    kind: str                 # "docs" | "windows"
    bounds: tuple             # (n_shards + 1,) cumulative item offsets
    docs: tuple = ()          # kind="docs": the documents
    seq: str = ""             # kind="windows": the underlying sequence
    window: int = 0
    stride: int = 0

    # -- construction --------------------------------------------------------

    @classmethod
    def from_docs(cls, docs, shard_docs: int = 8) -> "CorpusManifest":
        """Shard an explicit document corpus, ``shard_docs`` per shard."""
        docs = tuple(docs)
        if not docs:
            raise ValueError("empty corpus")
        if shard_docs < 1:
            raise ValueError("shard_docs must be >= 1")
        bounds = tuple(range(0, len(docs), shard_docs)) + (len(docs),)
        return cls(kind="docs", bounds=bounds, docs=docs)

    @classmethod
    def sliding(cls, seq: str, window: int, stride: int | None = None,
                shard_windows: int = 64) -> "CorpusManifest":
        """All sliding windows of ``seq``, ``shard_windows`` per shard.
        ``stride`` must divide ``window`` (default: disjoint windows)."""
        stride = window if stride is None else stride
        if window < 1 or stride < 1 or window % stride:
            raise ValueError("need stride >= 1 dividing window")
        if shard_windows < 1:
            raise ValueError("shard_windows must be >= 1")
        n_windows = (len(seq) - window) // stride + 1 if len(seq) >= window else 0
        if n_windows < 1:
            raise ValueError(
                f"sequence ({len(seq)} symbols) shorter than one "
                f"{window}-symbol window"
            )
        bounds = tuple(range(0, n_windows, shard_windows)) + (n_windows,)
        return cls(kind="windows", bounds=bounds, seq=seq,
                   window=window, stride=stride)

    # -- shape ---------------------------------------------------------------

    @property
    def n_shards(self) -> int:
        return len(self.bounds) - 1

    @property
    def n_items(self) -> int:
        """Total scan items (documents or windows) across all shards."""
        return self.bounds[-1]

    def shard_range(self, shard: int) -> tuple:
        """Half-open item range ``[start, stop)`` of one shard."""
        if not 0 <= shard < self.n_shards:
            raise IndexError(f"shard {shard} of {self.n_shards}")
        return self.bounds[shard], self.bounds[shard + 1]

    def digest(self) -> str:
        """Content hash of the corpus + sharding — the resume-safety check
        that a job directory is only ever reused for the same work."""
        h = hashlib.sha256()
        h.update(f"corpus-v1|{self.kind}|{self.window}|{self.stride}|".encode())
        h.update(",".join(str(b) for b in self.bounds).encode())
        if self.kind == "docs":
            for d in self.docs:
                h.update(b"|")
                h.update(d.encode() if isinstance(d, str)
                         else np.asarray(d, dtype=np.int32).tobytes())
        else:
            h.update(b"|")
            h.update(self.seq.encode())
        return h.hexdigest()


def default_stream_threshold(scanner: Scanner) -> int:
    """Documents at/above this length scan via the streaming path: four
    full ``(n_chunks, block_len)`` blocks — short enough to exercise the
    bounded-memory path on real corpora, long enough that block dispatch
    amortizes."""
    pol = scanner.plan.chunking
    return 4 * pol.n_chunks * pol.block_len


def scan_shard(scanner: Scanner, manifest: CorpusManifest, shard: int,
               stream_threshold: int | None = None) -> np.ndarray:
    """Scan one shard -> its ``(P, shard_items)`` hit matrix (bool)."""
    start, stop = manifest.shard_range(shard)
    if manifest.kind == "windows":
        lo = start * manifest.stride
        hi = (stop - 1) * manifest.stride + manifest.window
        return scanner.census_windows(
            manifest.seq[lo:hi], manifest.window, manifest.stride
        ).hits

    docs = list(manifest.docs[start:stop])
    thr = (default_stream_threshold(scanner)
           if stream_threshold is None else stream_threshold)
    hits = np.zeros((scanner.n_patterns, len(docs)), dtype=bool)
    short = [i for i, d in enumerate(docs) if len(d) < thr]
    if short:
        hits[:, short] = scanner.scan([docs[i] for i in short]).hits
    for i in (i for i, d in enumerate(docs) if len(d) >= thr):
        hits[:, i] = scanner.stream([docs[i]]).accepted
    return hits
