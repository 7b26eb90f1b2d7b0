"""Protein-sequence corpus with SFA-based labeling — the paper's technique
as a first-class data-pipeline stage.

Sequences are synthetic amino-acid strings with PROSITE motifs planted at a
controlled rate. The *labeling/filter* stage runs the constructed SFA over
every sequence (chunk-parallel matching, ``core.matching``): exactly the
ScanProsite workload the paper evaluates, feeding an LM training pipeline
(e.g. a protein language model that trains on motif-bearing sequences only).

As the reference's module, with one deliberate difference: the SFA is
constructed by the port's ``construct_sfa(engine="vectorized")`` on
``ProteinCorpus.device`` (the card by default: its membership store
fingerprints candidate states with the ``fingerprint`` kernel), and
``protein_batch`` keys its corpus cache by ``DataConfig.device``. Batches,
labels included, are the reference's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.dfa import DFA
from ..core.prosite import PROSITE_SAMPLES, compile_prosite, translate
from ..core.regex import AMINO_ACIDS
from ..core.sfa import SFA, construct_sfa

# token ids: 0 = pad/bos, 1..20 = amino acids
VOCAB = len(AMINO_ACIDS) + 1


@dataclass
class ProteinCorpus:
    pattern_id: str = "PS00016"          # RGD cell-attachment (tiny DFA)
    plant_rate: float = 0.5
    dfa: DFA = field(default=None, repr=False)
    sfa: SFA = field(default=None, repr=False)
    device: str = "cuda"

    def __post_init__(self):
        if self.dfa is None:
            self.dfa = compile_prosite(PROSITE_SAMPLES[self.pattern_id])
        if self.sfa is None:
            self.sfa = construct_sfa(self.dfa, engine="vectorized",
                                     max_states=200_000, device=self.device)

    def sample(self, rng: np.random.Generator, length: int) -> tuple:
        seq = rng.integers(0, len(AMINO_ACIDS), size=length).astype(np.int32)
        planted = rng.random() < self.plant_rate
        if planted:
            motif = self._motif_instance(rng)
            pos = rng.integers(0, max(length - len(motif), 1))
            seq[pos : pos + len(motif)] = motif
        # label via the SFA (single table walk; chunk-parallel in benches)
        state = self.sfa.run(seq)
        label = bool(self.sfa.accepting_states()[state])
        return seq, label

    def _motif_instance(self, rng) -> np.ndarray:
        # concrete instance of the pattern (for the bundled simple patterns
        # we plant the literal backbone, e.g. R-G-D)
        out = []
        tr = translate(PROSITE_SAMPLES[self.pattern_id])
        i = 0
        regex = tr.regex
        sym = {c: i for i, c in enumerate(AMINO_ACIDS)}
        while i < len(regex):
            c = regex[i]
            if c == "[":
                j = regex.index("]", i)
                members = [m for m in regex[i + 1 : j] if m in sym and regex[i+1] != "^"]
                out.append(sym[members[0]] if members else 0)
                i = j + 1
            elif c == "." :
                out.append(int(rng.integers(0, len(AMINO_ACIDS))))
                i += 1
            elif c == "{":
                j = regex.index("}", i)
                n = int(regex[i + 1 : j].split(",")[0])
                for _ in range(n - 1):
                    out.append(out[-1])
                i = j + 1
            elif c in sym:
                out.append(sym[c])
                i += 1
            else:
                i += 1
        return np.asarray(out, dtype=np.int32)


_CORPUS_CACHE: dict = {}


def protein_batch(cfg, step: int) -> dict:
    """Batch format matches the LM pipeline: tokens/labels shifted, with
    amino-acid ids offset by 1 (0 = bos)."""
    key = ("PS00016", cfg.device)
    if key not in _CORPUS_CACHE:
        _CORPUS_CACHE[key] = ProteinCorpus(device=cfg.device)
    corpus = _CORPUS_CACHE[key]
    rows = cfg.global_batch if cfg.rows_local < 0 else cfg.rows_local
    toks = np.zeros((rows, cfg.seq_len + 1), dtype=np.int32)
    match = np.zeros((rows,), dtype=bool)
    from .pipeline import _rng_for

    for r in range(rows):
        rng = _rng_for(cfg.seed, step, cfg.row_start + r)
        seq, label = corpus.sample(rng, cfg.seq_len)
        toks[r, 1:] = (seq + 1) % cfg.vocab_size
        match[r] = label
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "motif_label": match}


def protein_batch_stream(cfg, start_step: int = 0):
    step = start_step
    while True:
        yield protein_batch(cfg, step)
        step += 1
