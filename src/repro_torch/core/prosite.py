"""PROSITE protein-pattern compiler.

PROSITE patterns (https://prosite.expasy.org, the paper's benchmark source)
use a syntax of ``-``-separated elements:

  ``A``        a literal amino acid
  ``x``        any amino acid
  ``[ALT]``    any of the listed residues
  ``{AM}``     any residue *except* those listed
  ``e(n)``     element repeated exactly ``n`` times
  ``e(n,m)``   element repeated ``n``..``m`` times
  ``<``        pattern anchored at the N-terminus (string start)
  ``>``        pattern anchored at the C-terminus (string end)

We translate to the framework regex syntax (``core.regex``) and compile to a
minimal, complete DFA with *search* semantics unless ``<`` anchors the start
(matching ScanProsite behaviour).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .dfa import DFA, _make_accepting_absorbing, minimize, subset_construct
from .regex import AMINO_ACIDS, compile_nfa


class PrositeSyntaxError(ValueError):
    pass


@dataclass
class PrositePattern:
    raw: str
    regex: str
    anchored_start: bool
    anchored_end: bool


def translate(pattern: str) -> PrositePattern:
    """Translate PROSITE syntax to framework regex syntax."""
    raw = pattern.strip().rstrip(".")
    body = raw
    anchored_start = body.startswith("<")
    if anchored_start:
        body = body[1:]
    anchored_end = body.endswith(">")
    if anchored_end:
        body = body[:-1]
    if not body:
        raise PrositeSyntaxError(f"empty pattern {pattern!r}")

    out = []
    for elem in body.split("-"):
        elem = elem.strip()
        if not elem:
            raise PrositeSyntaxError(f"empty element in {pattern!r}")
        base, rep = _split_repeat(elem)
        out.append(_translate_element(base, pattern) + rep)
    return PrositePattern(
        raw=raw,
        regex="".join(out),
        anchored_start=anchored_start,
        anchored_end=anchored_end,
    )


def _split_repeat(elem: str) -> tuple:
    if elem.endswith(")"):
        open_idx = elem.rfind("(")
        if open_idx < 0:
            raise PrositeSyntaxError(f"unbalanced repeat in {elem!r}")
        inner = elem[open_idx + 1 : -1]
        parts = inner.split(",")
        if not all(p.strip().isdigit() for p in parts) or len(parts) > 2:
            raise PrositeSyntaxError(f"bad repeat spec {elem!r}")
        if len(parts) == 1:
            return elem[:open_idx], "{%d}" % int(parts[0])
        return elem[:open_idx], "{%d,%d}" % (int(parts[0]), int(parts[1]))
    return elem, ""


def _translate_element(base: str, pattern: str) -> str:
    if base == "x":
        return "."
    if base.startswith("[") and base.endswith("]"):
        members = base[1:-1]
        _check_members(members, pattern)
        return f"[{members}]"
    if base.startswith("{") and base.endswith("}"):
        members = base[1:-1]
        _check_members(members, pattern)
        return f"[^{members}]"
    if len(base) == 1 and base in AMINO_ACIDS:
        return base
    raise PrositeSyntaxError(f"bad element {base!r} in {pattern!r}")


def _check_members(members: str, pattern: str) -> None:
    if not members:
        raise PrositeSyntaxError(f"empty class in {pattern!r}")
    for c in members:
        if c not in AMINO_ACIDS:
            raise PrositeSyntaxError(f"residue {c!r} not an amino acid in {pattern!r}")


def compile_prosite(pattern: str, *, minimize_dfa: bool = True) -> DFA:
    """Compile a PROSITE pattern to a minimal complete search DFA."""
    tr = translate(pattern)
    regex = tr.regex
    if not tr.anchored_start:
        regex = "(.*)(" + regex + ")"
    if tr.anchored_end:
        # End-anchored: accepting only at string end — no absorbing accept.
        dfa = subset_construct(compile_nfa(regex, AMINO_ACIDS))
    else:
        dfa = _make_accepting_absorbing(subset_construct(compile_nfa(regex, AMINO_ACIDS)))
    return minimize(dfa) if minimize_dfa else dfa


# --------------------------------------------------------------------------
# A bundled selection of real PROSITE signatures (from the public database),
# spanning small to large DFA sizes — the benchmark suite's pattern corpus.
# --------------------------------------------------------------------------

PROSITE_SAMPLES = {
    # id: pattern                                            (documented family)
    "PS00001": "N-{P}-[ST]-{P}",                             # N-glycosylation
    "PS00004": "[RK](2)-x-[ST]",                             # cAMP phospho site
    "PS00005": "[ST]-x-[RK]",                                # PKC phospho site
    "PS00006": "[ST]-x(2)-[DE]",                             # CK2 phospho site
    "PS00007": "[RK]-x(2)-[DE]-x(3)-Y",                      # Tyr kinase phospho
    "PS00008": "G-{EDRKHPFYW}-x(2)-[STAGCN]-{P}",            # N-myristoylation
    "PS00009": "x-G-[RK]-[RK]",                              # amidation
    "PS00016": "R-G-D",                                      # RGD cell attachment
    "PS00017": "[AG]-x(4)-G-K-[ST]",                         # ATP/GTP P-loop
}

# A second tranche of small real signatures plus size-graded synthetic
# signatures in PROSITE syntax — enough patterns for bank-sized workloads
# (the multipattern engine wants >= 16 tables in one stack; the public
# database has thousands, we bundle a representative spread).
PROSITE_EXTRA = {
    "PS00002": "S-G-x-G",                                # glycosaminoglycan
    "PS00010": "C-x-[DN]-x(4)-[FY]-x-C-x-C",             # ASX hydroxylation
    "PS00014": "[KRHQSA]-[DENQ]-E-L>",                   # ER targeting (KDEL)
    "PS00342": "[STAGCN]-[RKH]-[LIVMAFY]>",              # peroxisome targeting
    "SYN00001": "C-x(2)-C",                              # cys pair, tiny
    "SYN00002": "H-x(3)-H",                              # his spacer
    "SYN00003": "L-x(2)-L-x(3)-L",                       # mini zipper
    "SYN00004": "[LIVM]-G-x-G-[ST]",                     # glycine-rich walker
    "SYN00005": "<M-x(2)-[KR]",                          # N-terminal anchored
    "SYN00006": "[FYW](2)-x-[DE]",                       # aromatic pair + acid
    "SYN00007": "P-x-P-x-P",                             # polyproline comb
    "SYN00008": "[RK](3)",                               # basic cluster
    "SYN00009": "G-[AG]-G-x-G",                          # nucleotide fold frag
    "SYN00010": "[ST]-P-x-[RK]",                         # proline-directed
}


def load_bank(ids=None, *, include_extra: bool = True):
    """Compile bundled signatures into one :class:`~.multipattern.PatternBank`.

    ``ids``: optional explicit signature ids (from ``PROSITE_SAMPLES`` /
    ``PROSITE_EXTRA``); default is every bundled tractable signature. The
    documented-intractable ``PROSITE_HARD`` set is never included — its
    members exceed subset construction long before banking matters.
    """
    from .multipattern import PatternBank

    pool = dict(PROSITE_SAMPLES)
    if include_extra:
        pool.update(PROSITE_EXTRA)
    if ids is None:
        ids = list(pool.keys())
    missing = [i for i in ids if i not in pool]
    if missing:
        raise KeyError(f"unknown PROSITE ids {missing}")
    return PatternBank.from_patterns({i: pool[i] for i in ids})


# Patterns whose *search DFA* already explodes during subset construction
# (wide wildcard windows -> exponentially many active-position subsets), let
# alone the SFA. The paper reports the same wall: "a large part of the
# sequence patterns from PROSITE exceeded the computational power of a
# contemporary 4-CPU multicore server with 128 GB of main memory" (§I).
# Kept out of the default benchmark/test loops; the census reports them as
# documented-intractable.
PROSITE_HARD = {
    "PS00018": "D-x-[DNS]-{ILVFYW}-[DENSTG]-[DNQGHRK]-{GP}-[LIVMC]-[DENQSTAGC]-x(2)-[DE]-[LIVMFYW]",  # EF-hand
    "PS00028": "C-x(2,4)-C-x(3)-[LIVMFYWC]-x(8)-H-x(3,5)-H",  # zinc finger C2H2
    "PS00029": "L-x(6)-L-x(6)-L-x(6)-L",                     # leucine zipper
    "PS00027": "[RK]-x(1,3)-[RKSAQ]-N-x(2)-[SAQ](2)-x-[RKTAENQ]-x-R-x-[RK]",  # homeobox-ish
    "PS00038": "[STAGC]-G-[PAV]-[LIVMFYWA]-[LIVM]-[STAGC]-x(2)-[LIVMFYWT]-[LIVMFYWGS]-x-[NQEH]",
}


def synthetic_protein(length: int, seed: int = 0) -> str:
    """Random amino-acid string for matching benchmarks."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(AMINO_ACIDS), size=length)
    return "".join(AMINO_ACIDS[i] for i in idx)
