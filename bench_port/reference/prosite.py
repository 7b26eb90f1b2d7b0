"""Frozen copy of the PROSITE compiler of the port's ``core/prosite.py``
(translation and compilation only; the bundled signatures live in
``bench_port/configs/prosite23.patterns.txt``).

PROSITE protein-pattern compiler.

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
