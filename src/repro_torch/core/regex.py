"""Regular-expression compiler: pattern -> Thompson NFA.

Supports the subset of regex syntax needed for PROSITE protein patterns and
the paper's benchmarks: literals, ``.``, character classes ``[...]`` /
``[^...]`` (with ranges), grouping ``(...)``, alternation ``|``, and the
postfix operators ``*``, ``+``, ``?``, ``{m}``, ``{m,n}``, ``{m,}``.

The automaton is built over an *explicit finite alphabet* (a list of single
characters); ``.`` and negated classes are expanded against that alphabet so
the resulting DFA transition table is dense and complete — the layout the
paper's construction and matching algorithms (and our CUDA kernels) require.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable


# Default alphabet: one-letter amino-acid codes, as in the paper's PROSITE
# evaluation (Section I, Fig. 1).
AMINO_ACIDS = "ACDEFGHIKLMNPQRSTVWY"


class RegexSyntaxError(ValueError):
    pass


# --------------------------------------------------------------------------
# AST
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Node:
    pass


@dataclass(frozen=True)
class Epsilon(Node):
    pass


@dataclass(frozen=True)
class CharClass(Node):
    """A set of symbol ids (already resolved against the alphabet)."""

    symbols: frozenset


@dataclass(frozen=True)
class Concat(Node):
    parts: tuple


@dataclass(frozen=True)
class Alternate(Node):
    options: tuple


@dataclass(frozen=True)
class Repeat(Node):
    child: Node
    lo: int
    hi: int | None  # None == unbounded


# --------------------------------------------------------------------------
# Parser
# --------------------------------------------------------------------------


class _Parser:
    def __init__(self, pattern: str, alphabet: str):
        self.pat = pattern
        self.pos = 0
        self.alphabet = alphabet
        self.sym_id = {c: i for i, c in enumerate(alphabet)}

    # -- helpers ----------------------------------------------------------
    def _peek(self) -> str | None:
        return self.pat[self.pos] if self.pos < len(self.pat) else None

    def _next(self) -> str:
        c = self._peek()
        if c is None:
            raise RegexSyntaxError(f"unexpected end of pattern: {self.pat!r}")
        self.pos += 1
        return c

    def _expect(self, c: str) -> None:
        got = self._next()
        if got != c:
            raise RegexSyntaxError(
                f"expected {c!r} at position {self.pos - 1} in {self.pat!r}, got {got!r}"
            )

    def _symbols_of(self, c: str) -> frozenset:
        if c not in self.sym_id:
            raise RegexSyntaxError(f"character {c!r} not in alphabet {self.alphabet!r}")
        return frozenset((self.sym_id[c],))

    # -- grammar ----------------------------------------------------------
    def parse(self) -> Node:
        node = self._alternation()
        if self.pos != len(self.pat):
            raise RegexSyntaxError(
                f"trailing input at position {self.pos} in {self.pat!r}"
            )
        return node

    def _alternation(self) -> Node:
        options = [self._concat()]
        while self._peek() == "|":
            self._next()
            options.append(self._concat())
        if len(options) == 1:
            return options[0]
        return Alternate(tuple(options))

    def _concat(self) -> Node:
        parts = []
        while True:
            c = self._peek()
            if c is None or c in "|)":
                break
            parts.append(self._postfix())
        if not parts:
            return Epsilon()
        if len(parts) == 1:
            return parts[0]
        return Concat(tuple(parts))

    def _postfix(self) -> Node:
        node = self._atom()
        while True:
            c = self._peek()
            if c == "*":
                self._next()
                node = Repeat(node, 0, None)
            elif c == "+":
                self._next()
                node = Repeat(node, 1, None)
            elif c == "?":
                self._next()
                node = Repeat(node, 0, 1)
            elif c == "{":
                node = self._bounded_repeat(node)
            else:
                return node

    def _bounded_repeat(self, node: Node) -> Node:
        self._expect("{")
        lo = self._number()
        hi: int | None = lo
        if self._peek() == ",":
            self._next()
            hi = None if self._peek() == "}" else self._number()
        self._expect("}")
        if hi is not None and hi < lo:
            raise RegexSyntaxError(f"bad repeat bounds {{{lo},{hi}}}")
        return Repeat(node, lo, hi)

    def _number(self) -> int:
        digits = ""
        while (c := self._peek()) is not None and c.isdigit():
            digits += self._next()
        if not digits:
            raise RegexSyntaxError(f"expected number at position {self.pos}")
        return int(digits)

    def _atom(self) -> Node:
        c = self._next()
        if c == "(":
            node = self._alternation()
            self._expect(")")
            return node
        if c == "[":
            return self._char_class()
        if c == ".":
            return CharClass(frozenset(range(len(self.alphabet))))
        if c == "\\":
            return CharClass(self._symbols_of(self._next()))
        if c in "*+?{":
            raise RegexSyntaxError(f"dangling operator {c!r} at {self.pos - 1}")
        return CharClass(self._symbols_of(c))

    def _char_class(self) -> Node:
        negate = False
        if self._peek() == "^":
            self._next()
            negate = True
        members: set = set()
        while (c := self._peek()) != "]":
            if c is None:
                raise RegexSyntaxError(f"unterminated class in {self.pat!r}")
            c = self._next()
            if c == "\\":
                c = self._next()
            if self._peek() == "-" and self.pos + 1 < len(self.pat) and self.pat[self.pos + 1] != "]":
                self._next()  # consume '-'
                end = self._next()
                for code in range(ord(c), ord(end) + 1):
                    ch = chr(code)
                    if ch in self.sym_id:
                        members.add(self.sym_id[ch])
            else:
                members |= self._symbols_of(c)
        self._expect("]")
        if negate:
            members = set(range(len(self.alphabet))) - members
        if not members:
            raise RegexSyntaxError(f"empty character class in {self.pat!r}")
        return CharClass(frozenset(members))


def parse(pattern: str, alphabet: str = AMINO_ACIDS) -> Node:
    return _Parser(pattern, alphabet).parse()


# --------------------------------------------------------------------------
# Thompson construction: AST -> NFA
# --------------------------------------------------------------------------


@dataclass
class NFA:
    """Thompson NFA with a single start and single accept state.

    ``transitions[s]`` is a list of ``(symbol_id | None, target)`` edges;
    ``None`` marks an epsilon edge.
    """

    n_states: int
    transitions: list
    start: int
    accept: int
    n_symbols: int
    alphabet: str

    def eps_closure(self, states: Iterable[int]) -> frozenset:
        stack = list(states)
        seen = set(stack)
        while stack:
            s = stack.pop()
            for sym, t in self.transitions[s]:
                if sym is None and t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    def step(self, states: Iterable[int], symbol: int) -> frozenset:
        out = set()
        for s in states:
            for sym, t in self.transitions[s]:
                if sym == symbol:
                    out.add(t)
        return self.eps_closure(out)


class _NFABuilder:
    def __init__(self, n_symbols: int):
        self.transitions: list = []
        self.n_symbols = n_symbols

    def new_state(self) -> int:
        self.transitions.append([])
        return len(self.transitions) - 1

    def add_edge(self, src: int, sym: int | None, dst: int) -> None:
        self.transitions[src].append((sym, dst))

    def build(self, node: Node) -> tuple:
        """Return (start, accept) fragment for ``node``."""
        if isinstance(node, Epsilon):
            s, a = self.new_state(), self.new_state()
            self.add_edge(s, None, a)
            return s, a
        if isinstance(node, CharClass):
            s, a = self.new_state(), self.new_state()
            for sym in sorted(node.symbols):
                self.add_edge(s, sym, a)
            return s, a
        if isinstance(node, Concat):
            first_s, prev_a = self.build(node.parts[0])
            for part in node.parts[1:]:
                s, a = self.build(part)
                self.add_edge(prev_a, None, s)
                prev_a = a
            return first_s, prev_a
        if isinstance(node, Alternate):
            s, a = self.new_state(), self.new_state()
            for opt in node.options:
                os, oa = self.build(opt)
                self.add_edge(s, None, os)
                self.add_edge(oa, None, a)
            return s, a
        if isinstance(node, Repeat):
            return self._build_repeat(node)
        raise TypeError(f"unknown node {node!r}")

    def _build_repeat(self, node: Repeat) -> tuple:
        lo, hi = node.lo, node.hi
        if (lo, hi) == (0, None):  # star
            s, a = self.new_state(), self.new_state()
            cs, ca = self.build(node.child)
            self.add_edge(s, None, cs)
            self.add_edge(s, None, a)
            self.add_edge(ca, None, cs)
            self.add_edge(ca, None, a)
            return s, a
        if (lo, hi) == (1, None):  # plus = child child*
            return self.build(Concat((node.child, Repeat(node.child, 0, None))))
        if (lo, hi) == (0, 1):  # optional
            s, a = self.new_state(), self.new_state()
            cs, ca = self.build(node.child)
            self.add_edge(s, None, cs)
            self.add_edge(s, None, a)
            self.add_edge(ca, None, a)
            return s, a
        # bounded {m} / {m,n} / {m,}: expand.
        parts: list = [node.child] * lo
        if hi is None:
            parts.append(Repeat(node.child, 0, None))
        else:
            parts.extend([Repeat(node.child, 0, 1)] * (hi - lo))
        if not parts:
            return self.build(Epsilon())
        return self.build(Concat(tuple(parts)) if len(parts) > 1 else parts[0])


def to_nfa(node: Node, alphabet: str = AMINO_ACIDS) -> NFA:
    b = _NFABuilder(len(alphabet))
    start, accept = b.build(node)
    return NFA(
        n_states=len(b.transitions),
        transitions=b.transitions,
        start=start,
        accept=accept,
        n_symbols=len(alphabet),
        alphabet=alphabet,
    )


def compile_nfa(pattern: str, alphabet: str = AMINO_ACIDS) -> NFA:
    return to_nfa(parse(pattern, alphabet), alphabet)
