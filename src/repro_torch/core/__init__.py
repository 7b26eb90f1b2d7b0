"""Core library of the PyTorch port: automata, fingerprints, monoids, banks.

``regex``, ``dfa``, ``prosite`` and ``bucketing`` are host-side NumPy code
(kept as the port's own copies so the package stands alone); ``fingerprint``,
``monoid``, ``matching`` and ``multipattern`` add the PyTorch halves.
"""

from .dfa import DFA, compile_dfa, example_fa, minimize, random_dfa, subset_construct
from .fingerprint import (
    BarrettConstants,
    DEFAULT_POLY_LOW,
    fingerprint_int,
    fingerprint_states,
    fingerprint_states_np,
    nth_poly_low,
)
from .monoid import Monoid, exclusive_scan, function_monoid, reduce, scan
from .multipattern import PatternBank, census_sequential
from .prosite import (
    PROSITE_EXTRA,
    PROSITE_SAMPLES,
    compile_prosite,
    load_bank,
    synthetic_protein,
    translate,
)
from .regex import AMINO_ACIDS, compile_nfa, parse
