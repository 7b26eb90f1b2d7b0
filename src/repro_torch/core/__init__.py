"""Core library of the PyTorch port: automata, fingerprints, monoids, banks.

``regex``, ``dfa``, ``prosite`` and ``bucketing`` are host-side NumPy code
(kept as the port's own copies so the package stands alone); ``fingerprint``,
``monoid``, ``matching`` and ``multipattern`` add the PyTorch halves.
Construction lives in :mod:`repro_torch.construction`; its long-standing
names resolve here lazily through the ``core.sfa`` shim, as in the
reference (``core.sfa_jax`` is the reference's other shim).
"""

from .dfa import DFA, compile_dfa, example_fa, minimize, random_dfa, subset_construct
from .fingerprint import (
    BarrettConstants,
    DEFAULT_POLY_LOW,
    barrett_reduce_int,
    clmul_int,
    fingerprint_int,
    fingerprint_states,
    fingerprint_states_np,
    is_irreducible,
    nth_poly_low,
    poly_mod_int,
    random_irreducible_poly64,
)
from .matching import (
    chunk_accept_trace,
    chunk_mapping_enumeration,
    chunk_state_sfa,
    match_ends_sequential,
    match_sequential,
)
from .monoid import (
    Monoid,
    affine_monoid,
    exclusive_scan,
    function_monoid,
    reduce,
    scan,
    shard_exclusive_scan,
    shard_reduce,
    softmax_monoid,
)
from .multipattern import PatternBank, bucket_by_size, census_sequential
from .prosite import (
    PROSITE_EXTRA,
    PROSITE_SAMPLES,
    compile_prosite,
    load_bank,
    synthetic_protein,
    translate,
)
from .regex import AMINO_ACIDS, compile_nfa, parse

# Construction names resolve lazily through core.sfa (PEP 562), as in the
# reference: ..construction imports core submodules while it initialises,
# so an eager import here would be circular when it is imported first.
_CONSTRUCTION_NAMES = (
    "SFA",
    "FingerprintCollision",
    "SFAStats",
    "StateBlowup",
    "construct_sfa",
    "construct_sfa_sequential",
    "construct_sfa_vectorized",
)


def __getattr__(name: str):
    if name in _CONSTRUCTION_NAMES:
        from . import sfa

        return getattr(sfa, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = sorted(
    [k for k in dir() if not k.startswith("_")] + list(_CONSTRUCTION_NAMES)
)
