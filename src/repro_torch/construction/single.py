"""Single-pattern construction entry points over the shared worklist core.

* :func:`construct_sfa_sequential` — paper Algorithm 1 on the host, with
  the §III-A optimizations as toggles that select a membership store of
  :mod:`.stores` (the Fig. 4 ablation is a store swap).
* :func:`construct_sfa_vectorized` — the bulk frontier closure on a device
  (``"cuda"`` by default): the ``expand_bank`` and ``fingerprint`` kernels
  and a ``searchsorted`` membership.
* :func:`construct_sfa` — the exactness wrapper: on a detected fingerprint
  collision, retry with the next irreducible polynomial of the sequence
  (attempt ``a`` uses polynomial ``poly_index + a``). ``engine="jax"``
  keeps the reference's name for the ``P = 1`` case of
  :func:`~.batched.construct_bank` (:func:`~.batched.construct_sfa_jax`),
  so the engine lists of the two packages match.

All engines give bit-identical SFAs, so a :class:`~.cache.SFACache` entry
answers :func:`construct_sfa` whichever engine built it.
"""

from __future__ import annotations

from ..core.dfa import DFA
from ..core.fingerprint import BarrettConstants, nth_poly_low
from ..device import resolve_device
from .batched import construct_sfa_jax
from .stores import (
    ExhaustiveStore,
    FingerprintScanStore,
    HashChainStore,
    SortedFingerprintStore,
)
from .types import SFA, FingerprintCollision, SFAStats, StateBlowup
from .worklist import close_bulk, close_scalar

#: Single-pattern engines, as the reference's construction plan names them.
ENGINES = ("vectorized", "sequential", "jax")


def _consts_for(poly_index: int) -> BarrettConstants:
    return BarrettConstants.cached(nth_poly_low(poly_index))


def construct_sfa_sequential(
    dfa: DFA,
    *,
    use_fingerprints: bool = True,
    use_hashing: bool = True,
    poly_index: int = 0,
    max_states: int = 1_000_000,
) -> SFA:
    """Algorithm 1 with the paper's §III-A optimizations as toggles.

    - fingerprints off: membership is the exhaustive vector comparison against
      every known state (the paper's baseline — O(|Q|·|Q_s|) per test).
    - fingerprints on, hashing off: linear scan compares 64-bit fingerprints,
      exact vector compare only on fingerprint equality.
    - hashing on (requires fingerprints): dict keyed by fingerprint with
      collision chains — the paper's hash table, O(1) expected.
    """
    if use_hashing and not use_fingerprints:
        raise ValueError("hashing requires fingerprints (paper §III-A)")
    stats = SFAStats(engine="sequential")
    if not use_fingerprints:
        store = ExhaustiveStore(stats)
    elif use_hashing:
        store = HashChainStore(stats, _consts_for(poly_index))
    else:
        store = FingerprintScanStore(stats, _consts_for(poly_index))
    return close_scalar(dfa, store, stats, max_states=max_states)


def construct_sfa_vectorized(
    dfa: DFA,
    *,
    poly_index: int = 0,
    max_states: int = 4_000_000,
    tile: int = 4096,
    device="cuda",
) -> SFA:
    """Bulk-synchronous frontier closure on ``device`` (``"cuda"`` by
    default; asking for CUDA without a card raises)."""
    stats = SFAStats(engine="vectorized")
    store = SortedFingerprintStore(stats, _consts_for(poly_index),
                                   dfa.n_states, resolve_device(device))
    return close_bulk(dfa, store, stats, max_states=max_states, tile=tile)


def construct_sfa(
    dfa: DFA,
    *,
    engine: str = "vectorized",
    max_states: int = 4_000_000,
    max_retries: int = 4,
    poly_index: int = 0,
    cache=None,
    device="cuda",
    **kwargs,
) -> SFA:
    """Construct the exact SFA; on a detected fingerprint collision, retry
    with a fresh irreducible polynomial (paper §II: P is random).
    ``poly_index`` is the base of the retry sequence (attempt ``a`` uses
    polynomial ``poly_index + a``), matching ``construct_bank``'s.

    ``cache`` optionally names a :class:`~.cache.SFACache` (or
    ``"shared"``: :func:`~.cache.shared_cache`; ``None``/``"off"``: none)
    consulted before and filled after construction; a cached blowup at an
    equal or larger budget raises :class:`~.types.StateBlowup` without
    constructing. ``device`` is where the ``"vectorized"`` and ``"jax"``
    engines run; ``"sequential"`` runs on the host. ``kwargs`` go to the
    engine.
    """
    from .cache import SFACache, shared_cache

    if cache == "shared":
        cache = shared_cache()
    elif cache is None or cache == "off":
        cache = None
    elif not isinstance(cache, SFACache):
        raise ValueError(f"cache must be an SFACache, 'shared', 'off' or "
                         f"None, got {cache!r}")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    base_poly = nth_poly_low(poly_index)
    if cache is not None:
        hit, sfa = cache.lookup(dfa, max_states=max_states,
                                poly_low=base_poly)
        if hit == "sfa":
            return sfa
        if hit == "blowup":  # known to exceed this budget: fail fast
            raise StateBlowup(
                f"SFA exceeds {max_states} states (cached blowup)")
    if engine != "sequential":
        kwargs["device"] = device
    build = {
        "sequential": construct_sfa_sequential,
        "vectorized": construct_sfa_vectorized,
        "jax": construct_sfa_jax,
    }[engine]
    last: Exception | None = None
    try:
        for attempt in range(max_retries):
            try:
                sfa = build(dfa, poly_index=poly_index + attempt,
                            max_states=max_states, **kwargs)
            except FingerprintCollision as e:  # pragma: no cover (rare)
                last = e
                continue
            if cache is not None:
                cache.store(dfa, sfa, poly_low=base_poly)
            return sfa
    except StateBlowup:
        if cache is not None:
            cache.store_blowup(dfa, max_states, poly_low=base_poly)
        raise
    raise last  # pragma: no cover
