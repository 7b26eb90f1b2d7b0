"""SFA construction in the port: the batched bank closure
(:func:`construct_bank`), the single-pattern engines (:func:`construct_sfa`
and friends), their result types and the content-addressed SFA cache
(:class:`SFACache`)."""

from .batched import (
    BUCKETINGS,
    EXPAND_BACKENDS,
    FINGERPRINT_BACKENDS,
    METHODS,
    RoundSchedule,
    construct_bank,
    construct_sfa_jax,
    resolve_method,
    round_schedule,
)
from .cache import CacheInfo, SFACache, dfa_cache_key, shared_cache
from .single import (
    ENGINES,
    construct_sfa,
    construct_sfa_sequential,
    construct_sfa_vectorized,
)
from .stores import (
    ExhaustiveStore,
    FingerprintScanStore,
    HashChainStore,
    SortedFingerprintStore,
)
from .types import (
    SFA,
    BankConstructionResult,
    BankStats,
    BucketStats,
    FingerprintCollision,
    SFAStats,
    StateBlowup,
)
