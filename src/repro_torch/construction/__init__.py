"""SFA construction in the port: the batched bank closure
(:func:`construct_bank`) and its result types."""

from .batched import (
    BUCKETINGS,
    EXPAND_BACKENDS,
    FINGERPRINT_BACKENDS,
    RoundSchedule,
    construct_bank,
    round_schedule,
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
