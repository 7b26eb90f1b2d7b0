"""The port's scan engine: plans, executors, streaming and the ``Scanner``
facade."""

from ..speculative import SpeculationStats
from .plan import (
    BACKENDS,
    CONSTRUCTION_ENGINES,
    CONSTRUCTION_METHODS,
    DISTRIBUTIONS,
    MODES,
    SPECULATION_SOURCES,
    ChunkPolicy,
    ConstructionPolicy,
    ScanPlan,
    SpeculationPolicy,
)
from .scanner import ConstructionReport, PatternGroup, ScanResult, Scanner
from .streaming import StreamResult, StreamSession
