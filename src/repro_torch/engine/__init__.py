"""The port's scan engine: plans, executors, streaming and the ``Scanner``
facade."""

from .plan import ChunkPolicy, ConstructionPolicy, ScanPlan
from .scanner import ConstructionReport, PatternGroup, ScanResult, Scanner
from .streaming import StreamResult, StreamSession
