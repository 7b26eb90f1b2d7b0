"""The port's scan engine: plans, executors and the ``Scanner`` facade."""

from .plan import ChunkPolicy, ConstructionPolicy, ScanPlan
from .scanner import ConstructionReport, PatternGroup, ScanResult, Scanner
