"""paper_sfa — the paper's own workload as a selectable "architecture".

Not an LM: ``get_config()`` returns the SFA workload description the
benchmarks and the distributed-matching launcher consume (PROSITE pattern
set, input-string sizing, construction engine). Kept in the same registry so
``--arch paper_sfa`` drives the paper-faithful pipeline end to end.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class SFAWorkload:
    name: str = "paper_sfa"
    family: str = "sfa"
    patterns: tuple = (
        "PS00001", "PS00004", "PS00005", "PS00006", "PS00007", "PS00008",
        "PS00009", "PS00016", "PS00017", "PS00029",
    )
    engine: str = "vectorized"
    match_length: int = 10_000_000   # paper Fig. 6 uses 1e10; scaled to CPU
    n_chunks: int = 64
    max_states: int = 2_000_000


def get_config() -> SFAWorkload:
    return SFAWorkload()
