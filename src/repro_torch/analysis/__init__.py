from .roofline import HW, roofline_terms
from .trace import collective_summary, parse_collectives

__all__ = ["collective_summary", "parse_collectives", "HW", "roofline_terms"]
