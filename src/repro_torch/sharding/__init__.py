from .rules import Dist, Rules, DEFAULT_RULES, logical_spec, constrain

__all__ = ["Dist", "Rules", "DEFAULT_RULES", "logical_spec", "constrain"]
