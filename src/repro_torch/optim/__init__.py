from .api import Optimizer, build_optimizer
from .schedule import make_schedule

__all__ = ["Optimizer", "build_optimizer", "make_schedule"]
