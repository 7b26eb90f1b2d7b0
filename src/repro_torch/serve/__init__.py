from .steps import make_prefill_step, make_decode_step

__all__ = ["make_prefill_step", "make_decode_step"]
