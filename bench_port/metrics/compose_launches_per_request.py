"""compose_launches_per_request: calls of the single combine's wrapper
(``kernels.compose.calls``, the program's counter; one launch each on a
card) over the window's completed requests. The windowed census makes a
pattern group's window compositions by log-depth prefix and suffix scans of
its block mappings, one combine a step, and one more to stitch them."""


def read(w):
    calls = w.counters.get("kernels.compose.calls")
    if not w.completed or calls is None:
        return None
    return calls / w.completed
