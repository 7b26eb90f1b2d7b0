"""walk_launches_per_request: calls of the chunk walk's wrapper
(``kernels.match_bank_chunks.calls``, the program's counter) over the
window's completed requests. The scan path makes one batch a distinct
document length and walks each batch in every pattern group."""


def read(w):
    if not w.completed:
        return None
    return w.counters.get("kernels.match_bank_chunks.calls", 0) / w.completed
