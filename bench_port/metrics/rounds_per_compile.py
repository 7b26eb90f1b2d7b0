"""rounds_per_compile: the construction's bulk rounds
(``construction.rounds``, the program's counter) over the window's
completed compiles."""


def read(w):
    if not w.completed:
        return None
    return w.counters.get("construction.rounds", 0) / w.completed
