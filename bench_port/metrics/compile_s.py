"""compile_s: the window over the compiles completed in it, each from a
bank of DFAs to a ready scanner, ending in a device synchronisation (host
clock)."""


def read(w):
    if not w.completed:
        return None
    return w.seconds / w.completed
