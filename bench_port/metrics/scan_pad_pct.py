"""scan_pad_pct: the pad symbols the scan path walked beyond its documents'
ends (``engine.scan_pad_symbols``, the program's counter) over the
documents' own symbols (``engine.scan_symbols``), in %, over the window.
The scan batches documents of neighbouring lengths together and pads each
batch to a multiple of its chunk count; a program that does not count them
reports nothing."""


def read(w):
    real = w.counters.get("engine.scan_symbols")
    pad = w.counters.get("engine.scan_pad_symbols")
    if not w.completed or not real or pad is None:
        return None
    return 100.0 * pad / real
