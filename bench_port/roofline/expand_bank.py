"""Work of one ``expand_bank`` launch: a construction round's frontier x
alphabet expansion. (B, n, k) tables and (B, T, n) frontier tiles ->
(B, T.k, n) candidates, and with word masks (B, W) the candidates packed
two 16-bit ids a word and masked, (B, T.k, W).

Only the work the round's inputs need is counted: of each pattern with
live frontier rows, its own table, its live frontier rows and their
candidates at its own width (the round's ``live_rows`` and ``n_true``);
padding rows of the active-set bucket, frontier rows past a pattern's
states and columns past its width are the program's padding. A gather: no
arithmetic counted, bytes as ``chip_smoke.py``'s kernel table counts them:
every input read once and every output written once.
"""

FACTS = ("round",)
TRACE_NAMES = ("expand_bank_kernel",)


def work(rec):
    """-> (bytes, int32 operations), or None for a launch outside a
    construction round."""
    if rec.get("round") is None:
        return None
    _, _, k = rec["args"][0]
    masked = len(rec["args"]) > 2 and rec["args"][2] is not None
    words = 0
    for r, n in zip(rec["round"]["live_rows"], rec["round"]["n_true"]):
        if r <= 0:
            continue
        W = (int(n) + 1) // 2 if masked else 0
        words += n * k + r * n + W + r * k * (n + W)
    return 4 * int(words), 0
