"""Work of one ``match_bank_chunks`` launch: chunk walks of P tables.

Each lane walks one chunk of L symbols from one start state, a table lookup
a symbol: two int32 operations a step (the row offset and the load), as
``chip_smoke.py``'s kernel table counts them. A walk from every state of a
padded (P, n, k) stack (``n_starts == n``) needs only each table's true
rows as lanes; a walk from one start (SFA mode) or from m explicit starts
(speculation) needs those. Bytes: each table's true rows read once, the
chunks read once, each needed lane's exit written once, and the starts.
"""

FACTS = ("true_rows",)
TRACE_NAMES = ("walk_kernel",)


def work(rec) -> tuple:
    """-> (bytes, int32 operations) the launch's inputs need."""
    P, n, k = rec["args"][0]
    B, L = rec["args"][1]
    _, _, n_starts = rec["out"]
    rows = sum(int(r) for r in rec["true_rows"])
    from_starts = len(rec["args"]) > 3 or "starts" in rec["kwargs"]
    lanes = rows if (n_starts == n and not from_starts) else P * n_starts
    nbytes = 4 * (rows * k + B * L + lanes * B
                  + (P * n_starts if from_starts else 0))
    return nbytes, 2 * lanes * B * L
