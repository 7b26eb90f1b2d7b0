"""Work of one ``fingerprint_bank`` launch: Rabin fingerprints of (P, B, W)
packed words under each pattern's polynomial.

Only the work the round's inputs need is counted: of each pattern with
live frontier rows, the candidates of those rows (``live_rows`` x k) at its
own words, ceil(``n_true`` / 2); padding rows of the active-set bucket,
candidates of frontier rows past a pattern's states and words past its
width are the program's padding. As ``chip_smoke.py``'s kernel table counts
it: a 32x32 carry-less product bit-sliced is 32 steps of 5 int32
operations; each word takes two products and 4 XORs into the limbs, the
Barrett step three products and 4 XORs. Bytes: words, weights and limbs
read once, the fingerprints written once.
"""

FACTS = ("round",)
TRACE_NAMES = ("fingerprint_bank_kernel",)
CLMUL32_OPS = 32 * 5


def work(rec):
    """-> (bytes, int32 operations), or None for a launch outside a
    construction round."""
    if rec.get("round") is None:
        return None
    P, B, _ = rec["args"][0]
    k = B // rec["round"]["tile"]
    nbytes = ops = 0
    for r, n in zip(rec["round"]["live_rows"], rec["round"]["n_true"]):
        if r <= 0:
            continue
        rows, W = int(r) * k, (int(n) + 1) // 2
        nbytes += 4 * (rows * W + W * 2 + 4 + rows * 2)
        ops += rows * (W * (2 * CLMUL32_OPS + 4) + 3 * CLMUL32_OPS + 4)
    return nbytes, ops
