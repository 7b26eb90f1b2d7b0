"""Work of one ``ops.compose_fold_rows`` call: the SFA scan's chunk fold,
stacks (P, S, n) and idx (P, D, m) -> out (P, D, n), each output row the
identity then m rows of the pattern's mapping stack in order, launched as
the rows instantiation of ``compose_fold_kernel``.

Bytes: the output written once and ``idx`` read once, the bound
``kernels/csrc/compose.cu`` states; no arithmetic is counted (a chain of
gathers). The stack rows are not counted: how many distinct rows a launch
reads depends on ``idx``'s contents, which the recorder does not read. So
the share errs low by at most the stacks' bytes over the counted ones
(57.5 MB of stacks at budget 20000 against 764 MB counted for a 2^22-residue
census shard, 143 MB for 16,384 reads of 56 residues).
"""

FACTS = ()
INSTANCE = "compose_fold_kernel<true>"


def work(rec) -> tuple:
    """-> (bytes, int32 operations) the call's inputs need."""
    n = rec["args"][0][2]
    P, D, m = rec["args"][1]
    return 4 * (P * D * n + P * D * m), 0
