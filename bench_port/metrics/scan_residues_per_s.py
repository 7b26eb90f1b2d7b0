"""scan_residues_per_s: every residue of the requests completed in the
window, over the window's length on the host's clock."""


def read(w):
    if w.seconds <= 0:
        return None
    return w.work / w.seconds
