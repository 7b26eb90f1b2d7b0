"""setup_s: the run's set-up, from the process's start to the window's:
imports, the kernels' build (first run in a checkout), the bank's DFAs
(built or read from the checkout's cache), the program's set-up and the
warm-up. Host clock."""


def read(w):
    return w.setup_s
