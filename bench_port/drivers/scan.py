"""Traffic of kind ``scan``: one client sends requests of documents to one
compiled scanner, each after the last one's hit matrix is in host memory.

Set-up compiles the configuration's bank (its DFAs as the benchmark built
them) under its plan, draws the mix's pool of requests from the seed and
scans one request to warm the scanner (its speculative profile, the
allocator). A request's work is its residues. The answers compared are the
hit matrices of a sample of the window's requests, each against the plain
reference's walk of every DFA over the same documents.
"""

from __future__ import annotations

import numpy as np

from bench_port.harness import inputs


class Driver:
    work_unit = "residues"

    def __init__(self, cell, bank, seed: int):
        self.bank = bank
        self.budget = int(cell.config["plan"]["sfa_state_budget"])
        self.pool = inputs.scan_pool(cell.traffic, seed)
        self.port = self.scanner = None

    def start(self, port) -> None:
        """The program's set-up: compile the bank, scan one request."""
        self.port = port
        self.scanner = port.compile(port.dfas(self.bank))
        port.scan(self.scanner, self.pool[0].docs)

    def call(self, i: int):
        """Request ``i`` -> (its residues, its answer)."""
        j = i % len(self.pool)
        hits = self.port.scan(self.scanner, self.pool[j].docs)
        return self.pool[j].residues, (j, hits)

    def to_host(self, answer):
        return answer

    def release(self) -> None:
        self.scanner = None

    def compare(self, answers, device, control: bool = False) -> dict:
        """Numbers compared: ``hit_mismatches``, the (pattern, doc) entries
        of the sampled answers that differ from the reference's (all of an
        answer's where its shape is wrong). ``control`` puts in the
        program's place the reference's scan as the paper makes it, each
        pattern's SFA walked (its DFA where the SFA blows past the
        configuration's budget), with state ids held in 8 bits."""
        import torch

        from bench_port.reference import sfa as ref_sfa
        from bench_port.reference.scan import BankTables

        b = self.bank
        ref = BankTables(b.tables, b.accepting, b.starts, device)
        low = None
        if control:
            walks = [ref_sfa.walk_tables(t, a, s, self.budget, np.uint8)
                     for t, a, s in zip(b.tables, b.accepting, b.starts)]
            low = BankTables(*zip(*walks), device, dtype=torch.uint8)
        cache: dict = {}
        bad = 0
        for j, hits in answers:
            req = self.pool[j]
            if j not in cache:
                cache[j] = ref.hits(req.codes, req.lengths)
            if low is not None:
                hits = low.hits(req.codes, req.lengths)
            want = cache[j]
            bad += (int(np.count_nonzero(hits != want))
                    if np.shape(hits) == want.shape else want.size)
        return {"hit_mismatches": bad}
