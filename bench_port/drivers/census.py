"""Traffic of kind ``census``: one client sends one long sequence at a time
to one compiled scanner's windowed census (``Scanner.census_windows``), each
after the last one's hit matrix is in host memory.

A request is one shard of the mix's ``shard_residues`` residues, drawn
i.i.d. from the mix's composition and handed to the program as one 1-D
int32 symbol array; the configuration's ``census`` gives the window and the
stride. Set-up compiles the configuration's bank under its plan, draws the
mix's ``pool`` of shards from the seed and runs one census to warm the
scanner. A request's work is its residues. The answers compared are the
(P, W) hit matrices of a sample of the window's requests, each against the
plain reference's walk of every DFA over every materialised window.
"""

from __future__ import annotations

import numpy as np

from bench_port.harness import inputs


def shard_pool(traffic: dict, seed: int) -> list:
    """The mix's ``pool`` shards, (shard_residues,) int32 symbol codes each,
    drawn from ``seed``."""
    cdf = np.cumsum(inputs._composition(traffic))
    cdf[-1] = 1.0
    rng = inputs.seed_rng(seed, 5)
    n = int(traffic["shard_residues"])
    if traffic["form"] != "array":
        raise ValueError(f"unknown request form {traffic['form']!r}")
    return [np.searchsorted(cdf, rng.random(n)).astype(np.int32)
            for _ in range(int(traffic["pool"]))]


class Driver:
    work_unit = "residues"

    def __init__(self, cell, bank, seed: int):
        self.bank = bank
        self.budget = int(cell.config["plan"]["sfa_state_budget"])
        self.window = int(cell.config["census"]["window"])
        self.stride = int(cell.config["census"]["stride"])
        self.pool = shard_pool(cell.traffic, seed)
        self.scanner = None

    def start(self, port) -> None:
        """The program's set-up: compile the bank, census one shard."""
        self.scanner = port.compile(port.dfas(self.bank))
        self._census(self.pool[0])

    def _census(self, shard) -> np.ndarray:
        """The (P, W) hit matrix of one shard, in host memory."""
        return self.scanner.census_windows(shard, self.window,
                                           self.stride).hits

    def call(self, i: int):
        """Request ``i`` -> (its residues, its answer)."""
        j = i % len(self.pool)
        return len(self.pool[j]), (j, self._census(self.pool[j]))

    def to_host(self, answer):
        return answer

    def release(self) -> None:
        self.scanner = None

    def compare(self, answers, device, control: bool = False) -> dict:
        """Numbers compared: ``hit_mismatches``, the (pattern, window)
        entries of the sampled answers that differ from the reference's
        (all of an answer's where its shape is wrong). ``control`` puts in
        the program's place the reference's census as the paper scans,
        each pattern's SFA walked over the materialised windows, with state
        ids held in 8 bits; an answer that is not a ``(shard, hits)`` pair
        then stands for the pool's shards in turn."""
        import torch

        from bench_port.reference import sfa as ref_sfa
        from bench_port.reference.census import window_hits
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
        for k, answer in enumerate(answers):
            j, hits = (answer if isinstance(answer, tuple)
                       else (k % len(self.pool), None))
            shard = self.pool[j]
            if j not in cache:
                cache[j] = window_hits(ref, shard, self.window, self.stride)
            if low is not None:
                hits = window_hits(low, shard, self.window, self.stride)
            want = cache[j]
            bad += (int(np.count_nonzero(hits != want))
                    if np.shape(hits) == want.shape else want.size)
        return {"hit_mismatches": bad}
