"""Traffic of kind ``compile``: one client compiles the configuration's bank
of DFAs into a ready scanner, again and again, each compile ending in a
device synchronisation. With the mix's ``cache: "off"`` every compile
constructs every SFA (the paper's construction from FAs).

Each compile hands the program the bank in one of the mix's ``orders``, in
turn; the orders are the same for every seed, which picks the first. A
compile's work is one compile. The answers compared are a sample of the
window's compiles: each pattern's SFA (transition table and mapping stack)
or blowup verdict against the plain reference construction at the
configuration's budget.
"""

from __future__ import annotations

import numpy as np

from bench_port.harness import inputs


class Driver:
    work_unit = "compiles"

    def __init__(self, cell, bank, seed: int):
        self.bank = bank
        self.budget = int(cell.config["plan"]["sfa_state_budget"])
        self.orders = inputs.compile_orders(cell.traffic, len(bank), seed)
        self.port = self.banks = None

    def start(self, port) -> None:
        """The program's set-up: the bank in each order as the program's
        DFAs, and one compile."""
        self.port = port
        self.banks = [port.dfas(self.bank, o) for o in self.orders]
        self._compile(self.banks[-1])

    def _compile(self, dfas):
        scanner = self.port.compile(dfas)
        self.port.sync()
        return scanner

    def call(self, i: int):
        """Compile ``i`` -> (1, its scanner)."""
        return 1, self._compile(self.banks[i % len(self.banks)])

    def to_host(self, scanner):
        """A kept compile's answer in host memory: {id: (blown, delta,
        mappings)}."""
        return self.port.sfas(scanner)

    def release(self) -> None:
        self.banks = None

    def compare(self, answers, device, control: bool = False) -> dict:
        """Numbers compared: ``sfa_mismatches``, the patterns of the sampled
        compiles whose verdict, transition table or mapping stack differs
        from the reference's (a pattern missing from an answer counts).
        ``control`` puts the reference computed with 8-bit state ids in the
        program's place."""
        from bench_port.reference import sfa as ref

        want = ref.construct_bank(self.bank.tables, self.budget)
        low = (ref.construct_bank(self.bank.tables, self.budget, np.uint8)
               if control else None)
        bad = 0
        for got in answers:
            for p, pid in enumerate(self.bank.ids):
                if low is not None:
                    mine = low[p]
                elif pid in got:
                    blown, delta, maps = got[pid]
                    mine = ref.RefSFA(blown, delta, maps)
                else:
                    bad += 1
                    continue
                bad += not ref.same(mine, want[p])
        return {"sfa_mismatches": bad}
