"""The one module of the benchmark that touches the program, ``repro_torch``.

It hands the program the benchmark's DFAs and requests through its public
entry points (``Scanner.compile``, ``Scanner.scan``), reads back what they
produced (hit matrices; each pattern's SFA or blowup verdict from the
compiled scanner's groups), and reads the program's counters, kernel
launches and kernel names. In a traced run it also records the shapes of
each launch of the kernels whose rooflines the benchmark reports, and the
facts their counts need, from the arguments the program gave the kernels'
wrappers and its construction rounds. The program is imported from ``src/`` of the checkout; where it
is missing the import fails and so does the run.
"""

from __future__ import annotations

import contextlib
import re
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def program():
    """-> the program's modules the benchmark uses, imported once."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch.obs as obs
    from repro_torch.core.dfa import DFA
    from repro_torch.engine import Scanner, ScanPlan
    from repro_torch.engine.plan import ConstructionPolicy
    from repro_torch.kernels import build, ops

    return dict(obs=obs, DFA=DFA, Scanner=Scanner, ScanPlan=ScanPlan,
                ConstructionPolicy=ConstructionPolicy, build=build, ops=ops)


class Port:
    """The program on one device under a configuration's plan."""

    def __init__(self, plan: dict, device: str, cache: str = "shared"):
        self.m = program()
        self.device = device
        self.plan = self.m["ScanPlan"](
            mode=plan["mode"], sfa_state_budget=int(plan["sfa_state_budget"]),
            device=device,
            construction=self.m["ConstructionPolicy"](cache=cache)).validate()

    def build_kernels(self) -> None:
        """Build every kernel library the checkout lacks (the first run in a
        checkout; later runs find them in the program's build directory)."""
        if self.device.startswith("cuda"):
            self.m["build"].build_all()

    def dfas(self, bank, order=None) -> dict:
        """{id: the program's DFA} of a bank, in ``order`` (default the
        bank's), built from the benchmark's arrays."""
        DFA = self.m["DFA"]
        idx = range(len(bank)) if order is None else order
        return {bank.ids[i]: DFA(table=bank.tables[i], start=bank.starts[i],
                                 accepting=bank.accepting[i],
                                 alphabet="ACDEFGHIKLMNPQRSTVWY")
                for i in idx}

    def sync(self) -> None:
        """Wait for the device's queued work."""
        if self.device.startswith("cuda"):
            import torch

            torch.cuda.synchronize()

    def compile(self, dfas: dict):
        return self.m["Scanner"].compile(dfas, self.plan)

    @staticmethod
    def scan(scanner, docs) -> np.ndarray:
        """The (P, D) hit matrix of one request, in host memory."""
        return scanner.scan(docs).hits

    @staticmethod
    def sfas(scanner) -> dict:
        """{id: (blown, delta (S, k) int32, mappings (S, n) int32)} of a
        compiled scanner, read from its groups: a pattern in an SFA group
        closed, any other is blown."""
        out = {}
        for g in scanner.groups:
            for j, i in enumerate(g.indices):
                pid = scanner.ids[i]
                if g.mode != "sfa":
                    out[pid] = (True, None, None)
                    continue
                S = int(g.sfa_states[j])
                n = int(g.bank.n_states[j])
                out[pid] = (False, g.deltas[j, :S].cpu().numpy(),
                            g.sfa_maps[j, :S, :n].cpu().numpy())
        return out

    # -- counters -----------------------------------------------------------

    def counters(self) -> dict:
        """The program's counters (``kernels.*``, ``construction.*``,
        ``engine.*``, ...) and its per-kernel launch counts (as
        ``launches.<kernel>``)."""
        snap = {k: v for k, v in self.m["obs"].snapshot().items()
                if isinstance(v, (int, float))}
        for name, v in self.m["ops"].launches.items():
            snap[f"launches.{name}"] = v
        return snap

    def annotate_spans(self, on: bool) -> None:
        """Bridge the program's spans into the profiler's host timeline."""
        self.m["obs"].configure(profiler_annotations=on)

    @contextlib.contextmanager
    def record_launches(self, needs: dict):
        """Within the block, every call of the wrappers of the kernels in
        ``needs`` ({kernel: the facts its roofline reads}) appends
        ``(kernel, record)`` to the yielded list: the shapes of its tensor
        arguments (``args``, ``kwargs``) and of its result (``out``), and,
        once the block ends, the facts asked for, worked out from the
        arguments the launch was given:

        - ``true_rows``: (P,) rows of each table of the (P, n, k) stack in
          the first argument, up to its last row that is not a self-loop
          (trailing rows that map every symbol to themselves are padding; an
          absorbing last state counts as padding, so the count errs low);
        - ``round``: the construction round the launch ran in, a row of the
          launch's pattern axis each: ``live_rows`` (B,), the frontier rows
          the round expands for that pattern (0 for a padding row of the
          active-set bucket), and ``n_true`` (B,), the pattern's own states
          out of the bank's padded width, read from its word mask; and the
          round's frontier ``tile``.

        The round's tensors are held as the program made them (each a fresh
        index of its bank's buffers) and read once the block has ended, so
        recording adds no device work to the window."""
        import torch

        from repro_torch.construction import batched

        ops = self.m["ops"]
        log: list = []
        saved = {k: getattr(ops, k) for k in needs}
        tables: dict = {}
        current: dict = {"round": None}

        def shape(a):
            return tuple(a.shape) if isinstance(a, torch.Tensor) else a

        def wrap(name, fn):
            def call(*args, **kwargs):
                out = fn(*args, **kwargs)
                first = out[0] if isinstance(out, tuple) else out
                rec = {"args": [shape(a) for a in args],
                       "kwargs": {k: shape(v) for k, v in kwargs.items()},
                       "out": shape(first)}
                if "true_rows" in needs[name]:
                    key = (args[0].data_ptr(), tuple(args[0].shape))
                    tables.setdefault(key, args[0])
                    rec["table_key"] = key
                if "round" in needs[name]:
                    rec["round"] = current["round"]
                log.append((name, rec))
                return out
            return call

        orig_round = batched._bucket_round

        def bucket_round(tables, states, fp_hi, fp_lo, delta, n_states,
                         frontier, active, weights, limbs, word_masks,
                         **kw):
            current["round"] = (n_states, frontier, active, word_masks,
                                kw["tile"])
            try:
                return orig_round(tables, states, fp_hi, fp_lo, delta,
                                  n_states, frontier, active, weights, limbs,
                                  word_masks, **kw)
            finally:
                current["round"] = None

        for k, fn in saved.items():
            setattr(ops, k, wrap(k, fn))
        batched._bucket_round = bucket_round
        try:
            yield log
        finally:
            for k, fn in saved.items():
                setattr(ops, k, fn)
            batched._bucket_round = orig_round
            rows = {key: _true_rows(t) for key, t in tables.items()}
            for _, rec in log:
                if "table_key" in rec:
                    rec["true_rows"] = rows[rec.pop("table_key")]
                if rec.get("round") is not None:
                    rec["round"] = round_facts(*rec["round"])


def round_facts(n_states, frontier, active, word_masks, tile: int) -> dict:
    """A construction round's facts (see :meth:`Port.record_launches`)."""
    import torch

    live = torch.where(active, (n_states - frontier).clamp(0, tile), 0)
    m = word_masks.to(torch.int64) & 0xFFFFFFFF
    n_true = 2 * (m == 0xFFFFFFFF).sum(1) + (m == 0xFFFF).sum(1)
    return {"live_rows": live.cpu().numpy(), "n_true": n_true.cpu().numpy(),
            "tile": int(tile)}


def _true_rows(t) -> np.ndarray:
    """(P, n, k) padded tables -> (P,) rows up to each table's last row
    that is not a self-loop."""
    import torch

    n = t.shape[1]
    loop = (t == torch.arange(n, device=t.device, dtype=t.dtype
                              )[None, :, None]).all(2)
    last = (~loop).to(torch.int64) * torch.arange(1, n + 1, device=t.device)
    return last.max(1).values.cpu().numpy()


def kernel_names() -> tuple:
    """The names of the program's CUDA kernels, read from its sources
    (``src/repro_torch/kernels/csrc``): every ``__global__`` function. A
    trace shows each inside its demangled signature."""
    names = set()
    for f in sorted((ROOT / "src" / "repro_torch" / "kernels" / "csrc")
                    .glob("*.cu*")):
        names.update(_GLOBAL.findall(f.read_text()))
    return tuple(sorted(names))


_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")
