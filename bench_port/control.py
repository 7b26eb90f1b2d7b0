"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, with state ids held in 8 bits
instead of the 16 the configurations state (the paper's packing; the port's
bulk construction refuses more than 2**16 states), compared with the
reference at full width as a run compares the program: for a compile, the
reference's SFA construction; for a scan, the reference's scan as the paper
makes it, each pattern's SFA walked. Each seed's numbers must come out above
their limit of 0.

    python3 bench_port/control.py --workload <cell> --seeds 1 2 3 [--device cuda]

The cell's traffic is drawn from each seed as a run draws it, and as many
answers are compared as a run keeps (the mix's ``check_answers``). The
program is not run.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control(bench: dict, workload: str, seed: int, device: str,
            root: Path = ROOT / "bench_port") -> dict:
    """The numbers the control gives for one seed of ``workload``."""
    from bench_port.harness import inputs

    cell = inputs.load_cell(bench, workload, root)
    driver = importlib.import_module(
        f"bench_port.drivers.{cell.traffic['kind']}")
    drv = driver.Driver(cell, inputs.load_bank(cell), seed)
    keep = int(cell.traffic["check_answers"])
    if cell.traffic["kind"] == "scan":
        rng = inputs.seed_rng(seed, 4)
        answers = [(int(j), None) for j in
                   rng.integers(len(drv.pool), size=keep)]
    else:
        answers = [{}] * keep
    return drv.compare(answers, device, control=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control(bench, args.workload, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
