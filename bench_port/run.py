"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for. A run sets up (imports, the kernels' build on a checkout's first run,
the configuration's DFAs, the traffic's requests from the seed, the
program's set-up and a warm-up), measures for ``--seconds`` on the host's
clock, compares a sample of the window's answers with the plain reference
once the window has closed, and prints one JSON line last on standard
output. ``--trace 1`` measures a shorter window (the mix's
``trace_seconds``) under ``torch.profiler`` and reports the cell's
per-layer metrics instead of its end-to-end ones.

The cell, its configuration, its traffic mix, its kind's driver
(``bench_port/drivers/<kind>.py``) and each metric's reader
(``bench_port/metrics/<name>.py``) are found by name from
``BENCHMARK.json``, so a cell, a mix, a configuration or a metric is added
by adding files and entries. The program is the PyTorch and CUDA port under
``src/``; nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Top-level module names a run must not have loaded by its end.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: Every number compared has the limit 0: the answers are exact.
LIMIT = 0
def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules(names=None) -> list:
    """The loaded modules (or ``names``) of JAX or the JAX package, by
    whole top-level name: ``repro_torch`` is the program, not ``repro``."""
    return sorted(m for m in list(sys.modules if names is None else names)
                  if m.split(".")[0] in FORBIDDEN)


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def measure(drv, seconds: float, seed: int, keep: int, annotate=None):
    """The closed loop: call the driver until ``seconds`` have passed on
    the host's clock, the last call finishing the window. -> (stats, the
    sampled answers)."""
    from bench_port.harness.inputs import Reservoir

    res = Reservoir(keep, seed)
    st = dict(attempted=0, completed=0, failed=0, work=0, latencies=[])
    t_begin = time.perf_counter()
    i = 0
    while True:
        st["attempted"] += 1
        t0 = time.perf_counter()
        try:
            if annotate is not None:
                with annotate("bench.request"):
                    work, answer = drv.call(i)
            else:
                work, answer = drv.call(i)
        except Exception:   # a failed request counts and fails the run
            st["failed"] += 1
            traceback.print_exc(file=sys.stderr)
        else:
            t1 = time.perf_counter()
            st["completed"] += 1
            st["work"] += work
            st["latencies"].append(t1 - t0)
            res.offer(answer)
        i += 1
        if time.perf_counter() - t_begin >= seconds:
            break
    st["seconds"] = time.perf_counter() - t_begin
    return st, res.items


def run(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", root: Path = ROOT / "bench_port",
        t_start: float = T_START) -> dict:
    """One run of ``workload``; -> the result line's object. ``device`` is
    ``"cuda"`` for every measured run (tests pass ``"cpu"``); ``root`` is
    the folder the cell's files are found in."""
    import torch

    from bench_port.harness import inputs
    from bench_port.harness.port import Port, kernel_names
    from bench_port.harness.trace import summarize
    from bench_port.harness.window import Window, load_reader, read_metric

    cell = inputs.load_cell(bench, workload, root)
    traffic = cell.traffic
    driver = importlib.import_module(f"bench_port.drivers.{traffic['kind']}")
    port = Port(cell.config["plan"], device, traffic.get("cache", "shared"))
    port.build_kernels()
    bank = inputs.load_bank(cell)
    drv = driver.Driver(cell, bank, seed)
    drv.start(port)
    port.sync()
    on_gpu = device.startswith("cuda")

    per_layer = [m for m in bench["per_layer"] if applies(m, workload)]
    metrics = per_layer if trace else [
        m for m in bench["end_to_end"] if applies(m, workload)]
    keep = int(traffic["check_answers"])
    before = port.counters()
    setup_s = time.perf_counter() - t_start
    summary, launches = None, []
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        needs = {k: load_reader("roofline", k).FACTS for k in (
            m["name"][:-len("_roofline")] for m in per_layer
            if m["name"].endswith("_roofline"))}
        port.annotate_spans(True)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_gpu else [])
        window = min(seconds, float(traffic["trace_seconds"]))
        with port.record_launches(needs) as launches, \
                profile(activities=acts) as prof:
            st, answers = measure(drv, window, seed, keep, record_function)
            port.sync()
        port.annotate_spans(False)
        t_read = time.perf_counter()
        summary = summarize(prof, st["seconds"])
        del prof
        log(f"trace read in {time.perf_counter() - t_read:.3f} s")
    else:
        st, answers = measure(drv, seconds, seed, keep)
        port.sync()
    after = port.counters()
    delta = {k: after[k] - before.get(k, 0) for k in after}
    peak = torch.cuda.max_memory_allocated() if on_gpu else 0

    w = Window(seconds=st["seconds"], setup_s=setup_s,
               completed=st["completed"], work=st["work"],
               latencies=st["latencies"], counters=delta, launches=launches,
               trace=summary)
    values = {}
    for m in metrics:
        v = read_metric(m["name"], w)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    log(f"{workload} seed {seed}: {st['completed']} of {st['attempted']} "
        f"calls in {st['seconds']:.3f} s, {st['work']} {drv.work_unit}, "
        f"set-up {setup_s:.3f} s, peak {peak} bytes")
    if len(st["latencies"]) >= 2:
        q = statistics.quantiles(st["latencies"], n=4)
        log(f"latency quartiles {q[0]:.6f} {q[1]:.6f} {q[2]:.6f} s")
    if summary is not None:
        traced, _ = summary.kernel_time(kernel_names())
        made = sum(v for k, v in delta.items() if k.startswith("launches."))
        calls = sum(v for k, v in delta.items()
                    if k.startswith("kernels.") and k.endswith(".calls"))
        log(f"trace: {summary.n_device_events} device events, {traced} of "
            f"them the port's kernels; {made} launches made "
            f"(ops.launches), {calls} kernel wrapper calls "
            f"(kernels.*.calls); busy {summary.busy_s:.6f} s of "
            f"{summary.window_s:.6f} s")

    # The peak is read above, before the reference runs; then the program's
    # answers go to host memory and its state is freed. The reference is
    # not timed.
    answers = [drv.to_host(a) for a in answers]
    drv.release()
    del port
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = drv.compare(answers, device)
    checks["failed_requests"] = st["failed"]
    log(f"reference: {len(answers)} answers compared in "
        f"{time.perf_counter() - t_ref:.3f} s")
    correct = bool(answers) and all(v <= LIMIT for v in checks.values())

    dev = {"platform": "gpu",
           "kind": torch.cuda.get_device_name(0) if on_gpu else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": st["attempted"],
           "failed": st["failed"], "metrics": values, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": summary.device_ops,
                            "idle_gaps": summary.idle_gaps}
    out["checks"] = {k: {"value": v, "limit": LIMIT}
                     for k, v in checks.items()}
    return out


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < chips[args.workload]):
        print(f"{args.workload} needs {chips[args.workload]} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    out = run(bench, args.workload, args.seed, args.seconds,
              bool(args.trace))
    leaked = forbidden_modules()
    if leaked:
        print(f"modules of JAX or the JAX package were loaded: {leaked}",
              file=sys.stderr)
        return 3
    log(f"card: {card_line()}")
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
