"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on fake devices.

The twin of the reference's ``launch/dryrun.py``, which lowers and
compiles each cell for 512 placeholder XLA devices. PyTorch has no
ahead-of-time compiler for a sharded step, so here each cell's step runs
for real, on nothing:

  1. a fake process group of 256 ranks (512 with ``--multi-pod``) starts
     in this one process (``FakeStore``, backend ``"fake"``: collectives
     return at once), and the production mesh (16×16 or 2×16×16) is built
     over it;
  2. the arch's sharding rules are resolved as the reference resolves them
     (a batch the data axes do not divide is replicated);
  3. parameters, optimizer state, caches and inputs are fake ``DTensor``s
     placed by the rules (``FakeTensorMode``: zero bytes allocated);
  4. the cell's step runs (train: forward, backward and the optimizer;
     prefill; decode) under ``analysis.trace.StepTrace``, which records
     rank 0's local ops: FLOPs, traffic bytes and collectives, **per
     device**;
  5. the three-term roofline (``analysis/roofline.py``, H100 constants:
     estimates, not measurements) is applied, and everything goes to
     ``results/dryrun_torch/<cell>.json``.

Depth: a model is a stack of identical groups (one cycle of its layer
pattern; whisper: one encoder and one decoder layer), so every count is
affine in the group count. A cell of more than three groups is traced at
two groups and at three and extrapolated to its depth (one group is no
point of the line: ``TRACED_GROUPS``); the JSON names the traced depths.
The high water of live bytes is the largest of each allocation site's
live bytes extrapolated (the site of the high water may move with depth).
The argument bytes are the full-depth tree's local shards. A trace leaves
out DTensor's own bookkeeping (``analysis/trace.py``), so a cell's counts
do not depend on what the process traced before; an extrapolated count
below 0 raises rather than writing the cell.

Memory: ``argument_gb`` is one rank's parameters, optimizer state, cache
and inputs; ``temp_gb`` the step's temporaries, the high-water mark of
the live tensors it makes (``analysis/trace.py``: an eager run's, not
XLA's buffer assignment of a fused program, so not comparable with the
reference's ``temp_gb``), extrapolated in depth like the counts;
``fits_80gb`` holds their sum against the H100's 80 GB, the reference's
rule (it checks 16 GB of a v5e).

``--one-device`` traces the step on one device (no mesh, ``Dist()``) and
``--global-batch`` cuts the batch: the estimate to hold against a card's
allocator (``torch.cuda.max_memory_allocated``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen1p5_0p5b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --arch qwen1p5_0p5b --shape train_4k --one-device --global-batch 4
  python -m repro_torch.launch.dryrun --all [--multi-pod]   # subprocess per cell,
                                                           # one a CPU core at once
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
#: The H100's device memory.
DEVICE_GB = 80.0


def start_fake_world(n: int) -> None:
    """A fake process group of ``n`` ranks in this process (rank 0)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"a world of {dist.get_world_size()} ranks "
                               f"is up; the dry-run needs {n}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def cell_rules(cfg, shape, mesh, rule_overrides=None):
    """The reference's rules for a cell: the arch's overrides, and a batch
    the data axes do not divide replicated."""
    from ..sharding.rules import Rules

    names = tuple(mesh.mesh_dim_names)
    n_data = math.prod(mesh.size(i) for i, a in enumerate(names)
                       if a != "model")
    rules = Rules(mesh_axes=names).with_overrides(cfg.sharding_overrides)
    if shape.global_batch % n_data:
        rules = rules.with_overrides({"batch": None, "cache_batch": None})
    if rule_overrides:
        rules = rules.with_overrides(rule_overrides)
    return rules


def groups_of(cfg) -> int:
    """Identical groups in ``cfg``'s stack: pattern cycles (whisper: encoder
    and decoder layer pairs, when their counts agree)."""
    if cfg.is_encoder_decoder:
        return cfg.n_layers if cfg.n_layers == cfg.n_encoder_layers else 0
    return cfg.n_layers // len(cfg.layer_pattern)


def with_groups(cfg, g: int):
    """``cfg`` cut to ``g`` groups (its pattern remainder kept)."""
    if cfg.is_encoder_decoder:
        return dataclasses.replace(cfg, n_layers=g, n_encoder_layers=g)
    P = len(cfg.layer_pattern)
    return dataclasses.replace(cfg, n_layers=g * P + cfg.n_layers % P)


def local_bytes(tree) -> int:
    """One rank's bytes of a tree of (fake) ``DTensor``s (or, on one
    device, tensors)."""
    from ..models.base import tree_leaves

    return sum(t.numel() * t.element_size() for t in (
        getattr(t, "to_local", lambda t=t: t)() for t in tree_leaves(tree)))


def cell_args(run, mesh, rules, fake):
    """The fake ``DTensor`` arguments of a cell's step -> {name: tree}."""
    from ..models import base as mbase
    from ..models.model import build_model, input_specs
    from ..optim import build_optimizer

    cfg, shape = run.model, run.shape
    model = build_model(cfg)
    specs = model.param_specs()
    args = {"params": mbase.shape_structs(specs, rules, mesh, fake),
            "inputs": input_specs(cfg, shape, mesh, rules, fake)}
    if shape.kind == "train":
        opt = build_optimizer(run.optimizer)
        args["opt_state"] = mbase.shape_structs(opt.state_specs(specs),
                                                rules, mesh, fake)
    else:
        args["cache"] = model.cache_structs(
            shape.global_batch, run.max_cache_len or shape.seq_len, rules,
            mesh, fake)
    return model, args


def trace_cell(run, mesh, rules, fake, sites=None):
    """Run the cell's step on fake ``DTensor``s under a ``StepTrace`` ->
    ``TraceStats`` (rank 0's local ops); ``sites``: a dict to fill with the
    live bytes at each allocation site's high water."""
    import torch

    from ..analysis.trace import trace_step
    from ..serve.steps import make_decode_step, make_prefill_step
    from ..sharding.rules import Dist
    from ..train.steps import make_train_step

    dist = Dist(rules=rules) if mesh is None else Dist.for_mesh(mesh, rules)
    model, a = cell_args(run, mesh, rules, fake)
    x = a["inputs"]
    if run.shape.kind == "train":
        step_fn, _ = make_train_step(model, run, dist)
        _, stats = trace_step(step_fn, a["params"], a["opt_state"], 0, x,
                              fake_mode=fake, sites=sites)
    elif run.shape.kind == "prefill":
        step_fn = make_prefill_step(model, run, dist)
        with torch.no_grad():
            _, stats = trace_step(step_fn, a["params"], a["cache"], x,
                                  fake_mode=fake, sites=sites)
    else:
        step_fn = make_decode_step(model, run, dist)
        with torch.no_grad():
            _, stats = trace_step(step_fn, a["params"], a["cache"],
                                  x["tokens"], x["cache_pos"], fake_mode=fake,
                                  sites=sites)
    return stats


#: The depths a deeper model is traced at. One group is no point of the
#: line: a stacked weight of one group is gathered as a view, of several
#: by a copy (``funcol``'s all-gather along a dim past the first).
TRACED_GROUPS = (2, 3)


def _affine(at: dict, nxt: dict, g: int, d: int, path: str = "") -> dict:
    """Counts at ``g`` groups from those at ``d`` and ``d + 1`` (nested
    dicts of numbers); a count below 0 raises ``ValueError``."""
    out = {}
    for k in set(at) | set(nxt):
        a, b = at.get(k, 0), nxt.get(k, 0)
        if isinstance(a, dict) or isinstance(b, dict):
            out[k] = _affine(a or {}, b or {}, g, d, f"{path}{k}/")
        else:
            out[k] = a + (g - d) * (b - a)
            if out[k] < 0:
                raise ValueError(f"{path}{k}: {a} at {d} groups, {b} at "
                                 f"{d + 1} extrapolate to {out[k]} at {g}")
    return out


def cell_stats(run, mesh, rules, fake) -> tuple:
    """The step's counts at ``run``'s depth -> (stats JSON, the traced
    depths): a model of more than TRACED_GROUPS[-1] groups is traced at
    TRACED_GROUPS and extrapolated. The high water of live bytes is the
    largest of the allocation sites' live bytes, each extrapolated (the
    peak's site may move with depth: the largest of lines is no line)."""
    G = groups_of(run.model)
    if G <= TRACED_GROUPS[-1]:
        return trace_cell(run, mesh, rules, fake).to_json(), [G]
    d = TRACED_GROUPS[0]
    a, b = {}, {}
    at, nxt = (trace_cell(run.replace(model=with_groups(run.model, g)), mesh,
                          rules, fake, sites).to_json()
               for g, sites in zip(TRACED_GROUPS, (a, b)))
    stats = _affine(at, nxt, G, d)
    stats["peak_temp_bytes"] = max(a[s] + (G - d) * (b[s] - a[s])
                                   for s in a if s in b)
    return stats, list(TRACED_GROUPS)


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               rule_overrides=None, one_device: bool = False,
               global_batch: int | None = None):
    """-> (run, mesh, rules, fake mode, meta) of one cell, its fake world
    started (``one_device``: no world, no mesh; ``global_batch``: the
    batch cut to it)."""
    from ..configs import get_run
    from ..models.model import build_model
    from ..sharding.rules import Rules
    from .mesh import make_production_mesh, mesh_config

    run = get_run(arch, shape_name, mesh_config(multi_pod=multi_pod))
    if global_batch:
        run = run.replace(shape=dataclasses.replace(
            run.shape, global_batch=global_batch))
    if one_device:
        mesh = None
        rules = Rules(mesh_axes=()).with_overrides(
            run.model.sharding_overrides)
    else:
        start_fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        rules = cell_rules(run.model, run.shape, mesh, rule_overrides)
    meta = {
        "arch": arch, "shape": shape_name,
        "mesh": "1" if one_device else "2x16x16" if multi_pod else "16x16",
        "n_devices": 1 if one_device else mesh.size(),
        "global_batch": run.shape.global_batch,
        "micro_batches": run.micro_batches,
        "params_b": build_model(run.model).n_params() / 1e9,
        "kind": run.shape.kind,
    }
    return run, mesh, rules, fake_mode(), meta


def fake_mode():
    """The cell's ``FakeTensorMode``. The step runs with it inactive: its
    arguments are fake and so is every op on them, while the small tensors
    DTensor makes for itself (shard offsets it reads back) stay real; a
    tensor the step makes from nothing is taken in as a constant."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             one_device: bool = False, global_batch: int | None = None
             ) -> dict:
    from ..analysis.roofline import roofline_terms

    t0 = time.time()
    run, mesh, rules, fake, meta = build_cell(
        arch, shape_name, multi_pod, one_device=one_device,
        global_batch=global_batch)
    cfg, shape = run.model, run.shape
    _, full_args = cell_args(run, mesh, rules, fake)
    arg_bytes = {k: local_bytes(v) for k, v in full_args.items()}
    G = groups_of(cfg)
    stats, depths = cell_stats(run, mesh, rules, fake)
    t_trace = time.time() - t0
    roof = roofline_terms(
        cfg, shape,
        per_device_flops=stats["flops"],
        per_device_bytes=stats["traffic_bytes"],
        per_device_coll_bytes=stats["coll_operand_bytes"],
        n_chips=meta["n_devices"],
    )
    arg_gb = sum(arg_bytes.values()) / 1e9
    temp_gb = stats["peak_temp_bytes"] / 1e9
    result = {
        **meta,
        "trace_s": round(t_trace, 1),
        "traced_groups": depths,
        "groups": G,
        "memory": {
            "argument_gb": arg_gb,
            "argument_bytes": arg_bytes,
            "temp_gb": temp_gb,
            "temp_note": "eager high-water mark of the step's live tensors "
                         "(analysis/trace.py), not XLA's buffer assignment",
            "fits_80gb": arg_gb + temp_gb < DEVICE_GB,
        },
        "trace_stats": stats,
        "counts": "per device: rank 0's local ops on its shards",
        "roofline": roof.to_json(),
        "roofline_note": "estimates from H100 SXM constants "
                         "(analysis/roofline.py), not measurements",
        "status": "ok",
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / cell_file_name(arch, shape_name, multi_pod, one_device)
     ).write_text(json.dumps(result, indent=2))
    print(f"[{arch} x {shape_name}] OK  trace {t_trace:.0f}s "
          f"args {arg_gb:.2f}GB temp {temp_gb:.2f}GB "
          f"fits80={result['memory']['fits_80gb']} "
          f"flops/dev {stats['flops']:.3e} coll {stats['coll_count']} "
          f"({stats['coll_operand_bytes']:.3e} B) dominant={roof.dominant} "
          f"terms(c/m/x)=({roof.compute_s:.3e},{roof.memory_s:.3e},"
          f"{roof.collective_s:.3e})s (estimates)", flush=True)
    return result


def cell_file_name(arch: str, shape_name: str, multi_pod: bool,
                   one_device: bool = False) -> str:
    where = "one" if one_device else "multipod" if multi_pod else "pod"
    return f"{arch}__{shape_name}__{where}.json"


def all_cells():
    from ..config import SHAPES
    from ..configs import ARCH_IDS, get_config, shape_applicable

    for arch in ARCH_IDS:
        if arch == "paper_sfa":
            continue
        cfg = get_config(arch)
        for shape_name, shape in SHAPES.items():
            ok, why = shape_applicable(cfg, shape)
            yield arch, shape_name, ok, why


def sweep(out_dir: Path, multi_pod: bool, timeout: int) -> list:
    """Every cell, one subprocess each, one a CPU core at a time (a fake
    cell's step is host work) -> the failed cells."""
    todo = []
    for arch, shape_name, ok, why in all_cells():
        cell_file = out_dir / cell_file_name(arch, shape_name, multi_pod)
        if not ok:
            out_dir.mkdir(parents=True, exist_ok=True)
            cell_file.write_text(json.dumps(
                {"arch": arch, "shape": shape_name, "status": "skipped",
                 "reason": why}, indent=2))
            print(f"[{arch} x {shape_name}] SKIP: {why}")
            continue
        if cell_file.exists() and json.loads(
                cell_file.read_text()).get("status") == "ok":
            print(f"[{arch} x {shape_name}] cached")
            continue
        todo.append((arch, shape_name, cell_file))

    def one(cell):
        arch, shape_name, cell_file = cell
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape_name, "--out", str(out_dir)]
        if multi_pod:
            cmd.append("--multi-pod")
        try:
            ok = subprocess.run(cmd, timeout=timeout).returncode == 0
        except subprocess.TimeoutExpired:
            ok = False
        if not ok:
            cell_file.write_text(json.dumps(
                {"arch": arch, "shape": shape_name, "status": "failed"},
                indent=2))
        return None if ok else (arch, shape_name)

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        return [c for c in pool.map(one, todo) if c is not None]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--timeout", type=int, default=3000)
    ap.add_argument("--one-device", action="store_true",
                    help="trace the step on one device, no mesh")
    ap.add_argument("--global-batch", type=int, default=None,
                    help="cut the shape's global batch to this")
    args = ap.parse_args()
    out_dir = Path(args.out)

    if args.all:
        failures = sweep(out_dir, args.multi_pod, args.timeout)
        print(f"\n=== dry-run sweep done; {len(failures)} failures: "
              f"{failures}")
        sys.exit(1 if failures else 0)

    try:
        run_cell(args.arch, args.shape, args.multi_pod, out_dir,
                 one_device=args.one_device, global_batch=args.global_batch)
    except Exception:
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
