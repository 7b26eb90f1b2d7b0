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
affine in the group count. A cell of more than two groups is traced at one
group and at two and extrapolated to its depth (exact for FLOPs, traffic
and collectives); the JSON names the traced depths. The argument bytes are
the full-depth tree's local shards.

Memory: ``argument_gb`` is one rank's parameters, optimizer state, cache
and inputs; ``fits_80gb`` holds them against the H100's 80 GB (the
reference checks 16 GB of a v5e, with XLA's temporaries). A fake run has
no allocator, so the step's temporaries are not measured: ``temp_gb`` is
null.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen1p5_0p5b --shape train_4k [--multi-pod]
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
    """One rank's bytes of a tree of (fake) ``DTensor``s."""
    from ..models.base import tree_leaves

    return sum(t.to_local().numel() * t.element_size()
               for t in tree_leaves(tree))


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


def trace_cell(run, mesh, rules, fake):
    """Run the cell's step on fake ``DTensor``s under a ``StepTrace`` ->
    ``TraceStats`` (rank 0's local ops)."""
    import torch

    from ..analysis.trace import trace_step
    from ..serve.steps import make_decode_step, make_prefill_step
    from ..sharding.rules import Dist
    from ..train.steps import make_train_step

    dist = Dist.for_mesh(mesh, rules)
    model, a = cell_args(run, mesh, rules, fake)
    x = a["inputs"]
    if run.shape.kind == "train":
        step_fn, _ = make_train_step(model, run, dist)
        _, stats = trace_step(step_fn, a["params"], a["opt_state"], 0, x,
                              fake_mode=fake)
    elif run.shape.kind == "prefill":
        step_fn = make_prefill_step(model, run, dist)
        with torch.no_grad():
            _, stats = trace_step(step_fn, a["params"], a["cache"], x,
                                  fake_mode=fake)
    else:
        step_fn = make_decode_step(model, run, dist)
        with torch.no_grad():
            _, stats = trace_step(step_fn, a["params"], a["cache"],
                                  x["tokens"], x["cache_pos"], fake_mode=fake)
    return stats


def _affine(one: dict, two: dict, g: int) -> dict:
    """Counts at ``g`` groups from those at one and two (nested dicts of
    numbers)."""
    out = {}
    for k in set(one) | set(two):
        a, b = one.get(k, 0), two.get(k, 0)
        if isinstance(a, dict) or isinstance(b, dict):
            out[k] = _affine(a or {}, b or {}, g)
        else:
            out[k] = a + (g - 1) * (b - a)
    return out


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               rule_overrides=None):
    """-> (run, mesh, rules, fake mode, meta) of one cell, its fake world
    started."""
    from ..configs import get_run
    from .mesh import make_production_mesh, mesh_config

    run = get_run(arch, shape_name, mesh_config(multi_pod=multi_pod))
    start_fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    rules = cell_rules(run.model, run.shape, mesh, rule_overrides)
    from ..models.model import build_model

    meta = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": mesh.size(),
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


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path
             ) -> dict:
    from ..analysis.roofline import roofline_terms

    t0 = time.time()
    run, mesh, rules, fake, meta = build_cell(arch, shape_name, multi_pod)
    cfg, shape = run.model, run.shape
    _, full_args = cell_args(run, mesh, rules, fake)
    arg_bytes = {k: local_bytes(v) for k, v in full_args.items()}
    G = groups_of(cfg)
    if G > 2:
        depths = [1, 2]
        one, two = (trace_cell(run.replace(model=with_groups(cfg, g)), mesh,
                               rules, fake).to_json() for g in depths)
        stats = _affine(one, two, G)
    else:
        depths = [G]
        stats = trace_cell(run, mesh, rules, fake).to_json()
    t_trace = time.time() - t0
    roof = roofline_terms(
        cfg, shape,
        per_device_flops=stats["flops"],
        per_device_bytes=stats["traffic_bytes"],
        per_device_coll_bytes=stats["coll_operand_bytes"],
        n_chips=meta["n_devices"],
    )
    arg_gb = sum(arg_bytes.values()) / 1e9
    result = {
        **meta,
        "trace_s": round(t_trace, 1),
        "traced_groups": depths,
        "groups": G,
        "memory": {
            "argument_gb": arg_gb,
            "argument_bytes": arg_bytes,
            "temp_gb": None,
            "fits_80gb": arg_gb < DEVICE_GB,
        },
        "trace_stats": stats,
        "counts": "per device: rank 0's local ops on its shards",
        "roofline": roof.to_json(),
        "roofline_note": "estimates from H100 SXM constants "
                         "(analysis/roofline.py), not measurements",
        "status": "ok",
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / cell_file_name(arch, shape_name, multi_pod)).write_text(
        json.dumps(result, indent=2))
    print(f"[{arch} x {shape_name}] OK  trace {t_trace:.0f}s "
          f"args {arg_gb:.2f}GB fits80={result['memory']['fits_80gb']} "
          f"flops/dev {stats['flops']:.3e} coll {stats['coll_count']} "
          f"({stats['coll_operand_bytes']:.3e} B) dominant={roof.dominant} "
          f"terms(c/m/x)=({roof.compute_s:.3e},{roof.memory_s:.3e},"
          f"{roof.collective_s:.3e})s (estimates)", flush=True)
    return result


def cell_file_name(arch: str, shape_name: str, multi_pod: bool) -> str:
    return f"{arch}__{shape_name}__{'multipod' if multi_pod else 'pod'}.json"


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
    args = ap.parse_args()
    out_dir = Path(args.out)

    if args.all:
        failures = sweep(out_dir, args.multi_pod, args.timeout)
        print(f"\n=== dry-run sweep done; {len(failures)} failures: "
              f"{failures}")
        sys.exit(1 if failures else 0)

    try:
        run_cell(args.arch, args.shape, args.multi_pod, out_dir)
    except Exception:
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
