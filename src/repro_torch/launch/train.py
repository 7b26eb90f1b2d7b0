"""Training launcher: one device, or every rank of a ``torchrun`` world.

    python -m repro_torch.launch.train --arch qwen1p5_0p5b --steps 1000 \
        [--shape train_4k] [--checkpoint-dir DIR] [--device cuda|cpu] [--reduced]
    torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch ... [--multi-pod]

Alone, it runs ``Trainer`` with ``Dist()`` (no mesh) on ``--device``, the
card by default. Under ``torchrun`` (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT`` in the environment; this replaces the
reference's ``jax.distributed.initialize`` and its ``--coordinator``,
``--num-processes`` and ``--process-id``) every rank joins the world (NCCL
on the card, each rank on ``cuda:LOCAL_RANK``; gloo on the CPU), the mesh
is chosen as the reference chooses it (the production mesh from 512 ranks
on, else a data-parallel host mesh over the world), and each rank makes
only its rows of every batch (by its data coordinate). ``--reduced`` (not
in the reference) trains the smoke-scale config (``config.reduced``) on a
cut shape, so the launcher runs on a CPU in seconds.
"""

from __future__ import annotations

import argparse
import os


def _world_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda[:N]' (default) or 'cpu'")
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale config on a cut shape")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch.config import ShapeConfig, reduced
    from repro_torch.configs import get_run
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.data.pipeline import local_rows
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                         mesh_config)
    from repro_torch.models.model import build_model
    from repro_torch.sharding.rules import Dist, Rules
    from repro_torch.train.trainer import Trainer

    world = _world_size()
    dev = resolve_device(args.device)
    started = False
    if world > 1:
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(dev)
        if not dist.is_initialized():
            dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
            started = True
    if world >= 512:
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device=dev.type)
        run = get_run(args.arch, args.shape,
                      mesh_config(multi_pod=args.multi_pod))
    else:
        # elastic: whatever ranks this deployment actually has
        mesh = make_host_mesh(world, 1, device=dev.type) if world > 1 \
            else None
        run = get_run(args.arch, args.shape)
    if args.reduced:
        run = run.replace(model=reduced(run.model), shape=ShapeConfig(
            run.shape.name, 32, 2 * run.micro_batches * world,
            run.shape.kind))
    if args.checkpoint_dir:
        run = run.replace(checkpoint_dir=args.checkpoint_dir)

    cfg = run.model
    if mesh is None:
        d = Dist()
    else:
        rules = Rules(mesh_axes=tuple(mesh.mesh_dim_names)).with_overrides(
            cfg.sharding_overrides)
        d = Dist.for_mesh(mesh, rules)
    model = build_model(cfg)
    # per-rank data sharding: this rank produces only its rows
    rows_total = run.shape.global_batch
    row_start, rows = local_rows(d, rows_total)
    data = make_pipeline(DataConfig(
        vocab_size=cfg.vocab_size,
        seq_len=run.shape.seq_len,
        global_batch=rows_total,
        row_start=row_start,
        rows_local=-1 if mesh is None else rows,
        seed=run.seed,
        device=str(dev),
    ))
    trainer = Trainer(model=model, run=run, dist=d, data=data, device=dev)
    trainer.install_preemption_handler()
    rank = dist.get_rank() if dist.is_initialized() else 0
    try:
        out = trainer.fit(args.steps)
    finally:
        data.stop()
        if started:
            dist.destroy_process_group()
    if rank == 0:
        print(f"final loss {out['final_loss']}")
    return out


if __name__ == "__main__":
    main()
