"""Training launcher, on one device.

    python -m repro_torch.launch.train --arch qwen1p5_0p5b --steps 1000 \
        [--shape train_4k] [--checkpoint-dir DIR] [--device cuda|cpu] [--reduced]

Runs ``Trainer`` with ``Dist()`` (no mesh) on ``--device``, the card by
default. The reference's multi-host arguments (``--coordinator``,
``--num-processes``, ``--process-id``, ``--multi-pod``) and its production
mesh wait for the sharded LM path: a ``torch.distributed`` world of more
than one rank raises. ``--reduced`` (not in the reference) trains the
smoke-scale config (``config.reduced``) on a cut shape, so the launcher
runs on a CPU in seconds.
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
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda[:N]' (default) or 'cpu'")
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale config on a cut shape")
    args = ap.parse_args(argv)

    from repro_torch.config import ShapeConfig, reduced
    from repro_torch.configs import get_run
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.device import resolve_device
    from repro_torch.models.model import build_model
    from repro_torch.sharding.rules import SHARDED_LM_ITEM, Dist
    from repro_torch.train.trainer import Trainer

    if _world_size() > 1:
        raise NotImplementedError(
            f"launch.train runs on one device; several ranks wait for "
            f"{SHARDED_LM_ITEM}")
    dev = resolve_device(args.device)
    run = get_run(args.arch, args.shape)
    if args.reduced:
        run = run.replace(model=reduced(run.model), shape=ShapeConfig(
            run.shape.name, 32, 2 * run.micro_batches, run.shape.kind))
    if args.checkpoint_dir:
        run = run.replace(checkpoint_dir=args.checkpoint_dir)

    cfg = run.model
    model = build_model(cfg)
    data = make_pipeline(DataConfig(
        vocab_size=cfg.vocab_size,
        seq_len=run.shape.seq_len,
        global_batch=run.shape.global_batch,
        seed=run.seed,
        device=str(dev),
    ))
    trainer = Trainer(model=model, run=run, dist=Dist(), data=data,
                      device=dev)
    trainer.install_preemption_handler()
    try:
        out = trainer.fit(args.steps)
    finally:
        data.stop()
    print(f"final loss {out['final_loss']}")
    return out


if __name__ == "__main__":
    main()
