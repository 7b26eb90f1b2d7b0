"""Serving launcher: bring up the continuous-batching engine for an arch.

    python -m repro_torch.launch.serve --arch qwen1p5_0p5b --requests 16

Parameters are drawn at random from a seeded ``torch.Generator`` on the
serving device (``--device``, the card by default). As in the reference,
``--reduced`` is a ``store_true`` flag whose default is already true, so
the launcher always serves the smoke-scale config; a full-width model is
served by driving ``ServeEngine`` directly.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="serve the smoke-scale config")
    ap.add_argument("--device", default="cuda",
                    help="'cuda[:N]' (default) or 'cpu'")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.config import HOST_MESH, RunConfig, ShapeConfig, reduced
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.sharding.rules import Dist

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen, device=dev)
    run = RunConfig(model=cfg, shape=ShapeConfig("serve", 128, args.slots, "decode"),
                    mesh=HOST_MESH)
    engine = ServeEngine(model, run, Dist(), params, n_slots=args.slots,
                         max_len=128, temperature=0.7)

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        L = int(rng.integers(4, 20))
        engine.submit(Request(
            prompt=rng.integers(1, cfg.vocab_size, size=L).astype(np.int32),
            max_new_tokens=args.max_new, rid=i,
        ))
    done = engine.run_until_done()
    toks = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests, {toks} tokens")


if __name__ == "__main__":
    main()
