"""One rank of the sharded LM tests (``test_torch_sharded.py``).

``run`` joins a two-rank gloo world through a ``file://`` rendezvous and
runs every case of :data:`CASES` on the CPU, on the meshes (1, 2) (tensor
parallel: heads, mlp and vocab over ``model``) and (2, 1) (FSDP ``embed``
and ``batch`` over ``data``); every rank issues the same collectives in
the same order, and rank 0 pickles the results (or each case's error) to
``results.pkl``. The inputs come from numpy seeds through the functions
below, which the tests call too, for the one-device path. This module
imports neither jax nor pytest: it is what a spawned rank imports.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import sys

import numpy as np

CPU = "cpu"
WORLD = 2
MESHES = {"1x2": (1, 2), "2x1": (2, 1)}
#: The reduced architectures of the reference's small dry-run test.
ARCHS = ("qwen3_8b", "granite_moe_1b", "mamba2_370m", "recurrentgemma_9b",
         "whisper_base", "yi_34b")
#: Forward and train batch: rows, tokens (the train step's are 16 + 1).
B, S = 4, 16
#: The serving case: slots, cache length, prompts (lengths), new tokens.
SERVE_ARCH, SERVE_SLOTS, SERVE_LEN = "qwen3_8b", 2, 48
SERVE_PROMPTS, SERVE_NEW = (7, 12, 5), 6
#: The checkpoint cases' architecture.
CKPT_ARCH = "granite_moe_1b"
MOE_TOKENS = (4, 8)                   # (B, S) of the MoE layer case


def cfg_of(arch: str):
    """The reference tests' reduced configs, in f32 (as
    ``tests/test_torch_models.py``)."""
    from repro_torch.config import reduced
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch == "mamba2_370m":
        cfg = reduced(cfg, ssm_heads=4, ssm_head_dim=32, d_model=64,
                      ssm_state=16)
    elif arch == "recurrentgemma_9b":
        cfg = reduced(cfg, n_layers=5, rglru_width=64, head_dim=16)
    elif arch == "yi_34b":      # its own rules: the stream's sequence
        cfg = reduced(cfg, sharding_overrides=cfg.sharding_overrides)
    else:
        cfg = reduced(cfg)
    return dataclasses.replace(cfg, dtype="float32")


def numpy_weights(specs, seed: int) -> dict:
    """Weights for a ParamSpec tree from a numpy seed (the reference's
    distributions, small noise on what it starts at zero or one), as f32
    numpy arrays in the spec's nested dicts."""
    rng = np.random.default_rng(seed)

    def one(s):
        if s.init == "uniform_scaled":
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            b = np.sqrt(1.0 / max(fan_in, 1))
            a = rng.uniform(-b, b, s.shape)
        elif s.init == "ones":
            a = 1.0 + 0.1 * rng.normal(size=s.shape)
        else:
            a = rng.normal(size=s.shape) * (s.scale if s.init == "normal"
                                            else 0.02)
        return a.astype(np.float32)

    from repro_torch.models.base import map_specs

    return map_specs(one, specs)


def torch_weights(specs, seed: int) -> dict:
    """``numpy_weights`` as CPU tensors of the specs' dtypes."""
    import torch

    from repro_torch.models.base import map_specs_with_paths, torch_dtype

    w = numpy_weights(specs, seed)

    def at(path):
        node = w
        for k in path:
            node = node[k]
        return node

    return map_specs_with_paths(lambda path, s: torch.from_numpy(
        at(path)).to(torch_dtype(s.dtype)), specs)


def inputs(cfg, seed: int = 1) -> dict:
    """numpy {tokens (B, S + 1) [, frames | prefix_embeds]}."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(1, cfg.vocab_size, (B, S + 1)).astype(
        np.int32)}
    if cfg.is_encoder_decoder:
        out["frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model))
    if cfg.num_prefix_embeds:
        out["prefix_embeds"] = rng.normal(
            size=(B, cfg.num_prefix_embeds, cfg.d_model))
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v
            for k, v in out.items()}


def train_run(cfg):
    """One train step's run: AdamW past its one-step warmup, 2
    micro-batches."""
    from repro_torch.config import HOST_MESH, SHAPES, OptimizerConfig, RunConfig

    return RunConfig(model=cfg, shape=SHAPES["train_4k"], mesh=HOST_MESH,
                     optimizer=OptimizerConfig(lr=1e-3, warmup_steps=1),
                     micro_batches=2)


def serve_prompts(cfg) -> list:
    rng = np.random.default_rng(3)
    return [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
            for n in SERVE_PROMPTS]


def moe_inputs(cfg, seed: int = 5) -> tuple:
    """(layer weights, x (B, S, d)) of one MoE layer, numpy f32."""
    from repro_torch.models.moe import moe_specs

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*MOE_TOKENS, cfg.d_model)).astype(np.float32)
    return numpy_weights(moe_specs(cfg), seed), x


# --------------------------------------------------------------------------
# Cases
# --------------------------------------------------------------------------


def _dist(mesh, cfg):
    from repro_torch.sharding.rules import Dist, Rules

    rules = Rules(mesh_axes=tuple(mesh.mesh_dim_names)).with_overrides(
        cfg.sharding_overrides)
    return Dist.for_mesh(mesh, rules)


def _batch(d, arrays: dict, train: bool) -> dict:
    """numpy arrays -> DTensors of this rank's rows (by its data
    coordinate), as the data pipeline hands them over."""
    import torch

    from repro_torch.data.pipeline import local_rows, to_mesh

    out = {}
    for k, v in arrays.items():
        if k == "tokens" and train:
            out["tokens"], out["labels"] = v[:, :-1], v[:, 1:]
        elif k == "tokens":
            out["tokens"] = v[:, :-1]
        else:
            out[k] = v
    start, n = local_rows(d, B)
    return {k: to_mesh(torch.from_numpy(np.ascontiguousarray(v[start:start + n])),
                       d) for k, v in out.items()}


def _full(tree):
    """A tree's leaves as full numpy arrays (every rank joins)."""
    from repro_torch.models.base import leaves_with_paths

    return {p: t.full_tensor().float().numpy() if hasattr(t, "full_tensor")
            else t.float().numpy() for p, t in leaves_with_paths(tree)}


def case_forward(mesh, arch):
    import torch

    from repro_torch.models.model import build_model

    cfg = cfg_of(arch)
    d = _dist(mesh, cfg)
    model = build_model(cfg)
    model.load(torch_weights(model.param_specs(), 0), d)
    batch = _batch(d, inputs(cfg), train=False)
    tokens = batch.pop("tokens")
    with torch.no_grad():
        logits, _, aux = model.forward(None, tokens, d, **batch)
    return dict(logits=logits.full_tensor().numpy(), aux=float(aux.full_tensor())
                if hasattr(aux, "full_tensor") else float(aux))


def capturing(build):
    """``build_optimizer`` whose optimizers' ``update`` puts the gradients
    they were given into the metrics (``"grads"``), as
    ``tests/test_torch_train.py`` captures them."""
    def wrapped(cfg):
        opt = build(cfg)

        def update(grads, *args):
            p, s, stats = opt.update(grads, *args)
            return p, s, {**stats, "grads": grads}

        return dataclasses.replace(opt, update=update)

    return wrapped


def nested(flat: dict) -> dict:
    """{path: array} -> nested dicts."""
    out: dict = {}
    for path, a in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return out


def train_step_on(d, arch, batch_fn):
    """One train step (step 1) of ``arch`` under ``d`` from the numpy
    weights, gradients captured -> (params, state, metrics) as numpy
    trees."""
    import repro_torch.train.steps as steps
    from repro_torch.models.model import build_model

    cfg = cfg_of(arch)
    model = build_model(cfg)
    params = model.load(torch_weights(model.param_specs(), 0), d)
    build = steps.build_optimizer
    steps.build_optimizer = capturing(build)
    try:
        step, opt = steps.make_train_step(model, train_run(cfg), d)
    finally:
        steps.build_optimizer = build
    state = opt.init(params, model.param_specs(), d)
    p, s, met = step(params, state, 1, batch_fn(d, inputs(cfg)))
    grads = met.pop("grads")
    return (nested(_full(p)), nested(_full(s)),
            {**{k: float(v) for k, v in met.items()},
             "grads": nested(_full(grads))})


def case_train(mesh, arch):
    return train_step_on(_dist(mesh, cfg_of(arch)), arch,
                         lambda d, x: _batch(d, x, train=True))


def case_moe(mesh):
    import torch

    from repro_torch.models.base import distribute_params
    from repro_torch.models.moe import moe_layer, moe_specs

    cfg = cfg_of("granite_moe_1b")
    d = _dist(mesh, cfg)
    w, x = moe_inputs(cfg)
    specs = moe_specs(cfg)
    params = distribute_params({k: torch.from_numpy(v) for k, v in w.items()},
                               specs, d.rules, mesh)
    from torch.distributed.tensor import distribute_tensor

    xt = distribute_tensor(torch.from_numpy(x), mesh, d.rules.placements(
        mesh, "batch", "seq_act", "embed_act"))
    with torch.no_grad():
        y, aux = moe_layer(params, xt, cfg, d.rules, mesh=mesh,
                           data_axes=d.data_axes, model_axis=d.model_axis)
    return dict(y=y.full_tensor().numpy(), aux=float(aux.full_tensor()))


def case_serve(mesh):
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = cfg_of(SERVE_ARCH)
    d = _dist(mesh, cfg)
    model = build_model(cfg)
    model.load(torch_weights(model.param_specs(), 0), d)
    eng = ServeEngine(model, train_run(cfg), d, None, n_slots=SERVE_SLOTS,
                      max_len=SERVE_LEN)
    for i, p in enumerate(serve_prompts(cfg)):
        eng.submit(Request(prompt=p, max_new_tokens=SERVE_NEW, rid=i))
    done = eng.run_until_done()
    return {r.rid: list(r.out_tokens) for r in done}


def case_checkpoint(meshes, out_dir):
    """Save a train state on (2, 1); restore it onto (1, 2) and onto one
    device; restore the reference's checkpoint (written by the test under
    ``out_dir/ref``) onto (2, 1)."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models.model import build_model
    from repro_torch.train.steps import make_train_step

    cfg = cfg_of(CKPT_ARCH)
    model = build_model(cfg)
    specs = model.param_specs()
    d21, d12 = _dist(meshes["2x1"], cfg), _dist(meshes["1x2"], cfg)
    params = model.load(torch_weights(specs, 0), d21)
    step, opt = make_train_step(model, train_run(cfg), d21)
    state = opt.init(params, specs, d21)
    params, state, _ = step(params, state, 1,
                            _batch(d21, inputs(cfg), train=True))
    saved = _full({"params": params, "opt": state})
    mgr = CheckpointManager(os.path.join(out_dir, "ckpt"), async_save=False)
    mgr.save(2, {"params": params, "opt": state}, extra={"data": {"step": 2}})
    opt_specs = opt.state_specs(specs)
    like = {"params": specs, "opt": opt_specs}
    on12 = mgr.restore(like, shardings=d12.shardings(like))
    on_one = mgr.restore({"params": torch_weights(specs, 1),
                          "opt": opt.init(torch_weights(specs, 1), specs)})
    ref = CheckpointManager(os.path.join(out_dir, "ref")).restore(
        {"params": specs}, shardings=d21.shardings({"params": specs}))
    return dict(saved=saved, step=on12[0], on_1x2=_full(on12[1]),
                on_1x2_placements=sorted(
                    {str(t.placements) for t in _leaves(on12[1])}),
                on_one=_full(on_one[1]), extra=on12[2],
                ref_on_2x1=_full(ref[1]))


def _leaves(tree):
    from repro_torch.models.base import tree_leaves

    return tree_leaves(tree)


CASES = tuple([f"forward_{a}_{m}" for a in ARCHS for m in MESHES]
              + [f"train_{a}_{m}" for a in ARCHS for m in MESHES]
              + [f"moe_{m}" for m in MESHES]
              + [f"serve_{m}" for m in MESHES]
              + ["checkpoint"])


def run_case(name: str, meshes: dict, out_dir: str):
    kind, _, rest = name.partition("_")
    if kind == "checkpoint":
        return case_checkpoint(meshes, out_dir)
    arch, _, mesh = rest.rpartition("_") if kind in ("forward", "train") \
        else ("", "", rest)
    fn = globals()[f"case_{kind}"]
    return fn(meshes[mesh], arch) if arch else fn(meshes[mesh])


def run(rank: int, init_file: str, out_dir: str, src: str,
        cases=CASES) -> None:
    """One rank: join the world, run every case, rank 0 writes results."""
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist

    # One intra-op thread a rank, as tests/_torch_threads.py does for a
    # test process: two ranks share the machine with the suite's workers.
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    from repro_torch.mesh import make_mesh

    meshes = {name: make_mesh(shape, ("data", "model"), device=CPU)
              for name, shape in MESHES.items()}
    results = {}
    for name in cases:
        try:
            results[name] = ("ok", run_case(name, meshes, out_dir))
        except Exception as e:  # recorded for the test, which reports it
            import traceback

            results[name] = ("error", type(e).__name__,
                             f"{e}\n{traceback.format_exc()}")
    if rank == 0:
        with open(os.path.join(out_dir, "results.pkl"), "wb") as f:
            pickle.dump(results, f)
    dist.destroy_process_group()
