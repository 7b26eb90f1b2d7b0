"""The sharded LM path: ``DTensor`` over a ``DeviceMesh``, on the CPU.

* Placements: for every architecture, every parameter and cache leaf, on
  (2, 2), (16, 16) and (2, 16, 16) meshes, ``Rules.placements`` shards the
  same tensor dims over the same mesh axes, in the same order, as the
  reference's ``Rules.spec``.
* Shard shapes: on a 4 x 2 mesh (a fake world of 8 in a subprocess; the
  reference's host mesh of 8 devices in another), the local shards of
  ``shape_structs`` and ``input_specs`` have the shapes of
  ``NamedSharding(mesh, spec).shard_shape`` for the five reduced
  architectures of ``tests/test_dryrun_small.py`` and yi_34b under its
  own rules (the residual stream's sequence over ``model``).
* Two gloo ranks (``tests/_torch_sharded_worker.py``, spawned once), on the
  meshes (1, 2) and (2, 1): the forward and one train step of those six
  models against the port's one-device path (so against the reference
  through the existing parity tests); granite's sharded ``moe_layer``
  against the reference's own sharded ``moe_layer`` on a 2-device host
  mesh; a ``ServeEngine`` run whose tokens equal the one-device engine's;
  a checkpoint saved on (2, 1) restored bit-equal onto (1, 2) and onto one
  device, and a reference checkpoint restored onto (2, 1).

Bounds: the forward's logits within 1e-5 of the largest (mamba2 1e-4: it
rounds the operands of two products to bf16, and another summation order
upstream moves a rounding by an ulp, as ``test_torch_models.py`` allows);
a train step within ``tests/test_torch_train.py``'s bounds.

The sharded MoE routes each data shard's tokens with that shard's
capacity, so on (2, 1) granite is held to ``_moe_local`` run on each data
shard, never to the one-device MoE.

A hung collective fails these tests: the ranks get :data:`TIMEOUT_S` and
are terminated after it.
"""

import json
import multiprocessing
import os
import pickle
import subprocess
import sys
import textwrap
import time
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import _torch_sharded_worker as W  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_train import _check_step  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro_torch.models.transformer as transformer  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_run as jget_run  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro.sharding.rules import Rules as JRules  # noqa: E402
from repro_torch.configs import get_run  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.base import leaves_with_paths  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.sharding.rules import Dist, Rules  # noqa: E402

TIMEOUT_S = 420
SRC = str(Path(__file__).resolve().parent.parent / "src")
FWD_RTOL = {"mamba2_370m": 1e-4}
FWD_RTOL_DEFAULT = 1e-5
#: The reference's checkpoint restored onto a port mesh: written with this
#: seed's weights at this step.
REF_SEED, REF_STEP = 7, 3


# --------------------------------------------------------------------------
# Placements against the reference's PartitionSpecs
# --------------------------------------------------------------------------

MESHES = {"2x2": ("data", "model"), "16x16": ("data", "model"),
          "2x16x16": ("pod", "data", "model")}


def _as_spec(placements, names, ndim) -> tuple:
    """Placements -> one entry a tensor dim: the mesh axes that shard it
    (in mesh order), as the reference's ``PartitionSpec`` entry."""
    out = []
    for d in range(ndim):
        axes = tuple(n for n, p in zip(names, placements)
                     if getattr(p, "dim", None) == d)
        out.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    return tuple(out)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != "paper_sfa"])
def test_placements_match_the_reference_specs(arch, mesh):
    names = MESHES[mesh]
    # Rules.placements reads only the mesh's axis names.
    dmesh = types.SimpleNamespace(mesh_dim_names=names)
    checked = 0
    for shape_name, batch in (("train_4k", 256), ("decode_32k", 128)):
        jrun, run = jget_run(arch, shape_name), get_run(arch, shape_name)
        jrules = JRules(mesh_axes=names).with_overrides(
            jrun.model.sharding_overrides)
        rules = Rules(mesh_axes=names).with_overrides(
            run.model.sharding_overrides)
        jm, m = jbuild_model(jrun.model), build_model(run.model)
        trees = [(jm.param_specs(), m.param_specs())]
        if shape_name == "decode_32k":
            trees.append((jm.cache_specs(batch, 4096),
                          m.cache_specs(batch, 4096)))
        for jtree, tree in trees:
            jleaves = jax.tree_util.tree_flatten_with_path(
                jtree, is_leaf=lambda x: hasattr(x, "logical"))[0]
            got = dict(leaves_with_paths(tree))
            assert len(jleaves) == len(got)
            for jpath, jspec in jleaves:
                path = tuple(k.key for k in jpath)
                spec = got[path]
                want = tuple(jrules.spec(*jspec.logical))
                want += (None,) * (len(jspec.shape) - len(want))
                have = _as_spec(rules.placements(dmesh, *spec.logical),
                                names, len(spec.shape))
                assert have == want, (arch, shape_name, path, have, want)
                checked += 1
    assert checked > 0


def test_placements_reject_what_dtensor_cannot_express():
    dmesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    with pytest.raises(ValueError, match="mesh order"):
        Rules(mapping={"batch": ("data", "pod")}).placements(dmesh, "batch")
    with pytest.raises(ValueError, match="two dims"):
        Rules().placements(dmesh, "heads", "mlp")
    # axes absent from the mesh drop out, as in resolve
    flat = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    assert _as_spec(Rules().placements(flat, "batch", None),
                    ("data", "model"), 2) == ("data", None)


def test_constrain_passes_a_plain_tensor_through():
    from repro_torch.sharding.rules import constrain

    x = torch.ones(2, 3)
    assert constrain(x, Rules(), "batch", "embed") is x
    assert Dist().shardings({"a": None}) is None


# --------------------------------------------------------------------------
# Local shard shapes on a 4 x 2 mesh, against NamedSharding.shard_shape
# --------------------------------------------------------------------------

DRYRUN_ARCHS = ["qwen3_8b", "granite_moe_1b", "mamba2_370m",
                "recurrentgemma_9b", "whisper_base", "yi_34b"]

_SHAPES_COMMON = """
    import os, sys, json
    sys.path.insert(0, %r)
    ARCHS = %r
    def small(get_config, reduced, arch):
        extra = {}
        if arch == "mamba2_370m":
            extra = dict(ssm_heads=4, ssm_head_dim=32, ssm_state=16)
        if arch == "yi_34b":    # its own rules: the stream's sequence split
            extra = dict(sharding_overrides=get_config(
                arch).sharding_overrides)
        return reduced(get_config(arch), d_model=64, n_heads=4, n_kv_heads=2,
                       head_dim=16, vocab_size=256, **extra)
"""

REF_SHAPES = textwrap.dedent(("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
""" + _SHAPES_COMMON + """
    import jax
    from jax.sharding import NamedSharding
    from repro.compat import make_mesh
    from repro.config import ShapeConfig, reduced
    from repro.configs import get_config
    from repro.models.model import build_model
    from repro.sharding.rules import Rules
    mesh = make_mesh((4, 2), ("data", "model"))
    out = {}
    for arch in ARCHS:
        cfg = small(get_config, reduced, arch)
        rules = Rules(mesh_axes=("data", "model")).with_overrides(
            cfg.sharding_overrides)
        model = build_model(cfg)
        leaves = jax.tree_util.tree_flatten_with_path(
            {"params": model.param_specs(), "cache": model.cache_specs(8, 64)},
            is_leaf=lambda x: hasattr(x, "logical"))[0]
        got = {"/".join(k.key for k in p): list(NamedSharding(
            mesh, rules.spec(*s.logical)).shard_shape(s.shape))
            for p, s in leaves}
        for kind in ("train", "decode"):
            B, S = 8, 64
            tok = NamedSharding(mesh, rules.spec("batch", None))
            got[f"{kind}/tokens"] = list(tok.shard_shape(
                (B, S) if kind == "train" else (B, 1)))
        if cfg.is_encoder_decoder:
            got["train/frames"] = list(NamedSharding(mesh, rules.spec(
                "batch", None, "embed_act")).shard_shape(
                (8, cfg.encoder_seq, cfg.d_model)))
        out[arch] = got
    print(json.dumps(out))
""") % (SRC, DRYRUN_ARCHS))

PORT_SHAPES = textwrap.dedent(_SHAPES_COMMON + """
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    from repro_torch.config import ShapeConfig, reduced
    from repro_torch.configs import get_config
    from repro_torch.mesh import make_mesh
    from repro_torch.models.base import leaves_with_paths, shape_structs
    from repro_torch.models.model import build_model, input_specs
    from repro_torch.sharding.rules import Rules
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    out = {}
    for arch in ARCHS:
        cfg = small(get_config, reduced, arch)
        rules = Rules(mesh_axes=("data", "model")).with_overrides(
            cfg.sharding_overrides)
        model = build_model(cfg)
        tree = {"params": model.param_structs(rules, mesh),
                "cache": model.cache_structs(8, 64, rules, mesh)}
        got = {"/".join(p): list(t.to_local().shape)
               for p, t in leaves_with_paths(tree)}
        for kind in ("train", "decode"):
            x = input_specs(cfg, ShapeConfig("t", 64, 8, kind), mesh, rules)
            got[f"{kind}/tokens"] = list(x["tokens"].to_local().shape)
            if "frames" in x:
                got[f"{kind}/frames"] = list(x["frames"].to_local().shape)
            assert all(t.to_local().untyped_storage().nbytes() == 0
                       or type(t.to_local()).__name__ == "FakeTensor"
                       for t in x.values())
        out[arch] = got
    print(json.dumps(out))
""") % (SRC, DRYRUN_ARCHS)


def _run_json(script: str) -> dict:
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_shard_shapes_match_named_sharding():
    want, got = _run_json(REF_SHAPES), _run_json(PORT_SHAPES)
    for arch in DRYRUN_ARCHS:
        w, g = want[arch], got[arch]
        assert set(w) <= set(g), (arch, sorted(set(w) - set(g)))
        bad = {k: (g[k], v) for k, v in w.items() if g[k] != v}
        assert not bad, (arch, bad)


# --------------------------------------------------------------------------
# Two gloo ranks
# --------------------------------------------------------------------------


def _write_reference_checkpoint(out: Path) -> dict:
    """The reference's checkpoint of ``CKPT_ARCH``'s parameters (numpy
    seed REF_SEED) at REF_STEP -> those parameters, numpy."""
    import jax.numpy as jnp

    from repro.checkpoint.manager import save_tree

    cfg = W.cfg_of(W.CKPT_ARCH)
    weights = W.numpy_weights(build_model(cfg).param_specs(), REF_SEED)
    jtree = {"params": _tree_apply(jnp.asarray, weights)}
    save_tree(out / "ref", REF_STEP, jtree)
    return weights


def _tree_apply(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_apply(fn, v) for k, v in tree.items()}
    return fn(tree)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn both ranks once; -> ({case: ("ok", result) | ("error", ...)},
    the reference checkpoint's weights)."""
    out = tmp_path_factory.mktemp("sharded")
    ref_weights = _write_reference_checkpoint(out)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=W.run,
                         args=(r, str(out / "rendezvous"), str(out), SRC))
             for r in range(W.WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.terminate()
        p.join(timeout=10)
    if hung:
        pytest.fail(f"{len(hung)} rank(s) still running after {TIMEOUT_S} s "
                    "(a hung collective); terminated")
    codes = [p.exitcode for p in procs]
    if codes != [0] * W.WORLD:
        pytest.fail(f"ranks exited with {codes}")
    with open(os.path.join(out, "results.pkl"), "rb") as f:
        return pickle.load(f), ref_weights


def _result(ranks, case):
    status, *rest = ranks[0][case]
    assert status == "ok", rest
    return rest[0]


def _per_shard_moe(n_shards: int):
    """``moe_layer`` as each of ``n_shards`` data shards runs it: the
    tokens split in rank order, ``_moe_local`` on each (its own capacity),
    the load-balance losses averaged."""
    def layer(params, x, cfg, rules, mesh=None, data_axes=(),
              model_axis=None):
        B, S, d = x.shape
        parts = x.reshape(n_shards, B * S // n_shards, d)
        outs = [moe._moe_local(params["router"], params["w_gate"],
                               params["w_up"], params["w_down"], p, cfg)
                for p in parts]
        y = torch.cat([o[0] for o in outs]).reshape(B, S, d)
        return y, torch.stack([o[1] for o in outs]).mean()

    return layer


def _one_device(monkeypatch, arch: str, mesh: str):
    """On (2, 1) the MoE runs per data shard (see the module's note)."""
    if arch == "granite_moe_1b" and mesh == "2x1":
        monkeypatch.setattr(transformer, "moe_layer", _per_shard_moe(2))


@pytest.mark.parametrize("mesh", sorted(W.MESHES))
@pytest.mark.parametrize("arch", W.ARCHS)
def test_sharded_forward_matches_one_device(ranks, arch, mesh, monkeypatch):
    got = _result(ranks, f"forward_{arch}_{mesh}")
    _one_device(monkeypatch, arch, mesh)
    cfg = W.cfg_of(arch)
    model = build_model(cfg)
    model.load(W.torch_weights(model.param_specs(), 0))
    x = {k: torch.from_numpy(v) for k, v in W.inputs(cfg).items()}
    tokens = x.pop("tokens")[:, :-1]
    with torch.no_grad():
        logits, _, aux = model.forward(None, tokens, Dist(), **x)
    want = logits.numpy()
    err = np.max(np.abs(want - got["logits"])) / np.max(np.abs(want))
    assert err <= FWD_RTOL.get(arch, FWD_RTOL_DEFAULT), (arch, mesh, err)
    assert abs(float(aux) - got["aux"]) <= 1e-5 * max(abs(float(aux)), 1.0)


@pytest.mark.parametrize("mesh", sorted(W.MESHES))
@pytest.mark.parametrize("arch", W.ARCHS)
def test_sharded_train_step_matches_one_device(ranks, arch, mesh,
                                               monkeypatch):
    got = _result(ranks, f"train_{arch}_{mesh}")
    _one_device(monkeypatch, arch, mesh)
    want = W.train_step_on(Dist(), arch, lambda d, x: {
        "tokens": torch.from_numpy(x["tokens"][:, :-1].copy()),
        "labels": torch.from_numpy(x["tokens"][:, 1:].copy()),
        **{k: torch.from_numpy(v) for k, v in x.items() if k != "tokens"}})
    _check_step(want, got, arch, bf16_grads=arch == "mamba2_370m")


REF_MOE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import sys, json
    import numpy as np
    sys.path.insert(0, %r)
    import jax, jax.numpy as jnp
    import dataclasses
    from repro.compat import make_mesh
    from repro.config import reduced
    from repro.configs import get_config
    from repro.models.moe import moe_layer
    from repro.sharding.rules import Dist, Rules
    cfg = dataclasses.replace(reduced(get_config("granite_moe_1b")),
                              dtype="float32")
    w = {k: jnp.asarray(v) for k, v in np.load(sys.argv[1]).items()
         if k != "x"}
    x = jnp.asarray(np.load(sys.argv[1])["x"])
    out = {}
    for name, shape in (("1x2", (1, 2)), ("2x1", (2, 1))):
        mesh = make_mesh(shape, ("data", "model"))
        d = Dist.for_mesh(mesh, Rules(mesh_axes=("data", "model")))
        with mesh:
            y, aux = jax.jit(lambda w, x: moe_layer(
                w, x, cfg, d.rules, mesh=mesh, data_axes=d.data_axes,
                model_axis=d.model_axis))(w, x)
        out[name] = {"y": np.asarray(y).tolist(), "aux": float(aux)}
    print(json.dumps(out))
""")


def test_sharded_moe_matches_the_reference_sharded_moe(ranks, tmp_path):
    """Both meshes against the reference's ``shard_map`` branch on a
    2-device host mesh (its default rules: the experts' mlp dim over
    ``model``), and against ``_moe_local`` run on each data shard."""
    cfg = W.cfg_of("granite_moe_1b")
    w, x = W.moe_inputs(cfg)
    np.savez(tmp_path / "moe.npz", x=x, **w)
    r = subprocess.run([sys.executable, "-c", REF_MOE % SRC,
                        str(tmp_path / "moe.npz")], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    for mesh, n_data in (("1x2", 1), ("2x1", 2)):
        got = _result(ranks, f"moe_{mesh}")
        ref_y = np.asarray(want[mesh]["y"], np.float32)
        err = np.max(np.abs(ref_y - got["y"])) / np.max(np.abs(ref_y))
        assert err <= FWD_RTOL_DEFAULT, (mesh, err)
        assert abs(want[mesh]["aux"] - got["aux"]) <= 1e-5 * want[mesh]["aux"]
        tw = {k: torch.from_numpy(v) for k, v in w.items()}
        y, aux = _per_shard_moe(n_data)(tw, torch.from_numpy(x), cfg, None)
        assert np.max(np.abs(y.numpy() - got["y"])) <= 1e-5 * np.max(
            np.abs(y.numpy())), mesh
        assert abs(float(aux) - got["aux"]) <= 1e-5 * float(aux)
    # the meshes route differently: per-shard capacity drops other tokens
    assert not np.allclose(_result(ranks, "moe_1x2")["y"],
                           _result(ranks, "moe_2x1")["y"])


@pytest.mark.parametrize("mesh", sorted(W.MESHES))
def test_sharded_serve_engine_matches_one_device(ranks, mesh):
    got = _result(ranks, f"serve_{mesh}")
    cfg = W.cfg_of(W.SERVE_ARCH)
    model = build_model(cfg)
    model.load(W.torch_weights(model.param_specs(), 0))
    eng = ServeEngine(model, W.train_run(cfg), Dist(), None,
                      n_slots=W.SERVE_SLOTS, max_len=W.SERVE_LEN)
    for i, p in enumerate(W.serve_prompts(cfg)):
        eng.submit(Request(prompt=p, max_new_tokens=W.SERVE_NEW, rid=i))
    want = {r.rid: list(r.out_tokens) for r in eng.run_until_done()}
    assert got == want
    assert len(want) == len(W.SERVE_PROMPTS)


def test_checkpoint_moves_between_meshes_and_one_device(ranks):
    got = _result(ranks, "checkpoint")
    saved = got["saved"]
    assert got["step"] == 2 and got["extra"] == {"data": {"step": 2}}
    assert set(got["on_1x2"]) == set(got["on_one"]) == set(saved)
    for path, a in saved.items():
        assert np.array_equal(got["on_1x2"][path], a), path
        assert np.array_equal(got["on_one"][path], a), path
    # the (1, 2) restore really is placed by the (1, 2) rules
    assert any("Shard" in p for p in got["on_1x2_placements"])


def test_reference_checkpoint_restores_onto_a_port_mesh(ranks):
    got = _result(ranks, "checkpoint")["ref_on_2x1"]
    want = dict(leaves_with_paths({"params": ranks[1]}))
    assert set(got) == set(want)
    for path, a in want.items():
        assert np.array_equal(got[path], a), path


def test_launcher_trains_on_two_ranks(tmp_path):
    """``launch.train`` under a torchrun-style environment: two gloo ranks
    on the CPU, each making its own rows; rank 0 alone writes the
    checkpoint and prints the loss."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port), "PYTHONPATH": SRC,
           "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen1p5_0p5b", "--reduced", "--steps", "2", "--device", "cpu",
           "--checkpoint-dir", str(tmp_path)]
    procs = [subprocess.Popen(cmd, env={**env, "RANK": str(r),
                                        "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    assert "final loss" in outs[0][0] and "final loss" not in outs[1][0]
    assert sorted(os.listdir(tmp_path)) == ["step_00000002"]
    meta = json.loads((tmp_path / "step_00000002" / "meta.json").read_text())
    assert meta["extra"]["data"]["step"] == 2
