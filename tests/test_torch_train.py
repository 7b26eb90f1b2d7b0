"""The port's training path against the reference package.

One train step of every LM architecture at the reference tests' reduced
sizes in f32, with ``micro_batches`` 1 and 2: the same numpy weights
(``test_torch_models.numpy_params``) and batch through both packages'
``make_train_step`` (the reference's jitted). Each optimizer is wrapped so
its ``update`` also returns the gradients it was given, which both
packages' steps hand back in their metrics: so the gradients are compared
before Adam, where a sign flip of a near-zero gradient would hide.

Bounds (summation orders differ between XLA and PyTorch):
  * loss within 1e-5 relative; grad norm within 1e-5, or 1e-3 where
    gradients pass a bf16 rounding;
  * each gradient leaf within 1e-4 of the reference leaf's largest entry
    (Adam's moments twice that), or 1e-2 where gradients pass a bf16
    rounding: grok's bf16 parameters, mamba2's bf16 operands (kept in f32
    as in the reference), bf16 compute copies (``gather_params_once``). An
    f32 sum that lands near a bf16 rounding boundary rounds the other way
    in the other package: 2^-8 relative at most, a few such steps deep;
  * each updated parameter within 1e-5 of the leaf's largest entry (a
    bf16 leaf: 8e-3, an ulp at the largest), or within 2·lr where its
    gradient is within 1e-3 of the leaf's largest (1e-2 where gradients pass
    a bf16 rounding): Adam's first step moves such an entry by up to lr
    whatever its sign.

Then ``remat`` ("none", "full", "dots") and the attention's per-chunk
checkpoint leave gradients unchanged, and the trainer and launcher run on
the CPU.
"""

import dataclasses
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_models import LM_ARCHS, _reduced_cfg, numpy_params  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.train.steps as jsteps  # noqa: E402
import repro_torch.train.steps as steps  # noqa: E402
from repro.config import HOST_MESH as JHOST_MESH  # noqa: E402
from repro.config import SHAPES as JSHAPES  # noqa: E402
from repro.config import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.config import RunConfig as JRunConfig  # noqa: E402
from repro.config import reduced as jreduced  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.attention import blockwise_attention as jattention  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro.sharding.rules import Dist as JDist  # noqa: E402
from repro_torch.config import (  # noqa: E402
    HOST_MESH, SHAPES, ModelConfig, OptimizerConfig, RunConfig, ShapeConfig)
from repro_torch.data import DataConfig, make_pipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.attention import blockwise_attention  # noqa: E402
from repro_torch.models.base import (  # noqa: E402
    leaves_with_paths, params_from_numpy, tree_map)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.sharding.rules import Dist  # noqa: E402
from repro_torch.train.trainer import StragglerMonitor, Trainer  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_RTOL_BF16 = 1e-4, 1e-2
NORM_RTOL, NORM_RTOL_BF16 = 1e-5, 1e-3
PARAM_RTOL, PARAM_RTOL_BF16 = 1e-5, 8e-3
LR = 1e-3


def _capturing(build):
    """``build`` whose optimizers' ``update`` also return their gradients
    in the stats (so in the train step's metrics)."""
    def wrapped(cfg):
        opt = build(cfg)

        def update(grads, state, params, step, specs):
            p, s, stats = opt.update(grads, state, params, step, specs)
            return p, s, {**stats, "grads": grads}

        return dataclasses.replace(opt, update=update)

    return wrapped


def _batch(cfg, B=4, S=16, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model))
    if cfg.num_prefix_embeds:
        batch["prefix_embeds"] = rng.normal(
            size=(B, cfg.num_prefix_embeds, cfg.d_model))
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v
            for k, v in batch.items()}


def _leaves(tree) -> dict:
    return {p: (t.float().numpy() if isinstance(t, torch.Tensor)
                else np.asarray(t, np.float32))
            for p, t in leaves_with_paths(tree)}


def _max_rel(want, got) -> float:
    return float(np.max(np.abs(want - got)) / (np.max(np.abs(want)) + 1e-30))


def _opt_cfg(cls):
    return cls(lr=LR, warmup_steps=1)


def _steps(arch: str, micro: int, monkeypatch, device="cpu", **flags) -> tuple:
    """One step (step 1: past warmup) in each package on the same weights
    and batch, the port's on ``device`` -> (reference (params, state,
    metrics), port's, on the CPU)."""
    monkeypatch.setattr(jsteps, "build_optimizer",
                        _capturing(jsteps.build_optimizer))
    monkeypatch.setattr(steps, "build_optimizer",
                        _capturing(steps.build_optimizer))
    jcfg = _reduced_cfg(arch, jget_config, jreduced, dtype="float32")
    cfg = _reduced_cfg(arch, dtype="float32")
    jm, m = jbuild_model(jcfg), build_model(cfg)
    jparams = numpy_params(jm.param_specs(), seed=1)
    batch = _batch(cfg)

    jrun = JRunConfig(model=jcfg, shape=JSHAPES["train_4k"], mesh=JHOST_MESH,
                      optimizer=_opt_cfg(JOptimizerConfig),
                      micro_batches=micro, **flags)
    jstep, jopt = jsteps.make_train_step(jm, jrun, JDist())
    jp = jax.tree.map(jnp.asarray, jparams)
    jout = jax.block_until_ready(jax.jit(jstep)(
        jp, jopt.init(jp, jm.param_specs()), jnp.asarray(1, jnp.int32),
        {k: jnp.asarray(v) for k, v in batch.items()}))

    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], mesh=HOST_MESH,
                    optimizer=_opt_cfg(OptimizerConfig), micro_batches=micro,
                    **flags)
    step, opt = steps.make_train_step(m, run, Dist())
    # a copy: the port updates in place, and jax may alias numpy's buffers
    params = params_from_numpy(jax.tree.map(np.copy, jparams),
                               m.param_specs(), device)
    out = step(params, opt.init(params, m.param_specs()), 1,
               {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
    return jax.tree.map(np.asarray, jout), tuple(
        tree_map(lambda t: t.cpu(), part) for part in out)


def _check_step(jout, out, arch: str, bf16_grads: bool) -> None:
    """``bf16_grads``: the gradients pass a bf16 rounding."""
    (jp, js, jmet), (p, s, met) = jout, out
    grad_rtol = GRAD_RTOL_BF16 if bf16_grads else GRAD_RTOL
    tols = dict(loss=LOSS_RTOL, aux_loss=LOSS_RTOL, lr=LOSS_RTOL,
                grad_norm=NORM_RTOL_BF16 if bf16_grads else NORM_RTOL)
    for key, rtol in tols.items():
        a, b = float(jmet[key]), float(met[key])
        assert abs(a - b) <= rtol * abs(a) + 1e-7, (arch, key, a, b)
    assert np.isfinite(float(met["loss"])) and float(met["lr"]) > 0
    jgrads, grads = _leaves(jmet["grads"]), _leaves(met["grads"])
    assert set(jgrads) == set(grads) == set(_leaves(jp))
    for path, g in jgrads.items():
        assert grads[path].shape == g.shape, path
        err = _max_rel(g, grads[path])
        assert err < grad_rtol, (arch, ".".join(path), err)
    jstate, state = _leaves(js), _leaves(s)
    for path, a in jstate.items():
        assert _max_rel(a, state[path]) < 2 * grad_rtol, (arch, path)
    jparams, params = _leaves(jp), _leaves(p)
    dtypes = {path: str(a.dtype) for path, a in leaves_with_paths(jp)}
    lr = float(jmet["lr"])
    for path, a in jparams.items():
        g = np.abs(jgrads[path])
        rtol = PARAM_RTOL_BF16 if dtypes[path] == "bfloat16" else PARAM_RTOL
        tol = rtol * np.max(np.abs(a)) + np.where(
            g <= max(1e-3, grad_rtol) * np.max(g), 2 * lr, 0.0)
        assert np.all(np.abs(a - params[path]) <= tol), (arch, path)


#: Architectures whose gradients pass a bf16 rounding in f32 compute:
#: grok's parameters are bf16, mamba2 rounds its quadratic form's operands.
BF16_GRADS = {"grok1_314b", "mamba2_370m"}


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_step_matches_reference(arch, micro, monkeypatch):
    jout, out = _steps(arch, micro, monkeypatch)
    _check_step(jout, out, arch, bf16_grads=arch in BF16_GRADS)
    # the port's step updated its tree in place and moved it
    assert out[0] is not None and any(
        not np.array_equal(a, b) for a, b in zip(
            _leaves(jout[0]).values(), _leaves(out[0]).values()))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_step_on_the_card_matches_reference(arch, monkeypatch):
    """The same step with the port on the card (f32 products, TF32 off):
    the same bounds against the reference on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py's lm_train phase "
                    "holds the card's step to the CPU's")
    assert not torch.backends.cuda.matmul.allow_tf32
    jout, out = _steps(arch, 2, monkeypatch, device="cuda")
    _check_step(jout, out, arch, bf16_grads=arch in BF16_GRADS)


def test_gather_params_once_matches_reference(monkeypatch):
    """bf16 compute copies of the f32 matrices, made once a step: bf16
    gradients on them, accumulated in f32, returned as f32."""
    jout, out = _steps("qwen1p5_0p5b", 2, monkeypatch, gather_params_once=True)
    for g in leaves_with_paths(out[2]["grads"]):
        assert g[1].dtype == torch.float32
    _check_step(jout, out, "qwen1p5_0p5b, gather once", bf16_grads=True)


# --------------------------------------------------------------------------
# remat and the attention's checkpoint: gradients unchanged
# --------------------------------------------------------------------------


def _port_grads(cfg, batch) -> dict:
    """The port's gradients of the train loss, from seeded weights."""
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    paths, leaves = zip(*leaves_with_paths(params))
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    kw = {k: torch.from_numpy(v) for k, v in batch.items()
          if k in ("frames", "prefix_embeds")}
    logits, _, aux = m(steps._unflatten(paths, leaves),
                       torch.from_numpy(batch["tokens"]), Dist(),
                       mode="train", **kw)
    loss = steps.cross_entropy(logits, torch.from_numpy(batch["labels"])) \
        + steps.AUX_WEIGHT * aux
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return {p: (torch.zeros_like(t) if g is None else g)
            for p, t, g in zip(paths, leaves, grads)}


@pytest.mark.parametrize("arch", ["qwen1p5_0p5b", "granite_moe_1b",
                                  "mamba2_370m", "recurrentgemma_9b",
                                  "whisper_base", "phi3_vision_4p2b"])
def test_remat_leaves_gradients_unchanged(arch):
    batch = _batch(_reduced_cfg(arch), B=2)
    want = _port_grads(_reduced_cfg(arch, dtype="float32", remat="none"),
                       batch)
    for remat in ("full", "dots"):
        got = _port_grads(_reduced_cfg(arch, dtype="float32", remat=remat),
                          batch)
        for path, g in want.items():
            assert torch.equal(got[path], g), (arch, remat, path)


def test_attention_chunk_checkpoint_matches_reference():
    """Several q and kv chunks, causal and windowed: the port's gradients
    through its per-q-chunk checkpoint against ``jax.grad`` of the
    reference's."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((2, 16, 4, 8), (2, 16, 2, 8), (2, 16, 2, 8)))
    w = rng.normal(size=(2, 16, 4, 8)).astype(np.float32)
    for kw in (dict(causal=True), dict(causal=True, window=6),
               dict(causal=False, softcap=5.0)):
        def jloss(q, k, v):
            return jnp.sum(jattention(q, k, v, q_chunk=4, kv_chunk=4, **kw) * w)

        want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
        tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                      for a in (q, k, v))
        out = blockwise_attention(tq, tk, tv, q_chunk=4, kv_chunk=4, **kw)
        got = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)),
                                  (tq, tk, tv))
        for a, b in zip(want, got):
            assert _max_rel(np.asarray(a), b.numpy()) < GRAD_RTOL, kw


# --------------------------------------------------------------------------
# the trainer and the launcher (the reference's tests/test_trainer_serve.py)
# --------------------------------------------------------------------------

TINY = ModelConfig(
    name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=128, head_dim=16, remat="none", tie_embeddings=True,
)


def _mk_trainer(ckpt_dir, checkpoint_every=10):
    shape = ShapeConfig("tiny_train", 32, 8, "train")
    run = RunConfig(
        model=TINY, shape=shape, mesh=HOST_MESH,
        optimizer=OptimizerConfig(lr=3e-3, warmup_steps=5, total_steps=200,
                                  schedule="constant"),
        micro_batches=2, checkpoint_dir=str(ckpt_dir),
        checkpoint_every=checkpoint_every, async_checkpoint=False,
    )
    data = make_pipeline(
        DataConfig(vocab_size=TINY.vocab_size, seq_len=32, global_batch=8,
                   seed=1, device="cpu"), prefetch=False)
    return Trainer(model=build_model(TINY), run=run, dist=Dist(), data=data,
                   log_every=5, device="cpu")


def test_training_reduces_loss(tmp_path):
    out = _mk_trainer(tmp_path).fit(30)
    losses = [m["loss"] for m in out["log"]]
    assert losses[-1] < losses[0], losses
    assert np.isfinite(losses[-1])
    assert out["steps"] == 30


def test_resume_equals_the_uninterrupted_run(tmp_path):
    straight = _mk_trainer(tmp_path / "a", checkpoint_every=3)
    straight.fit(6)
    first = _mk_trainer(tmp_path / "b", checkpoint_every=3)
    first.fit(3)
    resumed = _mk_trainer(tmp_path / "b", checkpoint_every=3)
    assert resumed.try_resume()
    assert resumed.step == 3 and resumed.data.step == first.data.step
    out = resumed.fit(6)
    assert out["steps"] == 6
    for name in ("params", "opt_state"):
        want = dict(leaves_with_paths(getattr(straight, name)))
        got = dict(leaves_with_paths(getattr(resumed, name)))
        assert set(want) == set(got)
        for path, t in want.items():
            assert torch.equal(t, got[path]), (name, path)


def test_sigterm_saves_and_exits_143(tmp_path):
    tr = _mk_trainer(tmp_path)
    previous = signal.getsignal(signal.SIGTERM)
    try:
        tr.install_preemption_handler()
        signal.raise_signal(signal.SIGTERM)
        with pytest.raises(SystemExit) as exc:
            tr.fit(5)
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert exc.value.code == 143
    assert tr.ckpt.latest() == 1


def test_straggler_monitor():
    m = StragglerMonitor(factor=2.0)
    assert not m.observe(1.0)
    assert not m.observe(1.0)
    for _ in range(3):
        assert not m.observe(1.0)
    assert m.observe(10.0)          # 10x the EWMA
    assert m.slow_steps == 1


def test_launcher_trains_on_the_cpu_and_defaults_to_the_card(tmp_path,
                                                              monkeypatch):
    out = launch_train.main(["--arch", "qwen1p5_0p5b", "--steps", "2",
                             "--device", "cpu", "--reduced",
                             "--checkpoint-dir", str(tmp_path)])
    assert out["steps"] == 2 and np.isfinite(out["final_loss"])
    assert sorted(os.listdir(tmp_path)) == ["step_00000002"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            launch_train.main(["--arch", "qwen1p5_0p5b", "--reduced"])
    # Several ranks join a torchrun world (tests/test_torch_sharded.py runs
    # two): without its rendezvous address, the launcher says so.
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK")}
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen1p5_0p5b", "--reduced", "--steps", "1", "--device", "cpu"],
        env={**env, "WORLD_SIZE": "2", "RANK": "0",
             "PYTHONPATH": str(Path(__file__).resolve().parents[1] / "src")},
        capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "MASTER_ADDR" in r.stderr, r.stderr[-2000:]
