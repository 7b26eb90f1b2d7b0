"""The port's optimizers and schedules against the reference package.

The same numpy-made params, grads, state and step go through each
package's ``update`` (the reference's jitted, as its train step runs it):
f32 results within 1e-6 of the leaf's largest entry (XLA may fuse a
multiply-add where PyTorch rounds twice; measured ≤ 2.5e-7), adamw8bit's
int8 codes equal but for ±1 where the scaled value sits at a rounding
tie (measured: none differ). Schedules: within 1e-7 of ``lr`` (an f32
ulp of ``cos``; measured 3.6e-8). Then the
reference's own invariants on the port alone.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.models.base import ParamSpec as JParamSpec  # noqa: E402
from repro.optim import build_optimizer as jbuild_optimizer  # noqa: E402
from repro.optim import make_schedule as jmake_schedule  # noqa: E402
from repro.optim.api import _dq8 as jdq8, _q8 as jq8  # noqa: E402
from repro.optim.api import clip_by_global_norm as jclip  # noqa: E402
from repro.optim.api import global_norm as jglobal_norm  # noqa: E402
from repro_torch.config import OptimizerConfig  # noqa: E402
from repro_torch.models.base import ParamSpec, leaves_with_paths  # noqa: E402
from repro_torch.optim import build_optimizer, make_schedule  # noqa: E402
from repro_torch.optim.api import (  # noqa: E402
    _dq8, _q8, clip_by_global_norm, global_norm)

#: max |port - reference| / max |reference| of an f32 leaf.
F32_RTOL = 1e-6
#: |port - reference| of a schedule value, over ``lr``.
SCHEDULE_RTOL = 1e-7

#: Leaves of every kind the optimizers tell apart: quantizable matrices
#: (last dim a multiple of 256) of rank 2 and 3, a matrix that is not, and
#: vectors (no weight decay, Adafactor unfactored).
SHAPES = {"w": ((4, 256), ("embed", "mlp")),
          "stack": ((2, 3, 512), ("layers", "embed", "mlp")),
          "odd": ((5, 7), ("embed", None)),
          "b": ((4,), (None,)),
          "nested": {"norm": ((6,), ("embed",))}}


def _specs(spec_cls, tree=SHAPES):
    return {k: (_specs(spec_cls, v) if isinstance(v, dict)
                else spec_cls(*v)) for k, v in tree.items()}


def _opt_cfg(cls, name, **kw):
    base = dict(name=name, lr=1e-2, warmup_steps=5, total_steps=40,
                weight_decay=0.1, grad_clip=1.0, schedule="cosine")
    base.update(kw)
    return cls(**base)


def _rel(want, got) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(want - got)) / (np.max(np.abs(want)) + 1e-30))


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def _numpy_tree(specs, rng, scale=1.0):
    return jax.tree.map(
        lambda s: (rng.normal(size=s.shape) * scale).astype(np.float32), specs,
        is_leaf=lambda x: isinstance(x, JParamSpec))


def _state(jopt, jspecs, rng):
    """A non-trivial optimizer state as numpy: the reference's state after
    two updates from zeros on random grads."""
    params = _to_jax(_numpy_tree(jspecs, rng))
    state = jopt.init(params, jspecs)
    for step in range(2):
        grads = _to_jax(_numpy_tree(jspecs, rng, 0.1))
        params, state, _ = jopt.update(grads, state, params,
                                       jnp.asarray(step), jspecs)
    return jax.tree.map(np.asarray, state)


def _leaves(tree) -> dict:
    return {p: np.asarray(t) for p, t in leaves_with_paths(tree)}


def _check_update(name: str, step: int, device: str) -> None:
    """One update in each package on the same numpy inputs, the port's on
    ``device``: its results against the reference's."""
    jspecs, specs = _specs(JParamSpec), _specs(ParamSpec)
    jopt = jbuild_optimizer(_opt_cfg(JOptimizerConfig, name))
    opt = build_optimizer(_opt_cfg(OptimizerConfig, name))
    rng = np.random.default_rng(step)
    state = _state(jopt, jspecs, rng)
    params = _numpy_tree(jspecs, rng)
    grads = _numpy_tree(jspecs, rng, 0.3)     # global norm > 1: clipped

    update = jax.jit(lambda g, s, p, t: jopt.update(g, s, p, t, jspecs))
    jp, js, jstats = update(_to_jax(grads), _to_jax(state), _to_jax(params),
                            jnp.asarray(step, jnp.int32))
    p, s = _to_torch(params, device), _to_torch(state, device)
    p2, s2, stats = opt.update(_to_torch(grads, device), s, p, step, specs)
    assert p2 is p and s2 is s                    # updated in place
    p2, s2 = _to_cpu(p2), _to_cpu(s2)
    assert float(stats["grad_norm"]) > 1.0
    for key in ("grad_norm", "lr"):
        assert _rel(jstats[key], stats[key].cpu()) < F32_RTOL, key

    want = _leaves(jax.tree.map(np.asarray, {"params": jp, "state": js}))
    got = _leaves({"params": p2, "state": s2})
    assert set(want) == set(got)
    ties = 0
    for path, a in want.items():
        b = got[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if a.dtype == np.int8:
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert diff.max() <= 1, path
            ties += int(np.count_nonzero(diff))
        else:
            assert _rel(a, b) < F32_RTOL, (path, _rel(a, b))
    # an int8 code differs only where the moment sits at a rounding tie
    assert ties <= 2, ties


@pytest.mark.parametrize("step", [0, 3, 17])
@pytest.mark.parametrize("name", ["adamw", "adamw8bit", "adafactor"])
def test_update_matches_reference(name, step):
    _check_update(name, step, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["adamw", "adamw8bit", "adafactor"])
def test_update_on_the_card_matches_reference(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _check_update(name, 17, "cuda")


@pytest.mark.parametrize("name", ["adamw", "adamw8bit", "adafactor"])
def test_state_specs_and_init_match_reference(name):
    jspecs, specs = _specs(JParamSpec), _specs(ParamSpec)
    jopt = jbuild_optimizer(_opt_cfg(JOptimizerConfig, name))
    opt = build_optimizer(_opt_cfg(OptimizerConfig, name))
    want = dict(leaves_with_paths(jopt.state_specs(jspecs)))
    got = dict(leaves_with_paths(opt.state_specs(specs)))
    assert set(want) == set(got)
    for path, w in want.items():
        g = got[path]
        assert (g.shape, g.logical, g.dtype, g.init) == (
            w.shape, w.logical, w.dtype, w.init), path
    params = _to_torch(_numpy_tree(jspecs, np.random.default_rng(0)))
    state = opt.init(params, specs)
    for path, t in leaves_with_paths(state):
        assert not t.any() and str(t.dtype) == f"torch.{want[path].dtype}"


def test_q8_and_norms_match_reference():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(8, 512)) * 0.01).astype(np.float32)
    jcodes, jscales = jq8(jnp.asarray(x))
    codes, scales = _q8(torch.from_numpy(x))
    assert codes.dtype == torch.int8
    assert np.array_equal(np.asarray(jcodes), codes.numpy())
    assert np.array_equal(np.asarray(jscales), scales.numpy())
    assert np.array_equal(np.asarray(jdq8(jcodes, jscales)),
                          _dq8(codes, scales).numpy())
    back = _dq8(codes, scales)
    assert float((back - torch.from_numpy(x)).abs().max()
                 / np.abs(x).max()) < 0.02

    tree = {"a": rng.normal(size=(10,)).astype(np.float32) * 10,
            "b": {"c": rng.normal(size=(3, 4)).astype(np.float32)}}
    assert _rel(jglobal_norm(_to_jax(tree)), global_norm(_to_torch(tree))) \
        < F32_RTOL
    jclipped, jnorm = jclip(_to_jax(tree), 1.0)
    clipped, norm = clip_by_global_norm(_to_torch(tree), 1.0)
    assert _rel(jnorm, norm) < F32_RTOL
    for path, a in _leaves(jclipped).items():
        assert _rel(a, _leaves(clipped)[path]) < F32_RTOL
    assert abs(float(global_norm(clipped)) - 1.0) < 1e-5


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_matches_reference(schedule):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, schedule=schedule)
    jsched = jmake_schedule(JOptimizerConfig(**kw))
    sched = make_schedule(OptimizerConfig(**kw))
    steps = np.arange(0, 130, dtype=np.int32)
    want = np.asarray(jax.vmap(jsched)(jnp.asarray(steps)))
    got = sched(torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    assert np.max(np.abs(want - got)) <= SCHEDULE_RTOL * kw["lr"]
    assert float(sched(0)) == 0.0 and float(sched(5)) == pytest.approx(1.5e-4)


# --------------------------------------------------------------------------
# The reference's invariants (tests/test_optim.py), on the port alone
# --------------------------------------------------------------------------

QUAD = {"w": ParamSpec((4, 256), ("embed", "mlp")), "b": ParamSpec((4,), (None,))}


@pytest.mark.parametrize("name", ["adamw", "adamw8bit", "adafactor"])
def test_optimizers_converge_on_quadratic(name):
    steps = 200
    opt = build_optimizer(OptimizerConfig(
        name=name, lr=0.05, warmup_steps=5, total_steps=steps,
        schedule="constant", weight_decay=0.0))
    gen = torch.Generator().manual_seed(0)
    params = {k: torch.randn(s.shape, generator=gen) * 0.02
              for k, s in QUAD.items()}
    state = opt.init(params, QUAD)

    def loss_fn(p):
        return sum(torch.sum(torch.square(p[k] - 0.5)) for k in sorted(p))

    for step in range(steps):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        grads = dict(zip(leaves, torch.autograd.grad(loss_fn(leaves),
                                                     list(leaves.values()))))
        params, state, _ = opt.update(grads, state, params, step, QUAD)
    final = float(loss_fn(params))
    # as the reference: adafactor bounces near the optimum (initial ~237)
    assert final < (2.0 if name == "adafactor" else 1e-2), (name, final)


def test_weight_decay_only_on_matrices():
    opt = build_optimizer(OptimizerConfig(
        name="adamw", lr=1e-2, weight_decay=0.5, schedule="constant",
        warmup_steps=0))
    gen = torch.Generator().manual_seed(1)
    params = {k: torch.randn(s.shape, generator=gen) for k, s in QUAD.items()}
    before = {k: v.clone() for k, v in params.items()}
    state = opt.init(params, QUAD)
    zero = {k: torch.zeros_like(v) for k, v in params.items()}
    p2, _, _ = opt.update(zero, state, params, 1, QUAD)
    assert float(p2["w"].abs().max()) < float(before["w"].abs().max())
    assert torch.equal(p2["b"], before["b"])
