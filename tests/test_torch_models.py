"""The port's LM models against the reference package, end to end.

Every architecture of ``LM_ARCHS`` at the reference tests' reduced sizes
with ``dtype="float32"``: the same weights (made from a numpy seed on the
reference's spec tree, carried over by ``params_from_numpy``) and the same
seed-made inputs go through both packages: train-mode logits, the prefill
cache and decode logits. Then the reference's own invariants on the port
alone: decode against forward in bf16, and the declared parameter counts
against ``ModelConfig.param_count``.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.config import reduced as jreduced  # noqa: E402
from repro.configs import ARCH_IDS, get_config as jget_config  # noqa: E402
from repro.models.base import ParamSpec as JParamSpec  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro.sharding.rules import Dist as JDist  # noqa: E402
from repro_torch.config import reduced  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.base import (  # noqa: E402
    leaves_with_paths, params_from_numpy)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.sharding.rules import Dist  # noqa: E402

LM_ARCHS = [a for a in ARCH_IDS if a != "paper_sfa"]

#: f32 parity: max |port - reference| / max |reference|. Both packages
#: compute in f32 with the same operand roundings (mamba2's bf16 operands
#: included); only summation orders differ (XLA's einsums and associative
#: scans against PyTorch's matmuls and Hillis–Steele scans), measured at
#: 1e-7 – 5e-6.
PARITY_RTOL = 1e-4


def _reduced_cfg(arch: str, get=get_config, red=reduced, **kw):
    """The reference tests' reduced configs (``tests/test_models.py``)."""
    cfg = get(arch)
    if arch == "mamba2_370m":
        cfg = red(cfg, ssm_heads=4, ssm_head_dim=32, d_model=64, ssm_state=16)
    elif arch == "recurrentgemma_9b":
        cfg = red(cfg, n_layers=5, rglru_width=64, head_dim=16)
    else:
        cfg = red(cfg)
    return dataclasses.replace(cfg, **kw)


def numpy_params(specs, seed: int):
    """Weights for the reference's spec tree from a numpy seed: its
    distributions, and small noise on what it starts at zero or one, so
    biases and norm scales are exercised too."""
    rng = np.random.default_rng(seed)

    def one(s: JParamSpec):
        if s.init == "uniform_scaled":
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            b = np.sqrt(1.0 / max(fan_in, 1))
            a = rng.uniform(-b, b, s.shape)
        elif s.init == "ones":
            a = 1.0 + 0.1 * rng.normal(size=s.shape)
        else:
            a = rng.normal(size=s.shape) * (s.scale if s.init == "normal"
                                            else 0.02)
        return np.asarray(a, np.float32).astype(jnp.dtype(s.dtype))

    return jax.tree.map(one, specs, is_leaf=lambda x: isinstance(x, JParamSpec))


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    extra = {}
    if cfg.is_encoder_decoder:
        extra["frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model))
    if cfg.num_prefix_embeds:
        extra["prefix_embeds"] = rng.normal(
            size=(B, cfg.num_prefix_embeds, cfg.d_model))
    extra = {k: v.astype(np.float32) for k, v in extra.items()}
    return toks, extra


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.max(np.abs(want - got)) / (np.max(np.abs(want)) + 1e-6))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _both(arch: str) -> dict:
    """Forward, prefill and decode of one architecture in both packages."""
    jcfg = _reduced_cfg(arch, jget_config, jreduced, dtype="float32")
    cfg = _reduced_cfg(arch, dtype="float32")
    jm, m = jbuild_model(jcfg), build_model(cfg)
    jparams = numpy_params(jm.param_specs(), seed=1)
    m.load(params_from_numpy(jparams, m.param_specs(), "cpu"))
    jp = jax.tree.map(jnp.asarray, jparams)

    B, S = 2, (16 if cfg.family == "ssm" else 12)
    toks, extra = _inputs(cfg, B, S + 1, seed=3)
    jkw = {k: jnp.asarray(v) for k, v in extra.items()}
    kw = {k: torch.from_numpy(v) for k, v in extra.items()}

    full = jax.jit(lambda p, t: jm.forward(p, t, JDist(), mode="train",
                                           **jkw)[0])(jp, jnp.asarray(toks))
    prefill = jax.jit(lambda p, t, c: jm.forward(
        p, t, JDist(), mode="prefill", cache=c, **jkw)[1])
    jcache = prefill(jp, jnp.asarray(toks[:, :S]), jm.init_cache(B, S + 8))
    decode = jax.jit(lambda p, t, c, pos: jm.forward(
        p, t, JDist(), mode="decode", cache=c, cache_pos=pos)[0])
    jdec = decode(jp, jnp.asarray(toks[:, S:S + 1]), jcache,
                  jnp.asarray(S, jnp.int32))

    with torch.inference_mode():
        got_full = m(None, torch.from_numpy(toks), Dist(), mode="train", **kw)[0]
        cache = m.init_cache(B, S + 8, device="cpu")
        m(None, torch.from_numpy(toks[:, :S]), Dist(), mode="prefill",
          cache=cache, **kw)
        prefill_cache = {p: t.clone() for p, t in leaves_with_paths(cache)}
        step = torch.from_numpy(toks[:, S:S + 1])
        got_dec = m(None, step, Dist(), mode="decode", cache=cache,
                    cache_pos=torch.tensor(S))[0]
        # the same step from per-slot positions, on the prefill cache again
        for p, t in leaves_with_paths(cache):
            t.copy_(prefill_cache[p])
        got_dec_slots = m(None, step, Dist(), mode="decode", cache=cache,
                          cache_pos=torch.full((B,), S, dtype=torch.int32))[0]
    return dict(
        cfg=cfg, model=m, jparams=jparams,
        want_full=np.asarray(full), got_full=got_full.numpy(),
        want_cache=dict(leaves_with_paths(_np_tree(jcache))),
        want_cache_dtypes={p: str(a.dtype) for p, a in
                           leaves_with_paths(jcache)},
        got_cache=prefill_cache,
        want_dec=np.asarray(jdec), got_dec=got_dec.numpy(),
        got_dec_slots=got_dec_slots.numpy(),
    )


@pytest.fixture(scope="module")
def runs():
    """Each architecture's runs, computed once (the reference's compiles
    dominate this file)."""
    memo = {}

    def get(arch):
        if arch not in memo:
            memo[arch] = _both(arch)
        return memo[arch]

    return get


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_matches_reference(runs, arch):
    r = runs(arch)
    assert r["got_full"].shape == r["want_full"].shape
    assert r["got_full"].dtype == np.float32          # logits are f32
    err = _rel(r["want_full"], r["got_full"])
    assert err < PARITY_RTOL, f"{arch}: train logits differ ({err:.3e})"
    # state_dict keys are the reference's tree paths joined by "."
    want_keys = {".".join(p) for p, _ in leaves_with_paths(r["jparams"])}
    assert set(r["model"].state_dict()) == want_keys


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_cache_matches_reference(runs, arch):
    r = runs(arch)
    want, got = r["want_cache"], r["got_cache"]
    assert set(got) == set(want)
    for path, a in want.items():
        t = got[path]
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype).removeprefix("torch.") == \
            r["want_cache_dtypes"][path], path
        err = _rel(a, t.float().numpy())
        assert err < PARITY_RTOL, f"{arch} {'.'.join(path)}: {err:.3e}"


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_matches_reference(runs, arch):
    r = runs(arch)
    err = _rel(r["want_dec"], r["got_dec"])
    assert err < PARITY_RTOL, f"{arch}: decode logits differ ({err:.3e})"
    # a (B,) cache_pos decodes as the scalar does
    err = _rel(r["want_dec"], r["got_dec_slots"])
    assert err < PARITY_RTOL, f"{arch}: per-slot decode differs ({err:.3e})"


# --------------------------------------------------------------------------
# The reference's invariants, on the port alone
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_arch_decode_matches_forward(arch):
    """``tests/test_models.py``'s check, in bf16 with the reference's
    bounds: a prefill + one decode step against the full forward."""
    cfg = _reduced_cfg(arch)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(1)
    model.init(gen, device="cpu")
    B, S = 2, (16 if cfg.family == "ssm" else 12)
    toks, extra = _inputs(cfg, B, S + 4, seed=3)
    toks = torch.from_numpy(toks)
    kw = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in extra.items()}
    with torch.inference_mode():
        full, _, _ = model(None, toks[:, :S + 1], Dist(), mode="train", **kw)
        cache = model.init_cache(B, S + 8, device="cpu")
        _, cache2, _ = model(None, toks[:, :S], Dist(), mode="prefill",
                             cache=cache, **kw)
        dec, _, _ = model(None, toks[:, S:S + 1], Dist(), mode="decode",
                          cache=cache2, cache_pos=torch.tensor(S))
    assert torch.isfinite(full).all()
    a, b = full[:, S].numpy(), dec[:, 0].numpy()
    err = np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-6)
    tol = 1e-1 if cfg.family == "hybrid" else 3e-2
    assert err < tol, f"{arch}: decode diverges from forward ({err:.3e})"


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_counts_match_configs(arch):
    """Declared parameter trees roughly agree with the analytic count, at
    full size (counted from the specs; the parameters stay on ``meta``)."""
    model = build_model(get_config(arch))
    declared, analytic = model.n_params(), get_config(arch).param_count()
    assert 0.85 < declared / analytic < 1.15, (arch, declared, analytic)
    assert declared == jbuild_model(jget_config(arch)).n_params()
    assert all(p.device.type == "meta" for p in model.parameters())
