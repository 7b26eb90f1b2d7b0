"""The port's LM layers against the reference's, one function at a time.

The same seed-made inputs go through each reference function and its twin
in ``repro_torch.models``: blockwise and decode attention (causal, window,
softcap, query offset, ring cache, per-slot positions, clamped writes),
the MoE dispatch with forced drops and ties, the causal conv with carried
state, mamba2 off a chunk multiple, RG-LRU, rope with scaling, the norms,
MLPs and the loss; then the spec tree helpers, ``params_from_numpy`` and
the sharding rules.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.sharding.rules import DEFAULT_RULES as JRULES  # noqa: E402
from repro.sharding.rules import Rules as JRules  # noqa: E402
from repro_torch.config import ModelConfig  # noqa: E402
from repro_torch.models import attention, layers, moe, rglru, ssm  # noqa: E402
from repro_torch.models.base import (  # noqa: E402
    init_params, params_from_numpy, pspec_tree)
from repro_torch.models.model import build_model  # noqa: E402
from repro.sharding.rules import Dist as JDist  # noqa: E402
from repro_torch.sharding.rules import (  # noqa: E402
    DEFAULT_RULES, Dist, Rules, constrain)

#: f32 against f32: max |port - reference| / max |reference|; only
#: summation orders differ (measured below 1e-6).
RTOL = 1e-5


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    return float(np.max(np.abs(want - got)) / (np.max(np.abs(want)) + 1e-6))


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _cfgs(**kw):
    """The same small config in both packages."""
    base = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=2, d_ff=64, vocab_size=64, head_dim=8,
                dtype="float32")
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def _params(jspecs, seed):
    """Random f32 weights for a spec dict, both as jax and torch trees."""
    rng = np.random.default_rng(seed)
    arrays = {k: _normal(rng, *s.shape, scale=0.3) for k, s in jspecs.items()}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    dict(),                                            # causal, one block
    dict(q_chunk=4, kv_chunk=8),                       # several blocks
    dict(window=5, q_chunk=4, kv_chunk=4),             # sliding window
    dict(softcap=2.0, q_chunk=8, kv_chunk=4),
    dict(causal=False, q_chunk=6, kv_chunk=4),
    dict(q_offset=8, Sq=8, q_chunk=4, kv_chunk=4),     # queries after keys
])
def test_blockwise_attention_matches_reference(case):
    case = dict(case)
    Sq = case.pop("Sq", 16)
    rng = np.random.default_rng(len(case) + Sq)
    q, k, v = (_normal(rng, 2, S, H, 8) for S, H in
               ((Sq, 4), (16, 2), (16, 2)))
    want = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), **case)
    got = attention.blockwise_attention(torch.from_numpy(q),
                                        torch.from_numpy(k),
                                        torch.from_numpy(v), **case)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(want, got) < RTOL


def test_blockwise_attention_bf16_accumulates_in_f32():
    """bf16 operands, f32 scores and sums, a bf16 output: within one bf16
    rounding of the output (2^-8 relative) of the reference."""
    rng = np.random.default_rng(7)
    q, k, v = (np.array(jnp.asarray(_normal(rng, 2, 16, H, 8),
                                    jnp.bfloat16).astype(jnp.float32))
               for H in (4, 2, 2))
    want = jattn.blockwise_attention(*(jnp.asarray(a, jnp.bfloat16)
                                       for a in (q, k, v)),
                                     q_chunk=8, kv_chunk=4)
    got = attention.blockwise_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        q_chunk=8, kv_chunk=4)
    assert got.dtype == torch.bfloat16
    assert _rel(np.asarray(want, np.float32), got) < 2.0 ** -8


def test_snap_divisor_matches_reference():
    # whisper's 1500-frame encoder: the reference's docstring says 512
    # snaps to 375, but it computes the largest divisor <= 512, 500.
    assert attention._snap_divisor(1500, 512) == jattn._snap_divisor(1500, 512) == 500
    assert attention._snap_divisor(1500, 499) == 375
    for n in (1, 7, 12, 64, 100, 1500):
        for c in (1, 5, 8, 512):
            assert attention._snap_divisor(n, c) == jattn._snap_divisor(n, c)


@pytest.mark.parametrize("window,pos", [(0, 9), (0, (3, 11)), (6, 13),
                                        (6, (2, 17)), (0, 0)])
def test_decode_attention_matches_reference(window, pos):
    """A plain cache and a ring cache (window 6), at a scalar position and
    at per-slot positions."""
    rng = np.random.default_rng(window + 1)
    S = window or 12
    q = _normal(rng, 2, 1, 4, 8)
    ck, cv = _normal(rng, 2, S, 2, 8), _normal(rng, 2, S, 2, 8)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(ck),
                                  jnp.asarray(cv), jnp.asarray(pos, jnp.int32),
                                  window=window, softcap=3.0)
    got = attention.decode_attention(torch.from_numpy(q), torch.from_numpy(ck),
                                     torch.from_numpy(cv),
                                     torch.tensor(pos, dtype=torch.int32),
                                     window=window, softcap=3.0)
    assert _rel(want, got) < RTOL


@pytest.mark.parametrize("window,pos", [
    (0, 5), (0, 30),                  # a scalar past the cache is clamped
    (0, (4, 30)),                     # a row past the cache is dropped
    (8, 21), (8, (3, 21)),            # ring slots
])
def test_attention_layer_decode_writes_like_reference(window, pos):
    jcfg, cfg = _cfgs(qkv_bias=True, qk_norm=True)
    jp, tp = _params(jattn.attention_specs(jcfg), seed=3)
    rng = np.random.default_rng(5)
    S_cache = window or 16
    x = _normal(rng, 2, 1, 32)
    ck, cv = _normal(rng, 2, S_cache, 2, 8), _normal(rng, 2, S_cache, 2, 8)
    p = np.array(np.broadcast_to(np.asarray(pos, np.int32), (2,))[:, None])
    jout, jc = jattn.attention_layer(
        jp, jnp.asarray(x), jcfg, JRULES, mode="decode",
        positions=jnp.asarray(p), window=window,
        cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        cache_pos=jnp.asarray(pos, jnp.int32))
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    out, c = attention.attention_layer(
        tp, torch.from_numpy(x), cfg, DEFAULT_RULES, mode="decode",
        positions=torch.from_numpy(p), window=window, cache=cache,
        cache_pos=torch.tensor(pos, dtype=torch.int32))
    assert c is cache                                  # written in place
    assert _rel(jout, out) < RTOL
    for name in ("k", "v"):
        assert _rel(jc[name], c[name]) < RTOL


@pytest.mark.parametrize("S,window", [(12, 0), (12, 8), (6, 8)])
def test_attention_layer_prefill_fills_cache_like_reference(S, window):
    """Prefill writes keys 0 .. S-1; a ring cache shorter than the prompt
    keeps the last ``window`` keys at their ring slots."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jattn.attention_specs(jcfg), seed=4)
    x = _normal(np.random.default_rng(S), 2, S, 32)
    shape = jattn.init_cache_shape(jcfg, 2, 16, window)["k"]
    assert shape == attention.init_cache_shape(cfg, 2, 16, window)["k"]
    pos = np.array(np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)))
    zeros = np.zeros(shape, np.float32)
    jout, jc = jattn.attention_layer(
        jp, jnp.asarray(x), jcfg, JRULES, mode="prefill",
        positions=jnp.asarray(pos), window=window,
        cache={"k": jnp.asarray(zeros), "v": jnp.asarray(zeros)})
    out, c = attention.attention_layer(
        tp, torch.from_numpy(x), cfg, DEFAULT_RULES, mode="prefill",
        positions=torch.from_numpy(pos), window=window,
        cache={"k": torch.zeros(shape), "v": torch.zeros(shape)})
    assert _rel(jout, out) < RTOL
    for name in ("k", "v"):
        assert _rel(jc[name], c[name]) < RTOL


def test_cross_attention_and_encode_kv_match_reference():
    jcfg, cfg = _cfgs(qkv_bias=True)
    jp, tp = _params(jattn.attention_specs(jcfg, cross=True), seed=6)
    rng = np.random.default_rng(6)
    enc, x = _normal(rng, 2, 10, 32), _normal(rng, 2, 3, 32)
    jkv = jattn.encode_kv(jp, jnp.asarray(enc), jcfg)
    kv = attention.encode_kv(tp, torch.from_numpy(enc), cfg)
    for a, b in zip(jkv, kv):
        assert _rel(a, b) < RTOL
    want = jattn.cross_attention_layer(jp, jnp.asarray(x), jkv, jcfg, JRULES)
    got = attention.cross_attention_layer(tp, torch.from_numpy(x), kv, cfg,
                                          DEFAULT_RULES)
    assert _rel(want, got) < RTOL


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------


def _reference_dispatch(x, router, cfg):
    """The reference's routing and dispatch (``_moe_local``'s first lines),
    whose intermediate values it does not return."""
    T = x.shape[0]
    E, k, C = cfg.n_experts, cfg.experts_per_token, jmoe._capacity(T, cfg)
    logits = x.astype(jnp.float32) @ router.astype(jnp.float32)
    _, top_ids = jax.lax.top_k(logits, k)
    flat_ids = top_ids.reshape(T * k)
    order = jnp.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    counts = jnp.bincount(flat_ids, length=E)
    starts = jnp.cumsum(counts) - counts
    pos_in_expert = jnp.arange(T * k) - starts[sorted_ids]
    keep = pos_in_expert < C
    buf_idx = jnp.where(keep, sorted_ids * C + pos_in_expert, E * C)
    return top_ids, keep, buf_idx


@pytest.mark.parametrize("router_scale,capacity", [(1.0, 0.5), (0.0, 1.0),
                                                   (1.0, 1.25)])
def test_moe_local_matches_reference(router_scale, capacity):
    """Capacity 0.5 forces drops; a zero router ties every expert (top-k
    must pick the lowest ids, as ``lax.top_k`` does), and its experts'
    capacity overflows."""
    jcfg, cfg = _cfgs(n_experts=4, experts_per_token=2,
                      moe_capacity_factor=capacity)
    rng = np.random.default_rng(int(capacity * 100))
    T, d, f, E = 24, 32, 64, 4
    x = _normal(rng, T, d)
    router = _normal(rng, d, E, scale=router_scale)
    ws = [_normal(rng, *s, scale=0.2) for s in ((E, d, f), (E, d, f),
                                                 (E, f, d))]
    top_ids, keep, buf_idx = _reference_dispatch(jnp.asarray(x),
                                                 jnp.asarray(router), jcfg)
    C = moe._capacity(T, cfg)
    assert C == jmoe._capacity(T, jcfg)
    _, got_ids = moe._top_k(torch.from_numpy(x) @ torch.from_numpy(router),
                            cfg.experts_per_token)
    _, _, got_keep, got_buf = moe._dispatch(got_ids, E, C)
    assert np.array_equal(np.asarray(top_ids), got_ids.numpy())
    assert np.array_equal(np.asarray(keep), got_keep.numpy())
    assert np.array_equal(np.asarray(buf_idx), got_buf.numpy())
    if capacity < 1 or router_scale == 0:
        assert not bool(np.all(np.asarray(keep)))      # drops happened

    jy, jaux = jmoe._moe_local(*(jnp.asarray(a) for a in (router, *ws, x)),
                               jcfg, model_axis=None)
    y, aux = moe._moe_local(*(torch.from_numpy(a) for a in (router, *ws, x)),
                            cfg)
    # index_add_'s order of adds is not fixed on CUDA: a tolerance
    assert _rel(jy, y) < RTOL
    assert abs(float(jaux) - float(aux)) < 1e-5 * abs(float(jaux))


def test_moe_layer_with_a_mesh_raises():
    """A mesh runs the sharded branch (``tests/test_torch_sharded.py``),
    never the one-device path: plain activations on a mesh raise."""
    _, cfg = _cfgs(n_experts=4, experts_per_token=2)
    with pytest.raises(TypeError, match="DTensor"):
        moe.moe_layer({}, torch.zeros(1, 2, 32), cfg, DEFAULT_RULES,
                      mesh=object())


# --------------------------------------------------------------------------
# Recurrences
# --------------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(int(with_state))
    x, w, b = _normal(rng, 2, 9, 6), _normal(rng, 4, 6), _normal(rng, 6)
    state = _normal(rng, 2, 3, 6) if with_state else None
    jout, jstate = jssm._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if state is None else jnp.asarray(state))
    out, st = ssm._causal_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        None if state is None else torch.from_numpy(state))
    assert _rel(jout, out) < RTOL
    assert np.array_equal(np.asarray(jstate), st.numpy())


def _mamba_cfgs():
    return _cfgs(family="ssm", d_ff=0, ssm_state=8, ssm_heads=4,
                 ssm_head_dim=16, ssm_chunk=8, layer_pattern=("mamba2",))


@pytest.mark.parametrize("S", [13, 16, 5])
def test_mamba2_train_matches_reference(S):
    """Off a chunk multiple (13, and 5 under one chunk) the sequence is
    padded and the padding stripped."""
    jcfg, cfg = _mamba_cfgs()
    jp, tp = _params(jssm.mamba2_specs(jcfg), seed=S)
    x = _normal(np.random.default_rng(S), 2, S, 32)
    want, _ = jax.jit(lambda p, x: jssm.mamba2_layer(
        p, x, jcfg, JRULES, mode="train"))(jp, jnp.asarray(x))
    got, _ = ssm.mamba2_layer(tp, torch.from_numpy(x), cfg, DEFAULT_RULES,
                              mode="train")
    assert tuple(got.shape) == (2, S, 32)
    assert _rel(want, got) < RTOL


def test_mamba2_prefill_and_decode_match_reference():
    jcfg, cfg = _mamba_cfgs()
    jp, tp = _params(jssm.mamba2_specs(jcfg), seed=2)
    rng = np.random.default_rng(2)
    x, step = _normal(rng, 2, 16, 32), _normal(rng, 2, 1, 32)
    _, jc = jax.jit(lambda p, x: jssm.mamba2_layer(
        p, x, jcfg, JRULES, mode="prefill"))(jp, jnp.asarray(x))
    _, c = ssm.mamba2_layer(tp, torch.from_numpy(x), cfg, DEFAULT_RULES,
                            mode="prefill")
    assert c["ssm"].dtype == torch.float32
    for name in ("conv", "ssm"):
        assert _rel(jc[name], c[name]) < RTOL
    jout, jc2 = jax.jit(lambda p, x, c: jssm.mamba2_layer(
        p, x, jcfg, JRULES, mode="decode", cache=c))(jp, jnp.asarray(step), jc)
    out, c2 = ssm.mamba2_layer(tp, torch.from_numpy(step), cfg, DEFAULT_RULES,
                               mode="decode", cache=c)
    assert _rel(jout, out) < RTOL
    for name in ("conv", "ssm"):
        assert _rel(jc2[name], c2[name]) < RTOL
    shapes = ssm.mamba2_cache_shapes(cfg, 2)
    assert shapes == jssm.mamba2_cache_shapes(jcfg, 2)
    assert tuple(c2["conv"].shape) == shapes["conv"]


def test_mamba2_prefill_needs_a_chunk_multiple():
    _, cfg = _mamba_cfgs()
    _, tp = _params(jssm.mamba2_specs(_mamba_cfgs()[0]), seed=1)
    with pytest.raises(AssertionError, match="multiple of ssm_chunk"):
        ssm.mamba2_layer(tp, torch.zeros(1, 13, 32), cfg, DEFAULT_RULES,
                         mode="prefill")


def test_rglru_matches_reference():
    """train, prefill (a cache carried in) and decode, with the tanh GELU."""
    jcfg, cfg = _cfgs(family="hybrid", rglru_width=24,
                      layer_pattern=("rglru",))
    jp, tp = _params(jrglru.rglru_specs(jcfg), seed=9)
    rng = np.random.default_rng(9)
    x, step = _normal(rng, 2, 11, 32), _normal(rng, 2, 1, 32)
    layer = jax.jit(lambda p, x, c, mode: jrglru.rglru_layer(
        p, x, jcfg, JRULES, mode=mode, cache=c), static_argnums=3)
    want, _ = layer(jp, jnp.asarray(x), None, "train")
    got, _ = rglru.rglru_layer(tp, torch.from_numpy(x), cfg, DEFAULT_RULES)
    assert _rel(want, got) < RTOL
    cache = {"conv": _normal(rng, 2, 3, 24), "h": _normal(rng, 2, 24)}
    _, jc = layer(jp, jnp.asarray(x),
                  {k: jnp.asarray(v) for k, v in cache.items()}, "prefill")
    _, c = rglru.rglru_layer(tp, torch.from_numpy(x), cfg, DEFAULT_RULES,
                             mode="prefill",
                             cache={k: torch.from_numpy(v) for k, v in cache.items()})
    for name in ("conv", "h"):
        assert _rel(jc[name], c[name]) < RTOL
    jout, _ = layer(jp, jnp.asarray(step), jc, "decode")
    out, _ = rglru.rglru_layer(tp, torch.from_numpy(step), cfg, DEFAULT_RULES,
                               mode="decode", cache=c)
    assert _rel(jout, out) < RTOL


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    got = layers.gelu(torch.from_numpy(x))
    assert _rel(jax.nn.gelu(jnp.asarray(x)), got) < 1e-6
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert float((got - exact).abs().max()) > 1e-4


# --------------------------------------------------------------------------
# Shared layers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("theta,scaling", [(10_000.0, 1.0), (1e6, 16.0)])
def test_rope_matches_reference(theta, scaling):
    rng = np.random.default_rng(int(scaling))
    x = _normal(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta, scaling)
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta,
                      scaling)
    assert _rel(want, got) < RTOL
    # bf16 in, bf16 out (the rotation itself in f32)
    got16 = layers.rope(torch.from_numpy(x).to(torch.bfloat16),
                        torch.from_numpy(pos), theta, scaling)
    assert got16.dtype == torch.bfloat16


@pytest.mark.parametrize("variant", ["swiglu", "gelu"])
def test_rmsnorm_mlp_embed_and_loss_match_reference(variant):
    jcfg, cfg = _cfgs(mlp_variant=variant)
    jp, tp = _params(jlayers.mlp_specs(jcfg), seed=11)
    rng = np.random.default_rng(11)
    x, scale = _normal(rng, 2, 5, 32), _normal(rng, 32)
    assert _rel(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(scale)),
                layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale))) < RTOL
    assert _rel(jlayers.mlp(jp, jnp.asarray(x), jcfg, JRULES),
                layers.mlp(tp, torch.from_numpy(x), cfg, DEFAULT_RULES)) < RTOL
    table = _normal(rng, 64, 32)
    toks = rng.integers(0, 64, (2, 5)).astype(np.int32)
    emb = layers.embed(torch.from_numpy(table), torch.from_numpy(toks), cfg,
                       DEFAULT_RULES)
    assert np.array_equal(np.asarray(jlayers.embed(
        jnp.asarray(table), jnp.asarray(toks), jcfg, JRULES)), emb.numpy())
    for transpose, w in ((True, table), (False, table.T.copy())):
        want = jlayers.unembed(jnp.asarray(w), jnp.asarray(x), JRULES, transpose)
        got = layers.unembed(torch.from_numpy(w), torch.from_numpy(x),
                             DEFAULT_RULES, transpose)
        assert got.dtype == torch.float32 and _rel(want, got) < RTOL
    logits = _normal(rng, 2, 5, 64, scale=3.0)
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(toks))
    got = layers.cross_entropy(torch.from_numpy(logits), torch.from_numpy(toks))
    assert abs(float(want) - float(got)) < 1e-5 * abs(float(want))


# --------------------------------------------------------------------------
# Parameter trees, rules
# --------------------------------------------------------------------------


def test_init_params_draws_the_reference_distributions():
    _, cfg = _cfgs(qkv_bias=True)
    model = build_model(cfg)
    specs = model.param_specs()
    gen = torch.Generator().manual_seed(0)
    tree = model.init(gen, device="cpu")
    again = init_params(specs, torch.Generator().manual_seed(0), device="cpu")
    wq = tree["blocks"]["0_attn"]["attn"]["wq"]
    assert torch.equal(wq, again["blocks"]["0_attn"]["attn"]["wq"])
    bound = np.sqrt(1.0 / wq.shape[-2])                 # uniform ±√(1/fan_in)
    assert float(wq.abs().max()) <= bound and float(wq.abs().max()) > 0.9 * bound
    assert float(tree["embed"].std()) == pytest.approx(0.02, rel=0.05)
    assert torch.all(tree["blocks"]["0_attn"]["attn"]["bq"] == 0)
    assert torch.all(tree["final_norm"] == 1)
    assert all(p.device.type == "cpu" and not p.requires_grad
               for p in model.parameters())
    with pytest.raises(ValueError, match="device"):
        init_params(specs, torch.Generator(), device="meta")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run there")
    _, cfg = _cfgs()
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        model.init(torch.Generator())
    with pytest.raises(RuntimeError, match="cuda"):
        model.init_cache(1, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_numpy({}, {})


def test_params_from_numpy_checks_every_leaf():
    _, cfg = _cfgs()
    specs = build_model(cfg).param_specs()
    arrays = jax.tree.map(lambda t: t.numpy(), init_params(
        specs, torch.Generator().manual_seed(0), device="cpu"))
    got = params_from_numpy(arrays, specs, device="cpu")
    assert torch.equal(got["embed"], torch.from_numpy(arrays["embed"]))
    assert got["blocks"]["0_attn"]["attn"]["wq"].shape == (2, 32, 4, 8)
    missing = {k: v for k, v in arrays.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="final_norm"):
        params_from_numpy(missing, specs, device="cpu")
    with pytest.raises(KeyError, match="extra"):
        params_from_numpy(dict(arrays, stray=np.zeros(1, np.float32)), specs,
                          device="cpu")
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(dict(arrays, embed=arrays["embed"][:-1]), specs,
                          device="cpu")
    with pytest.raises(ValueError, match="float64"):
        params_from_numpy(dict(arrays, embed=arrays["embed"].astype(np.float64)),
                          specs, device="cpu")
    bf = dict(arrays, embed=arrays["embed"].astype(jnp.bfloat16))
    specs_bf = dict(specs, embed=dataclasses.replace(specs["embed"],
                                                     dtype="bfloat16"))
    assert params_from_numpy(bf, specs_bf, device="cpu")["embed"].dtype \
        == torch.bfloat16


def test_rules_and_dist_mirror_the_reference():
    for rules, jrules in ((DEFAULT_RULES, JRULES),
                          (Rules(mesh_axes=("pod", "data", "model"))
                           .with_overrides({"embed": ("pod", "data")}),
                           JRules(mesh_axes=("pod", "data", "model"))
                           .with_overrides({"embed": ("pod", "data")}))):
        for axes in (("batch", "seq_act", "embed_act"), ("embed", "vocab"),
                     ("cache_batch", "cache_seq", None, "layers")):
            assert rules.spec(*axes) == tuple(jrules.spec(*axes))
    _, cfg = _cfgs()
    specs = build_model(cfg).param_specs()
    assert pspec_tree(specs, DEFAULT_RULES)["embed"] == ("model", "data")
    x = torch.ones(3)
    assert constrain(x, DEFAULT_RULES, "batch") is x
    # a mesh's axis roles, as the reference's for_mesh gives them
    import types

    for names in (("data", "model"), ("pod", "data", "model"), ("data",)):
        d = Dist.for_mesh(types.SimpleNamespace(mesh_dim_names=names))
        jd = JDist.for_mesh(types.SimpleNamespace(axis_names=names))
        assert (d.rules.mesh_axes, d.data_axes, d.model_axis) == (
            jd.rules.mesh_axes, jd.data_axes, jd.model_axis)
