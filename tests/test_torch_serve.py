"""The port's serving path: the continuous-batching ``ServeEngine``, its
steps and sampling, and the ``launch/serve`` CLI.

The reference's serving tests (``tests/test_trainer_serve.py``) mirrored on
the port alone in bf16, then the port's f32 engine against the reference's
``ServeEngine`` on carried weights: the same greedy tokens.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.config import HOST_MESH as JHOST_MESH  # noqa: E402
from repro.config import ModelConfig as JModelConfig  # noqa: E402
from repro.config import RunConfig as JRunConfig  # noqa: E402
from repro.config import ShapeConfig as JShapeConfig  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.sharding.rules import Dist as JDist  # noqa: E402
from repro_torch.config import HOST_MESH, ModelConfig, RunConfig, ShapeConfig  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models.base import params_from_numpy, tree_map  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.steps import greedy_sample, temperature_sample  # noqa: E402
from repro_torch.sharding.rules import Dist  # noqa: E402

_TINY = dict(
    name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16, remat="none",
    tie_embeddings=True,
)
TINY = ModelConfig(**_TINY)


def _engine(cfg, params=None, model=None, **kw):
    model = model or build_model(cfg)
    if params is None:
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
    run = RunConfig(model=cfg, shape=ShapeConfig("serve", 64, 2, "decode"),
                    mesh=HOST_MESH)
    return model, ServeEngine(model, run, Dist(), params, n_slots=2,
                              max_len=64, **kw)


def test_serving_engine_continuous_batching():
    _, eng = _engine(TINY, temperature=0.0)
    rng = np.random.default_rng(0)
    for i, L in enumerate([5, 9, 3, 7, 4]):
        eng.submit(Request(prompt=rng.integers(1, 128, size=L).astype(np.int32),
                           max_new_tokens=6, rid=i))
    done = eng.run_until_done(max_steps=200)
    assert len(done) == 5
    for r in done:
        assert r.done and 1 <= len(r.out_tokens) <= 6
        assert all(0 <= t < 128 for t in r.out_tokens)


def test_greedy_decode_matches_forward_argmax():
    """The engine's prefill + decode greedy tokens == argmax over full
    forwards, with two slots and ragged prompts (per-slot positions must
    isolate each sequence)."""
    model, eng = _engine(TINY, temperature=0.0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 128, size=L).astype(np.int32) for L in (8, 13, 5)]

    def ref_greedy(prompt, n):
        seq = list(prompt)
        with torch.inference_mode():
            for _ in range(n):
                logits, _, _ = model(None, torch.tensor([seq]), Dist(),
                                     mode="train")
                seq.append(int(torch.argmax(logits[0, -1])))
        return seq[len(prompt):]

    want = [ref_greedy(p, 4) for p in prompts]
    for i, p in enumerate(prompts):
        eng.submit(Request(prompt=p, max_new_tokens=4, rid=i))
    done = {r.rid: r.out_tokens for r in eng.run_until_done()}
    for i in range(len(prompts)):
        assert done[i] == want[i], (i, done[i], want[i])


def test_engine_matches_the_reference_engine():
    """f32, the reference's weights carried over, temperature 0: five
    ragged requests through two slots give the reference engine's tokens."""
    jcfg = JModelConfig(**_TINY, dtype="float32")
    cfg = ModelConfig(**_TINY, dtype="float32")
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg)
    params = model.load(params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          model.param_specs(), "cpu"))
    jeng = jengine.ServeEngine(
        jmodel, JRunConfig(model=jcfg, shape=JShapeConfig("serve", 64, 2,
                                                          "decode"),
                           mesh=JHOST_MESH),
        JDist(), jparams, n_slots=2, max_len=64, temperature=0.0)
    _, eng = _engine(cfg, params=params, model=model, temperature=0.0)
    rng = np.random.default_rng(2)
    for i, L in enumerate([5, 9, 3, 7, 4]):
        p = rng.integers(1, 128, size=L).astype(np.int32)
        jeng.submit(jengine.Request(prompt=p, max_new_tokens=6, rid=i))
        eng.submit(Request(prompt=p, max_new_tokens=6, rid=i))
    want = {r.rid: r.out_tokens for r in jeng.run_until_done()}
    got = {r.rid: r.out_tokens for r in eng.run_until_done()}
    assert got == want


def test_prefill_scatters_into_the_slot_row_like_the_reference():
    """``_put`` is ``dynamic_update_slice_in_dim`` on ``_batch_axis``: the
    slot's row of a stacked cache, the start clamped."""
    big = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    small = -np.ones((2, 1, 4), np.float32)
    for slot in (0, 2, 5):
        axis = jengine._batch_axis(big, small)
        assert engine._batch_axis(big, small) == axis == 1
        want = jax.lax.dynamic_update_slice_in_dim(
            jnp.asarray(big), jnp.asarray(small), slot, axis)
        got = torch.from_numpy(big.copy())
        engine._put(got, torch.from_numpy(small), slot)
        assert np.array_equal(np.asarray(want), got.numpy())
    same = np.zeros((2, 3), np.float32)
    assert engine._batch_axis(same, same) == jengine._batch_axis(same, same) == 0


def test_sampling():
    logits = torch.tensor([[0.0, 3.0, 1.0, -2.0], [5.0, 0.0, 0.0, 4.0]])
    assert greedy_sample(logits).tolist() == [1, 0]
    assert greedy_sample(logits).dtype == torch.int32
    assert torch.equal(temperature_sample(logits, None, 0.0),
                       greedy_sample(logits))
    draws = [temperature_sample(logits, torch.Generator().manual_seed(s), 1.0,
                                top_k=2) for s in range(200)]
    draws = torch.stack(draws)
    assert set(draws[:, 0].tolist()) == {1, 2}       # top-2 of row 0 only
    assert set(draws[:, 1].tolist()) == {0, 3}
    # softmax(5, 4) puts 0.73 on id 0
    assert 0.6 < float((draws[:, 1] == 0).float().mean()) < 0.85
    again = [temperature_sample(logits, torch.Generator().manual_seed(s), 1.0,
                                top_k=2) for s in range(200)]
    assert torch.equal(draws, torch.stack(again))    # the generator's draws


def test_launch_serve_runs_on_the_cpu(capsys):
    launch_serve.main(["--arch", "qwen1p5_0p5b", "--requests", "2",
                       "--device", "cpu"])
    assert "served 2 requests" in capsys.readouterr().out


def test_launch_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        launch_serve.main(["--arch", "qwen1p5_0p5b", "--requests", "1"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py's lm_serve phase "
                    "serves on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_decode_step_on_the_card(cuda):
    """An f32 prefill + decode step on the card against the same weights'
    on the CPU, and the card's greedy engine against the forward argmax."""
    cfg = dataclasses.replace(TINY, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    cpu = build_model(cfg)
    cpu.load(tree_map(lambda t: t.cpu(), params))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, 128, (2, 9)).astype(np.int32))
    outs = []
    for m, dev in ((model, cuda), (cpu, torch.device("cpu"))):
        with torch.inference_mode():
            cache = m.init_cache(2, 16, device=dev)
            m(None, toks[:, :8].to(dev), Dist(), mode="prefill", cache=cache)
            dec, _, _ = m(None, toks[:, 8:].to(dev), Dist(), mode="decode",
                          cache=cache, cache_pos=torch.tensor([8, 8], device=dev))
        outs.append(dec.cpu())
    err = (outs[0] - outs[1]).abs().max() / outs[1].abs().max()
    assert float(err) < 1e-4
