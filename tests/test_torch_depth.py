"""A deep random-init stack amplifies rounding, in the reference and the
port alike.

qwen1.5-0.5B's shapes at a quarter of its width (d_model 256: 4 heads of
64, d_ff 704; vocab cut to 4,096) at 2, 8 and 16 layers, on the same
numpy-made weights in both packages: a prefill of 64 tokens and a decode
step at position 64 against the train-mode forward's logits there (the
reference tests' check, ``tests/test_models.py``), in bf16 and in f32, and
the port's f32 logits against the reference's.

The reference's own f32 decode and forward differ only in the summation
order of the last position's path, yet part by thousands of times more at
16 layers than at 2: the growth is the random weights' conditioning, not
either package. In bf16 the same growth takes the reference past its own
3e-2 bound. The port follows it at every depth: its bf16 decode error
within a factor of 10 of the reference's, on the same side of the bound,
and its f32 logits no further from the reference's than 10 times the
reference's own f32 decode-vs-forward spread (1e-4 where that is smaller).

Run as a script, it prints the sweep at 2, 4, 8, 16 and 24 layers:

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/test_torch_depth.py

The ``cuda``-marked case does the same at qwen's full size (24 layers,
d_model 1,024, vocab 151,936): the reference on the CPU, the port on the
card.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402
from repro.sharding.rules import Dist as JDist  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.base import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.sharding.rules import Dist  # noqa: E402
from test_torch_models import PARITY_RTOL, _rel, numpy_params  # noqa: E402

ARCH = "qwen1p5_0p5b"
#: qwen1.5-0.5B at a quarter of its width, head_dim kept.
QUARTER = dict(d_model=256, n_heads=4, n_kv_heads=4, d_ff=704,
               vocab_size=4096)
DEPTHS = (2, 8, 16)
#: The prompt decoded after, as in chip_smoke.py's lm_serve phase.
PROMPT = 64
#: The reference tests' bound on bf16 decode against forward.
BF16_BOUND = 3e-2
#: How far apart the two packages may fall: the port's bf16 decode error
#: within this factor of the reference's (either way); its f32 logits
#: within this factor of the reference's own f32 decode-vs-forward spread.
#: (Measured on the CPU: at most 2.4 and 4.9.)
FACTOR = 10


def sweep(n_layers: int, width: dict, device: str = "cpu") -> dict:
    """Both packages on the same weights at ``n_layers``: each one's
    decode-vs-forward error in f32 and bf16 (``ref``/``port``), and the
    port's f32 forward and decode logits against the reference's
    (``parity``)."""
    out = {"ref": {}, "port": {}}
    toks = weights = None
    f32 = {}
    for dtype in ("float32", "bfloat16"):
        kw = dict(width, n_layers=n_layers, dtype=dtype)
        jcfg = dataclasses.replace(jget_config(ARCH), **kw)
        cfg = dataclasses.replace(get_config(ARCH), **kw)
        jm, m = jbuild_model(jcfg), build_model(cfg)
        if weights is None:
            weights = numpy_params(jm.param_specs(), seed=1)
            toks = np.random.default_rng(3).integers(
                1, cfg.vocab_size, (1, PROMPT + 1)).astype(np.int32)
        jp = jax.tree.map(jnp.asarray, weights)
        full = jax.jit(lambda p, t: jm.forward(p, t, JDist(),
                                               mode="train")[0])(
            jp, jnp.asarray(toks))
        cache = jax.jit(lambda p, t, c: jm.forward(
            p, t, JDist(), mode="prefill", cache=c)[1])(
            jp, jnp.asarray(toks[:, :PROMPT]), jm.init_cache(1, PROMPT + 8))
        dec = jax.jit(lambda p, t, c: jm.forward(
            p, t, JDist(), mode="decode", cache=c,
            cache_pos=jnp.asarray(PROMPT, jnp.int32))[0])(
            jp, jnp.asarray(toks[:, PROMPT:]), cache)
        full, dec = np.asarray(full, np.float32), np.asarray(dec, np.float32)
        out["ref"][dtype] = _rel(full[:, PROMPT], dec[:, 0])

        m.load(params_from_numpy(weights, m.param_specs(), device))
        t = torch.from_numpy(toks).to(device)
        with torch.inference_mode():
            got_full = m(None, t, Dist(), mode="train")[0]
            c = m.init_cache(1, PROMPT + 8, device=device)
            m(None, t[:, :PROMPT], Dist(), mode="prefill", cache=c)
            got_dec = m(None, t[:, PROMPT:], Dist(), mode="decode", cache=c,
                        cache_pos=torch.tensor(PROMPT, device=device))[0]
        got_full = got_full.float().cpu().numpy()
        got_dec = got_dec.float().cpu().numpy()
        out["port"][dtype] = _rel(got_full[:, PROMPT], got_dec[:, 0])
        if dtype == "float32":
            f32 = dict(forward=_rel(full, got_full), decode=_rel(dec, got_dec))
        del m
    out["parity"] = max(f32.values())
    return out


def check_f32_parity(r: dict) -> None:
    allowed = max(PARITY_RTOL, FACTOR * r["ref"]["float32"])
    assert r["parity"] < allowed, (
        f"f32 port against reference {r['parity']:.3e}, allowed "
        f"{allowed:.3e}: {r}")


def check_bf16_follows_reference(r: dict) -> None:
    ref, port = r["ref"]["bfloat16"], r["port"]["bfloat16"]
    assert ref / FACTOR < port < ref * FACTOR, r
    assert (port < BF16_BOUND) == (ref < BF16_BOUND), r


@pytest.fixture(scope="module")
def runs():
    memo = {}

    def get(n_layers):
        if n_layers not in memo:
            memo[n_layers] = sweep(n_layers, QUARTER)
        return memo[n_layers]

    return get


@pytest.mark.parametrize("n_layers", DEPTHS)
def test_f32_port_tracks_reference_at_depth(runs, n_layers):
    check_f32_parity(runs(n_layers))


@pytest.mark.parametrize("n_layers", DEPTHS)
def test_bf16_decode_error_follows_reference(runs, n_layers):
    check_bf16_follows_reference(runs(n_layers))


def test_reference_amplifies_rounding_with_depth(runs):
    shallow, deep = runs(DEPTHS[0]), runs(DEPTHS[-1])
    # f32: summation-order differences grow by orders of magnitude
    assert deep["ref"]["float32"] > 100 * shallow["ref"]["float32"], \
        (shallow, deep)
    # bf16: within the reference tests' bound shallow, past it deep
    assert shallow["ref"]["bfloat16"] < BF16_BOUND < deep["ref"]["bfloat16"], \
        (shallow, deep)


@pytest.mark.cuda
def test_full_size_qwen_on_the_card():
    """qwen1.5-0.5B at its published size: the reference on the CPU, the
    port on the card, the same weights. The reference's own bf16 decode
    error is past its tests' bound too, and the port follows it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the reference runs on the CPU "
                    "beside it")
    r = sweep(get_config(ARCH).n_layers, {}, device="cuda")
    print(f"full size: {r}")
    check_f32_parity(r)
    check_bf16_follows_reference(r)
    assert r["ref"]["bfloat16"] > BF16_BOUND, r


if __name__ == "__main__":
    torch.set_num_threads(4)
    for n in (2, 4, 8, 16, 24):
        r = sweep(n, QUARTER)
        print(f"{n:2d} layers: decode against forward, reference f32 "
              f"{r['ref']['float32']:.3e} bf16 {r['ref']['bfloat16']:.3e}; "
              f"port f32 {r['port']['float32']:.3e} bf16 "
              f"{r['port']['bfloat16']:.3e}; port against reference, f32 "
              f"{r['parity']:.3e}", flush=True)
