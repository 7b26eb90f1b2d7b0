"""Mamba-2 (SSD — state-space duality) layer.

The SSD recurrence ``h_t = a_t · h_{t-1} + dt_t · B_t ⊗ x_t`` is the
framework's affine monoid. The chunked algorithm, as in the reference:

  * intra-chunk: a small attention-like quadratic form per chunk;
  * inter-chunk: one affine-monoid *exclusive scan* over per-chunk lifted
    elements ``(Π a, Σ decay·dt·B⊗x)`` — ``core.monoid.exclusive_scan``.

The reference's two large contractions take bf16 operands with f32
results; here the operands are rounded to bf16 the same way and multiplied
in f32. Decode carries ``(conv_state, ssm_state)``, O(1) in context length.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..core import monoid as M
from ..sharding.rules import Rules, constrain
from .base import ParamSpec
from .layers import rmsnorm

AFF = M.affine_monoid()


def mamba2_dims(cfg: ModelConfig) -> tuple:
    d_in = cfg.ssm_expand * cfg.d_model
    H, Pd, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    assert H * Pd == d_in, (H, Pd, d_in)
    return d_in, H, Pd, N


def mamba2_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_in, H, Pd, N = mamba2_dims(cfg)
    conv_dim = d_in + 2 * N
    pd = cfg.param_dtype
    return {
        # order: [z (d_in), x (d_in), B (N), C (N), dt (H)]
        "in_proj": ParamSpec((d, 2 * d_in + 2 * N + H), ("embed", "rnn"), pd, "uniform_scaled"),
        "conv_w": ParamSpec((cfg.ssm_conv_width, conv_dim), ("conv", "rnn"), pd, "uniform_scaled"),
        "conv_b": ParamSpec((conv_dim,), ("rnn",), pd, "zeros"),
        "A_log": ParamSpec((H,), (None,), pd, "normal", 0.5),
        "D": ParamSpec((H,), (None,), pd, "ones"),
        "dt_bias": ParamSpec((H,), (None,), pd, "zeros"),
        "norm": ParamSpec((d_in,), ("rnn",), pd, "ones"),
        "out_proj": ParamSpec((d_in, d), ("rnn", "embed"), pd, "uniform_scaled"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None) -> tuple:
    """Depthwise causal conv over seq. x: (B, S, C); w: (W, C).

    Returns (out (B, S, C), new_state (B, W-1, C)) — state carries the last
    W-1 inputs for decode continuation."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                     # (B, S+W-1, C)
    out = sum(
        xp[:, i: i + x.shape[1]] * w[i].to(x.dtype) for i in range(W)
    ) + b.to(x.dtype)
    new_state = xp[:, -(W - 1):] if W > 1 else None
    return F.silu(out), new_state


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig) -> tuple:
    d_in, H, Pd, N = mamba2_dims(cfg)
    z = zxbcdt[..., :d_in]
    xin = zxbcdt[..., d_in: 2 * d_in]
    Bm = zxbcdt[..., 2 * d_in: 2 * d_in + N]
    Cm = zxbcdt[..., 2 * d_in + N: 2 * d_in + 2 * N]
    dt = zxbcdt[..., 2 * d_in + 2 * N:]
    return z, xin, Bm, Cm, dt


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """A bf16 operand of an f32-result product: rounded, then widened."""
    return x.to(torch.bfloat16).float()


def mamba2_layer(
    params: dict,
    x: torch.Tensor,                # (B, S, d)
    cfg: ModelConfig,
    rules: Rules,
    *,
    mode: str = "train",
    cache: dict | None = None,
) -> tuple:
    """Returns (out (B, S, d), new_cache)."""
    if mode == "decode":
        return _mamba2_decode(params, x, cfg, rules, cache)

    B, S, d = x.shape
    d_in, H, Pd, N = mamba2_dims(cfg)
    Q = min(cfg.ssm_chunk, S)
    S_orig = S
    if S % Q:
        # Right-pad to a chunk multiple; padding sits after every real token,
        # so causal results for real positions are unaffected. Prefill needs
        # the exact final state, so it requires divisibility.
        assert mode != "prefill", "prefill seq must be a multiple of ssm_chunk"
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, pad))
        S = S + pad
    dtype = x.dtype

    zxbcdt = x @ params["in_proj"].to(dtype)
    z, xin, Bm, Cm, dt = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, params["conv_w"], params["conv_b"])
    xin = conv_out[..., :d_in]
    Bm = conv_out[..., d_in: d_in + N]
    Cm = conv_out[..., d_in + N:]
    xin = constrain(xin, rules, "batch", "seq_act", "rnn")

    y, final_state = _on_rows(_ssd, (xin, Bm, Cm, dt),
                              (params["dt_bias"], params["A_log"], params["D"]),
                              cfg=cfg, Q=Q, want_state=mode == "prefill")
    y = y.to(dtype)

    # gated norm + output
    if S != S_orig:
        y = y[:, :S_orig]
        z = z[:, :S_orig]
    y = rmsnorm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = y @ params["out_proj"].to(dtype)
    out = constrain(out, rules, "batch", "seq_act", "embed_act")

    new_cache = None
    if mode == "prefill":
        new_cache = {"conv": conv_state, "ssm": final_state}
    return out, new_cache


def _ssd(xin, Bm, Cm, dt, dt_bias, A_log, D, *, cfg: ModelConfig, Q: int,
         want_state: bool) -> tuple:
    """The chunked SSD of (B, S, ·) activations -> (y (B, S, d_in) f32,
    the final state (B, H, N, P) f32 when ``want_state``, else an empty
    tensor)."""
    B, S, _ = xin.shape
    d_in, H, Pd, N = mamba2_dims(cfg)
    nc = S // Q
    f32 = torch.float32
    dt = F.softplus(dt.float() + dt_bias.float())
    A = -torch.exp(A_log.float())                       # (H,) negative
    loga = dt * A                                                  # (B, S, H) ≤ 0

    xh = xin.reshape(B, nc, Q, H, Pd).to(f32)
    Bc = Bm.reshape(B, nc, Q, N).to(f32)
    Cc = Cm.reshape(B, nc, Q, N).to(f32)
    dtc = dt.reshape(B, nc, Q, H)
    cum = torch.cumsum(loga.reshape(B, nc, Q, H), dim=2)          # inclusive

    # --- intra-chunk (quadratic, attention-like) ------------------------------
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])  # (B,nc,Qi,Qj,H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xin.device))
    scores = torch.einsum("bnqk,bnjk->bnqj", _bf16(Cc), _bf16(Bc))  # C_i · B_j
    scores = scores[..., None] * decay * dtc[:, :, None, :, :]       # (B,nc,Qi,Qj,H)
    scores = torch.where(mask[None, None, :, :, None], scores, 0.0)
    y_intra = torch.einsum("bnqjh,bnjhp->bnqhp", _bf16(scores), _bf16(xh))

    # --- chunk lifted elements + inter-chunk monoid scan -----------------------
    last = cum[:, :, -1:, :]                                          # (B,nc,1,H)
    decay_to_end = torch.exp(last - cum)                              # (B,nc,Q,H)
    S_c = torch.einsum("bnqh,bnqk,bnqhp->bnhkp", decay_to_end * dtc, Bc, xh)
    a_c = torch.exp(last[:, :, 0, :])[..., None, None]                # (B,nc,H,1,1)
    state_in = M.exclusive_scan(AFF, (a_c, S_c), axis=1)[1]           # (B,nc,H,N,P)

    y_inter = torch.einsum(
        "bnqh,bnqk,bnhkp->bnqhp", torch.exp(cum), Cc, state_in
    )
    y = (y_intra + y_inter
         + D.float()[None, None, None, :, None] * xh)
    y = y.reshape(B, S, d_in)
    if not want_state:
        return y, y.new_zeros(0)
    final_state = (a_c[:, -1, ..., 0, 0][:, :, None, None] * state_in[:, -1]
                   + S_c[:, -1])                                      # (B,H,N,P)
    return y, final_state.float()


def _on_rows(fn, acts: tuple, params: tuple, **kw) -> tuple:
    """``fn(*acts, *params, **kw)`` -> a tuple of (B, ...) tensors. On
    DTensors it runs under ``local_map`` on each rank's rows: the
    activations (rows first) split only over the data axes, the parameters
    replicated. DTensor's einsums here would flatten a sharded row dim with
    a sharded channel dim, which its view rules refuse; rows are
    independent, so each rank's local call is exact. A parameter's
    gradient is then each data shard's partial sum (its rows'), the same on
    every rank of the other axes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(acts[0], DTensor):
        return fn(*acts, *params, **kw)
    mesh = acts[0].device_mesh
    rows = tuple(Shard(0) if p == Shard(0) else Replicate()
                 for p in acts[0].placements)
    whole = (Replicate(),) * len(rows)
    summed = tuple(Partial() if p == Shard(0) else Replicate() for p in rows)
    acts = tuple(a.redistribute(mesh, rows) for a in acts)
    params = tuple(p.redistribute(mesh, whole) for p in params)
    f = local_map(functools.partial(fn, **kw), out_placements=(rows, rows),
                  in_placements=(rows,) * len(acts) + (whole,) * len(params),
                  in_grad_placements=(rows,) * len(acts)
                  + (summed,) * len(params), device_mesh=mesh)
    return f(*acts, *params)



def _mamba2_decode(params, x, cfg, rules, cache):
    """Single-token step. x: (B, 1, d); cache: conv (B, W-1, C), ssm (B,H,N,P)."""
    B = x.shape[0]
    d_in, H, Pd, N = mamba2_dims(cfg)
    dtype = x.dtype

    zxbcdt = x @ params["in_proj"].to(dtype)
    z, xin, Bm, Cm, dt = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)                        # (B,1,C)
    W = cfg.ssm_conv_width
    hist = torch.cat([cache["conv"].to(dtype), conv_in], dim=1)       # (B,W,C)
    conv_out = sum(hist[:, i] * params["conv_w"][i].to(dtype) for i in range(W))
    conv_out = F.silu(conv_out + params["conv_b"].to(dtype))          # (B,C)
    new_conv = hist[:, 1:]

    xin = conv_out[:, :d_in].reshape(B, H, Pd).float()
    Bv = conv_out[:, d_in: d_in + N].float()                          # (B,N)
    Cv = conv_out[:, d_in + N:].float()

    y, state = _on_rows(_ssd_step, (xin, Bv, Cv, dt[:, 0], cache["ssm"]),
                        (params["dt_bias"], params["A_log"], params["D"]))
    y = y.reshape(B, 1, d_in).to(dtype)

    y = rmsnorm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = y @ params["out_proj"].to(dtype)
    return out, {"conv": new_conv, "ssm": state}


def _ssd_step(xin, Bv, Cv, dt, state, dt_bias, A_log, D) -> tuple:
    """One token of the recurrence: xin (B, H, P), Bv and Cv (B, N), dt
    (B, H) raw, state (B, H, N, P) -> (y (B, H, P), the new state)."""
    dt = F.softplus(dt.float() + dt_bias.float())                     # (B,H)
    A = -torch.exp(A_log.float())
    a = torch.exp(dt * A)                                             # (B,H)
    state = (a[..., None, None] * state
             + torch.einsum("bh,bk,bhp->bhkp", dt, Bv, xin))
    y = torch.einsum("bk,bhkp->bhp", Cv, state)
    return y + D.float()[None, :, None] * xin, state


def mamba2_cache_shapes(cfg: ModelConfig, batch: int) -> dict:
    d_in, H, Pd, N = mamba2_dims(cfg)
    conv_dim = d_in + 2 * N
    return {
        "conv": (batch, cfg.ssm_conv_width - 1, conv_dim),
        "ssm": (batch, H, N, Pd),
    }
