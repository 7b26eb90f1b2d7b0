"""Attention: GQA / MQA / sliding-window / qk-norm / bias variants.

Training and prefill use the reference's blockwise (flash-style) form in
plain PyTorch: a loop over query chunks and, inside it, over KV chunks,
carrying the ``(m, s, o)`` partial-softmax accumulators — the
``core.monoid.softmax_monoid`` element — so peak memory is one
(Cq × Ckv) score block per head whatever the sequence length.

Decode attends one query against the whole cache. Windowed layers (SWA,
recurrentgemma's local attention) keep a **ring cache** of window size.

Scores and outputs are f32 whatever the compute dtype: the reference asks
for f32 results of its bf16 products (``preferred_element_type``), so the
operands are upcast here (exact) rather than multiplied in bf16 (whose
rounded results would be a different function).

Caches are written in place: ``attention_layer`` updates the ``cache``
tensors it is given and returns them.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..sharding.rules import Rules, constrain
from .base import ParamSpec
from .layers import rmsnorm, rope

NEG_INF = -1e30


def _snap_divisor(n: int, chunk: int) -> int:
    """Largest divisor of n that is <= chunk (chunked attention needs exact
    tiling; e.g. whisper's 1500-frame encoder snaps 512 -> 500)."""
    chunk = min(chunk, n)
    while n % chunk:
        chunk -= 1
    return max(chunk, 1)


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------


def attention_specs(cfg: ModelConfig, cross: bool = False) -> dict:
    d, H, KV = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim()
    pd = cfg.param_dtype
    specs = {
        "wq": ParamSpec((d, H, dh), ("embed", "heads", "head_dim"), pd, "uniform_scaled"),
        "wk": ParamSpec((d, KV, dh), ("embed", "kv_heads", "head_dim"), pd, "uniform_scaled"),
        "wv": ParamSpec((d, KV, dh), ("embed", "kv_heads", "head_dim"), pd, "uniform_scaled"),
        "wo": ParamSpec((H, dh, d), ("heads", "head_dim", "embed"), pd, "uniform_scaled"),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((H, dh), ("heads", "head_dim"), pd, "zeros")
        specs["bk"] = ParamSpec((KV, dh), ("kv_heads", "head_dim"), pd, "zeros")
        specs["bv"] = ParamSpec((KV, dh), ("kv_heads", "head_dim"), pd, "zeros")
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((dh,), ("head_dim",), pd, "ones")
        specs["k_norm"] = ParamSpec((dh,), ("head_dim",), pd, "ones")
    if cross:
        specs.pop("q_norm", None)
        specs.pop("k_norm", None)
    return specs


def _project_qkv(params, x, cfg: ModelConfig, rules: Rules, positions,
                 apply_rope: bool = True):
    dtype = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dtype))
    if cfg.qkv_bias:
        q = q + params["bq"].to(dtype)
        k = k + params["bk"].to(dtype)
        v = v + params["bv"].to(dtype)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    if apply_rope:
        q = rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
        k = rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
    q = constrain(q, rules, "batch", "attn_seq", "heads_act", None)
    k = constrain(k, rules, "batch", "attn_seq", None, None)
    v = constrain(v, rules, "batch", "attn_seq", None, None)
    return q, k, v


# --------------------------------------------------------------------------
# Blockwise (flash-style) attention — train / prefill
# --------------------------------------------------------------------------


def blockwise_attention(
    q: torch.Tensor,              # (B, Sq, H, dh)
    k: torch.Tensor,              # (B, Skv, KV, dh)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,             # 0 = unbounded
    q_offset: int = 0,           # absolute position of q[0]
    softcap: float = 0.0,
    q_chunk: int = 512,
    kv_chunk: int = 512,
) -> torch.Tensor:
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    q_chunk = _snap_divisor(Sq, q_chunk)
    kv_chunk = _snap_divisor(Skv, kv_chunk)
    nq, nk = Sq // q_chunk, Skv // kv_chunk
    scale = dh ** -0.5
    dev = q.device

    # (B, nq, Cq, KV, G, dh) and (B, nk, Ckv, KV, dh), f32 operands: the
    # products' f32 results are the reference's preferred_element_type.
    qc = q.reshape(B, nq, q_chunk, KV, G, dh).float()
    kc = k.reshape(B, nk, kv_chunk, KV, dh).float()
    vc = v.reshape(B, nk, kv_chunk, KV, dh)
    outs = []
    for qi in range(nq):
        q_blk = qc[:, qi]
        qpos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, KV, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        s = torch.zeros((B, KV, G, q_chunk), dtype=torch.float32, device=dev)
        o = torch.zeros((B, KV, G, q_chunk, dh), dtype=torch.float32,
                        device=dev)
        for ki in range(nk):
            k_blk, v_blk = kc[:, ki], vc[:, ki]
            kpos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            scores = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, k_blk) * scale
            if softcap:
                scores = softcap * torch.tanh(scores / softcap)
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window:
                mask &= qpos[:, None] - kpos[None, :] < window
            scores = torch.where(mask, scores, NEG_INF)
            m_blk = torch.amax(scores, dim=-1)                    # (B,KV,G,Cq)
            m_new = torch.maximum(m, m_blk)
            p = torch.exp(scores - m_new[..., None])
            alpha = torch.exp(m - m_new)
            s = s * alpha + torch.sum(p, dim=-1)
            o = o * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(v_blk.dtype).float(), v_blk.float())
            m = m_new
        out = o / torch.clamp(s, min=1e-30)[..., None]           # (B,KV,G,Cq,dh)
        outs.append(out.permute(0, 3, 1, 2, 4))                  # (B,Cq,KV,G,dh)
    out = torch.cat(outs, dim=1).reshape(B, Sq, H, dh)
    return out.to(q.dtype)


# --------------------------------------------------------------------------
# Decode attention (one query vs cache)
# --------------------------------------------------------------------------


def decode_attention(
    q: torch.Tensor,              # (B, 1, H, dh)
    cache_k: torch.Tensor,        # (B, S, KV, dh)
    cache_v: torch.Tensor,
    pos,                          # () or (B,) — current absolute position
    *,
    window: int = 0,              # ring cache when > 0 (S == window)
    softcap: float = 0.0,
) -> torch.Tensor:
    B, _, H, dh = q.shape
    S, KV = cache_k.shape[1], cache_k.shape[2]
    G = H // KV
    scale = dh ** -0.5
    qv = q.reshape(B, KV, G, dh)
    scores = torch.einsum("bhgd,bshd->bhgs", qv.float(), cache_k.float()) * scale
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    idx = torch.arange(S, device=q.device)[None]                  # (1, S)
    pos = torch.as_tensor(pos, device=q.device).to(torch.int64)
    posb = torch.broadcast_to(pos.reshape(-1), (B,))[:, None]    # (B, 1)
    if window:
        # Ring cache: slot s holds token t = pos - ((pos - s) mod S), valid if
        # 0 <= t and t > pos - S.
        t = posb - torch.remainder(posb - idx, S)
        valid = (t >= 0) & (t <= posb)                            # (B, S)
    else:
        valid = idx <= posb
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(cache_v.dtype).float(),
                       cache_v.float())
    return out.reshape(B, 1, H, dh).to(q.dtype)


# --------------------------------------------------------------------------
# Full layer: projections + attention + cache handling + output proj
# --------------------------------------------------------------------------


def init_cache_shape(cfg: ModelConfig, batch: int, max_len: int, window: int) -> dict:
    S = min(window, max_len) if window else max_len
    KV, dh = cfg.n_kv_heads, cfg.resolved_head_dim()
    return {"k": (batch, S, KV, dh), "v": (batch, S, KV, dh)}


def _write_decode(cache: torch.Tensor, new: torch.Tensor, slot) -> None:
    """Write the one-token ``new`` (B, 1, KV, dh) into ``cache`` (B, S, KV,
    dh) at ``slot``, in place. A scalar slot is clamped into the cache, as
    ``dynamic_update_slice`` clamps its start; a per-row slot out of the
    cache is dropped, as a scatter drops it."""
    S = cache.shape[1]
    new = new.to(cache.dtype)
    slot = torch.as_tensor(slot, device=cache.device).to(torch.int64)
    if slot.dim() == 0:
        cache.index_copy_(1, slot.clamp(0, S - 1).reshape(1), new)
        return
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = slot.clamp(0, S - 1)
    keep = ((slot >= 0) & (slot < S))[:, None, None]
    cache[rows, at] = torch.where(keep, new[:, 0], cache[rows, at])


def attention_layer(
    params: dict,
    x: torch.Tensor,              # (B, S, d)
    cfg: ModelConfig,
    rules: Rules,
    *,
    mode: str,                   # train | prefill | decode
    positions: torch.Tensor,      # (B, S) absolute positions
    window: int = 0,
    cache: dict | None = None,
    cache_pos=None,
    use_rope: bool = True,
    causal: bool = True,
) -> tuple:
    """Returns (out (B, S, d), cache written in place | None)."""
    dtype = x.dtype
    q, k, v = _project_qkv(params, x, cfg, rules, positions, apply_rope=use_rope)
    new_cache = None

    if mode == "decode":
        assert cache is not None and cache_pos is not None
        S_cache = cache["k"].shape[1]
        pos = torch.as_tensor(cache_pos, device=x.device)
        slot = torch.remainder(pos, S_cache) if window else pos
        _write_decode(cache["k"], k, slot)
        _write_decode(cache["v"], v, slot)
        out = decode_attention(
            q, cache["k"], cache["v"], pos, window=window,
            softcap=cfg.attn_logit_softcap,
        )
        new_cache = cache
    else:
        out = blockwise_attention(
            q, k, v,
            causal=causal,
            window=window,
            softcap=cfg.attn_logit_softcap,
        )
        if mode == "prefill":
            assert cache is not None
            S_cache = cache["k"].shape[1]
            S = k.shape[1]
            if window and S > S_cache:
                # Keep only the last ``window`` keys, placed at their ring slots.
                slots = torch.remainder(
                    torch.arange(S - S_cache, S, device=x.device), S_cache)
                cache["k"][:, slots] = k[:, S - S_cache:].to(cache["k"].dtype)
                cache["v"][:, slots] = v[:, S - S_cache:].to(cache["v"].dtype)
            else:
                cache["k"][:, :S] = k.to(cache["k"].dtype)
                cache["v"][:, :S] = v.to(cache["v"].dtype)
            new_cache = cache

    out = constrain(out, rules, "batch", "attn_seq", "heads_act", None)
    proj = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dtype))
    return constrain(proj, rules, "batch", "seq_act", "embed_act"), new_cache


def cross_attention_layer(
    params: dict,
    x: torch.Tensor,              # (B, S, d) decoder states
    enc_kv: tuple,               # precomputed (k, v): (B, S_enc, KV, dh)
    cfg: ModelConfig,
    rules: Rules,
) -> torch.Tensor:
    dtype = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dtype))
    if cfg.qkv_bias:
        q = q + params["bq"].to(dtype)
    k, v = enc_kv
    out = blockwise_attention(q, k, v, causal=False, softcap=0.0)
    proj = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dtype))
    return constrain(proj, rules, "batch", "seq_act", "embed_act")


def encode_kv(params: dict, enc_states: torch.Tensor, cfg: ModelConfig) -> tuple:
    """Project encoder output to cross-attention K/V once (cached)."""
    dtype = enc_states.dtype
    k = torch.einsum("bsd,dhk->bshk", enc_states, params["wk"].to(dtype))
    v = torch.einsum("bsd,dhk->bshk", enc_states, params["wv"].to(dtype))
    if cfg.qkv_bias:
        k = k + params["bk"].to(dtype)
        v = v + params["bv"].to(dtype)
    return k, v
