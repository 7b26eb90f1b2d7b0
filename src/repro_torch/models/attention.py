"""Attention: GQA / MQA / sliding-window / qk-norm / bias variants.

Training and prefill use the reference's blockwise (flash-style) form in
plain PyTorch: a loop over query chunks and, inside it, over KV chunks,
carrying the ``(m, s, o)`` partial-softmax accumulators — the
``core.monoid.softmax_monoid`` element — so peak memory is one
(Cq × Ckv) score block per head whatever the sequence length. Under
autograd each query chunk's KV loop is checkpointed, as the reference's
``jax.checkpoint`` on it: the backward pass recomputes the score blocks
rather than keeping one per (q, kv) pair.

Decode attends one query against the whole cache. Windowed layers (SWA,
recurrentgemma's local attention) keep a **ring cache** of window size.

Scores and outputs are f32 whatever the compute dtype: the reference asks
for f32 results of its bf16 products (``preferred_element_type``), so the
operands are upcast here (exact) rather than multiplied in bf16 (whose
rounded results would be a different function).

Caches are written in place: ``attention_layer`` updates the ``cache``
tensors it is given and returns them. A ``DTensor`` cache (on a mesh; the
rules shard its sequence, batch or KV heads) is written on each rank's
shard: DTensor has no sharding strategy for an in-place write into a
sharded dim, so the new keys go to the cache's placements with the
sequence whole, and each rank writes the positions its shard holds
(``_shard_write``).
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..sharding.rules import Rules, constrain, product
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
    q, k, v = product("bsd,dhk->bshk", x,
                      *(params[w].to(dtype) for w in ("wq", "wk", "wv")))
    # The rules' layout before the bias, norms and rope, which act on whole
    # heads: a head_dim the weights split (yi's serving rules) is gathered
    # here, as the rules ask of q, k and v.
    q = constrain(q, rules, "batch", "attn_seq", "heads_act", None)
    k = constrain(k, rules, "batch", "attn_seq", None, None)
    v = constrain(v, rules, "batch", "attn_seq", None, None)
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
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              softcap=softcap, q_chunk=q_chunk, kv_chunk=kv_chunk)
    if hasattr(q, "device_mesh"):                   # a DTensor
        return _sharded_blockwise(q, k, v, kw)
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

    def q_chunk_out(qi: int, q_blk, kc, vc):
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
        return out.permute(0, 3, 1, 2, 4)                        # (B,Cq,KV,G,dh)

    # Flash-style memory under autograd, as the reference's jax.checkpoint on
    # the per-q-chunk body: a q chunk's score blocks are recomputed in the
    # backward pass, so only its inputs and output outlive the forward.
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs = []
    for qi in range(nq):
        if remat:
            outs.append(checkpoint(q_chunk_out, qi, qc[:, qi], kc, vc,
                                   use_reentrant=False))
        else:
            outs.append(q_chunk_out(qi, qc[:, qi], kc, vc))
    out = torch.cat(outs, dim=1).reshape(B, Sq, H, dh)
    return out.to(q.dtype)


def _sharded_blockwise(q, k, v, kw: dict):
    """``blockwise_attention`` of DTensors, on each rank's shards under
    ``local_map``: the rows over the data axes and the heads over the model
    axis, as ``q`` has them (a sequence shard is gathered first). Rows and
    heads are independent, so each rank's local attention is exact; as
    DTensor ops the chunk loops would cross the mesh op by op. Where the
    heads' split does not follow the KV groups (KV heads not a multiple of
    the ranks that split the heads), K and V are repeated to one head a
    query head first."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    H, KV = q.shape[2], k.shape[2]
    place = [p if p in (Shard(0), Shard(2)) else Replicate()
             for p in q.placements]
    head_ranks = 1
    for i, p in enumerate(place):
        if p == Shard(2):
            head_ranks *= mesh.size(i)
    if H % head_ranks:                             # uneven heads: whole
        place = [Replicate() if p == Shard(2) else p for p in place]
    elif head_ranks > 1 and KV % head_ranks:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    q, k, v = (t.redistribute(mesh, place) for t in (q, k, v))
    fn = local_map(functools.partial(blockwise_attention, **kw),
                   out_placements=place, in_placements=(place,) * 3,
                   in_grad_placements=(place,) * 3, device_mesh=mesh)
    return fn(q, k, v)


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
    if hasattr(q, "device_mesh"):                   # a DTensor
        return _sharded_decode(q, cache_k, cache_v, pos, window, softcap)
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


def _decode_partials(q, cache_k, cache_v, posb, seq_offset: int, S: int,
                     window: int, softcap: float) -> tuple:
    """Flash-decode partials ``(m, s, o)`` (the softmax monoid's element)
    of one query against one slice of the cache's sequence, which starts at
    ``seq_offset`` of a cache of length ``S``; ``posb`` (B, 1)."""
    B, _, H, dh = q.shape
    KV = cache_k.shape[2]
    qv = q.reshape(B, KV, H // KV, dh)
    scores = torch.einsum("bhgd,bshd->bhgs", qv.float(), cache_k.float()) \
        * dh ** -0.5
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    idx = seq_offset + torch.arange(cache_k.shape[1], device=q.device)[None]
    if window:
        t = posb - torch.remainder(posb - idx, S)
        valid = (t >= 0) & (t <= posb)
    else:
        valid = idx <= posb
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    o = torch.einsum("bhgs,bshd->bhgd", p.to(cache_v.dtype).float(),
                     cache_v.float())
    return m, torch.sum(p, dim=-1, keepdim=True), o


def _sharded_decode(q, cache_k, cache_v, pos, window: int, softcap: float):
    """``decode_attention`` of DTensors on each rank's shards. DTensor's
    einsum here would flatten a sharded batch dim with a sharded head dim,
    which its view rules refuse; rows and KV heads are independent, so the
    query goes to the cache's row and head split and each rank attends
    locally. Where the rules shard the cache's sequence (``cache_seq``),
    each rank computes its slice's flash-decode partials, which are
    all-gathered over those mesh axes and combined with the softmax monoid
    (the reference's design for that layout); otherwise the local call is
    the one-device ``decode_attention`` itself."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    from ..core.monoid import reduce, softmax_monoid

    mesh, cp = cache_k.device_mesh, cache_k.placements
    H, KV = q.shape[2], cache_k.shape[2]
    qp = [p if p in (Shard(0), Shard(2)) else Replicate() for p in cp]
    seq_dims = [i for i, p in enumerate(cp) if p == Shard(1)]
    if any(p == Shard(2) for p in cp) and (H % KV or KV % math.prod(
            mesh.size(i) for i, p in enumerate(cp) if p == Shard(2))):
        raise ValueError("decode: the cache's KV heads split unevenly")
    q = q.redistribute(mesh, qp).to_local()
    k, v = cache_k.to_local(), cache_v.to_local()
    _, (b0, s0, *_) = compute_local_shape_and_global_offset(
        cache_k.shape, mesh, cp)
    if isinstance(pos, DTensor):            # replicated: every rank's own
        pos = pos.full_tensor()
    pos = torch.as_tensor(pos, device=q.device).to(torch.int64).reshape(-1)
    B = q.shape[0]
    if pos.numel() > 1:
        pos = pos[b0:b0 + B]
    if not seq_dims:
        out = decode_attention(q, k, v, pos if pos.numel() > 1 else pos[0],
                               window=window, softcap=softcap)
    else:
        posb = torch.broadcast_to(pos, (B,))[:, None]
        part = _decode_partials(q, k, v, posb, s0, cache_k.shape[1], window,
                                softcap)
        for i in seq_dims:
            part = tuple(funcol.all_gather_tensor(t[None], 0, (mesh, i))
                         for t in part)
            part = reduce(softmax_monoid(), part, axis=0)
        m, ssum, o = part
        out = (o / torch.clamp(ssum, min=1e-30)).reshape(q.shape).to(
            q.dtype)
    return DTensor.from_local(out, mesh, qp, run_check=False)


# --------------------------------------------------------------------------
# Full layer: projections + attention + cache handling + output proj
# --------------------------------------------------------------------------


def init_cache_shape(cfg: ModelConfig, batch: int, max_len: int, window: int) -> dict:
    S = min(window, max_len) if window else max_len
    KV, dh = cfg.n_kv_heads, cfg.resolved_head_dim()
    return {"k": (batch, S, KV, dh), "v": (batch, S, KV, dh)}


def _shard_write(cache, new) -> tuple:
    """A ``DTensor`` cache (B, S, KV, dh) and new keys (B, n, KV, dh) ->
    (this rank's cache shard, the new keys laid out as that shard with the
    sequence whole, the shard's global offsets). Writing into the shard
    writes the cache."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    if not isinstance(new, DTensor):
        raise TypeError("a DTensor cache takes DTensor keys")
    mesh, place = cache.device_mesh, cache.placements
    want = [Replicate() if p == Shard(1) else p for p in place]
    new = new.to(cache.dtype).redistribute(mesh, want).to_local()
    _, offset = compute_local_shape_and_global_offset(cache.shape, mesh,
                                                      place)
    return cache.to_local(), new, offset


def _write_positions(cache, new, positions: list) -> None:
    """``cache[:, positions[i]] = new[:, i]`` in place (prefill)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(cache, DTensor):
        idx = torch.as_tensor(positions, device=cache.device)
        cache.index_copy_(1, idx, new.to(cache.dtype))
        return
    local, new, (_, off, *_) = _shard_write(cache, new)
    held = [(i, p - off) for i, p in enumerate(positions)
            if 0 <= p - off < local.shape[1]]
    if held:
        src, dst = (torch.as_tensor(x, device=local.device)
                    for x in zip(*held))
        local.index_copy_(1, dst, new.index_select(1, src))


def _write_decode(cache: torch.Tensor, new: torch.Tensor, slot) -> None:
    """Write the one-token ``new`` (B, 1, KV, dh) into ``cache`` (B, S, KV,
    dh) at ``slot``, in place. A scalar slot is clamped into the cache, as
    ``dynamic_update_slice`` clamps its start; a per-row slot out of the
    cache is dropped, as a scatter drops it."""
    from torch.distributed.tensor import DTensor

    S = cache.shape[1]
    if isinstance(slot, DTensor):           # replicated: every rank's own
        slot = slot.full_tensor()
    slot = torch.as_tensor(slot, device=cache.device).to(torch.int64)
    if isinstance(cache, DTensor):
        _write_decode_shard(cache, new, slot)
        return
    new = new.to(cache.dtype)
    if slot.dim() == 0:
        cache.index_copy_(1, slot.clamp(0, S - 1).reshape(1), new)
        return
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = slot.clamp(0, S - 1)
    keep = ((slot >= 0) & (slot < S))[:, None, None]
    cache[rows, at] = torch.where(keep, new[:, 0], cache[rows, at])


def _write_decode_shard(cache, new, slot: torch.Tensor) -> None:
    """``_write_decode`` on this rank's shard of a ``DTensor`` cache,
    without a branch on the slot's value (the dry-run's slot is a fake
    tensor): a row whose slot lies outside the shard rewrites what it
    holds."""
    S = cache.shape[1]
    local, new, (b0, s0, *_) = _shard_write(cache, new)
    Bl, Sl = local.shape[:2]
    if Bl == 0 or Sl == 0:
        return
    if slot.dim() == 0:
        keep = torch.ones((), dtype=torch.bool, device=local.device)
        at = slot.clamp(0, S - 1)
    else:
        slot = slot[b0:b0 + Bl]
        keep = (slot >= 0) & (slot < S)
        at = slot.clamp(0, S - 1)
    at = at - s0
    keep = keep & (at >= 0) & (at < Sl)
    at = torch.broadcast_to(at.clamp(0, Sl - 1), (Bl,))
    keep = torch.broadcast_to(keep, (Bl,))[:, None, None]
    rows = torch.arange(Bl, device=local.device)
    local[rows, at] = torch.where(keep, new[:, 0], local[rows, at])


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
                slots = [p % S_cache for p in range(S - S_cache, S)]
                _write_positions(cache["k"], k[:, S - S_cache:], slots)
                _write_positions(cache["v"], v[:, S - S_cache:], slots)
            else:
                _write_positions(cache["k"], k, list(range(S)))
                _write_positions(cache["v"], v, list(range(S)))
            new_cache = cache

    out = constrain(out, rules, "batch", "attn_seq", "heads_act", None)
    proj = product("bshk,hkd->bsd", out, params["wo"].to(dtype))
    return constrain(proj, rules, "batch", "seq_act", "embed_act"), new_cache


def cross_attention_layer(
    params: dict,
    x: torch.Tensor,              # (B, S, d) decoder states
    enc_kv: tuple,               # precomputed (k, v): (B, S_enc, KV, dh)
    cfg: ModelConfig,
    rules: Rules,
) -> torch.Tensor:
    dtype = x.dtype
    q = product("bsd,dhk->bshk", x, params["wq"].to(dtype))
    if cfg.qkv_bias:
        q = q + params["bq"].to(dtype)
    k, v = enc_kv
    out = blockwise_attention(q, k, v, causal=False, softcap=0.0)
    proj = product("bshk,hkd->bsd", out, params["wo"].to(dtype))
    return constrain(proj, rules, "batch", "seq_act", "embed_act")


def encode_kv(params: dict, enc_states: torch.Tensor, cfg: ModelConfig) -> tuple:
    """Project encoder output to cross-attention K/V once (cached)."""
    dtype = enc_states.dtype
    k, v = product("bsd,dhk->bshk", enc_states,
                   params["wk"].to(dtype), params["wv"].to(dtype))
    if cfg.qkv_bias:
        k = k + params["bk"].to(dtype)
        v = v + params["bv"].to(dtype)
    return k, v
