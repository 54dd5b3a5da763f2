"""Transformer layers: norms, RoPE, GQA / sliding-window / bidirectional
attention with its KV cache (ring-buffered for a sliding window, int8
with per-position scales), Multi-head Latent Attention with its latent
cache, SwiGLU and the sort-based top-k MoE.

Port of ``repro/models/layers.py``.  Everything is a plain function over
a dict of parameter tensors, as in the reference; the compute type
follows the parameters (bf16 by default), norm statistics, RoPE, softmax
and the MoE router are computed in f32 and cast back, as there.  Where
the reference returns an updated cache, the port writes the cache in
place and returns it (a decode step then moves one row per layer, not
the whole cache).

Each ``*_specs`` function describes its parameters as ``Leaf``s (shape,
how the reference initialises it and, where it is not the model's, its
type); ``models/transformer.py`` turns them into tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter: its shape, its initialisation, one of
    ("normal", std), ("full", value), ("linspace", start, stop) over the
    last two dimensions, ("log_linspace", start, stop) the log of a
    linspace over the last dimension, and its type (None: the
    configuration's)."""
    shape: Tuple[int, ...]
    init: tuple
    dtype: Optional[torch.dtype] = None


def ones(*shape: int) -> Leaf:
    return Leaf(tuple(shape), ("full", 1.0))


def zeros(*shape: int) -> Leaf:
    return Leaf(tuple(shape), ("full", 0.0))


def normal(std: float, *shape: int, dtype: Optional[torch.dtype] = None
           ) -> Leaf:
    return Leaf(tuple(shape), ("normal", std), dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)
            * scale.to(torch.float32)).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


def apply_norm(x: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.use_layernorm:
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


def norm_specs(cfg: ModelConfig, d: int) -> Params:
    p = {"scale": ones(d)}
    if cfg.use_layernorm:
        p["bias"] = zeros(d)
    return p


# ---------------------------------------------------------------------------
# Rotary position embeddings (GPT-NeoX half-split convention)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integers.  Computed in f32."""
    half = x.shape[-1] // 2
    inv_freq = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(torch.float32) * inv_freq  # (B,S,half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# int8 cache quantization (per-position scales)
# ---------------------------------------------------------------------------

def _write_at(cache: torch.Tensor, value: torch.Tensor, idx) -> None:
    """``cache[:, idx] = value[:, 0]`` in place: ``idx`` a Python int, or a
    0-d integer tensor on the cache's device (no host sync either way)."""
    if torch.is_tensor(idx):
        cache.index_copy_(1, idx.reshape(1), value.to(cache.dtype))
    else:
        cache[:, idx] = value[:, 0]


def quant_write(cache_q, cache_scale, value, idx) -> None:
    """value: (B, 1, ...) new entry -> int8 store + f32 scale at position
    ``idx``, in place.  The scale is max |v| / 127 over the non-(B, S) axes,
    at least 1e-8; the store rounds half to even, as ``jnp.round``."""
    v32 = value.to(torch.float32)
    red = tuple(range(2, v32.dim()))
    scale = torch.clamp(torch.amax(torch.abs(v32), dim=red) / 127.0,
                        min=1e-8)                        # (B, 1)
    q = torch.clamp(torch.round(v32 / scale.reshape(scale.shape
                                                    + (1,) * len(red))),
                    -127, 127).to(torch.int8)
    _write_at(cache_q, q, idx)
    _write_at(cache_scale, scale, idx)


def dequant(cache_q, cache_scale, dtype):
    """(B, S, ...) int8 + (B, S) scales -> dtype."""
    extra = cache_q.dim() - 2
    return (cache_q.to(torch.float32)
            * cache_scale.reshape(cache_scale.shape + (1,) * extra)).to(dtype)


# ---------------------------------------------------------------------------
# Dense attention (MHA / GQA), with causal / sliding-window / bidirectional
# masks, prefill and single-token decode with a (ring-buffered) KV cache
# ---------------------------------------------------------------------------

def attention_specs(cfg: ModelConfig) -> Params:
    d, hkv, hd = cfg.d_model, cfg.n_kv_heads, cfg.resolved_head_dim
    hq = cfg.padded_heads            # pad heads are inert (masked output)
    sd = d ** -0.5
    p: Params = {
        "wq": normal(sd, d, hq, hd),
        "wk": normal(sd, d, hkv, hd),
        "wv": normal(sd, d, hkv, hd),
        "wo": normal((hq * hd) ** -0.5, hq, hd, d),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros(hq, hd)
        p["bk"] = zeros(hkv, hd)
        p["bv"] = zeros(hkv, hd)
    if cfg.qk_norm:
        p["q_norm"] = ones(hd)
        p["k_norm"] = ones(hd)
    return p


def head_mask(cfg: ModelConfig, device) -> Optional[torch.Tensor]:
    """(Hp,) mask, 1 for real heads and 0 for the TP-alignment pad heads,
    applied to the attention output before ``wo``: pad heads add nothing
    (the published architecture is unchanged).  None without pad heads."""
    if cfg.padded_heads == cfg.n_heads:
        return None
    return torch.arange(cfg.padded_heads, device=device) < cfg.n_heads


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,d...->bs...") as one matrix product: (B, S, d) times
    (d, *out) -> (B, S, *out), contiguous."""
    b, s, d = x.shape
    out = w.shape[1:]
    return torch.matmul(x, w.reshape(d, -1)).view(b, s, *out)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """q: (B,S,H,D)  k/v: (B,T,KV,D)  mask: (B,1,1,S,T) bool -> (B,S,H,D).

    The reference's dense attention: query head h reads kv head h // g;
    scores made in the inputs' type, widened to f32 and scaled by D^-0.5;
    masked with -1e30 (not -inf, so a fully masked row stays finite);
    probabilities cast to v's type before the product with v.  (A block
    of the query heads over whole k/v reads them through
    ``_kv_for_heads``.)"""
    b, s, h, dd = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, dd)
    scores = torch.einsum("bsngd,btnd->bngst", qg, k).to(torch.float32)
    scores = scores * (dd ** -0.5)
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bngst,btnd->bsngd", probs, v)
    return out.reshape(b, s, h, v.shape[-1])


def _kv_for_heads(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
                  head0: int, heads: int):
    """k/v (B,T,KV,D) for the block of ``heads`` query heads from global
    head ``head0`` (a rank's, the heads cut over the model axis's ranks):
    as they are where the rank holds the block of kv heads its query
    heads read (``heads`` / g of them), else, where it holds every kv
    head (a count M does not divide, the reference's rule), each query
    head's own kv head (global index) // g picked out, one a query head:
    a block need not start on a group's first head."""
    if heads == cfg.padded_heads or k.shape[2] != cfg.n_kv_heads:
        return k, v
    g = cfg.padded_heads // cfg.n_kv_heads
    idx = torch.arange(head0, head0 + heads, device=k.device) // g
    return k.index_select(2, idx), v.index_select(2, idx)


def _prefill_mask(cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """(B,1,1,S,S) mask from (B,S) positions."""
    qp = positions[:, None, None, :, None]
    kp = positions[:, None, None, None, :]
    if not cfg.causal:
        return torch.ones_like(qp == kp)
    mask = kp <= qp
    if cfg.sliding_window > 0:
        mask = mask & (qp - kp < cfg.sliding_window)
    return mask


def _clamp_index(idx, rows: int):
    """``idx`` moved back inside [0, rows), as
    ``jax.lax.dynamic_update_slice`` clamps its start: a Python int, or a
    0-d tensor clamped on its device (no host sync)."""
    if torch.is_tensor(idx):
        return torch.clamp(idx, 0, rows - 1)
    return min(max(int(idx), 0), rows - 1)


def _cache_index(cfg: ModelConfig, t, window: int):
    """The cache row decode step ``t`` writes: ``t % window`` in a sliding
    window's ring buffer, else ``t``, clamped (``_clamp_index``), so a
    step at t ≥ max_seq overwrites the last row as in the reference."""
    return _clamp_index(t % window if cfg.sliding_window > 0 else t, window)


def _attend_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor):
    """A block of the cache's rows' share of ``_attend`` for a decode step:
    q (B, 1, H, D) every query head, k/v (B, n, KV, D) the block's rows,
    ``valid`` (n,) the rows to read.  Returns the block's output left
    unnormalised (B, 1, H, D), its scores' max (B, 1, H) and its sum of
    exponentials (B, 1, H), all f32: the scores made as ``_attend`` makes
    them, their exponentials from the block's own max, 0 on every masked
    row (a block with no row to read gives zeros), cast to v's type
    before the product with v."""
    b, s, h, dd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, dd)
    scores = torch.einsum("bsngd,btnd->bngst", qg, k).to(torch.float32)
    scores = (scores * (dd ** -0.5)).masked_fill(~valid, -1e30)
    top = torch.amax(scores, dim=-1, keepdim=True)
    e = torch.exp(scores - top) * valid
    out = torch.einsum("bngst,btnd->bsngd", e.to(v.dtype), v)

    def heads(x):                                    # (B, KV, G, S) -> (B, S, H)
        return x.permute(0, 3, 1, 2).reshape(b, s, h)
    return (out.to(torch.float32).reshape(b, s, h, v.shape[-1]),
            heads(top[..., 0]), heads(e.sum(-1)))


def _decode_over_ranks(q, k, v, cache: Params, cfg: ModelConfig, t,
                       shards, head0: int) -> torch.Tensor:
    """One decode step's attention where the rank holds block
    ``shards.seq_block`` of the ``seq_blocks`` blocks of the cache's rows
    (``sharding.ModelShards.init_cache``) and, where ``q`` is a block of
    the query heads from global head ``head0``, that block (and of the kv
    heads where they are cut).  The step's query heads, and the new k/v
    row's where they are cut, are gathered over the model group in one
    all-gather; the rank whose block holds row ``_cache_index`` writes the
    row (every rank computes it, whole where the kv heads are whole; a
    0-d tensor ``t`` is read on the host to find that rank);
    each rank attends every head over its rows (``_attend_rows``, the
    rows' mask ``arange(window) <= t`` at the block's global offsets);
    the blocks' partials are rescaled by the largest max over the ranks
    that hold the rows and summed there, in f32, and the sum normalised
    and cast once.  Returns the output (B, 1, heads, D) of the rank's
    query heads."""
    heads, hkv = q.shape[2], k.shape[2]
    if heads != cfg.padded_heads:                    # a block of the heads
        parts = [q, k, v] if hkv != cfg.n_kv_heads else [q]
        whole = shards.gather_heads(torch.cat(parts, dim=2))
        m = shards.model_ranks
        whole = whole.view(*q.shape[:2], m, -1, q.shape[-1])
        q = whole[:, :, :, :heads].reshape(*q.shape[:2], -1, q.shape[-1])
        if len(parts) == 3:
            k = whole[:, :, :, heads:heads + hkv].reshape(
                *k.shape[:2], -1, k.shape[-1])
            v = whole[:, :, :, heads + hkv:].reshape(*k.shape)
    n = cache["k"].shape[1]
    row0 = shards.seq_block * n
    local = _cache_index(cfg, t, n * shards.seq_blocks) - row0
    if 0 <= local < n:
        if cfg.quantized_cache:
            quant_write(cache["k"], cache["k_scale"], k, local)
            quant_write(cache["v"], cache["v_scale"], v, local)
        else:
            _write_at(cache["k"], k, local)
            _write_at(cache["v"], v, local)
    if cfg.quantized_cache:
        ck = dequant(cache["k"], cache["k_scale"], q.dtype)
        cv = dequant(cache["v"], cache["v_scale"], q.dtype)
    else:
        ck, cv = cache["k"], cache["v"]
    valid = row0 + torch.arange(n, device=q.device) <= t
    out, top, total = _attend_rows(q, ck, cv, valid)
    peak = top.clone()
    shards.seq_max_(peak)
    scale = torch.exp(top - peak)        # 0 for a block with no row to read
    merged = torch.cat([out * scale[..., None], (total * scale)[..., None]],
                       dim=-1)
    shards.seq_sum_(merged)
    out = merged[..., :-1] / merged[..., -1:]
    return out[:, :, head0:head0 + heads].to(q.dtype)


def attention_block(x: torch.Tensor, p: Params, cfg: ModelConfig,
                    positions: torch.Tensor, cache: Optional[Params] = None,
                    t=None, head0: int = 0, shards=None
                    ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Dense GQA attention.  Without ``cache``, over the whole sequence:
    the attention kernel when ``use_kernels`` and ``causal`` (positions are
    ``arange`` per row, which the kernel takes as implicit), else the dense
    ``_attend`` under ``_prefill_mask``.  With ``cache``, one decode step:
    x is (B, 1, d) and ``t`` the current position (a Python int or a 0-d
    tensor); the step's k/v are written into the cache in place (at
    ``t % window`` in a sliding window's ring) and the cache is returned.
    ``p`` may hold a block of the query heads from global head ``head0``
    (the model axis over ranks): its output is then that block's partial
    product with ``wo``.  Over the model axis's ranks (``shards``, a
    ``sharding.ModelShards``) the cache is the rank's block of its rows,
    and a decode step merges the blocks' attention over the ranks
    (``_decode_over_ranks``)."""
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        k, v = _kv_for_heads(k, v, cfg, head0, q.shape[2])
        if cfg.use_kernels and cfg.causal:
            out = ops.routed_attention(q, k, v, causal=True,
                                       window=cfg.sliding_window)
        else:
            out = _attend(q, k, v, _prefill_mask(cfg, positions))
    elif shards is not None:
        out = _decode_over_ranks(q, k, v, cache, cfg, t, shards, head0)
    else:
        window = cache["k"].shape[1]
        idx = _cache_index(cfg, t, window)
        if cfg.quantized_cache:
            quant_write(cache["k"], cache["k_scale"], k, idx)
            quant_write(cache["v"], cache["v_scale"], v, idx)
            ck = dequant(cache["k"], cache["k_scale"], q.dtype)
            cv = dequant(cache["v"], cache["v_scale"], q.dtype)
        else:
            _write_at(cache["k"], k, idx)
            _write_at(cache["v"], v, idx)
            ck, cv = cache["k"], cache["v"]
        valid = torch.arange(window, device=x.device) <= t
        out = _attend(q, ck, cv, valid[None, None, None, None, :])
    hm = head_mask(cfg, x.device)
    if hm is not None:
        hm = hm[head0:head0 + out.shape[2]]
        out = out * hm[None, None, :, None].to(out.dtype)
    b, s = x.shape[:2]
    wo = p["wo"]
    y = torch.matmul(out.reshape(b, s, -1), wo.reshape(-1, wo.shape[-1]))
    return y, cache


def attention_cache_shape(cfg: ModelConfig, batch: int, max_seq: int):
    """Cache held per attention layer (sliding-window archs use a ring
    buffer of ``min(max_seq, window)`` rows)."""
    seq = (min(max_seq, cfg.sliding_window) if cfg.sliding_window > 0
           else max_seq)
    hd = cfg.resolved_head_dim
    shapes = {"k": (batch, seq, cfg.n_kv_heads, hd),
              "v": (batch, seq, cfg.n_kv_heads, hd)}
    if cfg.quantized_cache:
        shapes["k_scale"] = (batch, seq)
        shapes["v_scale"] = (batch, seq)
    return shapes


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V2).  The cache holds only the
# compressed latent c_kv (rank r) and the rope key shared by the heads;
# ``absorb=True`` is the weight-absorption decode (q taken into the latent
# space, the cache never decompressed).
# ---------------------------------------------------------------------------

def mla_specs(cfg: ModelConfig) -> Params:
    m = cfg.mla
    d, h, r = cfg.d_model, cfg.n_heads, m.kv_lora_rank
    sd = d ** -0.5
    return {
        "wq": normal(sd, d, h, m.qk_nope_head_dim + m.qk_rope_head_dim),
        "w_dkv": normal(sd, d, r),
        "w_krope": normal(sd, d, m.qk_rope_head_dim),
        "w_uk": normal(r ** -0.5, r, h, m.qk_nope_head_dim),
        "w_uv": normal(r ** -0.5, r, h, m.v_head_dim),
        "wo": normal((h * m.v_head_dim) ** -0.5, h, m.v_head_dim, d),
        "kv_norm": ones(r),
    }


def _mla_attend(q_nope, q_rope, c_kv, k_rope, p: Params,
                mask: torch.Tensor) -> torch.Tensor:
    """The latent decompressed into per-head keys (nope | shared rope) and
    values, then the dense ``_attend``: (B, S, H, v_head_dim)."""
    h = q_nope.shape[2]
    k_nope = _project(c_kv, p["w_uk"])
    v = _project(c_kv, p["w_uv"])
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        -1, -1, h, -1)], dim=-1)
    return _attend(torch.cat([q_nope, q_rope], dim=-1), k, v, mask)


def mla_block(x: torch.Tensor, p: Params, cfg: ModelConfig,
              positions: torch.Tensor, cache: Optional[Params] = None,
              t=None, absorb: bool = False
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """MLA.  Without ``cache``, over the whole sequence through the dense
    ``_attend``, whatever ``use_kernels`` says: the reference never routes
    MLA to the attention kernel (its q/k heads are nope + rope wide, 192
    at published width, v 128).  With ``cache``, one decode step: the
    step's latent and rope key are written in place at row ``t`` (clamped
    as ``dynamic_update_slice`` clamps; int8 with per-position scales
    under ``quantized_cache``), then attended decompressed, or in the
    latent space with ``absorb``."""
    m = cfg.mla
    nope = m.qk_nope_head_dim
    q = _project(x, p["wq"])
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    c_kv = rms_norm(torch.matmul(x, p["w_dkv"]), p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(torch.matmul(x, p["w_krope"])[:, :, None, :],
                        positions, cfg.rope_theta)[:, :, 0]

    if cache is None:
        out = _mla_attend(q_nope, q_rope, c_kv, k_rope, p,
                          _prefill_mask(cfg, positions))
    else:
        seq = cache["c_kv"].shape[1]
        idx = _clamp_index(t, seq)
        if cfg.quantized_cache:
            quant_write(cache["c_kv"], cache["c_kv_scale"], c_kv, idx)
            quant_write(cache["k_rope"], cache["k_rope_scale"], k_rope, idx)
            ck = dequant(cache["c_kv"], cache["c_kv_scale"], x.dtype)
            cr = dequant(cache["k_rope"], cache["k_rope_scale"], x.dtype)
        else:
            _write_at(cache["c_kv"], c_kv, idx)
            _write_at(cache["k_rope"], k_rope, idx)
            ck, cr = cache["c_kv"], cache["k_rope"]
        valid = torch.arange(seq, device=x.device) <= t
        if absorb:
            # score = q_nopeᵀ W_uk c_kv + q_ropeᵀ k_rope, no decompression
            q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])
            scores = (torch.einsum("bshr,btr->bhst", q_lat, ck)
                      + torch.einsum("bshk,btk->bhst", q_rope, cr))
            scores = scores.to(torch.float32) * (
                (nope + m.qk_rope_head_dim) ** -0.5)
            scores = scores.masked_fill(~valid, -1e30)
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            o_lat = torch.einsum("bhst,btr->bshr", probs, ck)
            out = torch.einsum("bshr,rhv->bshv", o_lat, p["w_uv"])
        else:
            out = _mla_attend(q_nope, q_rope, ck, cr, p,
                              valid[None, None, None, None, :])
    b, s = x.shape[:2]
    wo = p["wo"]
    y = torch.matmul(out.reshape(b, s, -1), wo.reshape(-1, wo.shape[-1]))
    return y, cache


def mla_cache_shape(cfg: ModelConfig, batch: int, max_seq: int):
    m = cfg.mla
    shapes = {"c_kv": (batch, max_seq, m.kv_lora_rank),
              "k_rope": (batch, max_seq, m.qk_rope_head_dim)}
    if cfg.quantized_cache:
        shapes["c_kv_scale"] = (batch, max_seq)
        shapes["k_rope_scale"] = (batch, max_seq)
    return shapes


# ---------------------------------------------------------------------------
# SwiGLU MLP and the sort-based top-k MoE
# ---------------------------------------------------------------------------

def mlp_specs(d: int, ff: int) -> Params:
    return {
        "w_gate": normal(d ** -0.5, d, ff),
        "w_in": normal(d ** -0.5, d, ff),
        "w_out": normal(ff ** -0.5, ff, d),
    }


def mlp_block(x: torch.Tensor, p: Params) -> torch.Tensor:
    g = F.silu(torch.matmul(x, p["w_gate"]))
    h = torch.matmul(x, p["w_in"])
    return torch.matmul(g * h, p["w_out"])


def cut_mlp_block(x: torch.Tensor, p: Params, width: int, ctx,
                  pinned: bool) -> torch.Tensor:
    """``mlp_block`` of whole hidden width ``width``; where the rank holds
    a block of its hidden units (the model axis over ranks), between
    Megatron's f and g (``ctx.model_in`` / ``model_out``, in the
    parameters' type where ``pinned``)."""
    if p["w_out"].shape[0] == width:
        return mlp_block(x, p)
    return ctx.model_out(mlp_block(ctx.model_in(x, True), p), True, pinned)


def moe_specs(cfg: ModelConfig) -> Params:
    """The router (kept in f32 whatever the model's type, as the
    reference's), the experts' (E, d, ff) / (E, ff, d) weights and the
    shared experts as one wider MLP."""
    m = cfg.moe
    d, ff, e = cfg.d_model, m.expert_d_ff, m.n_experts
    p: Params = {
        "router": normal(d ** -0.5, d, e, dtype=torch.float32),
        "w_gate": normal(d ** -0.5, e, d, ff),
        "w_in": normal(d ** -0.5, e, d, ff),
        "w_out": normal(ff ** -0.5, e, ff, d),
    }
    if m.n_shared_experts:
        p["shared"] = mlp_specs(d, ff * m.n_shared_experts)
    return p


def moe_capacity(m, tokens_per_group: int) -> int:
    cap = int(tokens_per_group * m.experts_per_token * m.capacity_factor
              / m.n_experts)
    return max(cap, 4)


def moe_block(x: torch.Tensor, p: Params, cfg: ModelConfig,
              ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE block of ``cfg.moe.dispatch``.  Over ranks (``ctx.ranks``)
    grouped dispatch decides each row's drops within the row, so a rank
    dispatches its own rows (over the model axis, its block of them); the
    global dispatch, which decides drops over the whole batch's B·S
    tokens, is refused there."""
    if cfg.moe.dispatch == "grouped":
        return moe_block_grouped(x, p, cfg, ctx)
    if ctx is not None and ctx.ranks is not None:
        raise NotImplementedError(
            "the global MoE dispatch decides drops over the whole batch's "
            "B·S tokens, which no rank holds: over ranks it is refused "
            "(ROADMAP A.8 (v)); take dispatch='grouped'")
    return moe_block_global(x, p, cfg)


def moe_block_grouped(x: torch.Tensor, p: Params, cfg: ModelConfig,
                      ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-batch-row (GShard group) dispatch: a token's expert slots and
    drops are decided within its row, capacity ``moe_capacity(S)`` a
    group.  Returns (y, aux)."""
    return _moe(x, p, cfg, moe_capacity(cfg.moe, x.shape[1]), ctx)


def moe_block_global(x: torch.Tensor, p: Params,
                     cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One dispatch over all B·S tokens, capacity ``moe_capacity(B·S)``.
    Returns (y, aux)."""
    b, s, d = x.shape
    y, aux = _moe(x.reshape(1, b * s, d), p, cfg,
                  moe_capacity(cfg.moe, b * s))
    return y.view(b, s, d), aux


def _route(x: torch.Tensor, router: torch.Tensor, k: int):
    """(probs, gates, experts) of x (G, N, d): the router's softmax in f32,
    each token's top k (ties to the lower expert, as ``jax.lax.top_k``: a
    stable descending sort) and their probabilities renormalised."""
    probs = torch.softmax(torch.matmul(x.to(torch.float32), router), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :k], idx[..., :k]
    return (probs, gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                           min=1e-9), gate_idx)


def _moe(x: torch.Tensor, p: Params, cfg: ModelConfig, cap: int,
         ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing with static per-expert capacity over G groups of N
    tokens, x (G, N, d) -> (y (G, N, d), aux).

    The reference's algorithm: the routing of ``_route``; the Switch
    load-balance loss e·Σ p̄ₑ·fₑ over the first choices; each (token,
    choice) entry takes the next free slot of its expert in token order
    (the position the reference's stable argsort gives it), and an entry
    past ``cap`` is dropped.  Written without a host read (no bincount,
    nonzero or boolean mask), so a decode step stays capturable in a CUDA
    graph:

    * dispatch writes each kept entry into its own row of an
      (E, G·cap, d) buffer, so the expert products are ``torch.bmm``
      over the stored (E, d, ff) weights, which are never copied;
      dropped entries go to one spare row past the buffer;
    * combine gathers each token's k contributions, weighted (0 where
      dropped), and sums them over k in a fixed order: the same bits on
      every run, where an atomic scatter-add would not be.

    Over ranks (``ctx.ranks``) the load-balance statistics p̄ and f are
    the whole batch's means, summed over the ranks in one all-reduce.
    Where the rank holds a block of the experts (the model axis over
    ranks, ``sharding.ModelShards``), it routes and dispatches its block
    of the groups alone, exchanges the buffer so that each rank runs its
    experts on every rank's slots, exchanges the outputs back, combines
    its groups and puts the groups' outputs together; the shared experts
    are a cut MLP."""
    m = cfg.moe
    e, k = m.n_experts, m.experts_per_token
    shards = None if ctx is None else ctx.ranks
    cut = p["w_out"].shape[0] != e            # the rank's block of experts
    xg = shards.own_groups(x) if cut else x
    g, n, d = xg.shape
    probs, gate_vals, gate_idx = _route(xg, p["router"], k)
    experts = torch.arange(e, device=x.device)
    first = (gate_idx[..., :1] == experts).to(torch.float32)
    if shards is not None:
        # the whole batch's means: every rank that holds groups holds as
        # many (over the model axis each rank a block of its data rank's)
        stats = torch.stack([torch.sum(probs, dim=(0, 1)),
                             torch.sum(first, dim=(0, 1))])
        if cut:
            sums = shards.sum_all(stats)
            holders = shards.world * shards.model_ranks
        else:
            sums, holders = ctx.data_sum(stats), shards.world
        me, ce = (sums / (g * n * holders)).unbind()
    else:
        me = torch.mean(probs, dim=(0, 1))
        ce = torch.mean(first, dim=(0, 1))
    aux = e * torch.sum(me * ce)

    ids = gate_idx.reshape(g, n * k)     # entry i: token i // k, choice i % k
    hit = ids[..., None] == experts                            # (G, N·k, E)
    pos = torch.gather(torch.cumsum(hit, dim=1), 2, ids[..., None])[..., 0] - 1
    keep = pos < cap
    group = torch.arange(g, device=x.device)[:, None]
    slot = (ids * g + group) * cap + torch.where(keep, pos, 0)  # (e, g, pos)
    spare = e * g * cap
    buf = xg.new_zeros((spare + 1, d))
    src = xg[:, :, None, :].expand(g, n, k, d).reshape(g * n * k, d)
    buf.index_copy_(0, torch.where(keep, slot, spare).reshape(-1), src)
    xb = buf[:spare].view(e, g * cap, d)
    if ctx is not None:
        # experts over model, groups over the data axes: the reference's
        # constraint on its (G, E, cap, d) buffer (a no-op off a dry-run)
        xb = ctx.cons_spec(xb, (ctx.tp, "dp", None))
    if cut:
        # block j of the experts to rank j; this rank's experts' slots
        # from every rank, laid in the groups' order as one process's
        mr = shards.model_ranks
        xb = shards.exchange(xb).view(mr, e // mr, g * cap, d) \
            .transpose(0, 1).reshape(e // mr, mr * g * cap, d)
    hmid = F.silu(torch.bmm(xb, p["w_gate"])) * torch.bmm(xb, p["w_in"])
    out = torch.bmm(hmid, p["w_out"])
    if cut:
        out = shards.exchange(out.view(e // mr, mr, g * cap, d)
                              .transpose(0, 1).reshape(e, g * cap, d))
    out = out.view(spare, d)

    w = torch.where(keep, gate_vals.reshape(g, n * k), 0.0).to(x.dtype)
    y = (out[slot] * w[..., None]).view(g, n, k, d).sum(dim=2)
    if cut:
        y = shards.all_groups(y)
    if m.n_shared_experts:
        y = y + cut_mlp_block(x, p["shared"],
                              m.expert_d_ff * m.n_shared_experts, ctx,
                              cfg.pin_proj_outputs)
    return y, aux
