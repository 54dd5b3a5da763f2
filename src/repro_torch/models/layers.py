"""Transformer layers: norms, RoPE, GQA / sliding-window / bidirectional
attention with its KV cache (ring-buffered for a sliding window, int8
with per-position scales), SwiGLU.

Port of ``repro/models/layers.py`` less MLA and MoE (ROADMAP.md A.5;
``models/transformer.py`` refuses configurations that ask for them).
Everything is a plain function over a dict of parameter tensors, as in
the reference; the compute type follows the parameters (bf16 by
default), norm statistics, RoPE and softmax are computed in f32 and cast
back, as there.  Where the reference returns an updated cache, the port
writes the cache in place and returns it (a decode step then moves one
row per layer, not the whole cache).

Each ``*_specs`` function describes its parameters as ``Leaf``s (shape
and how the reference initialises it); ``models/transformer.py`` turns
them into tensors.
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
    """One parameter: its shape and its initialisation, one of
    ("normal", std), ("full", value), ("linspace", start, stop)."""
    shape: Tuple[int, ...]
    init: tuple


def ones(*shape: int) -> Leaf:
    return Leaf(tuple(shape), ("full", 1.0))


def zeros(*shape: int) -> Leaf:
    return Leaf(tuple(shape), ("full", 0.0))


def normal(std: float, *shape: int) -> Leaf:
    return Leaf(tuple(shape), ("normal", std))


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
    probabilities cast to v's type before the product with v."""
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


def _cache_index(cfg: ModelConfig, t, window: int):
    """The cache row decode step ``t`` writes: ``t % window`` in a sliding
    window's ring buffer, else ``t``; moved back inside [0, window), as
    ``jax.lax.dynamic_update_slice`` clamps its start, so a step at
    t ≥ max_seq overwrites the last row as in the reference."""
    idx = t % window if cfg.sliding_window > 0 else t
    if torch.is_tensor(idx):
        return torch.clamp(idx, 0, window - 1)
    return min(max(int(idx), 0), window - 1)


def attention_block(x: torch.Tensor, p: Params, cfg: ModelConfig,
                    positions: torch.Tensor, cache: Optional[Params] = None,
                    t=None) -> Tuple[torch.Tensor, Optional[Params]]:
    """Dense GQA attention.  Without ``cache``, over the whole sequence:
    the attention kernel when ``use_kernels`` and ``causal`` (positions are
    ``arange`` per row, which the kernel takes as implicit), else the dense
    ``_attend`` under ``_prefill_mask``.  With ``cache``, one decode step:
    x is (B, 1, d) and ``t`` the current position (a Python int or a 0-d
    tensor); the step's k/v are written into the cache in place (at
    ``t % window`` in a sliding window's ring) and the cache is returned."""
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
        if cfg.use_kernels and cfg.causal:
            out = ops.routed_attention(q, k, v, causal=True,
                                       window=cfg.sliding_window)
        else:
            out = _attend(q, k, v, _prefill_mask(cfg, positions))
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
# SwiGLU MLP
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
