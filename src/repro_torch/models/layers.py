"""Transformer layers: norms, RoPE, GQA / sliding-window attention, SwiGLU.

Port of the parts of ``repro/models/layers.py`` the LM-loss workload runs
(the prefill path without a cache).  Everything is a plain function over
a dict of parameter tensors, as in the reference; the compute type
follows the parameters (bf16 by default), norm statistics and RoPE are
computed in f32 and cast back, as there.  MLA, MoE, decode, the int8
cache and the attention options no ported config uses (qkv bias,
qk-norm, pad heads) are not ported; ``models/transformer.py`` refuses
configurations that ask for them.

Each ``*_specs`` function describes its parameters as ``Leaf``s (shape
and how the reference initialises it); ``models/transformer.py`` turns
them into tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

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
        p["bias"] = Leaf((d,), ("full", 0.0))
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
# GQA attention with a causal / sliding-window mask (prefill, no cache)
# ---------------------------------------------------------------------------

def attention_specs(cfg: ModelConfig) -> Params:
    d, hq, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    sd = d ** -0.5
    return {
        "wq": normal(sd, d, hq, hd),
        "wk": normal(sd, d, hkv, hd),
        "wv": normal(sd, d, hkv, hd),
        "wo": normal((hq * hd) ** -0.5, hq, hd, d),
    }


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,d...->bs...") as one matrix product: (B, S, d) times
    (d, *out) -> (B, S, *out), contiguous."""
    b, s, d = x.shape
    out = w.shape[1:]
    return torch.matmul(x, w.reshape(d, -1)).view(b, s, *out)


def attention_block(x: torch.Tensor, p: Params, cfg: ModelConfig,
                    positions: torch.Tensor) -> torch.Tensor:
    """Dense GQA attention over the whole sequence (the loss forward's
    case): positions are ``arange`` per row, which the attention kernel
    takes as implicit."""
    q = apply_rope(_project(x, p["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_project(x, p["wk"]), positions, cfg.rope_theta)
    v = _project(x, p["wv"])
    out = ops.routed_attention(q, k, v, causal=cfg.causal,
                               window=cfg.sliding_window)
    b, s = x.shape[:2]
    wo = p["wo"]
    return torch.matmul(out.reshape(b, s, -1),
                        wo.reshape(-1, wo.shape[-1]))


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
