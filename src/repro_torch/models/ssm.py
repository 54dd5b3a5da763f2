"""RWKV6 "Finch" time mix and channel mix (data-dependent decay).

Port of the RWKV6 part of ``repro/models/ssm.py``, on the path without a
recurrent state (the loss forward's): the time mix's WKV recurrence goes
through ``kernels/ops.py::routed_wkv6`` (the CUDA kernel on the card, the
sequential plain version on the CPU), as the reference's does with
``use_kernels``.  Mamba2, the chunked form ``wkv6_chunked`` and the
decode step ``wkv6_step`` are not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Leaf, Params, normal, ones

# Clamp on the per-step log decay (the reference's; w >= exp(-3.5)).
_LOG_DECAY_MIN = -3.5


def rwkv6_specs(cfg: ModelConfig) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    hd = cfg.ssm.head_dim
    h = d // hd
    sd = d ** -0.5
    lora = max(32, hd // 2)
    half = Leaf((d,), ("full", 0.5))
    return {
        # time-mix interpolation coefficients (token shift)
        "mu_r": half, "mu_k": half, "mu_v": half, "mu_g": half, "mu_w": half,
        "w_r": normal(sd, d, h, hd),
        "w_k": normal(sd, d, h, hd),
        "w_v": normal(sd, d, h, hd),
        "w_g": normal(sd, d, h, hd),
        "w_o": normal(sd, h, hd, d),
        # data-dependent decay: w = exp(-exp(w0 + tanh(x A) B))
        "w0": Leaf((h, hd), ("linspace", -6.0, -1.0)),
        "w_lora_a": normal(sd, d, lora),
        "w_lora_b": normal(lora ** -0.5, lora, h, hd),
        "u": normal(0.1, h, hd),
        "ln_out": ones(h, hd),
        # channel mix; the reference draws w_r_cm from w_r's key, so the
        # two start equal (transformer.init_params copies it)
        "mu_k_cm": half, "mu_r_cm": half,
        "w_k_cm": normal(sd, d, ff),
        "w_v_cm": normal(ff ** -0.5, ff, d),
        "w_r_cm": normal(sd, d, d),
    }


def _token_shift(x: torch.Tensor) -> torch.Tensor:
    """x shifted one step later in time, zero at t = 0."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def rwkv6_time_mix(x: torch.Tensor, p: Params,
                   cfg: ModelConfig) -> torch.Tensor:
    """RWKV6 attention replacement.  x: (B, T, D) -> (B, T, D)."""
    b, t, d = x.shape
    hd = cfg.ssm.head_dim
    h = d // hd
    delta = _token_shift(x) - x
    x_r, x_k = x + delta * p["mu_r"], x + delta * p["mu_k"]
    x_v, x_g = x + delta * p["mu_v"], x + delta * p["mu_g"]
    x_w = x + delta * p["mu_w"]

    def heads(a, w):                           # (B,T,D) x (D,H,K) -> (B,T,H,K)
        return torch.matmul(a, w.reshape(d, h * hd)).view(b, t, h, hd)

    r = heads(x_r, p["w_r"])
    k = heads(x_k, p["w_k"])
    v = heads(x_v, p["w_v"])
    g = F.silu(heads(x_g, p["w_g"]))

    lora = torch.matmul(torch.tanh(torch.matmul(x_w, p["w_lora_a"])),
                        p["w_lora_b"].reshape(-1, h * hd)).view(b, t, h, hd)
    lw = -torch.exp(torch.clamp(p["w0"].to(torch.float32)
                                + lora.to(torch.float32), max=1.2528))
    lw = torch.clamp(lw, _LOG_DECAY_MIN, -1e-6)          # exp(1.2528) = 3.5

    o = ops.routed_wkv6(r, k, v, lw, p["u"])

    # per-head group norm, gate, out proj
    o32 = o.to(torch.float32)
    mu = torch.mean(o32, dim=-1, keepdim=True)
    var = torch.var(o32, dim=-1, keepdim=True, unbiased=False)
    o = ((o32 - mu) * torch.rsqrt(var + 64e-5)
         * p["ln_out"].to(torch.float32)).to(x.dtype)
    return torch.matmul((o * g).reshape(b, t, h * hd),
                        p["w_o"].reshape(h * hd, d))


def rwkv6_channel_mix(x: torch.Tensor, p: Params) -> torch.Tensor:
    """RWKV6 FFN (relu² channel mix)."""
    delta = _token_shift(x) - x
    x_k = x + delta * p["mu_k_cm"]
    x_r = x + delta * p["mu_r_cm"]
    k = torch.square(F.relu(torch.matmul(x_k, p["w_k_cm"])))
    kv = torch.matmul(k, p["w_v_cm"])
    r = torch.sigmoid(torch.matmul(x_r, p["w_r_cm"]))
    return r * kv
