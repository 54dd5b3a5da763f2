"""Plain PyTorch versions of the port's kernels (the correctness ground truth).

Copies of ``repro/kernels/ref.py``: each is the simplest implementation
of its kernel's function — full-materialization attention, an O(T)
sequential scan for WKV6, a plain matmul for the gram product.  ``ops``
takes these only for tensors on the CPU; on the card the kernels are
held against them by ``chip_smoke.py``.
"""
from __future__ import annotations

import torch


def attention_ref(q, k, v, causal: bool = True, window: int = 0):
    """q, k, v: (B, H, S, D) (same H — GQA expansion happens in ops.py).
    Returns (B, H, S, D).  As the reference: the scores are made in the
    inputs' type and then widened to f32, the probabilities are cast back
    to v's type before the product with v."""
    s, d = q.shape[2], q.shape[3]
    t = k.shape[2]
    scores = torch.einsum("bhsd,bhtd->bhst", q, k).to(torch.float32)
    scores = scores * (d ** -0.5)
    if causal:
        qp = torch.arange(s, device=q.device)[:, None]
        kp = torch.arange(t, device=q.device)[None, :]
        mask = kp <= qp
        if window > 0:
            mask = mask & (qp - kp < window)
        scores = scores.masked_fill(~mask, -1e30)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bhtd->bhsd", p, v)


def flash_attention_ref(q, k, v, causal: bool = True, window: int = 0):
    """``ops.flash_attention``'s function in plain torch, in the model's
    layout: q (B, S, Hq, D), k/v (B, S, Hkv, D) -> (B, S, Hq, D).  k/v are
    repeated per query head (head h reads kv head h // (Hq / Hkv)), as the
    reference's routed CPU leg does, then ``attention_ref``."""
    g = q.shape[2] // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2)


def wkv6_ref(r, k, v, lw, u, s0=None):
    """Sequential RWKV6 recurrence (the semantics definition).

    r, k, v, lw: (B, T, H, K); u: (H, K).  Returns (o (B, T, H, K) in r's
    type, s (B, H, K, K) f32):
      o_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ);  S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
    """
    b, t, h, kk = r.shape
    f32 = torch.float32
    r_, k_, v_, lw_ = (a.to(f32) for a in (r, k, v, lw))
    s = (torch.zeros((b, h, kk, kk), dtype=f32, device=r.device)
         if s0 is None else s0.to(f32))
    u_ = u.to(f32)[..., :, None]
    out = []
    for i in range(t):
        kv = k_[:, i, :, :, None] * v_[:, i, :, None, :]
        out.append(torch.einsum("bhk,bhkv->bhv", r_[:, i], s + u_ * kv))
        s = torch.exp(lw_[:, i])[..., None] * s + kv
    o = torch.stack(out, dim=1) if out else torch.zeros_like(r_)
    return o.to(r.dtype), s


def gram_ref(x: torch.Tensor, y: torch.Tensor):
    """X: (m, c), y: (m,) -> (XᵀX (c,c) f32, Xᵀy (c,) f32)."""
    x32 = x.to(torch.float32)
    return x32.T @ x32, x32.T @ y.to(torch.float32)
