"""Point sampling for ANM (paper §III box sampling and §IV eq. (6) line
sampling).  Port of ``repro/core/sampling.py``; the samplers take an
explicit ``torch.Generator`` in place of a jax key."""
from __future__ import annotations

from typing import Tuple

import torch


def sample_box(gen: torch.Generator, center: torch.Tensor, step: torch.Tensor,
               m: int) -> torch.Tensor:
    """m random points uniform in the box center ± step (paper: x' ± s)."""
    n = center.shape[0]
    u = torch.rand((m, n), generator=gen, dtype=center.dtype,
                   device=center.device) * 2.0 - 1.0
    return center[None, :] + u * step[None, :]


def clip_alpha_range(center: torch.Tensor, direction: torch.Tensor,
                     lo: torch.Tensor, hi: torch.Tensor,
                     alpha_min: float, alpha_max: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shrink [alpha_min, alpha_max] so every x' + α d stays inside [lo, hi]
    (paper §IV: bounds 'increased or decreased so no point along the
    directional line could be outside the search space')."""
    d = direction
    safe = torch.where(torch.abs(d) > 1e-30, d, torch.full_like(d, 1e-30))
    t_lo = (lo - center) / safe
    t_hi = (hi - center) / safe
    inf = torch.full_like(d, float("inf"))
    upper = torch.where(d > 0, t_hi, torch.where(d < 0, t_lo, inf))
    lower = torch.where(d > 0, t_lo, torch.where(d < 0, t_hi, -inf))
    a_hi = torch.clamp_max(torch.min(upper), alpha_max)
    a_lo = torch.clamp_min(torch.max(lower), alpha_min)
    # degenerate (direction points straight out of the box): collapse to 0
    a_hi = torch.clamp_min(a_hi, 0.0)
    a_lo = torch.minimum(torch.clamp_min(a_lo, 0.0), a_hi)
    return a_lo, a_hi


def sample_line(gen: torch.Generator, center: torch.Tensor,
                direction: torch.Tensor, alpha_min, alpha_max, m: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paper eq. (6): x = x' + (α_min + r·(α_max − α_min)) d,  r ~ U[0,1).

    Returns (points (m,n), alphas (m,))."""
    r = torch.rand((m,), generator=gen, dtype=center.dtype,
                   device=center.device)
    alphas = alpha_min + r * (alpha_max - alpha_min)
    return center[None, :] + alphas[:, None] * direction[None, :], alphas
