"""Randomized parallel line search along any update direction (paper §IV,
applied to LM training).

Port of ``repro/core/parallel_line_search.py``.  After an optimizer
proposes an update Δθ, p candidate step scales are evaluated and the
best-loss candidate wins.  Like the paper's line search there are no
sequential dependencies, any subset of candidate results suffices, and
scales > 1 let training escape shallow basins.

The candidates are evaluated one after another into one working set of
parameters, as the reference's ``lax.map`` evaluates them; the scales
are drawn from an explicit ``torch.Generator`` in place of a jax key,
and ``line_search_at`` takes them as given (the seam the tests carry the
reference's draws through).  Nothing is read back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core.tree import leaves_with_paths, map_tree


@dataclasses.dataclass(frozen=True)
class LineSearchConfig:
    p: int = 8
    alpha_min: float = 0.25
    alpha_max: float = 2.0
    include_unit: bool = True        # always test α=1 (plain optimizer step)


def require_device(params: Any, device) -> torch.device:
    """``device`` as a ``torch.device``, after checking that every leaf of
    ``params`` lies on it: the CPU runs only when the caller asks for it."""
    device = torch.device(device)
    for path, leaf in leaves_with_paths(params):
        if leaf.device.type != device.type or (
                device.index is not None and leaf.device != device):
            raise RuntimeError(f"parameter {path} lies on {leaf.device}, "
                               f"the step runs on {device}")
    return device


def apply_update(params: Any, update_tree: Any, alpha: torch.Tensor,
                 out: Optional[Any] = None) -> Any:
    """(p.f32 + α·u.f32) cast to p's type, leaf by leaf, written into
    ``out`` (a new tree if None), which is returned."""
    def step(p, u, dst):
        x = u.to(torch.float32) * alpha
        x += p
        dst.copy_(x)
    if out is None:
        out = map_tree(torch.empty_like, params)
    map_tree(step, params, update_tree, out)
    return out


def line_search_at(loss_fn: Callable, params: Any, update_tree: Any,
                   alphas: torch.Tensor,
                   completed_mask: Optional[torch.Tensor] = None):
    """The line search at given scales ``alphas`` (p,) f32: returns
    (best_params, best_alpha, best_loss), the last two 0-d tensors.  A
    candidate outside ``completed_mask`` scores +inf; ties go to the
    first minimum."""
    with torch.no_grad():
        work = map_tree(torch.empty_like, params)
        losses = torch.empty(alphas.shape[0], dtype=torch.float32,
                             device=alphas.device)
        for i, alpha in enumerate(alphas):
            losses[i] = loss_fn(apply_update(params, update_tree, alpha,
                                             out=work))
        del work
        if completed_mask is not None:
            losses = torch.where(completed_mask, losses,
                                 torch.full_like(losses, float("inf")))
        best = torch.argmin(losses)
        alpha_best = alphas[best]
        return (apply_update(params, update_tree, alpha_best), alpha_best,
                losses[best])


def randomized_line_search(loss_fn: Callable, params: Any, update_tree: Any,
                           generator: torch.Generator,
                           cfg: LineSearchConfig = LineSearchConfig(),
                           completed_mask: Optional[torch.Tensor] = None,
                           *, device="cuda"):
    """Returns (best_params, best_alpha, best_loss).

    loss_fn: params -> 0-d loss tensor (a closure over the evaluation
    minibatch).  update_tree: a tree of deltas shaped like params (the
    optimizer's step, sign and learning rate included).  generator: draws
    the p scales, uniform in [alpha_min, alpha_max), α₀ = 1 when
    ``include_unit``.  completed_mask: optional (p,) bool, the candidates
    that "returned" (first-m-of-M straggler semantics).  Runs on
    ``device``, where every parameter must lie.
    """
    device = require_device(params, device)
    r = torch.rand((cfg.p,), generator=generator, device=device,
                   dtype=torch.float32)
    alphas = cfg.alpha_min + r * (cfg.alpha_max - cfg.alpha_min)
    if cfg.include_unit:
        alphas[0] = 1.0
    return line_search_at(loss_fn, params, update_tree, alphas,
                          completed_mask)
