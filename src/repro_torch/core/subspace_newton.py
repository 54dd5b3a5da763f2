"""ANM lifted to neural-network training: Newton's method in a k-dim subspace.

Port of ``repro/core/subspace_newton.py`` (DESIGN.md §2).  A "function
evaluation" is a minibatch loss at θ + V·c; the m sample evaluations are
independent (any m of M suffice: dropped samples get weight 0, as a
failed volunteer's do), the regression of paper §III recovers the k-dim
gradient and Hessian, and the randomized line search of §IV picks the
step.  The basis V puts the momentum first and random directions after
it, so the method degrades to random-subspace descent when the quadratic
model is poor.

The geometry is ``core/subspace.py``'s: a fresh ``SubspaceProjection``
each step, anchored on the momentum, and the same per-leaf ``tree_lift``
the LM-loss backend uses.  Where the reference splits one jax key into
basis, box and line keys, the port draws all three from one
``torch.Generator`` in that order; ``subspace_newton_step_at`` takes the
basis and the draws as given (the seam through which the tests carry the
reference's draws across), and ``subspace_newton_step`` draws them and
calls it.

Memory, at published width: the step holds one (k, P) f32 basis and no
second one, evaluates the m + p candidates and the anchor one after
another into one preallocated lifted copy under ``no_grad``, and the
info it returns stays on the device (no host read of the step's values).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core import regression
from repro_torch.core.parallel_line_search import require_device
from repro_torch.core.subspace import SubspaceProjection, orthonormal_basis
from repro_torch.core.tree import leaves_with_paths, map_tree


@dataclasses.dataclass(frozen=True)
class SubspaceNewtonConfig:
    k: int = 8                       # subspace dimension
    m: Optional[int] = None          # samples; default 2 * n_columns(k)
    sample_scale: float = 0.05       # box half-width in subspace coords
    alpha_max: float = 2.0
    p_line: int = 16                 # line-search candidates
    damping: float = 1e-4
    ridge: float = 1e-6
    momentum: float = 0.9

    def m_resolved(self) -> int:
        return self.m or 2 * regression.n_columns(self.k)


def _n_params(params: Any) -> int:
    return sum(leaf.numel() for _, leaf in leaves_with_paths(params))


def init_state(params: Any) -> Dict[str, torch.Tensor]:
    """A zero (P,) f32 momentum on the parameters' device and step 0."""
    device = leaves_with_paths(params)[0][1].device
    return {"momentum": torch.zeros(_n_params(params), dtype=torch.float32,
                                    device=device),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def make_basis(generator: torch.Generator, flat_params: torch.Tensor,
               momentum: torch.Tensor, k: int) -> torch.Tensor:
    """(k, P) orthonormal basis: momentum + random directions."""
    return orthonormal_basis(flat_params.shape[0], k, generator,
                             flat_params.device, anchor=momentum)


def draw(generator: torch.Generator, params: Any, momentum: torch.Tensor,
         cfg: SubspaceNewtonConfig, device):
    """(basis (k, P), box coefficients (m, k), line scales (p,)) from
    ``generator``, in that order: the basis's k − 1 normal rows, then
    U[−s, s) box draws, then U[0, alpha_max) scales."""
    basis = orthonormal_basis(_n_params(params), cfg.k, generator, device,
                              anchor=momentum)
    s = cfg.sample_scale
    u = torch.rand((cfg.m_resolved(), cfg.k), generator=generator,
                   device=device, dtype=torch.float32)
    coeffs = -s + u * (2.0 * s)
    alphas = torch.rand((cfg.p_line,), generator=generator, device=device,
                        dtype=torch.float32) * cfg.alpha_max
    return basis, coeffs, alphas


def subspace_newton_step_at(loss_fn: Callable, params: Any, state: dict,
                            cfg: SubspaceNewtonConfig, basis: torch.Tensor,
                            coeffs: torch.Tensor, alphas: torch.Tensor,
                            completed_mask: Optional[torch.Tensor] = None):
    """One subspace-Newton step at a given basis (k, P), box coefficients
    (m, k) and line scales (p,).  Returns (new_params, new_state, info);
    info's values are 0-d tensors on the device."""
    proj = SubspaceProjection.from_basis(params, basis)
    with torch.no_grad():
        work = map_tree(torch.empty_like, params)

        def eval_at(cs: torch.Tensor) -> torch.Tensor:
            out = torch.empty(cs.shape[0], dtype=torch.float32,
                              device=cs.device)
            for i, c in enumerate(cs):
                out[i] = loss_fn(proj.lift(c, out=work))
            return out

        ys = eval_at(coeffs)
        weights = (None if completed_mask is None
                   else completed_mask.to(torch.float32))
        _, g, H = regression.fit_quadratic(coeffs, ys, weights, cfg.ridge)
        d = regression.newton_direction(g, H, cfg.damping)        # (k,)

        # randomized line search (paper §IV) over p candidates
        f_cand = eval_at(alphas[:, None] * d[None, :])
        del work
        f0 = loss_fn(params)
        best = torch.argmin(f_cand)
        take = f_cand[best] < f0
        alpha_best = torch.where(take, alphas[best],
                                 torch.zeros_like(alphas[best]))

        delta_flat = proj.shift_flat(alpha_best * d)
        flat = proj.flat0                    # made fresh: updated in place
        flat += delta_flat
        new_params = proj.unravel(flat)
        del flat
        mom = state["momentum"] * cfg.momentum
        mom += delta_flat
        info = {"loss_before": f0,
                "loss_after": torch.minimum(f_cand[best], f0),
                "alpha": alpha_best, "grad_norm": torch.linalg.norm(g)}
    return new_params, {"momentum": mom, "step": state["step"] + 1}, info


def subspace_newton_step(loss_fn: Callable, params: Any, state: dict,
                         cfg: SubspaceNewtonConfig,
                         generator: torch.Generator,
                         completed_mask: Optional[torch.Tensor] = None,
                         *, device="cuda"):
    """One ANM step in a k-dim subspace.

    loss_fn: params -> 0-d loss tensor (a closure over the minibatch).
    generator: draws the basis, the box and the line, in that order (a
    generator on ``device``).  completed_mask: optional (m,) bool, the
    sample evaluations that returned (first-m-of-M semantics); dropped
    samples get weight 0 in the regression.  Runs on ``device``, where
    every parameter must lie.  Returns (new_params, new_state, info).
    """
    device = require_device(params, device)
    basis, coeffs, alphas = draw(generator, params, state["momentum"], cfg,
                                 device)
    return subspace_newton_step_at(loss_fn, params, state, cfg, basis,
                                   coeffs, alphas, completed_mask)
