"""Regression-based gradient + Hessian estimation (paper §III, eq. 4–5).

Port of ``repro/core/regression.py``.  The quadratic surrogate is fit in
coordinates centered at x',
    f(x' + δ) ≈ c + g·δ + ½ δᵀ H δ,
by least squares over m sampled points, with the correct triangular
layout for the off-diagonal terms.

The normal-equations product XᵀX / Xᵀy is the dense hot spot; once the
design matrix reaches ``GRAM_KERNEL_MIN_ELEMENTS`` it goes through
``kernels.ops.gram`` (the hand-written CUDA kernel on the card, its plain
version on the CPU), the same route decision as the reference's.

Parity notes.  ``jnp.median``/``jnp.nanmedian`` average the two middle
values, as ``(low + high) * 0.5``; ``torch.median`` returns the lower one,
and ``torch.quantile``'s midpoint is a lerp that can differ in the last
bit.  ``_median``/``_nanmedian`` below compute the reference's formula on
a sorted copy, so the MAD masks agree exactly.  ``torch.triu_indices`` and
``jnp.triu_indices`` list the upper triangle in the same order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops

# m·cols threshold above which the fused XᵀX/Xᵀy kernel is used (the
# reference's threshold, so both packages route the same fits).
GRAM_KERNEL_MIN_ELEMENTS = 32768


def n_columns(n: int) -> int:
    """1 (const) + n (grad) + n (diag) + n(n-1)/2 (off-diag)."""
    return 1 + 2 * n + (n * (n - 1)) // 2


def min_points(n: int) -> int:
    """Minimum evaluations for the regression to be determined."""
    return n_columns(n)


def design_matrix(deltas: torch.Tensor) -> torch.Tensor:
    """deltas: (m, n) points relative to the center.  Returns X (m, cols)."""
    m, n = deltas.shape
    iu, ju = torch.triu_indices(n, n, 1, device=deltas.device)
    cols = [torch.ones((m, 1), dtype=deltas.dtype, device=deltas.device),
            deltas, 0.5 * deltas * deltas, deltas[:, iu] * deltas[:, ju]]
    return torch.cat(cols, dim=1)


def unpack(beta: torch.Tensor, n: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """beta (cols,) -> (c, gradient (n,), Hessian (n,n))  [paper eq. (5)].
    H is built exactly symmetric (``eigh`` reads one triangle)."""
    c = beta[0]
    g = beta[1:n + 1]
    h_diag = beta[n + 1:2 * n + 1]
    h_off = beta[2 * n + 1:]
    iu, ju = torch.triu_indices(n, n, 1, device=beta.device)
    H = torch.zeros((n, n), dtype=beta.dtype, device=beta.device)
    H[iu, ju] = h_off
    H = H + H.T
    H = H + torch.diag(h_diag)
    return c, g, H


def fit_quadratic(deltas: torch.Tensor, ys: torch.Tensor,
                  weights: Optional[torch.Tensor] = None, ridge: float = 1e-8,
                  use_kernel: Optional[bool] = None):
    """Weighted least squares via normal equations (paper eq. 4).

    deltas: (m, n); ys: (m,); weights: (m,) non-negative, 0 drops a sample.
    ``use_kernel=None`` routes XᵀX/Xᵀy through ``ops.gram`` when
    m·cols ≥ GRAM_KERNEL_MIN_ELEMENTS (f32 fits only; the kernel sums in
    f32), with √w folded into X and y.  Returns (c, g (n,), H (n,n)).
    """
    m, n = deltas.shape
    x = design_matrix(deltas.to(torch.float64)
                      if deltas.dtype == torch.float64
                      else deltas.to(torch.float32))
    y = ys.to(x.dtype)
    if use_kernel is None:
        use_kernel = (x.dtype == torch.float32
                      and x.shape[0] * x.shape[1] >= GRAM_KERNEL_MIN_ELEMENTS)
    if use_kernel:
        if weights is not None:
            sw = torch.sqrt(torch.clamp_min(weights.to(x.dtype), 0.0))
            xk, yk = x * sw[:, None], y * sw
        else:
            xk, yk = x, y
        gram, rhs = ops.gram(xk.to(torch.float32).contiguous(),
                             yk.to(torch.float32).contiguous())
        gram = gram.to(x.dtype)
        rhs = rhs.to(x.dtype)
    else:
        xw = x * weights.to(x.dtype)[:, None] if weights is not None else x
        gram = xw.T @ x                               # (cols, cols)
        rhs = xw.T @ y
    # scale-aware ridge keeps the solve stable when columns differ in magnitude
    diag = torch.diagonal(gram)
    lam = ridge * torch.clamp_min(torch.max(diag), 1.0)
    eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
    # solve_ex: a singular or non-finite system yields inf/NaN, as the
    # reference's solve does, instead of raising (and without a host sync)
    beta = torch.linalg.solve_ex(gram + lam * eye, rhs)[0]
    return unpack(beta, n)


def fit_quadratic_robust(deltas: torch.Tensor, ys: torch.Tensor,
                         ridge: float = 1e-8,
                         use_kernel: Optional[bool] = None):
    """Two-pass robust fit: value-MAD guard -> fit -> residual-MAD guard ->
    refit.  The residual pass catches lies that stay inside the natural
    spread of the sampled values but sit far off the local quadratic."""
    w = mad_outlier_weights(ys)
    c, g, H = fit_quadratic(deltas, ys, w, ridge, use_kernel)
    pred = c + deltas @ g + \
        0.5 * torch.einsum("mi,ij,mj->m", deltas, H, deltas)
    w2 = w * mad_outlier_weights(ys - pred)
    return fit_quadratic(deltas, ys, w2, ridge, use_kernel)


def _median(a: torch.Tensor) -> torch.Tensor:
    """``jnp.median``: the mean of the two middle values, (lo + hi) * 0.5."""
    s = torch.sort(a.reshape(-1)).values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _nanmedian(a: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian``: the median of the non-NaN values (NaN if none),
    without a host round trip for the count."""
    s = torch.sort(a.reshape(-1)).values          # NaN sorts last
    cnt = torch.sum(~torch.isnan(s))
    last = s.numel() - 1
    lo = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), 0, last)
    hi = torch.clamp(torch.div(cnt, 2, rounding_mode="floor"), 0, last)
    med = (s[lo] + s[hi]) * 0.5
    return torch.where(cnt > 0, med, torch.full_like(med, float("nan")))


def mad_outlier_weights(ys: torch.Tensor, k: float = 8.0) -> torch.Tensor:
    """Median-absolute-deviation outlier mask — drops malicious/corrupt
    fitness values before the fit (0/1 weights)."""
    finite = torch.isfinite(ys)
    nan = torch.full_like(ys, float("nan"))
    safe = torch.where(finite, ys, _nanmedian(torch.where(finite, ys, nan)))
    med = _median(safe)
    mad = _median(torch.abs(safe - med)) + 1e-12
    ok = torch.abs(safe - med) <= k * 1.4826 * mad
    return (finite & ok).to(ys.dtype)


def newton_direction(g: torch.Tensor, H: torch.Tensor,
                     damping: float = 1e-6) -> torch.Tensor:
    """d = -(H + λI)⁻¹ g  (paper eq. 3), with eigenvalue-shift damping so the
    direction is a descent direction even for indefinite H.

    A non-finite g or H (a fit poisoned by an infinite sample) gives a
    NaN direction, as the reference's ``eigh`` does; ``torch.linalg.eigh``
    raises on such input, so it is given the identity instead and its
    result masked, without a host round trip."""
    bad = ~(torch.isfinite(H).all() & torch.isfinite(g).all())
    H = torch.where(bad, torch.eye(H.shape[0], dtype=H.dtype,
                                   device=H.device), H)
    evals, evecs = torch.linalg.eigh(H)
    lam = torch.clamp_min(damping - torch.min(evals), damping)
    inv = 1.0 / (evals + lam)
    d = -(evecs * inv[None, :]) @ (evecs.T @ g)
    return torch.where(bad, torch.full_like(d, float("nan")), d)
