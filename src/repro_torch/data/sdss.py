"""Synthetic SDSS-like star catalogs + the 8-parameter stream MLE (paper §VI).

Port of ``repro/data/sdss.py``.  ``make_stripe`` is the reference's numpy
code unchanged, so a seed gives byte-identical stars and quadrature in both
packages.  The likelihood takes a batch of parameter rows at once, the
batch dimension written out where the reference ``vmap``s:

    params = [eps, cx, cy, cz, theta, phi, sigma, q]
    pdf = (1-w)·bg(x; q)/Z_bg + w·stream(x; c, axis, sigma)/Z_stream

Normalization constants are Monte-Carlo quadratures over the survey wedge
with a quadrature set fixed per dataset.  The three means over stars and
quadrature points are ``kernels/ops.py::row_mean``, which sums each row in
one fixed order: with every other step elementwise, a row's fitness is a
function of its own parameters alone, whatever the batch around it (the
reference's coalesced == solo and restored == uninterrupted contracts).
Memory: a batch of k rows over
N stars holds a few (k, N) f32 intermediates at once (k = 2048, N = 100k:
about 0.8 GB each).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch.kernels import ops

N_PARAMS = 8
# search-space bounds (paper: user-specified b_min/b_max)
LO = np.array([-6.0, -4.0, -4.0, -4.0, 0.0, -3.2, -3.0, 0.3], np.float32)
HI = np.array([2.0, 4.0, 4.0, 4.0, 3.2, 3.2, 1.0, 1.6], np.float32)
DEFAULT_STEP = 0.1 * (HI - LO)

WEDGE_LO = np.array([-5.0, -5.0, -5.0], np.float32)
WEDGE_HI = np.array([5.0, 5.0, 5.0], np.float32)


@dataclasses.dataclass(frozen=True)
class Stripe:
    name: str
    stars: np.ndarray          # (n_stars, 3)
    quad: np.ndarray           # (n_quad, 3) fixed quadrature points
    truth: np.ndarray          # (8,) generating parameters


def _axis(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """(k,), (k,) -> (k, 3) unit stream axes."""
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    return torch.stack([st * cp, st * sp, ct], dim=1)


def _bg_density(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Flattened-halo power-law background: x (N, 3), q (k,) -> (k, N)."""
    r2 = x[:, 0] ** 2 + x[:, 1] ** 2 + (x[None, :, 2] / q[:, None]) ** 2
    return (r2 + 0.25) ** -1.5


def _stream_density(x: torch.Tensor, center: torch.Tensor, axis: torch.Tensor,
                    sigma: torch.Tensor) -> torch.Tensor:
    """Gaussian tube around the line {center + t·axis}: x (N, 3),
    center/axis (k, 3), sigma (k,) -> (k, N)."""
    rel = [x[None, :, j] - center[:, j, None] for j in range(3)]
    along = (rel[0] * axis[:, 0, None] + rel[1] * axis[:, 1, None]
             + rel[2] * axis[:, 2, None])
    perp2 = rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2] - along ** 2
    return torch.exp(-0.5 * perp2 / (sigma ** 2)[:, None])


def log_likelihood(params: torch.Tensor, stars: torch.Tensor,
                   quad: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood per parameter row (LOWER is better — a
    fitness): params (k, 8) -> (k,)."""
    eps, cx, cy, cz, theta, phi, lsig, q = params.unbind(dim=1)
    w = torch.sigmoid(eps)
    sigma = torch.exp(lsig)
    center = torch.stack([cx, cy, cz], dim=1)
    axis = _axis(theta, phi)
    vol = float(np.prod(WEDGE_HI - WEDGE_LO))

    z_bg = ops.row_mean(_bg_density(quad, q)) * vol
    z_st = ops.row_mean(_stream_density(quad, center, axis, sigma)) * vol

    p_bg = _bg_density(stars, q) / torch.clamp_min(z_bg, 1e-12)[:, None]
    p_st = (_stream_density(stars, center, axis, sigma)
            / torch.clamp_min(z_st, 1e-12)[:, None])
    pdf = (1.0 - w)[:, None] * p_bg + w[:, None] * p_st
    return -ops.row_mean(torch.log(torch.clamp_min(pdf, 1e-30)))


def make_stripe(name: str, n_stars: int = 100_000, n_quad: int = 4096,
                seed: int = 0) -> Stripe:
    rng = np.random.default_rng(seed)
    # ground truth (perturbed per stripe)
    truth = np.array([
        rng.uniform(-1.5, -0.5),                     # eps (w ~ 0.2-0.4)
        *rng.uniform(-1.0, 1.0, 3),                  # stream center
        rng.uniform(0.8, 2.2), rng.uniform(-1.5, 1.5),  # theta, phi
        np.log(rng.uniform(0.3, 0.6)),               # log sigma
        rng.uniform(0.6, 1.1),                       # q
    ], np.float32)
    w = 1.0 / (1.0 + np.exp(-truth[0]))
    center, sigma, q = truth[1:4], float(np.exp(truth[6])), float(truth[7])
    th, ph = truth[4], truth[5]
    axis = np.array([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)])

    n_st = int(n_stars * w)
    n_bg = n_stars - n_st
    # stream stars: along the axis, Gaussian tube around it
    t = rng.uniform(-4, 4, n_st)
    e1 = np.cross(axis, [0.0, 0.0, 1.0])
    if np.linalg.norm(e1) < 1e-6:
        e1 = np.cross(axis, [0.0, 1.0, 0.0])
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(axis, e1)
    rad = rng.normal(0, sigma, (n_st, 2))
    st = center + t[:, None] * axis + rad[:, :1] * e1 + rad[:, 1:] * e2
    # background stars: rejection-sample the flattened halo in the wedge
    bg = []
    while sum(len(b) for b in bg) < n_bg:
        cand = rng.uniform(WEDGE_LO, WEDGE_HI, (4 * n_bg + 1024, 3))
        r2 = cand[:, 0] ** 2 + cand[:, 1] ** 2 + (cand[:, 2] / q) ** 2
        dens = (r2 + 0.25) ** -1.5
        keep = rng.random(len(cand)) < dens / dens.max()
        bg.append(cand[keep])
    bg = np.concatenate(bg)[:n_bg]
    stars = np.concatenate([st, bg]).astype(np.float32)
    stars = np.clip(stars, WEDGE_LO, WEDGE_HI)
    rng.shuffle(stars)
    quad = rng.uniform(WEDGE_LO, WEDGE_HI, (n_quad, 3)).astype(np.float32)
    return Stripe(name=name, stars=stars, quad=quad, truth=truth)


def stripe79(n_stars: int = 100_000) -> Stripe:
    return make_stripe("stripe79", n_stars, seed=79)


def stripe86(n_stars: int = 112_000) -> Stripe:
    return make_stripe("stripe86", n_stars, seed=86)


def make_fitness(stripe, device="cuda"):
    """Returns (f_batch (k,8)->(k,), f_single (8,)->0-d tensor) over the
    stripe's stars and quadrature, held on ``device``.  Either function
    takes a tensor or an array; results are f32 tensors on ``device``.
    ``stripe`` is a port ``Stripe`` or anything with the same ``stars``
    and ``quad`` arrays (a reference ``Stripe`` included)."""
    stars, quad = convert.stripe_tensors(stripe, device)

    def f_batch(ps):
        ps = torch.as_tensor(ps, dtype=torch.float32, device=stars.device)
        return log_likelihood(ps, stars, quad)

    def f_single(p):
        return f_batch(torch.as_tensor(p, dtype=torch.float32,
                                       device=stars.device)[None])[0]

    return f_batch, f_single
