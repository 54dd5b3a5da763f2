"""The port's phase-finish math against the JAX package's, on the same
seeded numpy inputs: design matrix and triangle order, the quadratic fit
on and off the gram route, the robust fit, the MAD guard, the Newton
direction and the alpha clip.

Tolerances: the design matrix and ``unpack`` are elementwise f32 products
and copies, so they agree bit for bit.  g, H and d come out of an f32
normal-equations solve and an f32 eigendecomposition done by different
LAPACK calls in a different summation order; they agree within rtol/atol
1e-3 (the conditioning of the 45-column fit amplifies f32 rounding).  The
MAD mask is a comparison against a median computed by the same formula on
the same values, so it must agree exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import regression as jreg
from repro.core import sampling as jsamp
from repro_torch.core import regression as reg
from repro_torch.core import sampling as samp

# the reference functions jitted whole: one compile per shape instead of
# one per primitive keeps these tests fast
_jfit = jax.jit(jreg.fit_quadratic, static_argnames=("use_kernel",))
_jrobust = jax.jit(jreg.fit_quadratic_robust)
_jmad = jax.jit(jreg.mad_outlier_weights)


def _random_quadratic(rng, n):
    A = rng.normal(size=(n, n))
    H = (A + A.T) / 2
    g = rng.normal(size=n)
    c = float(rng.normal())
    return c, g, H


def _quadratic_samples(seed, n, m):
    rng = np.random.default_rng(seed)
    c, g, H = _random_quadratic(rng, n)
    d = rng.uniform(-1, 1, (m, n))
    ys = c + d @ g + 0.5 * np.einsum("mi,ij,mj->m", d, H, d)
    return d.astype(np.float32), ys.astype(np.float32), (c, g, H)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.asarray(a))


def _close(got, want, tol=1e-3):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("n", [3, 8])
def test_triu_order_matches(n):
    iu_j, ju_j = jnp.triu_indices(n, k=1)
    iu_t, ju_t = torch.triu_indices(n, n, 1)
    assert np.array_equal(np.asarray(iu_j), iu_t.numpy())
    assert np.array_equal(np.asarray(ju_j), ju_t.numpy())


@pytest.mark.parametrize("n", [3, 8])
def test_design_matrix_and_unpack_bit_equal(n):
    rng = np.random.default_rng(n)
    d = rng.uniform(-1, 1, (37, n)).astype(np.float32)
    jd, td = _both(d)
    assert np.array_equal(np.asarray(jreg.design_matrix(jd)),
                          reg.design_matrix(td).numpy())
    assert reg.design_matrix(td).shape == (37, reg.n_columns(n))
    beta = rng.normal(size=reg.n_columns(n)).astype(np.float32)
    jb, tb = _both(beta)
    for a, b in zip(jreg.unpack(jb, n), reg.unpack(tb, n)):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("n,m,use_kernel", [
    (3, 40, None), (5, 60, False), (5, 60, True),
    (8, 800, None),      # m·cols = 36,000: the auto route takes the gram path
    (8, 800, False),
])
def test_fit_quadratic_matches(n, m, use_kernel):
    d, ys, (c, g, H) = _quadratic_samples(10 * n + m, n, m)
    jd, td = _both(d)
    jy, ty = _both(ys)
    want = _jfit(jd, jy, use_kernel=use_kernel)
    got = reg.fit_quadratic(td, ty, use_kernel=use_kernel)
    for a, b in zip(got, want):
        _close(b, a)
    _close(got[1], g, 5e-3)                    # and both recover the truth
    _close(got[2], H, 5e-3)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_weights_drop_samples(use_kernel):
    """tests/test_regression.py::test_weights_drop_samples on both packages:
    weight-0 samples must not influence the fit."""
    rng = np.random.default_rng(3)
    n = 4
    c, g, H = _random_quadratic(rng, n)
    m = reg.n_columns(n) + 20
    d = rng.uniform(-1, 1, (m, n))
    ys = c + d @ g + 0.5 * np.einsum("mi,ij,mj->m", d, H, d)
    ys_bad = ys.copy()
    ys_bad[:5] = 1e6
    w = np.ones(m)
    w[:5] = 0.0
    args = [a.astype(np.float32) for a in (d, ys_bad, w)]
    want = _jfit(*(jnp.asarray(a) for a in args), use_kernel=use_kernel)
    got = reg.fit_quadratic(*(torch.from_numpy(a) for a in args),
                            use_kernel=use_kernel)
    for a, b in zip(got, want):
        _close(a, b)
    _close(got[1], g, 5e-3)


@pytest.mark.parametrize("n,m", [(4, 120), (8, 800)])
def test_fit_quadratic_robust_matches_with_corruption(n, m):
    d, ys, (c, g, H) = _quadratic_samples(m, n, m)
    rng = np.random.default_rng(m + 1)
    bad = rng.choice(m, m // 20, replace=False)
    ys = ys.copy()
    ys[bad] -= (np.abs(ys[bad]) + 1.0) * rng.uniform(0.2, 0.8, bad.size)
    jd, td = _both(d)
    jy, ty = _both(ys.astype(np.float32))
    want = _jrobust(jd, jy)
    got = reg.fit_quadratic_robust(td, ty)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("m", [199, 200, 1000, 1001])
def test_mad_outlier_weights_equal(m):
    """Odd and even lengths (the median of an even count averages the two
    middle values), a NaN and a 1e5 outlier: the masks agree exactly."""
    rng = np.random.default_rng(m)
    ys = rng.normal(0, 1, m).astype(np.float32)
    ys[7] = 1e5
    ys[m // 2] = np.nan
    jy, ty = _both(ys)
    want = np.asarray(_jmad(jy))
    got = reg.mad_outlier_weights(ty).numpy()
    assert np.array_equal(got, want)
    assert got[7] == 0.0 and got[m // 2] == 0.0 and got.sum() >= m - 10


@pytest.mark.parametrize("ys", [
    [1.0, 2.0, 3.0, 4.0],                        # even: midpoint 2.5
    [np.nan, 1.0, 2.0, np.nan, 4.0],             # nanmedian over 3 values
    [np.nan, np.nan, 5.0, 7.0],                  # nanmedian over 2 values
    [np.nan, np.nan],                            # nothing finite
])
def test_mad_outlier_weights_small_cases(ys):
    ys = np.asarray(ys, np.float32)
    jy, ty = _both(ys)
    assert np.array_equal(reg.mad_outlier_weights(ty).numpy(),
                          np.asarray(_jmad(jy)))


@pytest.mark.parametrize("seed,pd", [(0, True), (1, False), (2, False)])
def test_newton_direction_matches(seed, pd):
    rng = np.random.default_rng(seed)
    n = 8
    A = rng.normal(size=(n, n))
    H = A @ A.T + n * np.eye(n) if pd else (A + A.T) / 2
    g = rng.normal(size=n)
    jg, tg = _both(g.astype(np.float32))
    jH, tH = _both(H.astype(np.float32))
    want = np.asarray(jreg.newton_direction(jg, jH, 1e-3))
    got = reg.newton_direction(tg, tH, 1e-3).numpy()
    _close(got, want)
    assert float(got @ g) < 0.0                  # a descent direction


@pytest.mark.parametrize("seed", range(6))
def test_clip_alpha_range_matches(seed):
    rng = np.random.default_rng(seed)
    n = 8
    lo = rng.uniform(-5, -1, n).astype(np.float32)
    hi = rng.uniform(1, 5, n).astype(np.float32)
    center = rng.uniform(-1, 1, n).astype(np.float32)
    d = rng.normal(0, 2, n).astype(np.float32)
    if seed == 5:
        d[:] = 0.0                               # degenerate: range (0, 0)
    j = jsamp.clip_alpha_range(*(jnp.asarray(a) for a in (center, d, lo, hi)),
                               0.0, 3.0)
    t = samp.clip_alpha_range(*(torch.from_numpy(a)
                                for a in (center, d, lo, hi)), 0.0, 3.0)
    for a, b in zip(t, j):
        assert float(a) == float(b)


@pytest.mark.parametrize("seed", [0, 1])
def test_samplers_stay_in_their_box_and_on_their_line(seed):
    """The torch samplers draw other numbers than jax.random, so they are
    held to the reference tests' properties, not to its values."""
    gen = torch.Generator().manual_seed(seed)
    center = torch.tensor([1.0, -2.0, 0.5])
    step = torch.tensor([0.1, 0.2, 0.3])
    pts = samp.sample_box(gen, center, step, 128)
    assert pts.shape == (128, 3)
    assert bool(torch.all(torch.abs(pts - center) <= step + 1e-6))
    direction = torch.tensor([0.5, -1.0, 2.0])
    lo, hi = torch.full((3,), -5.0), torch.full((3,), 5.0)
    a_lo, a_hi = samp.clip_alpha_range(center, direction, lo, hi, 0.0, 3.0)
    pts, alphas = samp.sample_line(gen, center, direction, a_lo, a_hi, 64)
    assert bool(torch.all((alphas >= a_lo) & (alphas <= a_hi)))
    assert bool(torch.all((pts >= lo - 1e-4) & (pts <= hi + 1e-4)))
    assert torch.allclose(pts, center + alphas[:, None] * direction)
