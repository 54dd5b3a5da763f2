"""The port's engine and synchronous driver against the JAX package's.

Both engines draw their points with numpy ``default_rng``, so from one
seed (or one restored state) they hand out bit-identical blocks; they
part only where the f32 phase finish (fit, eigh, solve) rounds
differently.  Tolerances are stated per test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core.anm import anm_minimize as j_anm_minimize
from repro.data import sdss as jsdss
from repro_torch import convert
from repro_torch.core import engine
from repro_torch.core.anm import AnmConfig, anm_minimize
from repro_torch.data import sdss
from repro_torch.launch import fig2

N = 6


def _quad(seed=0, n=N):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    H = A @ A.T + n * np.eye(n)
    x_opt = rng.uniform(-0.5, 0.5, n)

    def f_np(xs):
        d = np.asarray(xs, np.float64) - x_opt
        return 0.5 * np.einsum("mi,ij,mj->m", d, H, d)

    return f_np, H, x_opt


def _drive(eng, f_np, n_calls):
    """Feed an engine (of either package) n_calls generate/assimilate
    rounds of f_np."""
    for _ in range(n_calls):
        reqs = eng.generate()
        if not reqs:
            break
        ys = f_np(np.stack([r.point for r in reqs]))
        eng.assimilate([engine.EvalResult(r, float(y))
                        for r, y in zip(reqs, ys)])


def _ref_engine(cfg_kw, seed=11):
    return jengine.AnmEngine(np.ones(N), -10 * np.ones(N), 10 * np.ones(N),
                             0.5 * np.ones(N), jengine.AnmConfig(**cfg_kw),
                             seed=seed)


@pytest.mark.parametrize("calls,phase", [
    (1, "validating"),        # bootstrap f(x0) in; its quorum pending
    (3, "linesearch"),        # regression finished: a direction is set
    (4, "validating"),        # line search finished: a candidate in quorum
    (5, "regression"),        # one iteration committed
])
def test_reference_state_continues_bitwise_in_port(calls, phase):
    """A reference engine's state_dict() loads into the port engine, whose
    next requests are the reference engine's own, bit for bit."""
    f_np, _, _ = _quad()
    ref = _ref_engine(dict(m_regression=40, m_line_search=40,
                           max_iterations=5))
    _drive(ref, f_np, calls)
    assert ref.phase == phase
    port = convert.engine_from_state(ref.state_dict(), device="cpu")
    assert port.phase == ref.phase and port.iteration == ref.iteration
    if ref.phase in (engine.REGRESSION, engine.LINESEARCH):
        a, b = ref.generate_block(17), port.generate_block(17)
        assert a[1] == b[1]
        for x, y in zip((a[0], a[2], a[3]), (b[0], b[2], b[3])):
            assert np.array_equal(x, y, equal_nan=True)
    ra, pa = ref.generate(3), port.generate(3)
    assert [(r.ticket, r.phase_id, r.validates) for r in ra] == \
        [(r.ticket, r.phase_id, r.validates) for r in pa]
    assert all(np.array_equal(x.point, y.point) for x, y in zip(ra, pa))
    assert ref.state_dict()["rng_state"] == port.state_dict()["rng_state"]


def test_port_state_round_trips_into_reference():
    """The layout is shared both ways: a port state loads into the
    reference engine with the same next block."""
    f_np, _, _ = _quad()
    cfg = dict(m_regression=40, m_line_search=40, max_iterations=5)
    port = engine.AnmEngine(np.ones(N), -10 * np.ones(N), 10 * np.ones(N),
                            0.5 * np.ones(N), engine.AnmConfig(**cfg),
                            seed=11, device="cpu")
    _drive(port, f_np, 3)
    assert port.phase == engine.LINESEARCH
    ref = _ref_engine(cfg, seed=0)
    ref.load_state(port.state_dict())
    a, b = ref.generate_block(9), port.generate_block(9)
    assert np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])


@pytest.mark.parametrize("name,seed,start_seed,engine_seed", fig2.STRIPES)
def test_first_regression_direction_on_sdss(name, seed, start_seed,
                                            engine_seed):
    """m = 800 gives m·cols = 36,000: the gram route is live.  The same
    points and fitness values go into both phase finishes; the directions
    agree to cosine ≥ 0.999 and the alpha range to 1e-3 relative (f32
    solves of a 45-column fit in different summation orders)."""
    stripe = sdss.make_stripe(name, n_stars=5_000, seed=seed)
    x0 = fig2.start_point(stripe, start_seed)
    cfg = dict(m_regression=800, m_line_search=800, max_iterations=3)
    ref = jengine.AnmEngine(x0, sdss.LO, sdss.HI, sdss.DEFAULT_STEP,
                            jengine.AnmConfig(**cfg), seed=engine_seed)
    port = engine.AnmEngine(x0, sdss.LO, sdss.HI, sdss.DEFAULT_STEP,
                            engine.AnmConfig(**cfg), seed=engine_seed,
                            device="cpu")
    ref.set_initial_fitness(0.0)
    port.set_initial_fitness(0.0)
    blk_ref, blk_port = ref.generate_block(), port.generate_block()
    assert np.array_equal(blk_ref[2], blk_port[2])
    jf, _ = jsdss.make_fitness(stripe)
    ys = np.asarray(jf(jnp.asarray(blk_ref[2], jnp.float32)), np.float64)
    k = len(ys)
    for eng in (ref, port):
        eng.assimilate_arrays(np.full(k, eng.phase_id), blk_ref[0],
                              blk_ref[2], blk_ref[3], np.full(k, -1), ys)
        assert eng.phase == engine.LINESEARCH
    d_ref, d_port = ref.direction, port.direction
    cos = d_ref @ d_port / (np.linalg.norm(d_ref) * np.linalg.norm(d_port))
    assert cos >= 0.999, cos
    np.testing.assert_allclose(port.alpha_range, ref.alpha_range, rtol=1e-3)
    assert len(port.phase_finish_s) == 1


def test_degenerate_fit_gives_zero_direction():
    """An infinite fitness poisons the normal equations (0·inf = NaN): both
    engines turn the non-finite direction into a zero one with alpha range
    (0, 0), then re-sample the center."""
    f_np, _, _ = _quad()
    cfg = dict(m_regression=40, m_line_search=40, max_iterations=3)
    ref = _ref_engine(cfg)
    port = engine.AnmEngine(np.ones(N), -10 * np.ones(N), 10 * np.ones(N),
                            0.5 * np.ones(N), engine.AnmConfig(**cfg),
                            seed=11, device="cpu")
    for eng in (ref, port):
        eng.set_initial_fitness(100.0)
        tk, ph, pts, al = eng.generate_block()
        ys = f_np(pts)
        ys[3] = np.inf
        eng.assimilate_arrays(np.full(len(ys), ph), tk, pts, al,
                              np.full(len(ys), -1), ys)
        assert eng.phase == engine.LINESEARCH
        assert np.array_equal(eng.direction, np.zeros(N))
        assert eng.alpha_range == (0.0, 0.0)
    assert np.array_equal(ref.generate_block(5)[2], port.generate_block(5)[2])


def test_anm_converges_on_quadratic_in_few_iterations():
    """tests/test_sampling_and_anm.py's 6-D quadratic through the port's
    driver, with the seed the reference derives from jax.random.key(1)."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(N, N))
    H = A @ A.T + N * np.eye(N)
    x_opt = rng.uniform(-0.5, 0.5, N)
    Ht = torch.tensor(H, dtype=torch.float32)
    xt = torch.tensor(x_opt, dtype=torch.float32)

    def f_batch(xs):
        d = xs - xt[None, :]
        return 0.5 * torch.einsum("mi,ij,mj->m", d, Ht, d)

    x0 = x_opt + rng.uniform(-1, 1, N)
    seed = int(jax.random.randint(jax.random.key(1), (), 0, 2**31 - 1))
    state = anm_minimize(
        f_batch, x0, lo=-10 * np.ones(N), hi=10 * np.ones(N),
        step=0.5 * np.ones(N),
        cfg=AnmConfig(m_regression=120, m_line_search=200, max_iterations=8,
                      alpha_max=1.5),
        seed=seed, device="cpu")
    f0 = float(f_batch(torch.tensor(x0, dtype=torch.float32)[None])[0])
    assert state.best_fitness < 1e-2 * f0
    assert state.history[2].best_fitness < 0.2 * f0
    assert state.center.dtype == torch.float32 and state.iteration == 8


def test_small_sdss_run_matches_reference():
    """The Fig. 2 setting cut to 5k stars and 4 iterations at m = 800 (the
    gram route live on the CPU plain path).  The port's launch code and the
    reference's driver, same stripe, start and seed, end within 1e-3
    relative of each other's final fitness."""
    name, seed, start_seed, engine_seed = fig2.STRIPES[0]
    assert engine_seed == int(jax.random.randint(jax.random.key(seed), (),
                                                 0, 2**31 - 1))
    port = fig2.run_stripe(name, seed, start_seed, engine_seed,
                           n_stars=5_000, m=800, iters=4, device="cpu")
    stripe = jsdss.make_stripe(name, n_stars=5_000, seed=seed)
    jf, jfs = jsdss.make_fitness(stripe)
    x0 = fig2.start_point(stripe, start_seed)
    ref = j_anm_minimize(jf, x0, jsdss.LO, jsdss.HI, jsdss.DEFAULT_STEP,
                         jengine.AnmConfig(m_regression=800,
                                           m_line_search=800,
                                           max_iterations=4),
                         jax.random.key(seed))
    assert port["start_fitness"] == pytest.approx(float(jfs(x0)), rel=2e-5)
    assert port["iterations"] == ref.iteration == 4
    assert port["final_fitness"] == pytest.approx(ref.best_fitness, rel=1e-3)
    assert port["final_fitness"] < port["start_fitness"]
    assert port["peak_device_bytes"] is None              # a CPU run
