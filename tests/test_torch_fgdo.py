"""The port's FGDO adapter (``repro_torch/core/fgdo.py``) on the CPU.

The reference's tests/test_fgdo.py, port against port (asynchrony, fault
tolerance, validation, determinism, the reliable-host gates), then
ROADMAP A.1's two gates port against reference on the same seeds: the
synchronous driver and the FGDO adapter reach the same center, and a
first candidate worse than the start is not committed.  The engines run
their phase finish on the CPU (``device="cpu"``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.anm import AnmConfig as JAnmConfig
from repro.core.anm import anm_minimize as j_anm_minimize
from repro.core.fgdo import FgdoAnmServer as JFgdoAnmServer
from repro.core.grid import GridConfig as JGridConfig
from repro.core.grid import VolunteerGrid as JVolunteerGrid
from repro_torch.core.anm import AnmConfig, anm_minimize
from repro_torch.core.fgdo import FgdoAnmServer as _PortFgdo
from repro_torch.core.grid import GridConfig, VolunteerGrid

#: the port's adapter with its engine on the CPU
FgdoAnmServer = functools.partial(_PortFgdo, device="cpu")


def _quad_problem(n=4, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    H = A @ A.T + n * np.eye(n)
    x_opt = rng.uniform(-0.5, 0.5, n)

    def f(x):
        d = np.asarray(x, np.float64) - x_opt
        return float(0.5 * d @ H @ d)

    return f, x_opt, n


def _run(f, n, grid_cfg, anm_cfg=None, seed=1):
    server = FgdoAnmServer(
        x0=np.ones(n), lo=-10 * np.ones(n), hi=10 * np.ones(n),
        step=0.5 * np.ones(n),
        cfg=anm_cfg or AnmConfig(m_regression=80, m_line_search=80,
                                 max_iterations=6),
        seed=seed)
    grid = VolunteerGrid(f, grid_cfg)
    grid.run(server)
    return server, grid


def test_converges_on_reliable_grid():
    f, x_opt, n = _quad_problem()
    server, _ = _run(f, n, GridConfig(n_hosts=32, failure_prob=0.0,
                                      malicious_prob=0.0, seed=2))
    assert server.best_fitness < 1e-2 * f(np.ones(n))
    assert server.iteration >= 3


def test_fault_tolerance_failures_and_malice():
    """20% of results never return + 10% malicious hosts: still converges,
    stale results are discarded, corrupted candidates rejected by quorum."""
    f, x_opt, n = _quad_problem(seed=3)
    server, grid = _run(f, n, GridConfig(n_hosts=48, failure_prob=0.2,
                                         malicious_prob=0.1, seed=5))
    assert server.best_fitness < 5e-2 * f(np.ones(n))
    assert grid.stats.failed > 0
    assert grid.stats.corrupted > 0
    # malicious "best" line-search results must have been caught at least once
    # (they under-report fitness by 20-80%, far outside validation rtol)
    assert server.stats.validations_failed >= 1


def test_determinism():
    f, _, n = _quad_problem(seed=7)
    cfg = GridConfig(n_hosts=24, failure_prob=0.1, malicious_prob=0.05, seed=9)
    s1, _ = _run(f, n, cfg, seed=11)
    s2, _ = _run(f, n, cfg, seed=11)
    assert s1.best_fitness == s2.best_fitness
    assert [r.best_fitness for r in s1.history] == \
        [r.best_fitness for r in s2.history]
    np.testing.assert_array_equal(s1.center, s2.center)


def test_phase_advances_on_first_m_results():
    """The server must never wait for stragglers: with heterogeneity spread
    over 100x speeds, iterations still complete (stale > 0 proves late
    results arrived after phase advance and were dropped, not blocking)."""
    f, _, n = _quad_problem(seed=8)
    server, grid = _run(f, n, GridConfig(n_hosts=64, speed_sigma=1.5,
                                         failure_prob=0.05,
                                         malicious_prob=0.0, seed=13))
    assert server.done
    assert server.stats.stale > 0
    assert server.best_fitness < 0.1 * f(np.ones(n))


def test_malicious_best_rejected():
    """A malicious result that would win the line search must be caught by
    quorum validation and the next-best candidate promoted (paper §V /
    FGDO validation-reduction)."""
    calls = {"n": 0}

    def f(x):
        return float(np.sum(np.asarray(x) ** 2))

    server = FgdoAnmServer(x0=np.ones(2), lo=-5 * np.ones(2), hi=5 * np.ones(2),
                           step=0.3 * np.ones(2),
                           cfg=AnmConfig(m_regression=30, m_line_search=30,
                                         max_iterations=1),
                           seed=1, validation_quorum=2)
    # drive manually: bootstrap f(x0), then regression with honest results
    now = 0.0
    while server.phase in ("bootstrap", "regression"):
        wu = server.generate_work(0, now)
        server.assimilate(wu, f(wu.point), 0, now)
        now += 1
    # line-search phase: honest results, then one lying "perfect" result
    wus = [server.generate_work(0, now + i) for i in range(29)]
    lie_wu = server.generate_work(0, now + 30)
    for i, wu in enumerate(wus):
        server.assimilate(wu, f(wu.point), 0, now + i)
    server.assimilate(lie_wu, -1000.0, 666, now + 31)      # malicious winner
    assert server.validating
    # quorum re-evaluations return the TRUTH for the lying point
    while server.validating and not server.done:
        wu = server.generate_work(1, now)
        if wu is None:
            break
        server.assimilate(wu, f(wu.point), 1, now)
        now += 1
    assert server.stats.validations_failed >= 1
    # committed fitness must be a real value, not the lie
    assert server.history[-1].best_fitness > -100.0


def test_new_host_cold_start_grace():
    """The return-rate gate must NOT exclude a brand-new host: with 1
    issued / 0 returned it sits at a 0% return rate it never had a chance
    to improve, so the gate only engages after ``min_issued_for_rate``
    (default 4) issues.  Regression pin for the reliable-host cold start:
    below the threshold the host keeps receiving work (validation work
    included), at the threshold with nothing returned it stops."""
    def f(x):
        return float(np.sum(np.asarray(x) ** 2))

    server = FgdoAnmServer(x0=np.ones(2), lo=-5 * np.ones(2),
                           hi=5 * np.ones(2), step=0.3 * np.ones(2),
                           cfg=AnmConfig(m_regression=30, m_line_search=30,
                                         max_iterations=1),
                           seed=1, validation_quorum=2)
    now = 0.0
    worker, rookie, blackhole = 1, 42, 66
    # drive to the LINE-SEARCH validation (the bootstrap probe has its own
    # earlier quorum round, during which the rookies aren't fed yet)
    while not (server.validating and not server.engine.bootstrapping):
        # the rookie picks up 3 workunits it hasn't returned YET; the
        # black hole grabs 5 and will never return any
        if server.phase in ("regression", "linesearch"):
            if server._host_issued.get(rookie, 0) < 3:
                server.generate_work(rookie, now)
            if server._host_issued.get(blackhole, 0) < 5:
                server.generate_work(blackhole, now)
        wu = server.generate_work(worker, now)
        if wu is not None:
            server.assimilate(wu, f(wu.point), worker, now + 1.0)
        now += 1
    assert server._host_issued[rookie] == 3
    assert server._host_returned.get(rookie, 0) == 0
    assert server._host_issued[blackhole] == 5
    # 3 issued / 0 returned is INSIDE the grace window: the rookie stays
    # eligible and actually receives a validation replica ...
    assert server._host_returns(rookie)
    assert server.generate_work(rookie, now) is not None
    # ... while 5 issued / 0 returned is past it: gate engaged
    assert not server._host_returns(blackhole)
    assert server.generate_work(blackhole, now) is None


def test_vanishing_fast_host_loses_reliable_status():
    """A host that takes work and never returns must stop receiving
    latency-critical validation replicas.  Turnaround tracking alone is
    failure-blind: a vanishing host records NO turnaround, so it stayed
    'reliable' forever before the return-rate guard."""
    def f(x):
        return float(np.sum(np.asarray(x) ** 2))

    server = FgdoAnmServer(x0=np.ones(2), lo=-5 * np.ones(2),
                           hi=5 * np.ones(2), step=0.3 * np.ones(2),
                           cfg=AnmConfig(m_regression=30, m_line_search=30,
                                         max_iterations=1),
                           seed=1, validation_quorum=2)
    now = 0.0
    black_hole = 0                 # the fast host that drops everything
    workers = [1, 2, 3, 4]
    # interleave: the black hole grabs work instantly and never returns it;
    # honest workers complete the phases
    while server.phase in ("bootstrap", "regression"):
        server.generate_work(black_hole, now)              # vanishes
        h = workers[int(now) % len(workers)]
        wu = server.generate_work(h, now)
        if wu is not None:
            server.assimilate(wu, f(wu.point), h, now + 1.0)
        now += 1
    while server.phase == "linesearch" and not server.validating:
        server.generate_work(black_hole, now)              # vanishes
        h = workers[int(now) % len(workers)]
        wu = server.generate_work(h, now)
        if wu is not None:
            server.assimilate(wu, f(wu.point), h, now + 1.0)
        now += 1
    assert server.validating
    assert server._host_issued[black_hole] >= 4
    assert server._host_returned.get(black_hole, 0) == 0
    # the black hole is refused validation work; a returning host is not
    assert not server._host_reliable(black_hole)
    assert server.generate_work(black_hole, now) is None
    assert server.generate_work(workers[0], now) is not None


# -- ROADMAP A.1: port against reference on the same seeds ----------------

def _engine_quad(seed):
    """tests/test_engine.py's seeded convex quadratic: f (float64 numpy)
    for the per-event grid and the f32 batch form for the sync drivers."""
    f, x_opt, n = _quad_problem(seed=seed)
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    H = A @ A.T + n * np.eye(n)
    h32, x32 = H.astype(np.float32), x_opt.astype(np.float32)

    def f_batch_j(xs):
        d = xs - jnp.asarray(x32)[None, :]
        return 0.5 * jnp.einsum("mi,ij,mj->m", d, jnp.asarray(h32), d)

    def f_batch_t(xs):
        d = xs - torch.from_numpy(x32)[None, :]
        return 0.5 * torch.einsum("mi,ij,mj->m", d, torch.from_numpy(h32), d)

    return f, f_batch_j, f_batch_t, x_opt, n


def test_sync_and_fgdo_reach_same_center_as_the_reference():
    """tests/test_engine.py::test_sync_and_fgdo_reach_same_center in both
    packages: each package's sync driver and FGDO adapter reach x_opt, and
    the port's FGDO center and fitness track the reference's on the same
    seeds (f is float64 numpy in both; only the f32 phase finish differs,
    so the centers agree to the convergence tolerance)."""
    f, fb_j, fb_t, x_opt, n = _engine_quad(42)
    box = (np.ones(n), -10 * np.ones(n), 10 * np.ones(n), 0.5 * np.ones(n))
    kw = dict(m_regression=80, m_line_search=80, max_iterations=8)
    grid = dict(n_hosts=32, failure_prob=0.0, malicious_prob=0.0, seed=2)
    j_state = j_anm_minimize(fb_j, *box, JAnmConfig(**kw),
                             key=jax.random.key(0))
    j_server = JFgdoAnmServer(*box, JAnmConfig(**kw), seed=1)
    JVolunteerGrid(f, JGridConfig(**grid)).run(j_server)
    seed = int(jax.random.randint(jax.random.key(0), (), 0, 2**31 - 1))
    state = anm_minimize(fb_t, *box, AnmConfig(**kw), seed=seed,
                         device="cpu")
    server = FgdoAnmServer(*box, AnmConfig(**kw), seed=1)
    VolunteerGrid(f, GridConfig(**grid)).run(server)
    f0 = f(np.ones(n))
    for center, best in ((np.asarray(state.center, np.float64),
                          state.best_fitness),
                         (server.center, server.best_fitness),
                         (np.asarray(j_state.center, np.float64),
                          j_state.best_fitness),
                         (j_server.center, j_server.best_fitness)):
        np.testing.assert_allclose(center, x_opt, atol=5e-2)
        assert best < 1e-3 * f0
    np.testing.assert_allclose(server.center, j_server.center, atol=5e-2)
    assert server.iteration == j_server.iteration
    assert abs(server.best_fitness - j_server.best_fitness) <= 1e-3 * f0


def test_first_candidate_worse_than_start_is_not_committed_in_both():
    """tests/test_engine.py::test_first_candidate_worse_than_start_is_not_
    committed through the FGDO adapter of both packages: started AT the
    optimum, neither moves its center nor commits a worse fitness, and
    both see the same first fitness f(x0)."""
    f, _, _, x_opt, n = _engine_quad(21)
    f0 = f(x_opt)
    lo, hi, step = -10 * np.ones(n), 10 * np.ones(n), 0.5 * np.ones(n)
    kw = dict(m_regression=40, m_line_search=40, max_iterations=3)
    grid = dict(n_hosts=16, failure_prob=0.0, malicious_prob=0.0, seed=2)
    j_server = JFgdoAnmServer(x_opt.copy(), lo, hi, step, JAnmConfig(**kw),
                              seed=1)
    JVolunteerGrid(f, JGridConfig(**grid)).run(j_server)
    server = FgdoAnmServer(x_opt.copy(), lo, hi, step, AnmConfig(**kw),
                           seed=1)
    VolunteerGrid(f, GridConfig(**grid)).run(server)
    for s in (server, j_server):
        assert s.best_fitness <= f0 + 1e-12
        np.testing.assert_array_equal(s.center, x_opt)
        assert all(r.best_fitness <= f0 + 1e-12 for r in s.history)
    assert server.history[0].best_fitness == j_server.history[0].best_fitness
    assert len(server.history) == len(j_server.history)
