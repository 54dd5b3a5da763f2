"""The port's batched grid and evaluation backend (DESIGN.md §6–§7).

Port against port, bit for bit: sync == pipelined on the seeded settings
of tests/test_substrates_pipelined.py, two runs of one seed, and a search
restored through ``state_dict``/``load_state`` against the uninterrupted
one.  Port against reference, on the same seeds: the fleets are the same
numpy draws, the fitness and phase finish are f32 in two frameworks, so
the final fitness is compared with a tolerance (stated in the test).
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core.grid import GridConfig as JGridConfig
from repro.core.substrates.batched_grid import \
    BatchedVolunteerGrid as JBatchedVolunteerGrid
from repro_torch.core.engine import (AnmConfig, AnmEngine, EvalResult,
                                     identical_trajectories)
from repro_torch.core.grid import GridConfig, malicious_lie
from repro_torch.core.substrates.batched_grid import BatchedVolunteerGrid
from repro_torch.core.substrates.eval_backend import (STAGING_RING,
                                                      InProcessEvalBackend,
                                                      bucket_size)


def _quad(n=8, seed=3):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)).astype(np.float32)
    H = A @ A.T + n * np.eye(n, dtype=np.float32)
    x_opt = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    return H, x_opt


def _quad_fitness(n=8, seed=3):
    H, x_opt = (torch.from_numpy(a) for a in _quad(n, seed))

    def f_batch(xs):
        d = xs - x_opt[None, :]
        return 0.5 * torch.einsum("mi,ij,mj->m", d, H, d)

    return f_batch, n


def _engine(n, m, iters, seed=7):
    cfg = AnmConfig(m_regression=m, m_line_search=m, max_iterations=iters)
    return AnmEngine(np.ones(n), -10 * np.ones(n), 10 * np.ones(n),
                     0.5 * np.ones(n), cfg, seed=seed, device="cpu")


def _run_grid(f_batch, n, *, pipelined, n_hosts=256, tick_batch=None,
              failure_prob=0.1, malicious_prob=0.02, m=48, iters=4,
              backend=None, grid_seed=3, engine_seed=7):
    gcfg = GridConfig(n_hosts=n_hosts, failure_prob=failure_prob,
                      malicious_prob=malicious_prob, seed=grid_seed)
    engine = _engine(n, m, iters, engine_seed)
    grid = BatchedVolunteerGrid(f_batch, gcfg, tick_batch=tick_batch,
                                backend=backend, pipelined=pipelined,
                                device="cpu")
    return engine, grid.run(engine)


SWEEP = [(256, None, 0.0, 0.0), (256, 4, 0.1, 0.02), (128, 8, 0.3, 0.1),
         (512, 16, 0.05, 0.01)]


@pytest.mark.parametrize("n_hosts,tick_batch,failure_prob,malicious_prob",
                         SWEEP)
def test_pipelined_matches_sync_seeded_sweep(n_hosts, tick_batch,
                                             failure_prob, malicious_prob):
    f_batch, n = _quad_fitness()
    kw = dict(n_hosts=n_hosts, tick_batch=tick_batch,
              failure_prob=failure_prob, malicious_prob=malicious_prob)
    e_pipe, s_pipe = _run_grid(f_batch, n, pipelined=True, **kw)
    e_sync, s_sync = _run_grid(f_batch, n, pipelined=False, **kw)
    assert identical_trajectories(e_pipe, e_sync)
    assert e_pipe.stats == e_sync.stats
    assert s_pipe.sim_time == s_sync.sim_time
    assert s_pipe.completed == s_sync.completed
    assert s_pipe.ticks == s_sync.ticks
    assert s_pipe.corrupted == s_sync.corrupted


def test_pipeline_actually_runs_deep_and_speculates():
    f_batch, n = _quad_fitness()
    kw = dict(n_hosts=128, tick_batch=8, m=128, iters=3,
              failure_prob=0.15, malicious_prob=0.02)
    e_pipe, s_pipe = _run_grid(f_batch, n, pipelined=True, **kw)
    e_sync, _ = _run_grid(f_batch, n, pipelined=False, **kw)
    assert s_pipe.max_in_flight > 1
    assert s_pipe.spec_blocks > 0
    assert s_pipe.spec_discarded == 0
    assert identical_trajectories(e_pipe, e_sync)


@pytest.mark.parametrize("pipelined", [True, False])
def test_deterministic_over_two_runs(pipelined):
    f_batch, n = _quad_fitness()
    kw = dict(n_hosts=256, tick_batch=4, failure_prob=0.1,
              malicious_prob=0.05)
    e1, s1 = _run_grid(f_batch, n, pipelined=pipelined, **kw)
    e2, s2 = _run_grid(f_batch, n, pipelined=pipelined, **kw)
    assert identical_trajectories(e1, e2) and e1.stats == e2.stats
    assert s1.bucket_hist == s2.bucket_hist and s1.sim_time == s2.sim_time


def test_warmed_backend_never_runs_a_new_shape_mid_run():
    f_batch, n = _quad_fitness()
    be = InProcessEvalBackend(f_batch, n_dims=n, max_bucket=128,
                              device="cpu")
    warmed = be.compile_count
    assert warmed == 5                       # buckets 8, 16, 32, 64, 128
    _run_grid(f_batch, n, pipelined=True, m=48, backend=be)
    _run_grid(f_batch, n, pipelined=False, m=48, backend=be)
    assert be.compile_count == warmed


def _drive(engine, backend, f_rounds, state_at=None):
    """Sync loop through the backend; returns the state_dict taken after
    ``state_at`` rounds (pickled, as a checkpoint would carry it)."""
    saved = None
    for i in range(f_rounds):
        if engine.done:
            break
        if i == state_at:
            saved = pickle.dumps(engine.state_dict())
        reqs = engine.generate(64)
        if not reqs:
            break
        ys = backend(np.stack([r.point for r in reqs]))
        engine.assimilate([EvalResult(r, float(y))
                           for r, y in zip(reqs, ys)])
    return saved


@pytest.mark.parametrize("crash_round", [1, 4, 7, 12])
def test_restored_equals_uninterrupted(crash_round):
    f_batch, n = _quad_fitness()
    be = InProcessEvalBackend(f_batch, device="cpu")
    full = _engine(n, 96, 4)
    saved = _drive(full, be, 1000, state_at=crash_round)
    assert full.done
    restored = _engine(n, 96, 4, seed=0)     # the state carries the rng
    restored.load_state(pickle.loads(saved))
    _drive(restored, be, 1000)
    assert identical_trajectories(full, restored)
    assert full.stats == restored.stats


def test_port_matches_reference_on_same_seeds():
    """The same fleet and engine seeds through both packages' grids.  Both
    runs reach the quadratic's minimum; the final fitness agrees within
    1e-3 of the start's (an absolute tolerance: near the optimum the
    value is ~0, so a relative one would only measure f32 noise)."""
    H, x_opt = _quad()
    jH, jx = jnp.asarray(H), jnp.asarray(x_opt)

    @jax.jit
    def jf_batch(xs):
        d = xs - jx[None, :]
        return 0.5 * jnp.einsum("mi,ij,mj->m", d, jH, d)

    f_batch, n = _quad_fitness()
    kw = dict(n_hosts=256, tick_batch=4, failure_prob=0.1,
              malicious_prob=0.02)
    port, s_port = _run_grid(f_batch, n, pipelined=True, **kw)
    ref = jengine.AnmEngine(np.ones(n), -10 * np.ones(n), 10 * np.ones(n),
                            0.5 * np.ones(n),
                            jengine.AnmConfig(m_regression=48,
                                              m_line_search=48,
                                              max_iterations=4), seed=7)
    s_ref = JBatchedVolunteerGrid(
        jf_batch, JGridConfig(n_hosts=256, failure_prob=0.1,
                              malicious_prob=0.02, seed=3),
        tick_batch=4, pipelined=True).run(ref)
    f0 = float(f_batch(torch.ones(1, n))[0])
    assert port.iteration == ref.iteration == 4
    assert abs(port.best_fitness - ref.best_fitness) <= 1e-3 * f0
    assert port.best_fitness < 0.05 * f0 and ref.best_fitness < 0.05 * f0
    # the fleet itself is the same numpy draw in both packages
    assert s_port.failed > 0 and s_ref.failed > 0


def test_backend_finalizes_corruption_and_pad_lanes():
    f_batch, n = _quad_fitness()
    be = InProcessEvalBackend(f_batch, device="cpu")
    pts = np.random.default_rng(0).uniform(-1, 1, (11, n))
    mal_u = np.full(11, np.nan)
    mal_u[[2, 7]] = [0.3, 0.7]
    h = be.submit(pts, mal_u)
    assert h.kp == bucket_size(11) == 16 and h.event is None
    ys = be.collect(h)
    assert ys.shape == (11,) and ys.dtype == np.float64
    y32 = f_batch(torch.from_numpy(pts.astype(np.float32)))
    want = torch.where(torch.isnan(torch.from_numpy(mal_u).float()), y32,
                       malicious_lie(y32, torch.from_numpy(mal_u).float()))
    assert np.array_equal(ys, want.numpy().astype(np.float64))
    assert np.isnan(h.ys.numpy()[11:]).all()          # pad lanes: NaN


def test_staging_ring_refuses_to_restage_an_uncollected_slot():
    f_batch, n = _quad_fitness()
    be = InProcessEvalBackend(f_batch, device="cpu")
    pts = np.zeros((5, n))
    handles = [be.submit(pts) for _ in range(STAGING_RING)]
    with pytest.raises(RuntimeError, match="uncollected"):
        be.submit(pts)
    be.collect(handles[0])
    newer = be.submit(pts)                        # reuses slot 0
    be.collect(handles[0])                        # stale double collect
    with pytest.raises(RuntimeError, match="uncollected"):
        be.submit(pts)                            # slot 1 still owned
    be.collect(handles[1])
    be.submit(pts)
    assert newer.slot == handles[0].slot


@pytest.mark.parametrize("k,min_bucket,want", [
    (1, 8, 8), (8, 8, 8), (9, 8, 16), (1000, 8, 1024), (2008, 8, 2048),
    (3, 1, 4)])
def test_bucket_size(k, min_bucket, want):
    assert bucket_size(k, min_bucket) == want
