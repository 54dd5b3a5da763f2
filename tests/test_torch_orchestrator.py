"""The port's multi-search orchestrator: coalesced buckets, fleet
scheduling, and the search-level parity contract (DESIGN.md §8).

The reference's tests/test_orchestrator.py, port against port on the CPU,
less ``test_multi_search_parity_on_pod_backend`` (the port has no
pod-mesh backend yet: ROADMAP A.6); then ``search_spec_from_reference``
carries a reference portfolio's specs across field by field.

The contracts under test:

  * orchestration changes WHEN lanes are evaluated, never what an engine
    sees — every search in a coalesced multi-search run commits
    bit-identical iterates (and identical final ``EngineStats``) to the
    same spec run alone, on both evaluation backends;
  * coalescing actually amortizes: in the long-phase regime one device
    dispatch serves many per-search blocks, and lane tags demux the shared
    bucket back to the right searches bit-exactly;
  * portfolio policies only stop stepping searches: a killed search's
    committed history is a PREFIX of its solo run; restarts are fresh
    deterministic specs whose trajectories are solo-reproducible too;
  * a warmed shared backend stays zero-compile through a coalesced
    multi-search run.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.core.anm import AnmConfig
from repro_torch.core.engine import AnmEngine, identical_trajectories
from repro_torch.core.grid import GridConfig
from repro_torch.core.orchestrator import (CoalescingSubmitter, FleetScheduler,
                                     SearchDirector, SearchSpec,
                                     multi_start_specs)
from repro_torch.core.substrates.batched_grid import BatchedVolunteerGrid
from repro_torch.core.substrates.eval_backend import InProcessEvalBackend
from repro_torch import convert
from repro.core.grid import GridConfig as JGridConfig
from repro.core.orchestrator import FleetScheduler as JFleetScheduler
from repro.core.orchestrator import multi_start_specs as j_multi_start_specs
from repro.core.substrates.eval_backend import \
    InProcessEvalBackend as JInProcessEvalBackend

pytestmark = pytest.mark.orchestrator

#: the port's constructors with the fitness and the engines on the CPU
InProcessEvalBackend = functools.partial(InProcessEvalBackend, device="cpu")
AnmEngine = functools.partial(AnmEngine, device="cpu")


def _quad_fitness(n=8, seed=3):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)).astype(np.float32)
    H = torch.from_numpy(A @ A.T + n * np.eye(n, dtype=np.float32))
    x_opt = torch.from_numpy(rng.uniform(-0.5, 0.5, n).astype(np.float32))

    def f_batch(xs):
        # ½ dᵀHd in elementwise steps, each row on its own: a torch matrix
        # product may block its rows by the batch's width, and every
        # contract here needs a lane's value to be its own (as the SDSS
        # fitness's fixed-order row means make it)
        d = xs - x_opt[None, :]
        hd = sum(d[:, j, None] * H[j][None, :] for j in range(n))
        return 0.5 * sum(hd[:, i] * d[:, i] for i in range(n))

    return f_batch, n


def _solo_run(spec: SearchSpec, backend, *, pipelined=True):
    """The parity baseline — `SearchSpec.solo_run` is the ONE shared
    construction (tests, dryrun smoke, benchmark, example all use it)."""
    return spec.solo_run(backend, pipelined=pipelined)


def _portfolio(backend, n_searches=4, *, n_hosts=512, m=32, iters=3,
               configs=None, policy="fixed", fleet_seed=3, **director_kw):
    f_batch, n = _quad_fitness()
    fleet = GridConfig(n_hosts=n_hosts, failure_prob=0.1,
                       malicious_prob=0.02, seed=fleet_seed)
    sched = FleetScheduler(backend, fleet)
    anm = AnmConfig(m_regression=m, m_line_search=m, max_iterations=iters)
    specs = multi_start_specs(sched, np.ones(n), -10 * np.ones(n),
                              10 * np.ones(n), 0.5 * np.ones(n), anm,
                              n_searches, seed=0, jitter=0.3,
                              configs=configs)
    director = SearchDirector(sched, specs, policy, **director_kw)
    return director.run(), sched


# -- the parity contract ------------------------------------------------------

def test_coalesced_searches_match_solo_runs_bit_identically():
    """Heterogeneous portfolio (two different m's), coalesced over one
    backend: every search's committed iterates AND final engine stats
    must equal the same spec run alone."""
    f_batch, _ = _quad_fitness()
    backend = InProcessEvalBackend(f_batch)
    hetero = [AnmConfig(m_regression=32, m_line_search=32, max_iterations=3),
              AnmConfig(m_regression=48, m_line_search=48, max_iterations=2)]
    res, _ = _portfolio(backend, 4, configs=hetero)
    assert len(res.outcomes) == 4
    for o in res.outcomes:
        assert o.status == "done"
        solo = _solo_run(o.spec, backend)
        assert identical_trajectories(o.engine, solo)
        assert o.engine.stats == solo.stats
    # the coalescer really ran: shared buckets served per-search blocks
    assert res.coalesce_stats.dispatches < res.coalesce_stats.lane_blocks
    assert res.coalesce_stats.lanes > 0


def test_uncoalesced_scheduler_still_matches_solo():
    """coalesce=False (the serial-equivalent dispatch mode the benchmarks
    compare against) must preserve the identical trajectories too."""
    f_batch, _ = _quad_fitness()
    backend = InProcessEvalBackend(f_batch)
    fleet = GridConfig(n_hosts=256, failure_prob=0.1, malicious_prob=0.02,
                       seed=3)
    sched = FleetScheduler(backend, fleet, coalesce=False)
    anm = AnmConfig(m_regression=24, m_line_search=24, max_iterations=2)
    specs = multi_start_specs(sched, np.ones(8), -10 * np.ones(8),
                              10 * np.ones(8), 0.5 * np.ones(8), anm, 2)
    res = SearchDirector(sched, specs).run()
    assert res.coalesce_stats is None
    for o in res.outcomes:
        assert identical_trajectories(o.engine, _solo_run(o.spec, backend))


def test_uncoalesced_deep_pipelines_survive_the_shared_staging_ring():
    """Many uncoalesced searches pipelining deep stack more same-shape
    in-flight buckets than one grid's depth clamp accounts for; the
    scheduler's shared ring guard must drain the oldest early instead of
    letting the backend raise — with trajectories still solo-identical.
    (Regression: this exact shape crashed with 'uncollected submission
    still aliases staging slot' before the guard existed.)"""
    f_batch, _ = _quad_fitness()
    backend = InProcessEvalBackend(f_batch)
    fleet = GridConfig(n_hosts=768, failure_prob=0.1, malicious_prob=0.02,
                       seed=3)
    sched = FleetScheduler(backend, fleet, coalesce=False,
                           pipeline_depth=6)
    anm = AnmConfig(m_regression=96, m_line_search=96, max_iterations=2)
    specs = multi_start_specs(sched, np.ones(8), -10 * np.ones(8),
                              10 * np.ones(8), 0.5 * np.ones(8), anm, 6,
                              jitter=0.3)
    res = SearchDirector(sched, specs).run()
    assert sched.ring_guard.ring_drains > 0    # the guard really engaged
    for o in res.outcomes:
        assert identical_trajectories(
            o.engine, _solo_run(o.spec, backend, pipelined=True))


# -- coalescing mechanics -----------------------------------------------------

def test_coalescing_amortizes_dispatches_in_long_phases():
    """Long phases (rare phase-boundary collects) are the regime the
    coalescer exists for: most rounds must fold every live search's block
    into ONE dispatch."""
    f_batch, _ = _quad_fitness()
    backend = InProcessEvalBackend(f_batch)
    res, _ = _portfolio(backend, 4, n_hosts=512, m=96, iters=2)
    st = res.coalesce_stats
    # 4 searches' blocks per round; boundaries force some extra dispatches
    assert st.dispatches < 0.5 * st.lane_blocks
    for o in res.outcomes:
        assert identical_trajectories(
            o.engine, _solo_run(o.spec, InProcessEvalBackend(f_batch)))


def test_lane_tags_demux_shared_bucket():
    """Two searches' blocks in one shared bucket: collect must hand each
    search exactly the values its own solo bucket would have produced,
    and the handle's lane tags must map lanes to search ids."""
    f_batch, n = _quad_fitness()
    backend = InProcessEvalBackend(f_batch)
    co = CoalescingSubmitter(backend)
    sub_a, sub_b = co.lane_submitter(0), co.lane_submitter(1)
    rng = np.random.default_rng(0)
    pts_a = rng.uniform(-1, 1, (5, n))
    pts_b = rng.uniform(-1, 1, (9, n))
    u_b = np.full(9, np.nan)
    u_b[[1, 4]] = [0.3, 0.7]           # corruption lanes stay per-lane
    lane_a = sub_a.submit(pts_a)
    lane_b = sub_b.submit(pts_b, u_b)
    co.flush()
    assert co.stats.dispatches == 1 and co.stats.lane_blocks == 2
    handle = lane_a.round_.handle
    np.testing.assert_array_equal(handle.tags[:5], 0)
    np.testing.assert_array_equal(handle.tags[5:14], 1)
    assert lane_a.kp == handle.kp
    ys_a = sub_a.collect(lane_a)
    ys_b = sub_b.collect(lane_b)
    np.testing.assert_array_equal(ys_a, backend(pts_a))
    np.testing.assert_array_equal(ys_b, backend(pts_b, u_b))


def test_collect_before_flush_forces_the_round_out():
    """A search that must decide a phase transition mid-round cannot wait
    for the others: collecting an undispatched lane flushes the open
    round immediately, and later submits open a new round."""
    f_batch, n = _quad_fitness()
    backend = InProcessEvalBackend(f_batch)
    co = CoalescingSubmitter(backend)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (6, n))
    lane = co.lane_submitter(0).submit(pts)
    ys = co.collect(lane)              # round still open -> forced flush
    np.testing.assert_array_equal(ys, backend(pts))
    assert co.stats.forced_flushes == 1 and co.stats.dispatches == 1
    pts2 = rng.uniform(-1, 1, (3, n))
    lane2 = co.lane_submitter(1).submit(pts2)
    co.flush()
    np.testing.assert_array_equal(co.collect(lane2), backend(pts2))
    assert co.stats.dispatches == 2


def test_warmed_backend_stays_zero_compile_through_multi_search():
    """The coalesced ladder (sum of per-search warm bounds) is compiled by
    the director's warm-up; the run itself must not add a single trace."""
    f_batch, _ = _quad_fitness()
    backend = InProcessEvalBackend(f_batch)
    res, _ = _portfolio(backend, 3, n_hosts=384, m=24, iters=2)
    warmed = backend.compile_count
    assert warmed > 0
    res2, _ = _portfolio(backend, 3, n_hosts=384, m=24, iters=2)
    assert backend.compile_count == warmed
    for a, b in zip(res.outcomes, res2.outcomes):
        assert identical_trajectories(a.engine, b.engine)


def test_identical_trajectories_separates_independently_seeded_engines():
    """The parity predicate must have teeth across a multi-start
    portfolio: engines on the SAME problem with different seeds (or
    different sub-fleets) diverge and must compare unequal, while a true
    re-run compares equal — otherwise every gate in this file could
    vacuously pass."""
    f_batch, n = _quad_fitness()
    backend = InProcessEvalBackend(f_batch)
    grid_cfg = GridConfig(n_hosts=128, failure_prob=0.05,
                          malicious_prob=0.01, seed=3)
    # 4 iterations: this workload's first committed improvement lands at
    # iteration 4, and only improving commits make seeds distinguishable
    anm = AnmConfig(m_regression=32, m_line_search=32, max_iterations=4)

    def run(engine_seed, grid_seed=3):
        engine = AnmEngine(np.ones(n), -10 * np.ones(n), 10 * np.ones(n),
                           0.5 * np.ones(n), anm, seed=engine_seed)
        BatchedVolunteerGrid(
            None, dataclasses.replace(grid_cfg, seed=grid_seed),
            backend=backend).run(engine)
        return engine

    base, rerun = run(7), run(7)
    assert identical_trajectories(base, rerun)
    assert not identical_trajectories(base, run(8))       # engine seed
    assert not identical_trajectories(base, run(7, 4))    # sub-fleet seed


# -- fleet partitioning -------------------------------------------------------

def test_partition_and_subfleet_are_deterministic():
    f_batch, _ = _quad_fitness()
    backend = InProcessEvalBackend(f_batch)
    fleet = GridConfig(n_hosts=1024, seed=11)
    sched = FleetScheduler(backend, fleet, min_hosts=32)
    assert sched.partition(4) == 256
    assert sched.partition(128) == 32          # floored, never starved
    subs = [sched.subfleet(i, 4) for i in range(4)]
    assert all(s.n_hosts == 256 for s in subs)
    assert len({s.seed for s in subs}) == 4    # distinct sub-fleets
    # deterministic: the same slot always yields the same sub-fleet
    assert sched.subfleet(2, 4) == subs[2]


# -- portfolio policies -------------------------------------------------------

def test_portfolio_kill_retires_dominated_search_as_solo_prefix():
    """A search started far from the optimum is killed once it trails the
    incumbent past probation — and its committed history must be exactly
    the first iterations of its solo run (stopping early is the ONLY
    thing a kill may do)."""
    f_batch, n = _quad_fitness()
    backend = InProcessEvalBackend(f_batch)
    fleet = GridConfig(n_hosts=512, failure_prob=0.05, malicious_prob=0.01,
                       seed=5)
    sched = FleetScheduler(backend, fleet)
    anm = AnmConfig(m_regression=32, m_line_search=32, max_iterations=6)
    specs = multi_start_specs(sched, np.zeros(n), -10 * np.ones(n),
                              10 * np.ones(n), 0.5 * np.ones(n), anm, 3,
                              jitter=0.1)
    # doom one search: start it in a far corner with a tiny step so it
    # cannot catch the incumbent within its probation
    bad = dataclasses.replace(specs[1], x0=9.5 * np.ones(n),
                              step=0.05 * np.ones(n))
    specs = [specs[0], bad, specs[2]]
    # margin of 2.0 (on the |best|+1 scale): the near-start survivors
    # differ by far less, the far-corner search by orders of magnitude
    res = SearchDirector(sched, specs, "portfolio", kill_margin=2.0,
                         probation_iterations=2).run()
    by_name = {o.spec.name: o for o in res.outcomes}
    killed = by_name[bad.name]
    assert killed.status == "killed"
    assert killed.engine.iteration < anm.max_iterations
    solo = _solo_run(bad, backend)
    assert len(solo.history) >= len(killed.engine.history) > 0
    for got, want in zip(killed.engine.history, solo.history):
        np.testing.assert_array_equal(got.center, want.center)
        assert got.best_fitness == want.best_fitness
    # the survivors ran to completion and stayed solo-identical
    for name in (specs[0].name, specs[2].name):
        o = by_name[name]
        assert o.status == "done"
        assert identical_trajectories(o.engine, _solo_run(o.spec, backend))
    assert res.best.spec.name != bad.name


def test_restart_policy_spawns_deterministic_solo_reproducible_restarts():
    f_batch, _ = _quad_fitness()
    backend = InProcessEvalBackend(f_batch)
    res, sched = _portfolio(backend, 2, n_hosts=256, m=24, iters=2,
                            policy="restart", max_restarts=2, seed=13)
    assert len(res.outcomes) == 4              # 2 originals + 2 restarts
    restarts = [o for o in res.outcomes if "~r" in o.spec.name]
    assert len(restarts) == 2
    for o in res.outcomes:
        assert o.status == "done"
        # a restart's spec is fully recorded, so it is solo-reproducible
        # like any other search — the parity contract has no exceptions
        assert identical_trajectories(o.engine, _solo_run(o.spec, backend))
    # fresh seeds, not reruns of the dead search
    names = {o.spec.engine_seed for o in res.outcomes}
    assert len(names) == 4
    assert sched.stats.admitted == 4


# -- across packages ------------------------------------------------------------

def test_search_spec_from_reference_carries_every_field():
    """A reference multi-start portfolio's specs, carried across by
    ``convert.search_spec_from_reference``, equal the port's own
    multi-start specs field by field (same starts, sub-fleets, seeds and
    configs), and run in the port to the same trajectories."""
    f_batch, n = _quad_fitness()
    box = (np.ones(n), -10 * np.ones(n), 10 * np.ones(n), 0.5 * np.ones(n))
    fleet = dict(n_hosts=256, failure_prob=0.1, malicious_prob=0.02, seed=3)
    anm = AnmConfig(m_regression=16, m_line_search=16, max_iterations=2)
    from repro.core.anm import AnmConfig as JAnmConfig
    j_sched = JFleetScheduler(JInProcessEvalBackend(lambda x: x[:, 0]),
                              JGridConfig(**fleet))
    j_specs = j_multi_start_specs(
        j_sched, *box, JAnmConfig(**dataclasses.asdict(anm)), 3, seed=0,
        jitter=0.3)
    backend = InProcessEvalBackend(f_batch)
    specs = multi_start_specs(FleetScheduler(backend, GridConfig(**fleet)),
                              *box, anm, 3, seed=0, jitter=0.3)
    carried = [convert.search_spec_from_reference(s, device="cpu")
               for s in j_specs]
    for mine, theirs in zip(specs, carried):
        for f in dataclasses.fields(SearchSpec):
            a, b = getattr(mine, f.name), getattr(theirs, f.name)
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, b), f.name
            else:
                assert a == b, f.name
        assert identical_trajectories(mine.solo_run(backend),
                                      theirs.solo_run(backend))
