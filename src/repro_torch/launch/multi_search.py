"""Multi-search orchestration over one shared fleet (DESIGN.md §8): act 1
of ``examples/multi_search.py`` on the port.

The paper's ANM is a local optimizer that FGDO runs as one of MANY
concurrent searches over a single volunteer grid.  A heterogeneous
portfolio of searches on the synthetic SDSS stream problem (perturbed
starts, two per-phase m's) shares one fleet and one warmed evaluation
backend, every search's tick blocks coalesced into shared search-id-tagged
buckets — one device dispatch per scheduling round, however many searches
are live.  Act 1 runs the portfolio coalesced, re-runs each search ALONE
(the bit-identical parity contract), then replays the portfolio through a
warm evaluation cache (DESIGN.md §10), which must serve hits and commit
the same trajectories.  The example's acts 2 and 3 (the portfolio and
restart policies) are not ported yet.

The default is the example's light problem (500 stars, 512 quadrature
points, 768 hosts, m = 96); ``--paper-scale`` takes stripe79 at 100k stars
and 4096 quadrature points, 4096 hosts and m = 1000.

    PYTHONPATH=src python -m repro_torch.launch.multi_search --device cpu
    PYTHONPATH=src python -m repro_torch.launch.multi_search --paper-scale
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.core.engine import AnmConfig, identical_trajectories
from repro_torch.core.grid import GridConfig
from repro_torch.core.orchestrator import (FleetScheduler, SearchDirector,
                                           multi_start_specs)
from repro_torch.core.substrates.eval_backend import InProcessEvalBackend
from repro_torch.core.substrates.eval_cache import EvalCache
from repro_torch.data import sdss


def make_problem(n_stars: int = 500, n_quad: int = 512, device="cuda"):
    """(f_batch, x0) of the example: stripe79 and its seeded start."""
    stripe = sdss.make_stripe("stripe79", n_stars=n_stars, n_quad=n_quad,
                              seed=79)
    f_batch, _ = sdss.make_fitness(stripe, device)
    rng = np.random.default_rng(1)
    x0 = np.clip(stripe.truth + rng.normal(0, 0.25, 8).astype(np.float32),
                 sdss.LO, sdss.HI)
    return f_batch, x0


def fleet(n_hosts: int = 768) -> GridConfig:
    """The example's shared fleet, partitioned across the searches."""
    return GridConfig(n_hosts=n_hosts, base_eval_time=3600.0,
                      failure_prob=0.1, malicious_prob=0.03, seed=5)


def portfolio_specs(sched: FleetScheduler, x0, n_searches: int, m: int,
                    iterations: int):
    """The example's heterogeneous portfolio: half the searches at m, half
    at m / 2, starts jittered around x0."""
    hetero = [AnmConfig(m_regression=m, m_line_search=m,
                        max_iterations=iterations),
              AnmConfig(m_regression=m // 2, m_line_search=m // 2,
                        max_iterations=iterations)]
    return multi_start_specs(sched, x0, sdss.LO, sdss.HI, sdss.DEFAULT_STEP,
                             hetero[0], n_searches, seed=11, jitter=0.35,
                             configs=hetero)


def coalesced(backend, grid: GridConfig, x0, n_searches: int, m: int,
              iterations: int):
    """The portfolio coalesced over ``backend``, after a warm-up (the
    bucket ladder, and a one-iteration copy of the portfolio so the first
    phase finish at each m runs outside the timed window).  Returns
    (director result, wall seconds)."""
    sched = FleetScheduler(backend, grid)
    specs = portfolio_specs(sched, x0, n_searches, m, iterations)
    sched.warm(len(x0), specs)
    warm = FleetScheduler(backend, grid)
    SearchDirector(warm, [dataclasses.replace(
        s, anm=dataclasses.replace(s.anm, max_iterations=1))
        for s in portfolio_specs(warm, x0, n_searches, m, iterations)]).run()
    t0 = time.perf_counter()
    res = SearchDirector(sched, specs).run()
    return res, time.perf_counter() - t0


def solo_reruns(res, backend):
    """Each search of a director result re-run alone on ``backend``.
    Returns (bit-identical: every solo trajectory equals its coalesced
    one, wall seconds)."""
    t0 = time.perf_counter()
    parity = True
    for o in res.outcomes:
        parity &= identical_trajectories(o.engine, o.spec.solo_run(backend))
    return parity, time.perf_counter() - t0


def cache_replay(res, backend, grid: GridConfig):
    """The portfolio of ``res`` cold through a fresh eval cache, then warm.
    Returns (cache status, warm wall seconds, bit-identical: the warm run's
    trajectories and stats equal the uncached run's)."""
    specs = [o.spec for o in res.outcomes]
    cache = EvalCache(fingerprint="multi_search_example")
    SearchDirector(FleetScheduler(backend, grid, cache=cache), specs).run()
    t0 = time.perf_counter()
    warm = SearchDirector(FleetScheduler(backend, grid, cache=cache),
                          specs).run()
    wall = time.perf_counter() - t0
    same = all(identical_trajectories(a.engine, b.engine)
               and a.engine.stats == b.engine.stats
               for a, b in zip(res.outcomes, warm.outcomes))
    return cache.status(), wall, same


def outcome_table(res):
    for o in res.outcomes:
        print(f"  {o.spec.name:>12}  {o.status:>6}  "
              f"iter {o.engine.iteration:>2}  "
              f"best {o.engine.best_fitness:.5f}  "
              f"(m={o.spec.anm.m_regression}, "
              f"{o.spec.grid.n_hosts} hosts)")
    best = res.best
    print(f"  incumbent: {best.spec.name} at {best.engine.best_fitness:.5f}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--searches", type=int, default=6)
    ap.add_argument("--hosts", type=int, default=None,
                    help="TOTAL shared fleet, partitioned across searches "
                         "(768; 4096 with --paper-scale)")
    ap.add_argument("--m", type=int, default=None,
                    help="per-phase m of half the searches (96; 1000 with "
                         "--paper-scale); the other half take m / 2")
    ap.add_argument("--iterations", type=int, default=4)
    ap.add_argument("--paper-scale", action="store_true",
                    help="stripe79 at 100k stars, 4096 hosts, m = 1000")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    paper = args.paper_scale
    hosts = args.hosts or (4096 if paper else 768)
    m = args.m or (1000 if paper else 96)
    f_batch, x0 = make_problem(*((100_000, 4096) if paper else (500, 512)),
                               device=args.device)
    backend = InProcessEvalBackend(f_batch, device=args.device)
    grid = fleet(hosts)
    res, wall_co = coalesced(backend, grid, x0, args.searches, m,
                             args.iterations)
    co = res.coalesce_stats
    print(f"coalesced {args.searches}-search portfolio ({args.device}): "
          f"{wall_co:.2f}s wall, {res.rounds} rounds, "
          f"{co.dispatches} device dispatches for {co.lane_blocks} "
          f"per-search blocks "
          f"({co.lane_blocks / max(co.dispatches, 1):.1f}x amortized), "
          f"padded lanes {co.padded_lanes} vs {co.solo_padded_lanes} solo")
    outcome_table(res)
    parity, wall_ser = solo_reruns(res, backend)
    print(f"serial re-runs: {wall_ser:.2f}s wall "
          f"({wall_ser / max(wall_co, 1e-9):.2f}x the coalesced run) — "
          f"trajectories "
          f"{'bit-identical' if parity else 'DIVERGED (BUG)'}")
    cc, wall_warm, same = cache_replay(res, backend, grid)
    print(f"warm cache replay: {wall_warm:.2f}s wall "
          f"({wall_co / max(wall_warm, 1e-9):.1f}x the cold coalesced "
          f"run), {cc['hits']} hits / {cc['misses']} misses "
          f"(hit rate {cc['hit_rate']:.2f}), store {cc['store_size']} "
          f"entries; bit-identical: {same}")


if __name__ == "__main__":
    main()
