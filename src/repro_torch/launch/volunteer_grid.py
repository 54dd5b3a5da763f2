"""FGDO on a simulated volunteer grid, on the port.

Port of ``examples/volunteer_grid.py``.  Act 1: a 256-host heterogeneous,
faulty, partly malicious grid, simulated event by event
(``core/grid.py::VolunteerGrid``), fits the 8-parameter SDSS stream model
through the BOINC-style ``FgdoAnmServer``: work generated on demand, one
single-point fitness call on the device per completed workunit (a host
read per event, so this act is host-bound by design), phases advancing on
the first m results and the best line-search point quorum-validated
before it is committed.  Act 2: the same engine on a fleet of 4096 hosts,
every tick's completions evaluated as one bucket on the device.  The
default is the example's size (6k stars, m = 128), ``--paper-scale`` the
paper's for act 2 (100k stars, m = 1000); both run 8 iterations.
``--substrate`` picks act 2's evaluation backend (in-process, or the pod
mesh: ``make_data_mesh``'s (1, 1) mesh on one GPU); act 3 runs the same
grid through the OTHER backend and says whether the iterates are
bit-identical.  ``--out`` writes each act's gates, iterations, best
fitness, wall and kernel launches.

    PYTHONPATH=src python -m repro_torch.launch.volunteer_grid --device cpu
    PYTHONPATH=src python -m repro_torch.launch.volunteer_grid \
        --paper-scale --no-pipelined --substrate pod_mesh
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import paper_anm
from repro_torch.core.engine import (AnmConfig, AnmEngine,
                                     identical_trajectories)
from repro_torch.core.fgdo import FgdoAnmServer
from repro_torch.core.grid import GridConfig, VolunteerGrid
from repro_torch.core.substrates.batched_grid import BatchedVolunteerGrid
from repro_torch.core.substrates.eval_backend import InProcessEvalBackend
from repro_torch.core.substrates.pod_mesh import PodMeshEvalBackend
from repro_torch.data import sdss
from repro_torch.launch.acts import ActLog, fit_elements, record_search

#: the example's fleet (examples/volunteer_grid.py, act 2)
FLEET = GridConfig(n_hosts=4096, base_eval_time=3600.0, speed_sigma=1.0,
                   failure_prob=0.1, malicious_prob=0.03, seed=5)
#: act 1's per-event fleet: 256 of the same hosts
EVENT_FLEET = dataclasses.replace(FLEET, n_hosts=256)
#: the example's per-phase m and iterations
M, ITERATIONS = 128, 8


#: the evaluation backends ``--substrate`` picks from
SUBSTRATES = ("in_process", "pod_mesh")


def make_backend(substrate: str, f_batch, device="cuda"):
    """A fresh backend of kind ``substrate`` for ``f_batch``."""
    if substrate == "pod_mesh":
        return PodMeshEvalBackend(f_batch, device=device)
    return InProcessEvalBackend(f_batch, device=device)


def start_point(stripe) -> np.ndarray:
    """The example's x0: the truth perturbed by a seeded draw, clipped."""
    rng = np.random.default_rng(1)
    return np.clip(stripe.truth + rng.normal(0, 0.2, 8).astype(np.float32),
                   sdss.LO, sdss.HI)


def make_problem(n_stars: int = 6_000, device="cuda"):
    """(f_batch, x0) of the example: stripe79 and its seeded start."""
    stripe = sdss.make_stripe("stripe79", n_stars=n_stars, seed=79)
    f_batch, _ = sdss.make_fitness(stripe, device)
    return f_batch, start_point(stripe)


def per_event(f_single, x0, device="cuda", m: int = M,
              iters: int = ITERATIONS):
    """Act 1: the per-event 256-host grid through ``FgdoAnmServer``, each
    completed workunit one ``f_single`` call read back to the host.
    Returns (server, grid stats, wall seconds)."""
    server = FgdoAnmServer(
        x0, sdss.LO, sdss.HI, sdss.DEFAULT_STEP,
        AnmConfig(m_regression=m, m_line_search=m, max_iterations=iters),
        seed=3, validation_quorum=paper_anm.smoke().validation_quorum,
        device=device)
    grid = VolunteerGrid(lambda p: float(f_single(p)), EVENT_FLEET)
    t0 = time.perf_counter()
    stats = grid.run(server)
    return server, stats, time.perf_counter() - t0


def run(f_batch, x0, *, m: int = 128, iters: int = 8, pipelined: bool = True,
        pipeline_depth: int = 4, device="cuda", backend=None):
    """One batched-grid search; returns (engine, grid stats, wall seconds).
    ``backend`` may be passed to share one warmed backend across runs."""
    if backend is None:
        backend = InProcessEvalBackend(f_batch, device=device)
    engine = AnmEngine(x0, sdss.LO, sdss.HI, sdss.DEFAULT_STEP,
                       AnmConfig(m_regression=m, m_line_search=m,
                                 max_iterations=iters),
                       seed=3,
                       validation_quorum=paper_anm.CONFIG.validation_quorum,
                       device=device)
    grid = BatchedVolunteerGrid(None, FLEET, backend=backend,
                                pipelined=pipelined,
                                pipeline_depth=pipeline_depth)
    t0 = time.perf_counter()
    stats = grid.run(engine)
    return engine, stats, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pipelined", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="pipelined tick loop (DESIGN.md §7) of acts 2-3; "
                         "--no-pipelined collects every bucket synchronously")
    ap.add_argument("--pipeline-depth", type=int, default=4,
                    help="max in-flight tick buckets when pipelined")
    ap.add_argument("--substrate", default="in_process", choices=SUBSTRATES,
                    help="evaluation backend of act 2 (act 3 runs the "
                         "OTHER backend for the parity comparison)")
    ap.add_argument("--paper-scale", action="store_true",
                    help="acts 2-3 at 100k stars and m = 1000 per phase")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="result JSON path")
    args = ap.parse_args(argv)
    log = ActLog("volunteer_grid", args.device)
    per_event_act(args, log)
    batched(args, log)
    return log.finish(args.out)


def per_event_act(args, log: ActLog) -> None:
    """Act 1: the per-event 256-host grid at the example's size."""
    stripe = sdss.make_stripe("stripe79", n_stars=6_000, seed=79)
    _, f_single = sdss.make_fitness(stripe, args.device)
    x0 = start_point(stripe)
    print(f"start fitness {float(f_single(x0)):.5f}; truth "
          f"{float(f_single(stripe.truth)):.5f}")
    with log.act("per_event") as rec:
        server, g, wall = per_event(f_single, x0, args.device)
        record_search(rec, server)
        rec.update(evaluations=g.completed, lost=g.failed,
                   corrupted=g.corrupted, stale=server.stats.stale,
                   rejected=server.stats.validations_failed,
                   sim_hours=g.sim_time / 3600,
                   fit_elements=fit_elements(M, sdss.N_PARAMS))
        rec["gates"]["committed_every_iteration"] = (
            server.iteration == ITERATIONS)
    print(f"converged to {server.best_fitness:.5f} in {server.iteration} "
          f"iterations / {g.sim_time / 3600:.1f} simulated hours; "
          f"{wall:.2f}s wall ({g.completed / wall:.0f} evaluations/s, one "
          f"host read each, {args.device})")
    print(f"grid: {g.completed} results ({g.failed} lost, {g.corrupted} "
          f"corrupted), {server.stats.stale} stale discarded, "
          f"{server.stats.validations_failed} malicious bests rejected by "
          f"quorum")
    for r in server.history:
        print(f"  iter {r.iteration}: best={r.best_fitness:.5f} "
              f"alpha={r.best_alpha:.2f}")


def batched(args, log: ActLog) -> None:
    """Acts 2-3: the 4096-host batched grid on ``--substrate``, then on
    the other backend, which must commit the same iterates."""
    f_batch, x0 = make_problem(100_000 if args.paper_scale else 6_000,
                               args.device)
    m = 1000 if args.paper_scale else M
    with log.act("batched") as rec:
        engine, stats, wall = run(
            f_batch, x0, m=m, pipelined=args.pipelined,
            pipeline_depth=args.pipeline_depth, device=args.device,
            backend=make_backend(args.substrate, f_batch, args.device))
        record_search(rec, engine)
        rec.update(evaluations=stats.batched_evals,
                   batches=stats.batch_calls,
                   fit_elements=fit_elements(m, sdss.N_PARAMS))
        rec["gates"]["committed_every_iteration"] = (
            engine.iteration == ITERATIONS)
    print(f"batched grid (4096 hosts, {args.substrate} backend, "
          f"{'pipelined' if args.pipelined else 'sync'}, {args.device}): "
          f"{engine.best_fitness:.5f} in {engine.iteration} iterations / "
          f"{stats.sim_time / 3600:.1f} simulated hours — "
          f"{stats.batch_calls} fitness batches (mean "
          f"{stats.batched_evals / max(stats.batch_calls, 1):.0f} points "
          f"each), {wall:.2f}s wall")
    print(f"  device-blocked {stats.device_blocked_s:.3f}s vs host "
          f"{stats.host_s:.3f}s, pipeline depth {stats.max_in_flight}, "
          f"{stats.spec_blocks} speculative blocks "
          f"({stats.spec_discarded} discarded), buckets "
          f"{dict(sorted(stats.bucket_hist.items()))}")
    print(f"  grid: {stats.completed} results ({stats.failed} lost, "
          f"{stats.corrupted} corrupted), {engine.stats.stale} stale, "
          f"{engine.stats.validations_failed} malicious bests rejected")

    # act 3: the same grid through the OTHER backend (same seed, so the
    # same iterates on either backend, pipelined or not)
    other = SUBSTRATES[1 - SUBSTRATES.index(args.substrate)]
    with log.act("other_backend") as rec:
        engine2, stats2, _ = run(
            f_batch, x0, m=m, pipelined=args.pipelined,
            pipeline_depth=args.pipeline_depth, device=args.device,
            backend=make_backend(other, f_batch, args.device))
        same = identical_trajectories(engine, engine2)
        record_search(rec, engine2)
        rec.update(evaluations=stats2.batched_evals,
                   fit_elements=fit_elements(m, sdss.N_PARAMS))
        rec["gates"]["bit_identical_across_backends"] = same
    print(f"{other} backend: {engine2.best_fitness:.5f} — iterates "
          f"{'bit-identical to' if same else 'DIVERGED from'} the "
          f"{args.substrate} backend")


if __name__ == "__main__":
    raise SystemExit(main())
