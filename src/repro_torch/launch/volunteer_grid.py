"""The 4096-host batched volunteer grid on the port.

Port of acts 2–3 of ``examples/volunteer_grid.py``: a heterogeneous, faulty,
partly malicious fleet of 4096 hosts fits the 8-parameter SDSS stream
model, every tick's completions evaluated as one bucket on the device,
phases advancing on the first m results and the best line-search point
quorum-validated before it is committed.  The default is the example's
size (6k stars, m = 128), ``--paper-scale`` the paper's (100k stars,
m = 1000); both run 8 iterations.  ``--substrate`` picks the evaluation
backend of that run (in-process, or the pod mesh: ``make_data_mesh``'s
(1, 1) mesh on one GPU); then act 3 of the example runs the same grid
through the OTHER backend and says whether the iterates are
bit-identical.

    PYTHONPATH=src python -m repro_torch.launch.volunteer_grid --device cpu
    PYTHONPATH=src python -m repro_torch.launch.volunteer_grid \
        --paper-scale --no-pipelined --substrate pod_mesh
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import paper_anm
from repro_torch.core.engine import (AnmConfig, AnmEngine,
                                     identical_trajectories)
from repro_torch.core.grid import GridConfig
from repro_torch.core.substrates.batched_grid import BatchedVolunteerGrid
from repro_torch.core.substrates.eval_backend import InProcessEvalBackend
from repro_torch.core.substrates.pod_mesh import PodMeshEvalBackend
from repro_torch.data import sdss

#: the example's fleet (examples/volunteer_grid.py, act 2)
FLEET = GridConfig(n_hosts=4096, base_eval_time=3600.0, speed_sigma=1.0,
                   failure_prob=0.1, malicious_prob=0.03, seed=5)


#: the evaluation backends ``--substrate`` picks from
SUBSTRATES = ("in_process", "pod_mesh")


def make_backend(substrate: str, f_batch, device="cuda"):
    """A fresh backend of kind ``substrate`` for ``f_batch``."""
    if substrate == "pod_mesh":
        return PodMeshEvalBackend(f_batch, device=device)
    return InProcessEvalBackend(f_batch, device=device)


def make_problem(n_stars: int = 6_000, device="cuda"):
    """(f_batch, x0) of the example: stripe79 and its seeded start."""
    stripe = sdss.make_stripe("stripe79", n_stars=n_stars, seed=79)
    f_batch, _ = sdss.make_fitness(stripe, device)
    rng = np.random.default_rng(1)
    x0 = np.clip(stripe.truth + rng.normal(0, 0.2, 8).astype(np.float32),
                 sdss.LO, sdss.HI)
    return f_batch, x0


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pipelined", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="pipelined tick loop (DESIGN.md §7); "
                         "--no-pipelined collects every bucket synchronously")
    ap.add_argument("--pipeline-depth", type=int, default=4,
                    help="max in-flight tick buckets when pipelined")
    ap.add_argument("--substrate", default="in_process", choices=SUBSTRATES,
                    help="evaluation backend of the run (act 3 runs the "
                         "OTHER backend for the parity comparison)")
    ap.add_argument("--paper-scale", action="store_true",
                    help="100k stars and m = 1000 per phase")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    f_batch, x0 = make_problem(100_000 if args.paper_scale else 6_000,
                               args.device)
    m = 1000 if args.paper_scale else 128
    engine, stats, wall = run(
        f_batch, x0, m=m, pipelined=args.pipelined,
        pipeline_depth=args.pipeline_depth, device=args.device,
        backend=make_backend(args.substrate, f_batch, args.device))
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
    engine2, _, _ = run(
        f_batch, x0, m=m, pipelined=args.pipelined,
        pipeline_depth=args.pipeline_depth, device=args.device,
        backend=make_backend(other, f_batch, args.device))
    same = identical_trajectories(engine, engine2)
    print(f"{other} backend: {engine2.best_fitness:.5f} — iterates "
          f"{'bit-identical to' if same else 'DIVERGED from'} the "
          f"{args.substrate} backend")


if __name__ == "__main__":
    main()
