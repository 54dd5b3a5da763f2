"""The model stack as the fitness function: ``examples/anm_lm.py`` on the
port (DESIGN.md §11).

Every evaluation is a real forward + cross-entropy of a ``models/``
network on a fixed synthetic batch, its parameters moved along a
k-dimensional orthonormal subspace (``core/subspace.py``).  The
asynchronous Newton engine searches the coefficient box; on the card the
forward runs the port's CUDA attention (h2o-danube-3) or wkv6 (rwkv6)
kernel.  Three acts, as in the reference:

  1. solo: one search through the pipelined batched grid;
  2. portfolio: a coalesced multi-start portfolio per arch (rwkv6 and
     h2o-danube), every orchestrated search bit-identical to its solo run;
  3. crash: the same workload through the checkpointed work server,
     killed mid-search and restored from snapshot + replay log,
     bit-identical to the uninterrupted run.

    PYTHONPATH=src python -m repro_torch.launch.anm_lm --device cpu --act 1
    PYTHONPATH=src python -m repro_torch.launch.anm_lm --act 3
"""
from __future__ import annotations

import argparse
import tempfile
import time

from repro_torch.core.engine import identical_trajectories
from repro_torch.core.orchestrator import (FleetScheduler, SearchDirector,
                                           SearchSpec, multi_start_specs)
from repro_torch.core.grid import GridConfig
from repro_torch.core.substrates.batched_grid import BatchedVolunteerGrid
from repro_torch.core.substrates.eval_backend import bucket_size
from repro_torch.core.substrates.lm_loss import (LmLossEvalBackend,
                                                 LmWorkload)
from repro_torch.server.sim import (ServerSubstrate, SimulatedCrash,
                                    lm_problem, lm_search, result_doc)

__all__ = ["lm_problem", "lm_search", "warmed_backend", "run", "portfolio",
           "crash_restore", "main"]

PORTFOLIO_ARCHS = ("rwkv6-7b", "h2o-danube-3-4b")


def warmed_backend(wl: LmWorkload, m: int, mesh=None) -> LmLossEvalBackend:
    """The backend (on ``mesh`` if given) with its whole bucket ladder run
    once, as act 1 builds it (no bucket shape is first run mid-search)."""
    max_bucket = bucket_size(BatchedVolunteerGrid.warm_max_bucket(m))
    return LmLossEvalBackend(wl, mesh, n_dims=wl.k, max_bucket=max_bucket)


def run(spec: SearchSpec, fleet: GridConfig, backend: LmLossEvalBackend, *,
        pipelined: bool = True):
    """Act 1: one search; returns (engine, grid stats, wall seconds)."""
    engine = spec.build_engine()
    grid = BatchedVolunteerGrid(None, fleet, backend=backend,
                                pipelined=pipelined)
    t0 = time.perf_counter()
    stats = grid.run(engine)
    return engine, stats, time.perf_counter() - t0


def portfolio(spec: SearchSpec, fleet: GridConfig, backend, n_searches: int,
              *, seed: int = 7, jitter: float = 0.3):
    """Act 2 for one arch: ``n_searches`` multi-start searches coalesced
    over one backend, then each re-run alone.  Returns (director result,
    coalesced wall seconds, parity: every search bit-identical to its solo
    run, solo wall seconds)."""
    sched = FleetScheduler(backend, fleet)
    specs = multi_start_specs(sched, spec.x0, spec.lo, spec.hi, spec.step,
                              spec.anm, n_searches, seed=seed, jitter=jitter)
    t0 = time.perf_counter()
    res = SearchDirector(sched, specs).run()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    parity = all(identical_trajectories(o.engine, o.spec.solo_run(backend))
                 and o.engine.iteration == o.spec.anm.max_iterations
                 for o in res.outcomes)
    return res, wall, parity, time.perf_counter() - t0


def crash_restore(spec: SearchSpec, fleet: GridConfig, backend, *,
                  crash_frac: float = 0.4, snapshot_every: int = 25):
    """Act 3: the search through the work server uninterrupted, then again
    with a checkpoint, crashed after ``crash_frac`` of the uninterrupted
    run's messages and restored.  Returns (uninterrupted result doc,
    restored result doc, the crash's message, bit-identical: the same
    committed history and engine stats)."""
    base = result_doc(ServerSubstrate(spec, fleet, backend).run())
    kill_after = max(50, int(crash_frac * base["pool"]["messages"]))
    crash = None
    with tempfile.TemporaryDirectory(prefix="anm_lm_") as ckpt:
        try:
            ServerSubstrate(spec, fleet, backend, ckpt_dir=ckpt,
                            snapshot_every=snapshot_every,
                            max_messages=kill_after).run()
        except SimulatedCrash as e:
            crash = str(e)
        if crash is None:
            raise RuntimeError(f"the server finished before its crash "
                               f"point ({kill_after} messages)")
        res = result_doc(ServerSubstrate(spec, fleet, backend,
                                         ckpt_dir=ckpt).run(resume=True))
    match = (res["history"] == base["history"]
             and res["engine_stats"] == base["engine_stats"])
    return base, res, crash, match


def act1_solo(args):
    print(f"== act 1: ANM over the {args.arch} loss landscape "
          f"({args.device}) ==")
    spec, fleet, wl = lm_problem(arch=args.arch, k=args.k, m=args.m,
                                 iterations=args.iterations,
                                 n_hosts=args.hosts, device=args.device)
    t0 = time.perf_counter()
    backend = warmed_backend(wl, args.m)
    print(f"  workload: {wl.proj.n_params} params, k={wl.k} subspace, "
          f"warmed ladder in {time.perf_counter() - t0:.1f}s "
          f"({backend.compile_count} bucket shapes)")
    c0 = backend.compile_count
    engine, stats, wall = run(spec, fleet, backend)
    loss0 = engine.history[0].best_fitness
    print(f"  {engine.iteration} iterations, loss {loss0:.6f} -> "
          f"{engine.best_fitness:.6f} in {wall:.1f}s wall "
          f"({stats.batch_calls} buckets, "
          f"{backend.compile_count - c0} new bucket shapes mid-run)")


def act2_portfolio(args):
    print(f"== act 2: a coalesced portfolio per arch ({args.device}) ==")
    best = {}
    for arch in PORTFOLIO_ARCHS:
        spec, fleet, wl = lm_problem(arch=arch, k=args.k, m=args.m,
                                     iterations=args.iterations,
                                     n_hosts=args.hosts, device=args.device)
        backend = LmLossEvalBackend(wl)
        res, wall, parity, _ = portfolio(spec, fleet, backend,
                                         args.searches)
        co = res.coalesce_stats
        print(f"  {arch}: {args.searches} searches, "
              f"{co.dispatches} dispatches for {co.lane_blocks} blocks, "
              f"best {res.best.engine.best_fitness:.6f} in {wall:.1f}s; "
              f"solo parity {'ok' if parity else 'FAIL'}")
        best[arch] = res.best.engine.best_fitness
    winner = min(best, key=best.get)
    print(f"  best landscape: {winner} at {best[winner]:.6f}")


def act3_crash(args):
    print(f"== act 3: kill the work server mid-search, restore "
          f"({args.device}) ==")
    spec, fleet, wl = lm_problem(arch=args.arch, k=args.k, m=args.m,
                                 iterations=args.iterations,
                                 n_hosts=args.hosts, device=args.device)
    base, res, crash, match = crash_restore(spec, fleet,
                                            LmLossEvalBackend(wl))
    print(f"  uninterrupted: {base['iteration']} iterations, best "
          f"{base['best_fitness']:.6f}, {base['pool']['messages']} "
          f"protocol messages")
    print(f"  {crash}")
    print(f"  restored: replayed {res['replayed']} log records, re-leased "
          f"{res['pool']['resumed_leases']} in-flight workunits, "
          f"finished at {res['best_fitness']:.6f}")
    print(f"  bit-identical to uninterrupted: {'ok' if match else 'FAIL'}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--act", type=int, default=0, choices=[0, 1, 2, 3],
                    help="run one act (0 = all)")
    ap.add_argument("--arch", default="rwkv6-7b")
    ap.add_argument("--k", type=int, default=6)
    ap.add_argument("--m", type=int, default=12)
    ap.add_argument("--iterations", type=int, default=2)
    ap.add_argument("--hosts", type=int, default=48)
    ap.add_argument("--searches", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    if args.act in (0, 1):
        act1_solo(args)
    if args.act in (0, 2):
        act2_portfolio(args)
    if args.act in (0, 3):
        act3_crash(args)


if __name__ == "__main__":
    main()
