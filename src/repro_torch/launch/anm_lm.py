"""The model stack as the fitness function: act 1 of ``examples/anm_lm.py``.

Every evaluation is a real forward + cross-entropy of a ``models/``
network on a fixed synthetic batch, its parameters moved along a
k-dimensional orthonormal subspace (``core/subspace.py``).  The
asynchronous Newton engine searches the coefficient box through the
pipelined batched grid; on the card the forward runs the port's CUDA
attention (h2o-danube-3) or wkv6 (rwkv6) kernel.

    PYTHONPATH=src python -m repro_torch.launch.anm_lm --device cpu
    PYTHONPATH=src python -m repro_torch.launch.anm_lm --arch h2o-danube-3-4b

Acts 2 (a coalesced portfolio) and 3 (the work server crashed and
restored) need the orchestrator and the server, which are not ported.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.core.engine import AnmConfig, AnmEngine
from repro_torch.core.grid import GridConfig
from repro_torch.core.substrates.batched_grid import BatchedVolunteerGrid
from repro_torch.core.substrates.eval_backend import bucket_size
from repro_torch.core.substrates.lm_loss import (LmLossEvalBackend,
                                                 LmWorkload,
                                                 make_lm_workload)


@dataclasses.dataclass(frozen=True)
class LmSearch:
    """The fields of the reference's ``SearchSpec`` that act 1 uses."""
    name: str
    x0: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    step: np.ndarray
    anm: AnmConfig
    engine_seed: int
    validation_quorum: int

    def build_engine(self, device="cuda") -> AnmEngine:
        return AnmEngine(self.x0, self.lo, self.hi, self.step, self.anm,
                         seed=self.engine_seed,
                         validation_quorum=self.validation_quorum,
                         device=device)


def lm_problem(arch: str = "rwkv6-7b", k: int = 6, n_hosts: int = 48,
               m: int = 12, iterations: int = 2, engine_seed: int = 7,
               grid_seed: int = 9, failure: float = 0.05,
               malicious: float = 0.02, quorum: int = 2,
               workload_seed: int = 3, device="cuda", **workload_kw):
    """Copy of the reference's ``server/sim.py::lm_problem`` (same
    defaults): the search is the k-dim coefficient box of an LM workload,
    and every fitness evaluation is a forward + loss.  ``workload_kw``
    goes to ``make_lm_workload`` (e.g. ``full_width``, ``n_layers``,
    ``seq_len``).  Returns (search, fleet, workload)."""
    wl = make_lm_workload(arch, k=k, seed=workload_seed, device=device,
                          **workload_kw)
    return lm_search(wl, n_hosts=n_hosts, m=m, iterations=iterations,
                     engine_seed=engine_seed, grid_seed=grid_seed,
                     failure=failure, malicious=malicious, quorum=quorum)


def lm_search(wl: LmWorkload, n_hosts: int = 48, m: int = 12,
              iterations: int = 2, engine_seed: int = 7, grid_seed: int = 9,
              failure: float = 0.05, malicious: float = 0.02,
              quorum: int = 2):
    """(search, fleet, wl) of ``lm_problem`` around a given workload."""
    fleet = GridConfig(n_hosts=n_hosts, failure_prob=failure,
                       malicious_prob=malicious, seed=grid_seed)
    search = LmSearch(
        name=f"lm_{wl.arch}", x0=wl.x0, lo=wl.lo, hi=wl.hi, step=wl.step,
        anm=AnmConfig(m_regression=m, m_line_search=m,
                      max_iterations=iterations),
        engine_seed=engine_seed, validation_quorum=quorum)
    return search, fleet, wl


def warmed_backend(wl: LmWorkload, m: int) -> LmLossEvalBackend:
    """The backend with its whole bucket ladder run once, as act 1 builds
    it (no bucket shape is first run mid-search)."""
    max_bucket = bucket_size(BatchedVolunteerGrid.warm_max_bucket(m))
    return LmLossEvalBackend(wl, n_dims=wl.k, max_bucket=max_bucket)


def run(search: LmSearch, fleet: GridConfig, backend: LmLossEvalBackend, *,
        pipelined: bool = True, device="cuda"):
    """One act-1 search; returns (engine, grid stats, wall seconds)."""
    engine = search.build_engine(device)
    grid = BatchedVolunteerGrid(None, fleet, backend=backend,
                                pipelined=pipelined)
    t0 = time.perf_counter()
    stats = grid.run(engine)
    return engine, stats, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6-7b")
    ap.add_argument("--k", type=int, default=6)
    ap.add_argument("--m", type=int, default=12)
    ap.add_argument("--iterations", type=int, default=2)
    ap.add_argument("--hosts", type=int, default=48)
    ap.add_argument("--pipelined", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    print(f"== act 1: ANM over the {args.arch} loss landscape "
          f"({args.device}) ==")
    search, fleet, wl = lm_problem(arch=args.arch, k=args.k, m=args.m,
                                   iterations=args.iterations,
                                   n_hosts=args.hosts, device=args.device)
    t0 = time.perf_counter()
    backend = warmed_backend(wl, args.m)
    print(f"  workload: {wl.proj.n_params} params, k={wl.k} subspace, "
          f"warmed ladder in {time.perf_counter() - t0:.1f}s "
          f"({backend.compile_count} bucket shapes)")
    c0 = backend.compile_count
    engine, stats, wall = run(search, fleet, backend,
                              pipelined=args.pipelined, device=args.device)
    loss0 = engine.history[0].best_fitness
    print(f"  {engine.iteration} iterations, loss {loss0:.6f} -> "
          f"{engine.best_fitness:.6f} in {wall:.1f}s wall "
          f"({stats.batch_calls} buckets, "
          f"{backend.compile_count - c0} new bucket shapes mid-run)")


if __name__ == "__main__":
    main()
