"""SearchDirector: the portfolio layer over the shared fleet (DESIGN.md §8).

Port of ``repro/core/orchestrator/director.py``, over the port's engine and
batched grid.

The paper's ANM is a *local* optimizer that FGDO schedules as one of many
concurrent searches over a single volunteer grid; this module is that
outer layer for the reproduction.  A director owns N ``SearchSpec``s
(multi-start seeds, heterogeneous ``AnmConfig``s, different starts and
bounds), admits them onto a ``FleetScheduler``, and applies a restart /
portfolio policy between scheduling rounds:

  * ``fixed``     — run every search to completion (pure multi-start);
  * ``portfolio`` — best-of-portfolio with early kill: a search that has
                    had its probation and still trails the incumbent by
                    the kill margin is retired, freeing its capacity;
  * ``restart``   — every finished search hands its capacity to a fresh
                    search started from a perturbation of the incumbent
                    (the classic multi-start-with-restarts portfolio).

Policies only decide WHICH searches are stepped — never what any engine
sees.  A killed search simply stops being stepped (its committed prefix
is exactly what a solo run would have committed); a restart is a brand
new search on a fresh deterministic spec.  The director's own rng draws
restart perturbations only and never touches per-search rngs, so every
orchestrated trajectory stays bit-identical to a solo run of its spec.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.engine import AnmConfig, AnmEngine
from repro_torch.core.grid import GridConfig
from repro_torch.core.orchestrator.coalesce import CoalesceStats
from repro_torch.core.orchestrator.scheduler import (DONE, KILLED, FleetScheduler,
                                               FleetSchedulerStats,
                                               LiveSearch)
from repro_torch.core.substrates.batched_grid import BatchedVolunteerGrid

#: spacing of derived restart seeds (engine and grid), prime like the
#: scheduler's slot stride so independently-derived streams never collide
RESTART_SEED_STRIDE = 104729


def dominated_cut(best: float, kill_margin: float) -> float:
    """THE portfolio kill threshold: a search trailing the incumbent by
    more than ``kill_margin`` on the sign-safe ``|best| + 1`` scale (the
    same scale as ``grid.malicious_lie``) is dominated.  Shared by the
    director's between-round policy and the work server's portfolio
    routing (``server/server.py``), so the two layers can never
    disagree about what "dominated" means."""
    return best + kill_margin * (abs(best) + 1.0)


@dataclasses.dataclass(frozen=True)
class SearchSpec:
    """Everything needed to run one search — and to REPRODUCE it alone:
    a solo ``BatchedVolunteerGrid(None, spec.grid, backend=...)`` run of
    an engine built from these fields commits bit-identical iterates to
    the orchestrated search (the parity contract's baseline)."""
    name: str
    x0: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    step: np.ndarray
    anm: AnmConfig
    grid: GridConfig                  # the search's fixed sub-fleet
    engine_seed: int = 0
    validation_quorum: int = 2
    #: where the engine's phase finish runs (the port's one field beyond
    #: the reference's: the card unless the caller asks for the CPU)
    device: str = "cuda"

    def build_engine(self) -> AnmEngine:
        """The engine this spec describes — used by the scheduler at
        admission AND by every parity baseline, so the two can never
        drift apart field by field."""
        return AnmEngine(self.x0, self.lo, self.hi, self.step, self.anm,
                         seed=self.engine_seed,
                         validation_quorum=self.validation_quorum,
                         device=self.device)

    def solo_run(self, backend, *, pipelined: bool = True,
                 tick_batch: Optional[int] = None, overcommit: float = 2.0,
                 pipeline_depth: int = 4) -> AnmEngine:
        """THE parity baseline: this spec's engine alone on this spec's
        sub-fleet over ``backend``.  The knobs mirror `FleetScheduler`'s
        — pass the scheduler's values when checking an orchestrated run.
        Every parity gate (tests, ``chip_smoke.py``) calls this one
        helper, so a spec field can't be silently dropped from the
        contract."""
        engine = self.build_engine()
        BatchedVolunteerGrid(None, self.grid, tick_batch=tick_batch,
                             overcommit=overcommit, backend=backend,
                             pipelined=pipelined,
                             pipeline_depth=pipeline_depth).run(engine)
        return engine


@dataclasses.dataclass
class MultiSearchResult:
    """Outcome of a director run: every search that ever lived (admission
    order), the round count, and the fleet/coalescing instrumentation."""
    outcomes: List[LiveSearch]
    rounds: int
    scheduler_stats: FleetSchedulerStats
    coalesce_stats: Optional[CoalesceStats]

    @property
    def best(self) -> Optional[LiveSearch]:
        """The incumbent: lowest finite committed fitness across the whole
        portfolio (None only if no search ever committed one)."""
        cands = [o for o in self.outcomes
                 if np.isfinite(o.engine.best_fitness)]
        return min(cands, key=lambda o: o.engine.best_fitness,
                   default=None)


def multi_start_specs(scheduler: FleetScheduler, x0, lo, hi, step,
                      anm: AnmConfig, n_searches: int, *, seed: int = 0,
                      jitter: float = 0.25,
                      configs: Optional[Sequence[AnmConfig]] = None,
                      validation_quorum: int = 2,
                      name: str = "search") -> List[SearchSpec]:
    """The standard multi-start portfolio: search 0 keeps the caller's
    start, the rest perturb it by ``jitter × step`` (clipped to bounds);
    engine seeds and sub-fleets are derived deterministically per slot.
    ``configs`` (cycled) makes the portfolio heterogeneous — e.g. half the
    searches on a cheaper ``m`` than the paper's 1000.  The engines run
    on the scheduler's backend's device."""
    device = str(scheduler.backend.device)
    rng = np.random.default_rng(seed)
    x0 = np.asarray(x0, np.float64)
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    step = np.asarray(step, np.float64)
    specs = []
    for i in range(n_searches):
        xi = x0 if i == 0 or jitter <= 0 else np.clip(
            x0 + jitter * step * rng.standard_normal(x0.shape), lo, hi)
        specs.append(SearchSpec(
            name=f"{name}-{i}", x0=xi, lo=lo, hi=hi, step=step,
            anm=(configs[i % len(configs)] if configs else anm),
            grid=scheduler.subfleet(i, n_searches),
            engine_seed=seed + 101 * i + 1,
            validation_quorum=validation_quorum, device=device))
    return specs


class SearchDirector:
    """Runs a portfolio of searches over one ``FleetScheduler``.

    ``kill_margin`` is relative on the ``|best| + 1`` scale (the same
    sign-safe scale as ``grid.malicious_lie``), so portfolios near zero
    or negative fitness behave; ``probation_iterations`` committed
    iterations shield young searches from an early incumbent.
    ``max_rounds`` is a hard scheduling budget — leftover searches are
    retired as killed, never silently dropped."""

    def __init__(self, scheduler: FleetScheduler,
                 specs: Sequence[SearchSpec], policy: str = "fixed", *,
                 kill_margin: float = 0.5, probation_iterations: int = 2,
                 max_restarts: int = 0, restart_sigma: float = 0.25,
                 seed: int = 0, max_rounds: int = 10_000_000,
                 kill_schedule: Optional[dict] = None):
        if policy not in ("fixed", "portfolio", "restart"):
            raise ValueError(f"unknown policy {policy!r}")
        self.scheduler = scheduler
        self.specs = list(specs)
        self.policy = policy
        self.kill_margin = kill_margin
        self.probation_iterations = probation_iterations
        self.max_restarts = max_restarts
        self.restart_sigma = restart_sigma
        self.max_rounds = max_rounds
        self._rng = np.random.default_rng(seed)
        self._restarts_used = 0
        # §14 director-level replay seam: a recorded ``kill_log`` from a
        # defended run ({name: round}) re-applied at the same round
        # boundaries — the director twin of the FleetDefense schedule.
        # A round boundary is a pure function of the scheduling sequence,
        # so a scheduled kill lands at the same committed prefix in any
        # two runs of the same specs.
        self.kill_schedule = dict(kill_schedule) if kill_schedule else None
        self.kill_log: List[dict] = []
        self._live: List[LiveSearch] = []
        self._round = 0

    # -- policy helpers ------------------------------------------------------

    @staticmethod
    def _incumbent(searches: Sequence[LiveSearch]):
        cands = [ls for ls in searches
                 if np.isfinite(ls.engine.best_fitness)]
        return min(cands, key=lambda ls: ls.engine.best_fitness,
                   default=None)

    def _dominated(self, live: Sequence[LiveSearch],
                   everyone: Sequence[LiveSearch]) -> List[LiveSearch]:
        inc = self._incumbent(everyone)
        if inc is None:
            return []
        cut = dominated_cut(inc.engine.best_fitness, self.kill_margin)
        return [ls for ls in live
                if ls.engine.iteration >= self.probation_iterations
                and ls.engine.best_fitness > cut]

    def _restart_spec(self, dead: LiveSearch,
                      everyone: Sequence[LiveSearch]) -> SearchSpec:
        """A fresh spec on the dead search's capacity: start from a
        perturbed incumbent (or the dead search's own start if nothing
        committed yet), with freshly-derived engine and grid seeds."""
        j = self._restarts_used
        base = dead.spec
        inc = self._incumbent(everyone)
        if inc is None:
            x0 = base.x0
        else:
            x0 = np.clip(
                np.asarray(inc.engine.center, np.float64)
                + self.restart_sigma * np.asarray(base.step, np.float64)
                * self._rng.standard_normal(len(base.x0)),
                base.lo, base.hi)
        stride = RESTART_SEED_STRIDE * (j + 1)
        return dataclasses.replace(
            base, name=f"{base.name}~r{j}", x0=x0,
            engine_seed=base.engine_seed + stride,
            grid=dataclasses.replace(base.grid,
                                     seed=base.grid.seed + stride))

    def _retire(self, ls: LiveSearch, status: str) -> None:
        ls.grid_stats = ls.grid.finish()   # drain in-flight buckets
        ls.status = status

    def kill_search(self, name) -> bool:
        """Director seam (§14): retire one live search by verdict —
        ``name`` is the spec name or the admission ``search_id``.  The
        kill is logged with the current round, so ``kill_log`` re-applied
        as ``kill_schedule`` reproduces it at the same boundary.  Safe to
        call from a ``FleetDefense`` verdict between rounds; a name that
        is not live is a no-op (False)."""
        for ls in list(self._live):
            if ls.spec.name == name or ls.search_id == name:
                self._live.remove(ls)
                self._retire(ls, KILLED)
                self.kill_log.append({"name": ls.spec.name,
                                      "round": self._round})
                return True
        return False

    def _apply_kill_schedule(self) -> None:
        if not self.kill_schedule:
            return
        for name, rnd in self.kill_schedule.items():
            if int(rnd) == self._round:
                self.kill_search(name)

    # -- the run loop --------------------------------------------------------

    def run(self, max_ticks: int = 1_000_000,
            max_sim_time: float = float("inf")) -> MultiSearchResult:
        sched = self.scheduler
        if self.specs:
            sched.warm(len(self.specs[0].x0), self.specs)
        live = [sched.admit(spec, i, max_ticks, max_sim_time)
                for i, spec in enumerate(self.specs)]
        self._live = live                  # the kill seam's target list
        everyone = list(live)
        next_id = len(live)
        rounds = 0
        self._round = 0
        self._apply_kill_schedule()        # round-0 kills: before any step
        while live and rounds < self.max_rounds:
            finished = sched.round(live)
            rounds += 1
            self._round = rounds
            self._apply_kill_schedule()
            for ls in finished:
                live.remove(ls)
                self._retire(ls, DONE)
                if self.policy == "restart" \
                        and self._restarts_used < self.max_restarts:
                    spec = self._restart_spec(ls, everyone)
                    self._restarts_used += 1
                    # the restart inherits capacity, not history: it must
                    # fit the warmed ladder, which it does by construction
                    # (same sub-fleet size and an anm no larger than base)
                    nls = sched.admit(spec, next_id, max_ticks,
                                      max_sim_time)
                    next_id += 1
                    live.append(nls)
                    everyone.append(nls)
            if self.policy == "portfolio" and live:
                for ls in self._dominated(live, everyone):
                    live.remove(ls)
                    self._retire(ls, KILLED)
        for ls in live:                    # max_rounds budget exhausted
            self._retire(ls, KILLED)
        return MultiSearchResult(
            outcomes=everyone, rounds=rounds,
            scheduler_stats=sched.stats,
            coalesce_stats=(sched.coalescer.stats
                            if sched.coalescer is not None else None))
