"""FleetScheduler: one shared fleet, many concurrent searches (DESIGN.md §8).

Port of ``repro/core/orchestrator/scheduler.py``, over the port's
``BatchedVolunteerGrid``.

The scheduler owns the resource side of multi-search: it partitions the
shared fleet's host capacity into fixed per-search sub-fleets, admits
searches onto them (engine + stepwise ``BatchedVolunteerGrid`` wired to
the coalescing submitter), and advances every live search ONE tick per
scheduling round, flushing the round's shared bucket as a single device
dispatch.

Capacity is fixed at admission for a search's whole lifetime, on purpose:
a search's virtual grid (host speeds, failure draws, completion order) is
a pure function of its ``GridConfig``, so resizing a live search's fleet
would change the trajectory it commits and break the solo-parity
contract — every orchestrated search must remain bit-identical to the
same engine run alone on the same sub-fleet.  Capacity freed by a
finished or killed search is therefore only recycled into NEW searches
(the director's restart policy), never into running ones.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core.engine import AnmEngine
from repro_torch.core.grid import GridConfig
from repro_torch.core.substrates.batched_grid import (BatchedGridStats,
                                                BatchedVolunteerGrid)
from repro_torch.core.substrates.eval_backend import (STAGING_RING, EvalBackend,
                                                bucket_size)
from repro_torch.core.substrates.eval_cache import CachingSubmitter, EvalCache
from repro_torch.core.orchestrator.coalesce import CoalescingSubmitter

#: spacing of derived per-slot grid seeds (a prime, so slots never collide
#: with each other or with small user seed offsets)
SLOT_SEED_STRIDE = 7919

RUNNING, DONE, KILLED = "running", "done", "killed"


@dataclasses.dataclass
class FleetSchedulerStats:
    rounds: int = 0                   # scheduling rounds driven
    steps: int = 0                    # per-search ticks stepped
    admitted: int = 0                 # searches ever admitted
    peak_live: int = 0                # most searches live in one round


class _SharedRingGuard:
    """Uncoalesced multi-search submitter: per-search dispatches straight
    to the backend, but ONE guard across all searches for the backend's
    per-shape staging rings.  Each grid clamps only its OWN pipeline
    depth, so K searches pipelining same-shape buckets would jointly
    overrun the ring; before a submit would alias a still-in-flight slot,
    the guard collects the oldest outstanding handle of that shape early
    (the owning grid's later ``collect`` re-reads the already-materialized
    values — the backend's ownership tokens make a second collect safe,
    and collect timing is invisible to engines by the §7 contract)."""

    def __init__(self, backend: EvalBackend):
        self.backend = backend
        self._inflight: Dict[int, collections.deque] = {}  # kp -> handles
        self._collected: set = set()                       # (kp, seq) done
        self.ring_drains = 0

    def submit(self, pts, mal_u=None):
        kp = bucket_size(len(pts), self.backend.min_bucket)
        dq = self._inflight.setdefault(kp, collections.deque())
        # positional ring: everything older than the newest ring-2
        # submissions of this shape must be collected before submitting
        while len(dq) > STAGING_RING - 2:
            old = dq.popleft()
            key = (old.kp, old.seq)
            if key in self._collected:
                self._collected.discard(key)
            else:
                self.backend.collect(old)     # frees the slot early
                self.ring_drains += 1
        handle = self.backend.submit(pts, mal_u)
        dq.append(handle)
        return handle

    def collect(self, handle):
        dq = self._inflight.get(handle.kp)
        # record only handles the guard still tracks (deques are FIFO in
        # seq order, so anything older than the head was already drained)
        if dq and handle.seq >= dq[0].seq:
            self._collected.add((handle.kp, handle.seq))
        return self.backend.collect(handle)


@dataclasses.dataclass
class LiveSearch:
    """One admitted search: its spec, engine, stepwise grid, and status.
    ``grid_stats`` is sealed by the director when the search leaves the
    fleet (done or killed)."""
    spec: "SearchSpec"                # noqa: F821 — defined in director.py
    engine: AnmEngine
    grid: BatchedVolunteerGrid
    search_id: int
    status: str = RUNNING
    grid_stats: Optional[BatchedGridStats] = None


class FleetScheduler:
    """Partitions host capacity and drives live searches tick-by-tick.

    ``fleet`` describes the TOTAL shared fleet; ``partition``/``subfleet``
    derive the per-search slice.  ``coalesce=True`` (default) routes every
    search's tick blocks through one ``CoalescingSubmitter`` so a round
    costs one device dispatch however many searches are live;
    ``coalesce=False`` keeps per-search dispatches (the serial-equivalent
    baseline the benchmarks time against).  Searches default to the
    pipelined tick loop — coalescing pays off exactly when collects are
    deferred to phase boundaries, so most rounds are pure submits.
    """

    def __init__(self, backend: EvalBackend, fleet: GridConfig, *,
                 coalesce: bool = True, pipelined: bool = True,
                 pipeline_depth: int = 4, tick_batch: Optional[int] = None,
                 overcommit: float = 2.0, min_hosts: int = 16,
                 cache: Optional[EvalCache] = None, dedup: bool = True):
        self.raw_backend = backend
        # the memo layer (DESIGN.md §10) wraps the backend BELOW the
        # coalescer, so exact-hit stripping applies to the whole shared
        # multi-search bucket; bit-exact-only serving keeps every search
        # on its cache-off trajectory (the §8 parity contract holds)
        self.cache = cache
        if cache is not None:
            backend = CachingSubmitter(backend, cache)
        self.backend = backend
        self.fleet = fleet
        self.coalescer = (CoalescingSubmitter(backend, dedup=dedup)
                          if coalesce else None)
        # the uncoalesced path still needs ONE cross-search guard for the
        # backend's staging rings (per-grid depth clamps don't compose)
        self.ring_guard = None if coalesce else _SharedRingGuard(backend)
        self.pipelined = pipelined
        self.pipeline_depth = pipeline_depth
        self.tick_batch = tick_batch
        self.overcommit = overcommit
        self.min_hosts = min_hosts
        self.stats = FleetSchedulerStats()

    # -- capacity ------------------------------------------------------------

    def partition(self, n_searches: int) -> int:
        """Hosts per search: an equal split of the fleet, floored so a
        search is never starved below a working sub-fleet."""
        return max(self.min_hosts,
                   self.fleet.n_hosts // max(n_searches, 1))

    def subfleet(self, slot: int, n_searches: int) -> GridConfig:
        """The sub-fleet the search admitted into ``slot`` owns for its
        whole lifetime.  Fully deterministic: same fleet config + slot =>
        same sub-fleet, which is what lets a solo parity run reconstruct
        exactly the grid an orchestrated search saw."""
        return dataclasses.replace(
            self.fleet, n_hosts=self.partition(n_searches),
            seed=self.fleet.seed + SLOT_SEED_STRIDE * slot)

    def warm(self, n_dims: int, specs: Sequence["SearchSpec"]) -> None:  # noqa: F821
        """Warm the shared backend over the bucket ladder multi-search can
        reach.  Coalescing: one round may carry EVERY live search's tick
        block, so the ladder top is the SUM of the per-search warm bounds.
        Uncoalesced: buckets stay per-search, so the top is their MAX —
        warming the sum there would run shapes no dispatch can ever
        produce.  Without this, the first full round would run new bucket
        shapes inside the timed/parity path (the warm-ladder contract of
        DESIGN.md §7 extends to §8)."""
        bounds = [min(spec.grid.n_hosts,
                      BatchedVolunteerGrid.warm_max_bucket(
                          max(spec.anm.m_regression,
                              spec.anm.m_line_search), self.overcommit))
                  for spec in specs]
        top = sum(bounds) if self.coalescer is not None else max(bounds,
                                                                 default=1)
        self.backend.warm(n_dims, bucket_size(max(top, 1),
                                              self.backend.min_bucket))

    # -- search lifecycle ----------------------------------------------------

    def admit(self, spec: "SearchSpec", search_id: int,  # noqa: F821
              max_ticks: int = 1_000_000,
              max_sim_time: float = float("inf")) -> LiveSearch:
        """Bind a search onto the fleet: engine from the spec, a stepwise
        grid on the spec's sub-fleet, submitter routed through the
        coalescer (tagged with ``search_id``) when coalescing is on."""
        engine = spec.build_engine()
        submitter = (self.coalescer.lane_submitter(search_id)
                     if self.coalescer is not None else self.ring_guard)
        grid = BatchedVolunteerGrid(
            None, spec.grid, tick_batch=self.tick_batch,
            overcommit=self.overcommit, backend=self.backend,
            pipelined=self.pipelined, pipeline_depth=self.pipeline_depth,
            submitter=submitter)
        grid.start(engine, max_ticks, max_sim_time)
        self.stats.admitted += 1
        return LiveSearch(spec=spec, engine=engine, grid=grid,
                          search_id=search_id)

    def round(self, live: Sequence[LiveSearch]) -> List[LiveSearch]:
        """One scheduling round: every live search advances one tick, then
        the shared bucket (all their submits) dispatches once.  Returns
        the searches whose runs ended this round (engine done or budget
        hit) — the caller finalizes them."""
        finished: List[LiveSearch] = []
        for ls in live:
            if ls.grid.step():
                self.stats.steps += 1
            else:
                finished.append(ls)
        if self.coalescer is not None:
            self.coalescer.flush()
        self.stats.rounds += 1
        self.stats.peak_live = max(self.stats.peak_live, len(live))
        return finished
