"""MetricsHub: the live observability plane's collection core (DESIGN.md §13).

Port of ``repro/obs/metrics.py``, plain Python, unchanged but for its
imports.  Probes read host state only (counters, registry summaries,
``CacheStats``): a probe runs on whichever thread applies a message or
serves a poll, and must never read a tensor, which would wait on the
evaluation backend's CUDA stream.

Two publication styles, chosen so the hot paths pay nothing they do not
already pay:

  * **pull probes** — every hot layer already maintains cheap stats
    objects (``ServerCounters``, ``BatchedGridStats``, ``CoalesceStats``,
    ``CacheStats``, the registry's churn ledger, the sequenced intake's
    depth counters).  A probe is a zero-argument callable that reads one
    of them into a plain dict; the hub calls it only at SAMPLE time.  The
    hot path has no new branch, no new write — publishing is free between
    samples by construction.
  * **push counters** — ``inc(name)`` for the handful of events that have
    no existing stats object (registry churn transitions use this via the
    registry's own ints; the hub-level counters exist for ad-hoc layers).
    An increment is one dict ``__setitem__`` — cheap enough to stay on.

Sampling is driven by **virtual time**: ``maybe_sample(now)`` is called at
applied-message boundaries with the server's message-derived clock, so
given the same applied message sequence the snapshot boundaries are
deterministic — which is what lets the anomaly-defense layer
(``repro.obs.anomaly``) act on samples and still replay bit-identically
from a recorded schedule.  Snapshots land in a fixed-size ring
(``maxlen=ring``): the hub's memory is bounded no matter how long the
server runs, and ``since(cursor)`` serves the ``subscribe_stats`` wire
extension by cursor — a slow subscriber misses old snapshots instead of
growing server state.

Nothing here is part of any ``state_dict``: snapshots are never logged,
never replayed, and a crash-restored server starts a fresh ring (§13's
recovery-compatibility argument — observability must not perturb the
replay contract, so it owns no replayable state).
"""
from __future__ import annotations

import collections
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: version stamped into every snapshot and ``stats`` reply — a consumer
#: of the stream checks this, not PROTOCOL_VERSION (the framing version)
STREAM_VERSION = 1


def _plain(x):
    """Sanitize probe output for the wire codecs: numpy scalars → python,
    non-finite floats kept (both codecs carry them), dict keys → str
    (msgpack allows int keys but JSON silently rewrites them — emit one
    shape so codec choice can never change a snapshot's schema)."""
    # scalar leaves first (bool is an int subclass, so one check covers
    # it): they are ~90% of snapshot nodes and this walk runs per sample
    if x is None or isinstance(x, (int, float, str)):
        return x
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    item = getattr(x, "item", None)           # numpy scalars
    if callable(item):
        return _plain(item())
    return str(x)


class MetricsHub:
    """Counters + probes in, stamped ring-buffered snapshots out."""

    def __init__(self, interval: float = 25.0, ring: int = 256):
        if interval <= 0:
            raise ValueError("interval must be positive virtual seconds")
        self.interval = float(interval)
        self.ring = int(ring)
        self._probes: "collections.OrderedDict[str, Tuple[Callable[[], dict], Tuple[str, ...]]]" = \
            collections.OrderedDict()
        self._counters: Dict[str, int] = {}
        self._snapshots: collections.deque = collections.deque(maxlen=ring)
        self._seq = 0
        #: next virtual time a ``maybe_sample`` will fire (None: fires on
        #: the first call).  Public so the server's per-message hook can
        #: inline the compare and skip the call entirely between samples.
        self.next_sample_at: Optional[float] = None
        self._prev: Optional[dict] = None      # last snapshot, for rates
        self._subscribers: List[Callable[[dict], None]] = []

    # -- publication side ----------------------------------------------------

    def inc(self, name: str, n: int = 1) -> None:
        """Monotonic push counter — one dict write, safe on any path."""
        self._counters[name] = self._counters.get(name, 0) + n

    def counter(self, name: str) -> int:
        return self._counters.get(name, 0)

    def register_probe(self, name: str, fn: Callable[[], dict],
                       rates: Sequence[str] = (),
                       plain: bool = False) -> None:
        """Register a sample-time reader.  ``fn()`` must return a plain
        dict of scalars/lists (read-only: a probe must never mutate what
        it reads).  Keys named in ``rates`` additionally get a derived
        ``<key>_per_s`` gauge from the delta vs the previous snapshot in
        virtual time (how ``messages/sec`` is produced without any hot-
        path timing).  ``plain=True`` promises the output is ALREADY
        codec-neutral (python scalars, str keys, fresh dicts) and skips
        the per-sample sanitizing walk — the server's own probes qualify,
        and at fleet scale that walk was a measurable share of the §13
        overhead budget."""
        self._probes[name] = (fn, tuple(rates), bool(plain))

    def on_sample(self, cb: Callable[[dict], None]) -> None:
        """Run ``cb(snapshot)`` synchronously after every sample — the
        anomaly-defense hook.  Callbacks run at the deterministic sample
        boundary, in registration order."""
        self._subscribers.append(cb)

    # -- sampling ------------------------------------------------------------

    def maybe_sample(self, now: float) -> Optional[dict]:
        """Sample iff ``interval`` virtual seconds elapsed since the last
        snapshot (and once immediately on the first call).  Called at
        applied-message boundaries; deterministic in the applied order."""
        if self.next_sample_at is not None and now < self.next_sample_at:
            return None
        snap = self.sample(now)
        self.next_sample_at = now + self.interval
        return snap

    def sample(self, now: float) -> dict:
        groups: Dict[str, dict] = {}
        for name, (fn, rates, plain) in self._probes.items():
            doc = fn() if plain else _plain(fn())
            if rates and self._prev is not None:
                dt = float(now) - float(self._prev["now"])
                prev_doc = self._prev["groups"].get(name, {})
                for key in rates:
                    cur, old = doc.get(key), prev_doc.get(key)
                    if dt > 0 and isinstance(cur, (int, float)) \
                            and isinstance(old, (int, float)):
                        doc[key + "_per_s"] = (cur - old) / dt
            groups[name] = doc
        snap = {
            "stream_v": STREAM_VERSION,
            "seq": self._seq,
            "now": float(now),
            "counters": dict(self._counters),
            "groups": groups,
        }
        self._seq += 1
        self._snapshots.append(snap)
        self._prev = snap
        for cb in self._subscribers:
            cb(snap)
        return snap

    # -- consumption side ----------------------------------------------------

    @property
    def seq(self) -> int:
        """Stamps handed out so far (next snapshot gets this seq)."""
        return self._seq

    def latest(self) -> Optional[dict]:
        return self._snapshots[-1] if self._snapshots else None

    def since(self, cursor: int) -> Tuple[List[dict], int, int]:
        """Snapshots with ``seq > cursor`` (oldest first), the new cursor,
        and the count of snapshots the cursor missed because the ring
        already dropped them.  A consumer that fell off the ring resumes
        at the oldest retained snapshot — by design, not an error — but
        the gap is reported, not silent (§14 satellite)."""
        out = [s for s in self._snapshots if s["seq"] > cursor]
        new_cursor = out[-1]["seq"] if out else max(cursor, self._seq - 1)
        if self._snapshots:
            oldest = self._snapshots[0]["seq"]
        else:
            oldest = self._seq                 # nothing retained at all
        dropped = max(0, oldest - max(cursor, -1) - 1)
        return out, new_cursor, dropped

    def series(self, group: str, key: str) -> List[Tuple[float, float]]:
        """One gauge's retained time-series: [(now, value), ...] — the
        dashboard's sparkline source."""
        out = []
        for s in self._snapshots:
            v = s["groups"].get(group, {}).get(key)
            if isinstance(v, (int, float)) and math.isfinite(float(v)):
                out.append((s["now"], float(v)))
        return out


# -- probe adapters for the hot layers ----------------------------------------
#
# Each helper registers a read-only view over a layer's existing stats
# object.  They live here (not in the layers) so a layer imports nothing
# from the obs plane — instrumentation is attach-time wiring, and a build
# without observability never touches this module.

def attach_engine(hub: MetricsHub, engine, name: str = "engine") -> None:
    """Phase machine + commit trajectory: phase, iteration (== commits),
    best fitness, and the full ``EngineStats`` counter set."""
    import dataclasses

    def probe() -> dict:
        d = dataclasses.asdict(engine.stats)
        d.update(phase=engine.phase, iteration=engine.iteration,
                 best_fitness=engine.best_fitness,
                 commits=len(engine.history))
        return d

    hub.register_probe(name, probe)


def attach_grid(hub: MetricsHub, grid, name: str = "grid") -> None:
    """Tick counters + the live device-pipeline depth of a
    ``BatchedVolunteerGrid``."""
    import dataclasses

    def probe() -> dict:
        d = dataclasses.asdict(grid.stats)
        d["in_flight"] = grid.in_flight
        return d

    hub.register_probe(name, probe, rates=("ticks",))


def attach_coalescer(hub: MetricsHub, submitter,
                     name: str = "coalescer") -> None:
    """Dispatch/padding amortization counters + live ring pressure of a
    ``CoalescingSubmitter``."""
    import dataclasses

    def probe() -> dict:
        d = dataclasses.asdict(submitter.stats)
        d["ring_pressure"] = submitter.ring_pressure
        return d

    hub.register_probe(name, probe)


def attach_cache(hub: MetricsHub, cache, name: str = "cache") -> None:
    """Hit/miss/store counters of an ``EvalCache`` (the same doc the wire
    ``status`` reply carries)."""
    hub.register_probe(name, cache.status, rates=("hits", "misses"))


def attach_intake(hub: MetricsHub, intake, name: str = "intake") -> None:
    """Sequenced-intake pressure: next expected stamp, parked arrivals,
    out-of-band (retry) deliveries."""

    def probe() -> dict:
        return {"next_seq": intake.next_seq, "parked": intake.parked,
                "out_of_band": intake.out_of_band}

    hub.register_probe(name, probe)
