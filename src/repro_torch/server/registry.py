"""Host registry: per-host reliability, latency and churn (DESIGN.md §9).

Port of ``repro/server/registry.py``, numpy and plain Python, unchanged but
for its imports.

The FGDO/BOINC server model assumes nothing about a volunteer host except
what it has OBSERVED about it: how much work it took, how much it returned,
how fast, and when it was last heard from.  ``HostRegistry`` is that
observation store, shared by every layer that schedules work —

  * ``core/fgdo.py`` reads the reliable-host gates (``returns_work`` /
    ``reliable``) when handing out latency-critical validation replicas;
  * the work server (``server/server.py``) records every protocol
    message here (issue/result/heartbeat/no-work backoff) and serializes
    the registry into its crash checkpoints;
  * the simulated client pool rebuilds its event schedule from
    ``next_contact_at`` after a crash restore.

Churn model: a host is ``alive`` while it keeps contacting the server,
decays to ``suspect`` after ``suspect_after`` seconds of silence and to
``dead`` after ``dead_after`` (swept lazily from message timestamps, so the
transitions are deterministic in virtual time).  Any contact revives it —
volunteer hosts come and go, and the pull model means a returning host
simply starts requesting work again.

Reliability gates (semantics carried over from the pre-registry
``FgdoAnmServer``, pinned by ``tests/test_fgdo.py``):

  * **return-rate gate** (``returns_work``): a host that takes work and
    vanishes records no turnaround at all, so turnaround alone is
    failure-blind — judge hosts by what they RETURN.  Cold-start grace:
    the gate only engages after ``min_issued_for_rate`` workunits have
    been issued, so a brand-new host with 1 issued / 0 returned (a 0%
    return rate it never had a chance to improve) is not excluded before
    its first result can possibly arrive;
  * **latency gate** (``reliable``): below-median EWMA turnaround among
    observed hosts, with benefit of the doubt while fewer than
    ``min_latency_samples`` hosts have recorded one.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, Optional

ALIVE, SUSPECT, DEAD = "alive", "suspect", "dead"


def _median(vals) -> Optional[float]:
    """Median of a list of floats, bit-identical to ``np.median`` (odd n
    picks the middle element; even n averages the two middles, and /2 is
    an exact float op) without the array-conversion overhead — the
    metrics-hub probe recomputes this every sample, and at fleet sizes
    the numpy round-trip dominated the whole observability budget."""
    if not vals:
        return None
    s = sorted(vals)
    mid = len(s) // 2
    return float(s[mid]) if len(s) % 2 else (s[mid - 1] + s[mid]) / 2.0


@dataclasses.dataclass
class HostRecord:
    """Everything the server knows about one host — all of it learned from
    protocol messages, all of it serializable."""
    host_id: int
    registered_at: float = 0.0
    last_seen: float = 0.0
    issued: int = 0                   # workunits handed to this host
    returned: int = 0                 # results it actually reported
    stale: int = 0                    # returns that arrived phase-stale
    ewma_latency: Optional[float] = None
    state: str = ALIVE
    nowork_streak: int = 0            # consecutive empty-handed requests
    # paged out by the fleet-defense layer (the reference's
    # ``repro/obs/anomaly.py``, not ported yet): a
    # quarantined host fails ``reliable()`` until released.  Defaulted so
    # pre-obs snapshots load unchanged; serialized with the record so a
    # crash-restored registry keeps its quarantine.
    quarantined: bool = False
    # when this host will next contact us (set on every reply; None while
    # it holds a lease — its next contact derives from the lease).  The
    # crash-restored client world is rebuilt from exactly this field.
    next_contact_at: Optional[float] = 0.0

    @property
    def valid_rate(self) -> float:
        """Fraction of returned results that were still usable (not
        phase-stale) — observability, not a scheduling gate."""
        return (self.returned - self.stale) / self.returned \
            if self.returned else 1.0


class HostRegistry:
    def __init__(self, min_return_rate: float = 0.5,
                 min_issued_for_rate: int = 4, latency_alpha: float = 0.3,
                 min_latency_samples: int = 4, suspect_after: float = 300.0,
                 dead_after: float = 1200.0):
        self.min_return_rate = min_return_rate
        self.min_issued_for_rate = min_issued_for_rate
        self.latency_alpha = latency_alpha
        self.min_latency_samples = min_latency_samples
        self.suspect_after = suspect_after
        self.dead_after = dead_after
        self.hosts: Dict[int, HostRecord] = {}
        # monotonic churn-transition counters (observability, surfaced as
        # MetricsHub gauges): alive→suspect and →dead decays counted in
        # sweep(), any-contact revivals counted in touch().  Cheap ints on
        # paths that already walk/touch the record — no new branching cost
        self.churn_to_suspect = 0
        self.churn_to_dead = 0
        self.churn_revived = 0
        # incremental fleet aggregates (DESIGN.md §13): the metrics hub
        # probes ``summary()`` every sample, so the totals are maintained
        # on the paths that already touch a record (a few int ops per
        # message, paid identically with or without a hub) instead of
        # re-scanned per sample — only the latency median / reliable-set
        # pass stays O(n) at sample time
        self._issued_total = 0
        self._returned_total = 0
        self._stale_total = 0
        self._warming = 0             # hosts with no ewma sample yet
        self._quarantined = 0
        self._excluded = 0            # hosts failing the return-rate gate
        self._states = {ALIVE: 0, SUSPECT: 0, DEAD: 0}
        self._suspect_ids: set = set()
        self._dead_ids: set = set()

    # -- bookkeeping ---------------------------------------------------------

    def record(self, host_id: int) -> HostRecord:
        rec = self.hosts.get(host_id)
        if rec is None:
            rec = self.hosts[host_id] = HostRecord(host_id)
            self._states[ALIVE] += 1
            self._warming += 1
        return rec

    def _set_state(self, rec: HostRecord, new_state: str) -> None:
        old = rec.state
        if old == new_state:
            return
        self._states[old] -= 1
        self._states[new_state] += 1
        if old == SUSPECT:
            self._suspect_ids.discard(rec.host_id)
        elif old == DEAD:
            self._dead_ids.discard(rec.host_id)
        if new_state == SUSPECT:
            self._suspect_ids.add(rec.host_id)
        elif new_state == DEAD:
            self._dead_ids.add(rec.host_id)
        rec.state = new_state

    def _rate_excluded(self, rec: HostRecord) -> bool:
        return (rec.issued >= self.min_issued_for_rate and
                rec.returned < self.min_return_rate * rec.issued)

    def register(self, host_id: int, now: float) -> HostRecord:
        """Idempotent: re-registering (a client reconnecting after a server
        crash) revives and touches the record, never resets its history."""
        rec = self.record(host_id)
        if rec.registered_at == 0.0 and rec.last_seen == 0.0:
            rec.registered_at = now
        return self.touch(host_id, now)

    def touch(self, host_id: int, now: float) -> HostRecord:
        """Any contact proves liveness and revives a suspect/dead host."""
        rec = self.record(host_id)
        rec.last_seen = max(rec.last_seen, now)
        if rec.state != ALIVE:
            self.churn_revived += 1
            self._set_state(rec, ALIVE)
        return rec

    def on_issue(self, host_id: int, now: float) -> None:
        rec = self.touch(host_id, now)
        ex0 = self._rate_excluded(rec)
        rec.issued += 1
        self._issued_total += 1
        if self._rate_excluded(rec) != ex0:
            self._excluded += -1 if ex0 else 1
        rec.nowork_streak = 0
        rec.next_contact_at = None    # next contact derives from the lease

    def on_result(self, host_id: int, now: float, turnaround: float,
                  stale: bool = False) -> None:
        rec = self.touch(host_id, now)
        ex0 = self._rate_excluded(rec)
        rec.returned += 1
        self._returned_total += 1
        if stale:
            rec.stale += 1
            self._stale_total += 1
        ta = max(turnaround, 1e-9)
        a = self.latency_alpha
        if rec.ewma_latency is None:
            rec.ewma_latency = ta
            self._warming -= 1
        else:
            rec.ewma_latency = (1 - a) * rec.ewma_latency + a * ta
        if self._rate_excluded(rec) != ex0:
            self._excluded += -1 if ex0 else 1
        rec.nowork_streak = 0
        rec.next_contact_at = now     # a client re-requests immediately

    def on_no_work(self, host_id: int, now: float, retry_after: float) -> None:
        rec = self.touch(host_id, now)
        rec.nowork_streak += 1
        rec.next_contact_at = now + retry_after

    def sweep(self, now: float) -> None:
        """Lazy churn transitions from message-time silence.  Deterministic:
        driven only by the virtual timestamps messages carry."""
        for rec in self.hosts.values():
            silent = now - rec.last_seen
            if silent > self.dead_after:
                if rec.state != DEAD:
                    self.churn_to_dead += 1
                    self._set_state(rec, DEAD)
            elif silent > self.suspect_after:
                if rec.state == ALIVE:
                    self.churn_to_suspect += 1
                self._set_state(rec, SUSPECT)

    # -- scheduling gates ----------------------------------------------------

    def returns_work(self, host_id: int) -> bool:
        """Return-rate gate with the cold-start minimum-sample grace."""
        rec = self.hosts.get(host_id)
        if rec is None:
            return True
        return not (rec.issued >= self.min_issued_for_rate and
                    rec.returned < self.min_return_rate * rec.issued)

    def reliable(self, host_id: int) -> bool:
        """Latency-critical work gate: returns work AND below-median EWMA
        turnaround (unknown hosts get the benefit of the doubt while the
        sample is small).  A quarantined host (paged out by the anomaly-
        defense layer) fails unconditionally until released."""
        rec = self.hosts.get(host_id)
        if rec is not None and rec.quarantined:
            return False
        if not self.returns_work(host_id):
            return False
        t = None if rec is None else rec.ewma_latency
        known = [r.ewma_latency for r in self.hosts.values()
                 if r.ewma_latency is not None]
        if t is None or len(known) < self.min_latency_samples:
            return True
        return t <= _median(known)

    # -- fleet-defense paging (the reference's repro/obs/anomaly.py) ------

    def quarantine(self, host_id: int) -> bool:
        """Page a host out of the ``reliable()`` set.  Returns whether the
        flag actually flipped (idempotent re-pages are no-ops)."""
        rec = self.record(host_id)
        flipped = not rec.quarantined
        rec.quarantined = True
        if flipped:
            self._quarantined += 1
        return flipped

    def release(self, host_id: int) -> bool:
        rec = self.hosts.get(host_id)
        if rec is None or not rec.quarantined:
            return False
        rec.quarantined = False
        self._quarantined -= 1
        return True

    # -- observability -------------------------------------------------------

    def counts(self) -> Dict[str, int]:
        return dict(self._states)

    def ids(self, state: str):
        """Sorted host ids currently in one churn state — the cohort lists
        the anomaly detector pages on."""
        if state == SUSPECT:
            return sorted(self._suspect_ids)
        if state == DEAD:
            return sorted(self._dead_ids)
        return sorted(h for h, r in self.hosts.items() if r.state == state)

    def reliable_set(self):
        """Sorted host ids currently passing ``reliable()`` — the gauge
        the defense gate measurably shrinks.  Same semantics as calling
        ``reliable()`` per host, but the latency median is computed once
        (``summary()``/snapshot probes call this per sample, and the gate
        must stay O(n)).  Hosts still warming up (``ewma_latency is
        None``) are INCLUDED — they hold the benefit of the doubt, and
        are reported separately as ``warming`` rather than silently
        dropped from the gauge."""
        known = [r.ewma_latency for r in self.hosts.values()
                 if r.ewma_latency is not None]
        med = _median(known)
        doubt = len(known) < self.min_latency_samples
        out = []
        for h, r in self.hosts.items():
            if r.quarantined or not self.returns_work(h):
                continue
            if r.ewma_latency is None or doubt or r.ewma_latency <= med:
                out.append(h)
        return sorted(out)

    def summary(self, include_ids: bool = False) -> dict:
        # the totals come from the incremental aggregates; the one pass
        # that remains collects latencies for the median and the
        # reliable-set count (both couple all hosts through the median,
        # so they cannot be maintained incrementally).  The metrics hub
        # calls this every sample — the former per-field scans priced
        # observability at ~25% of a loopback run's wall, far above the
        # §13 overhead ceiling — so the pass is one comprehension, and
        # while nothing is quarantined or rate-excluded (known for free
        # from the aggregates) the gate filter is skipped outright: every
        # host is gated, so the gated latencies ARE ``lat`` and the gated
        # warming count IS ``_warming``.  include_ids adds the
        # suspect/dead cohort id lists the anomaly detector pages on
        # (maintained sets).
        lat: list = []
        by_state: dict = {}   # state -> [sum, count], same single pass
        for r in self.hosts.values():
            d = r.__dict__
            t = d["ewma_latency"]
            if t is not None:
                lat.append(t)
                b = by_state.get(d["state"])
                if b is None:
                    by_state[d["state"]] = [t, 1]
                else:
                    b[0] += t
                    b[1] += 1
        med = _median(lat)
        if self._quarantined or self._excluded:
            min_iss, min_rate = self.min_issued_for_rate, self.min_return_rate
            gd = [d for r in self.hosts.values()
                  if not (d := r.__dict__)["quarantined"]
                  and not ((iss := d["issued"]) >= min_iss
                           and d["returned"] < min_rate * iss)]
            gated = [t for d in gd if (t := d["ewma_latency"]) is not None]
            gated_warming = len(gd) - len(gated)
        else:
            gated, gated_warming = lat, self._warming
        if len(lat) < self.min_latency_samples:
            reliable = gated_warming + len(gated)   # benefit of the doubt
        else:
            reliable = gated_warming + bisect.bisect_right(sorted(gated), med)
        out = {
            "hosts": len(self.hosts), "states": dict(self._states),
            "issued": self._issued_total, "returned": self._returned_total,
            "stale_returns": self._stale_total,
            "median_latency": med,
            # §14 window-detector feed: mean turnaround per state cohort
            "latency_by_state": {s: b[0] / b[1]
                                 for s, b in by_state.items()},
            "excluded_by_return_rate": self._excluded,
            # §13 fleet-health gauges: cold-start hosts are "warming", not
            # invisible; the reliable set is the defended surface
            "warming": self._warming,
            "reliable_set": reliable,
            "quarantined": self._quarantined,
            "churn": {"to_suspect": self.churn_to_suspect,
                      "to_dead": self.churn_to_dead,
                      "revived": self.churn_revived},
        }
        if include_ids:
            out["suspect_ids"] = sorted(self._suspect_ids)
            out["dead_ids"] = sorted(self._dead_ids)
        return out

    # -- serialization -------------------------------------------------------

    def state_dict(self) -> dict:
        # vars() copy, not dataclasses.asdict: the recursive walk is ~50x
        # slower and snapshots serialize thousands of host records
        return {"hosts": {str(h): dict(vars(rec))
                          for h, rec in self.hosts.items()},
                "churn": {"to_suspect": self.churn_to_suspect,
                          "to_dead": self.churn_to_dead,
                          "revived": self.churn_revived}}

    def load_state(self, d: dict) -> None:
        self.hosts = {}
        for h, rec in d["hosts"].items():
            rec = dict(rec)
            rec["host_id"] = int(rec["host_id"])
            self.hosts[int(h)] = HostRecord(**rec)
        churn = d.get("churn", {})
        self.churn_to_suspect = int(churn.get("to_suspect", 0))
        self.churn_to_dead = int(churn.get("to_dead", 0))
        self.churn_revived = int(churn.get("revived", 0))
        self._rebuild_aggregates()

    def _rebuild_aggregates(self) -> None:
        """One recovery-time scan re-derives every incremental aggregate
        from the loaded records — the aggregates are pure caches, never
        serialized, so a snapshot from any prior version restores them."""
        self._issued_total = self._returned_total = self._stale_total = 0
        self._warming = self._quarantined = self._excluded = 0
        self._states = {ALIVE: 0, SUSPECT: 0, DEAD: 0}
        self._suspect_ids, self._dead_ids = set(), set()
        for h, r in self.hosts.items():
            self._states[r.state] += 1
            if r.state == SUSPECT:
                self._suspect_ids.add(h)
            elif r.state == DEAD:
                self._dead_ids.add(h)
            self._issued_total += r.issued
            self._returned_total += r.returned
            self._stale_total += r.stale
            if r.ewma_latency is None:
                self._warming += 1
            if r.quarantined:
                self._quarantined += 1
            if self._rate_excluded(r):
                self._excluded += 1
