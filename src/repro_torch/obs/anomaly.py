"""Anomaly detection over the stats stream + deterministic fleet defense.

Port of ``repro/obs/anomaly.py``, plain Python, unchanged; its schedules
are the reference's JSON, read by either package.

``FleetDefense`` subscribes to a ``MetricsHub`` (``hub.on_sample``) and
watches the server-side snapshot groups — ``registry`` and ``server``
only, the groups whose values are a pure function of the applied message
sequence (client-side groups like the pool's are racy-by-design gauges
and MUST NOT feed a gate).  Detectors:

  * **suspect cohort** — hosts newly flipped alive→suspect/dead since the
    last page.  Gate-affecting: the cohort is QUARANTINED in the
    ``HostRegistry`` (``reliable()`` → False), shrinking the reliable set
    that ``FgdoAnmServer`` draws latency-critical validation replicas
    from.  A host that revives (any-contact) is RELEASED — and, per the
    paging contract, each cohort transition fires exactly once: a host
    that stays suspect across many samples does not re-page, a release
    does not re-page, and only a fresh alive→suspect transition after a
    revival pages again.
  * **stale-rate spike** — phase-stale returns per returned result over
    the last sample window above ``stale_rate_spike``.  Page-only.
  * **duplicate-report spike** — duplicate report deliveries per window
    above ``dup_spike``.  Page-only.
  * **cache hit-rate collapse** — hit rate dropping below
    ``hit_rate_floor`` after having been above it.  Page-only.
  * **turnaround drift** (window detector, §14) — per state-cohort EWMA
    of the registry's mean turnaround: a fast EWMA drifting more than
    ``turnaround_drift`` above the slow baseline EWMA pages the cohort.
    Page-only; armed when ``turnaround_drift > 0``.
  * **search stall** (window detector, §14) — a running search with no
    committed improvement (iteration or best fitness) for
    ``stall_window`` consecutive samples is KILLED through the director
    seam (``director.kill_search(search_id)`` — the work server and the
    orchestrator's ``SearchDirector`` both implement it).  Gate-affecting:
    recorded as a ``kill_search`` event and re-applied at the recorded
    seq on replay, exactly like quarantine.  Armed when
    ``stall_window > 0`` and a director is attached.

Page-only events are recorded but touch no gate: they are operator
signal.  Every event (gate-affecting or not) is appended to a JSON-able
**anomaly schedule** keyed by snapshot ``seq``, and mirrored to any
``on_event`` sink (the retention store's post-mortem feed).

Determinism story (the §13 gate): sampling happens at applied-message
boundaries in virtual time, so snapshot ``seq`` k lands at the same
applied message in any two runs with the same message prefix.  A live
defended run records ``(seq, action, hosts)``; a REPLAY run
(``FleetDefense.replay(schedule)``) applies exactly those actions at
exactly those seqs without consulting the detectors.  By induction the
two runs apply identical registry mutations at identical boundaries —
bit-identical committed iterates, solo-reproducible from the recorded
schedule.  (A crash-restored defended run is reproduced the same way:
re-run from the recorded schedule.  Observability WITHOUT defense owns
no mutable state at all, so its crash story is the unchanged §9 one.)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

SCHEDULE_VERSION = 1

#: gate-affecting actions — the only ones a replay applies
QUARANTINE, RELEASE = "quarantine", "release"
#: gate-affecting director action (§14): retire a stalled search
KILL = "kill_search"
#: page-only action: recorded, surfaced, no gate effect
PAGE = "page"


@dataclasses.dataclass
class AnomalyEvent:
    seq: int                          # snapshot seq the verdict fired at
    now: float                        # that snapshot's virtual time
    kind: str                         # suspect_cohort | revived_cohort |
    #                                   stale_spike | dup_spike |
    #                                   cache_collapse
    action: str                       # quarantine | release | page
    hosts: List[int]                  # affected cohort (empty for rates)
    detail: Dict[str, float] = dataclasses.field(default_factory=dict)

    def to_doc(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_doc(cls, d: dict) -> "AnomalyEvent":
        return cls(seq=int(d["seq"]), now=float(d["now"]),
                   kind=str(d["kind"]), action=str(d["action"]),
                   hosts=[int(h) for h in d["hosts"]],
                   detail=dict(d.get("detail", {})))


class FleetDefense:
    """Anomaly verdicts paging the registry's scheduling gates.

    Live mode (``schedule=None``): detect on every hub sample, apply
    quarantine/release, record the schedule.  Replay mode (``schedule``
    given): apply the recorded gate actions at their recorded seqs,
    detectors off — the solo-reproducibility twin of a live run.
    """

    def __init__(self, registry, hub, *, schedule: Optional[dict] = None,
                 min_cohort: int = 1, stale_rate_spike: float = 0.5,
                 dup_spike: int = 8, hit_rate_floor: float = 0.2,
                 director=None, stall_window: int = 0,
                 turnaround_drift: float = 0.0, ewma_alpha: float = 0.25):
        self.registry = registry
        self.min_cohort = int(min_cohort)
        self.stale_rate_spike = float(stale_rate_spike)
        self.dup_spike = int(dup_spike)
        self.hit_rate_floor = float(hit_rate_floor)
        # §14 window detectors: ``director`` is the kill seam (anything
        # with ``kill_search(search_id)`` — the work server or the
        # orchestrator's SearchDirector); stall_window counts samples,
        # turnaround_drift is the fractional fast-over-slow EWMA trigger
        self.director = director
        self.stall_window = int(stall_window)
        self.turnaround_drift = float(turnaround_drift)
        self.ewma_alpha = float(ewma_alpha)
        self.events: List[AnomalyEvent] = []
        self._paged: Set[int] = set()         # hosts currently quarantined
        self._rate_latched: Set[str] = set()  # page-only detectors latched
        self._hit_rate_seen_high = False
        self._prev_groups: Optional[dict] = None
        self._killed: Set[int] = set()        # searches killed by verdict
        self._stall: Dict[int, list] = {}     # sid -> [iter, best, count]
        self._ewma: Dict[str, list] = {}      # cohort -> [fast, slow, n]
        self._sinks: List = []
        self._replay: Optional[Dict[int, List[AnomalyEvent]]] = None
        if schedule is not None:
            if int(schedule.get("v", -1)) != SCHEDULE_VERSION:
                raise ValueError(
                    f"anomaly schedule version {schedule.get('v')!r} != "
                    f"{SCHEDULE_VERSION}")
            self._replay = {}
            for ed in schedule["events"]:
                ev = AnomalyEvent.from_doc(ed)
                self._replay.setdefault(ev.seq, []).append(ev)
        hub.on_sample(self._on_sample)

    @classmethod
    def replay(cls, registry, hub, schedule: dict,
               director=None) -> "FleetDefense":
        return cls(registry, hub, schedule=schedule, director=director)

    def on_event(self, cb) -> None:
        """Mirror every recorded event to ``cb(event)`` — the retention
        sink's feed.  Called after the event is applied and appended."""
        self._sinks.append(cb)

    @property
    def live(self) -> bool:
        return self._replay is None

    # -- the sample hook -----------------------------------------------------

    def _on_sample(self, snap: dict) -> None:
        if self._replay is not None:
            for ev in self._replay.get(int(snap["seq"]), []):
                self._apply(ev)
                self._record(ev)
            return
        self._detect_cohort(snap)
        self._detect_rates(snap)
        if self.turnaround_drift > 0.0:
            self._detect_turnaround(snap)
        if self.stall_window > 0 and self.director is not None:
            self._detect_stall(snap)

    def _record(self, ev: AnomalyEvent) -> None:
        self.events.append(ev)
        for cb in self._sinks:
            cb(ev)

    def _apply(self, ev: AnomalyEvent) -> None:
        if ev.action == QUARANTINE:
            for h in ev.hosts:
                self.registry.quarantine(h)
            self._paged.update(ev.hosts)
        elif ev.action == RELEASE:
            for h in ev.hosts:
                self.registry.release(h)
            self._paged.difference_update(ev.hosts)
        elif ev.action == KILL:
            sid = int(ev.detail["search_id"])
            if sid not in self._killed and self.director is not None:
                self.director.kill_search(sid)
            self._killed.add(sid)

    # -- live detectors ------------------------------------------------------

    def _detect_cohort(self, snap: dict) -> None:
        reg = snap["groups"].get("registry")
        if reg is None:
            return
        down = {int(h) for h in reg.get("suspect_ids", [])} \
            | {int(h) for h in reg.get("dead_ids", [])}
        newly = sorted(down - self._paged)
        if len(newly) >= self.min_cohort:
            ev = AnomalyEvent(
                seq=int(snap["seq"]), now=float(snap["now"]),
                kind="suspect_cohort", action=QUARANTINE, hosts=newly,
                detail={"suspect": float(len(down))})
            self._apply(ev)
            self._record(ev)
        revived = sorted(self._paged - down)
        if revived:
            ev = AnomalyEvent(
                seq=int(snap["seq"]), now=float(snap["now"]),
                kind="revived_cohort", action=RELEASE, hosts=revived)
            self._apply(ev)
            self._record(ev)

    def _detect_rates(self, snap: dict) -> None:
        srv = snap["groups"].get("server", {})
        reg = snap["groups"].get("registry", {})
        cache = snap["groups"].get("cache")
        prev = self._prev_groups
        self._prev_groups = {"server": srv, "registry": reg}

        def delta(cur: dict, old: dict, key: str) -> float:
            c, o = cur.get(key), old.get(key)
            if isinstance(c, (int, float)) and isinstance(o, (int, float)):
                return float(c) - float(o)
            return 0.0

        def fire(name: str, cond: bool, detail: Dict[str, float]) -> None:
            # latch per detector: fire on the False→True edge only, re-arm
            # once the condition clears — a sustained spike is one page
            if cond and name not in self._rate_latched:
                self._rate_latched.add(name)
                self._record(AnomalyEvent(
                    seq=int(snap["seq"]), now=float(snap["now"]),
                    kind=name, action=PAGE, hosts=[], detail=detail))
            elif not cond:
                self._rate_latched.discard(name)

        if prev:
            d_ret = delta(reg, prev["registry"], "returned")
            d_stale = delta(reg, prev["registry"], "stale_returns")
            rate = d_stale / d_ret if d_ret > 0 else 0.0
            fire("stale_spike", d_ret > 0 and rate > self.stale_rate_spike,
                 {"stale_rate": rate})
            d_dup = delta(srv, prev["server"], "duplicate_reports")
            fire("dup_spike", d_dup > self.dup_spike,
                 {"duplicate_reports": d_dup})
        if cache is not None:
            hr = cache.get("hit_rate")
            if isinstance(hr, (int, float)):
                if hr >= self.hit_rate_floor:
                    self._hit_rate_seen_high = True
                fire("cache_collapse",
                     self._hit_rate_seen_high and hr < self.hit_rate_floor,
                     {"hit_rate": float(hr)})

    # -- §14 window detectors ------------------------------------------------

    def _detect_turnaround(self, snap: dict) -> None:
        """Per state-cohort EWMA drift: a fast EWMA of the cohort's mean
        turnaround rising more than ``turnaround_drift`` above the slow
        baseline pages that cohort.  Page-only, latched per cohort."""
        reg = snap["groups"].get("registry", {})
        by_state = reg.get("latency_by_state")
        if not isinstance(by_state, dict):
            return
        for state, mean in by_state.items():
            if not isinstance(mean, (int, float)):
                continue
            mean = float(mean)
            ent = self._ewma.get(state)
            if ent is None:
                self._ewma[state] = [mean, mean, 1]
                continue
            a = self.ewma_alpha
            ent[0] += a * (mean - ent[0])            # fast
            ent[1] += (a / 4.0) * (mean - ent[1])    # slow baseline
            ent[2] += 1
            name = f"turnaround_drift:{state}"
            drifted = (ent[2] >= 8 and ent[1] > 0.0
                       and ent[0] > (1.0 + self.turnaround_drift) * ent[1])
            if drifted and name not in self._rate_latched:
                self._rate_latched.add(name)
                self._record(AnomalyEvent(
                    seq=int(snap["seq"]), now=float(snap["now"]),
                    kind="turnaround_drift", action=PAGE, hosts=[],
                    detail={"state_cohort": state, "fast_ewma": ent[0],
                            "slow_ewma": ent[1],
                            "drift": ent[0] / ent[1] - 1.0}))
            elif not drifted:
                self._rate_latched.discard(name)

    def _detect_stall(self, snap: dict) -> None:
        """Per-search stall: a RUNNING search whose (iteration, best) pair
        hasn't moved for ``stall_window`` consecutive samples is retired
        through the director seam.  Gate-affecting, fires once per
        search."""
        srv = snap["groups"].get("server", {})
        searches = srv.get("searches")
        if not isinstance(searches, list):
            return
        for s in searches:
            sid = int(s["search_id"])
            if s.get("status") != "running" or sid in self._killed:
                self._stall.pop(sid, None)
                continue
            prog = (int(s.get("iteration", 0)), float(s.get("best", 0.0)))
            ent = self._stall.get(sid)
            if ent is None or (ent[0], ent[1]) != prog:
                self._stall[sid] = [prog[0], prog[1], 0]
                continue
            ent[2] += 1
            if ent[2] >= self.stall_window:
                ev = AnomalyEvent(
                    seq=int(snap["seq"]), now=float(snap["now"]),
                    kind="search_stall", action=KILL, hosts=[],
                    detail={"search_id": float(sid),
                            "window": float(ent[2]),
                            "iteration": float(prog[0]),
                            "best": prog[1]})
                self._apply(ev)
                self._record(ev)
                self._stall.pop(sid, None)

    # -- the recorded schedule -----------------------------------------------

    def schedule_doc(self) -> dict:
        """The JSON-able record a replay run reproduces this run from.
        Only gate-affecting events matter for reproduction; page-only
        events ride along as the operator log."""
        return {"v": SCHEDULE_VERSION,
                "events": [e.to_doc() for e in self.events]}

    def summary(self) -> dict:
        by_action: Dict[str, int] = {}
        for e in self.events:
            by_action[e.action] = by_action.get(e.action, 0) + 1
        return {"mode": "live" if self.live else "replay",
                "events": len(self.events), "by_action": by_action,
                "quarantined_now": len(self._paged),
                "searches_killed": sorted(self._killed)}
