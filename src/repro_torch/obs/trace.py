"""Workunit lifecycle tracing (§14): sampled span records off server hooks.

Port of ``repro/obs/trace.py``, plain Python, unchanged.

A span follows one workunit through the paths the server already touches:
issued (lease grant) → [lapsed] → reported → committed / stale / dropped.
Hooks fire from ``WorkServer`` behind a single ``is not None`` check, so
an un-traced server pays one attribute compare per lease event and a
traced one pays a dict write — both far inside the §13 overhead ceiling.

Determinism: whether a workunit is traced is decided by a **keyed hash of
(trace seed, search, wu id)** — splitmix64 over the ids, no RNG object,
no sequential state — so the sampled set is identical across runs,
restores and replays of the same message sequence.  Tracing therefore
cannot perturb anything (the hooks only read), and the sampled population
is reproducible: a post-mortem over two runs of the same seed sees the
same workunits.

Completed spans land in a bounded ring (oldest dropped, counted); the
``RetentionSink`` drains the ring into the snapshot store at hub sample
boundaries.  Nothing here enters ``state_dict``: a restored server starts
a fresh tracer (open spans from before the crash are simply never closed
— the store still holds every span completed and flushed before the
kill, which is the post-mortem contract).
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

TRACE_VERSION = 1

_MASK = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """The splitmix64 finalizer: a fast, well-mixed 64-bit hash in pure
    int arithmetic (platform-independent, unlike ``hash``)."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def wu_sampled(seed: int, search: int, wu: int, rate: float) -> bool:
    """Deterministic keyed sampling decision for one workunit: the same
    (seed, search, wu) always answers the same, on any run."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    h = _splitmix64(_splitmix64(_splitmix64(int(seed)) ^ int(search))
                    ^ int(wu))
    return (h >> 11) / float(1 << 53) < rate


class WorkUnitTracer:
    """Collects sampled lifecycle spans through server hooks.

    ``sample_rate`` is the fraction of workunits traced (keyed on
    (seed, search, wu) — see ``wu_sampled``); ``ring`` bounds completed
    spans held between drains.  Span docs are plain JSON-able dicts::

        {"trace_v": 1, "search": s, "wu": w, "host": h,
         "phase": p, "validates": v_or_null,
         "issued_at": t0, "lapsed_at": t_or_null,
         "reported_at": t1, "outcome": "committed|assimilated|stale|"
                                       "dropped", "late": bool,
         "turnaround": t1 - t0}
    """

    def __init__(self, sample_rate: float = 1.0, ring: int = 1024,
                 seed: int = 0):
        self.sample_rate = float(sample_rate)
        self.ring = int(ring)
        self.seed = int(seed)
        self._open: Dict[Tuple[int, int], dict] = {}
        self._done: collections.deque = collections.deque()
        self.sampled = 0                  # spans opened
        self.skipped = 0                  # unsampled lease grants
        self.completed = 0                # spans closed
        self.ring_dropped = 0             # completed spans lost to the bound

    # -- server hooks --------------------------------------------------------

    def on_issue(self, search: int, wu: int, host: int, now: float,
                 phase: int, validates: Optional[int]) -> None:
        if not wu_sampled(self.seed, search, wu, self.sample_rate):
            self.skipped += 1
            return
        self.sampled += 1
        self._open[(search, wu)] = {
            "trace_v": TRACE_VERSION, "search": int(search), "wu": int(wu),
            "host": int(host), "phase": int(phase),
            "validates": None if validates is None else int(validates),
            "issued_at": float(now), "lapsed_at": None,
        }

    def on_lapse(self, search: int, wu: int, now: float) -> None:
        span = self._open.get((int(search), int(wu)))
        if span is not None and span["lapsed_at"] is None:
            span["lapsed_at"] = float(now)

    def on_settle(self, search: int, wu: int, now: float, outcome: str,
                  late: bool = False) -> None:
        span = self._open.pop((int(search), int(wu)), None)
        if span is None:
            return
        span["reported_at"] = float(now)
        span["outcome"] = str(outcome)
        span["late"] = bool(late)
        span["turnaround"] = float(now) - span["issued_at"]
        if len(self._done) >= self.ring:
            self._done.popleft()
            self.ring_dropped += 1
        self._done.append(span)
        self.completed += 1

    # -- consumption ---------------------------------------------------------

    @property
    def open_spans(self) -> int:
        return len(self._open)

    def drain(self) -> List[dict]:
        """Pop every completed span (oldest first) — the retention sink's
        per-sample sweep."""
        out = list(self._done)
        self._done.clear()
        return out

    def summary(self) -> dict:
        return {"trace_v": TRACE_VERSION, "sample_rate": self.sample_rate,
                "sampled": self.sampled, "skipped": self.skipped,
                "completed": self.completed, "open": self.open_spans,
                "ring_dropped": self.ring_dropped}
