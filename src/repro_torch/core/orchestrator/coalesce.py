"""Cross-search bucket coalescing over one shared EvalBackend (DESIGN.md §8).

Port of ``repro/core/orchestrator/coalesce.py``, over the port's
``EvalBackend`` staging ring.

K concurrent searches submitting their tick blocks separately pay K device
dispatches per scheduling round, and every small block rounds up to its own
power-of-two bucket — at multi-search scale the padding and the dispatch
round-trips, not the fitness FLOPs, dominate.  ``CoalescingSubmitter``
closes both holes: within a scheduling round, each search's block is
appended to one OPEN shared round; the round dispatches as a single
backend bucket whose lanes are tagged with the submitting search's id
(``EvalHandle.tags`` — per-lane attribution for observability; the demux
itself is positional), and each search gets back a ``LaneSlice`` — a
lazy handle onto its contiguous lane range of the shared result.

Why coalescing cannot change what any engine observes (the safety
argument, pinned by the parity gates): a backend bucket is row-
independent — ``f_batch`` maps each lane to its fitness with no cross-lane
terms, the malicious-corruption mask and the pad-NaN mask are per-lane,
and in the port the SDSS fitness sums each lane in one fixed order
(``kernels/ops.py::row_mean``), its other steps elementwise, so no bucket
width changes a lane's bits.  So a lane evaluated inside a
wide shared bucket carries bit-for-bit the value it would have carried in
the search's own small bucket; the only things coalescing changes are the
padded width paid per real lane and WHEN the dispatch happens — and the
pipelined-parity contract (DESIGN.md §7) already established that collect
timing is invisible to the engine.

The façade each search's grid holds (``lane_submitter(search_id)``) quacks
exactly like an ``EvalBackend``'s submit/collect pair, so
``BatchedVolunteerGrid`` needs no coalescing knowledge: its ``submitter``
seam points here instead of at the backend, and everything else —
pipelining, speculation, staging-ring clamps — behaves identically.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.substrates.eval_backend import (STAGING_RING, EvalBackend,
                                                bucket_size)
from repro_torch.core.substrates.eval_cache import canonical_block


@dataclasses.dataclass
class CoalesceStats:
    """The speed story, measurable: ``dispatches`` vs ``lane_blocks`` is
    the dispatch amortization (one device round-trip now serves that many
    per-search blocks), ``padded_lanes`` vs ``solo_padded_lanes`` the
    padding amortization (width actually paid vs what the same blocks
    would have paid in their own buckets)."""
    dispatches: int = 0               # real device buckets submitted
    lane_blocks: int = 0              # per-search blocks folded into them
    lanes: int = 0                    # real lanes across all dispatches
    padded_lanes: int = 0             # padded width actually paid
    solo_padded_lanes: int = 0        # width the same blocks would pay solo
    forced_flushes: int = 0           # rounds dispatched early by a collect
    ring_drains: int = 0              # old rounds materialized to free slots
    lanes_deduped: int = 0            # duplicate honest lanes evaluated once
    bucket_hist: Dict[int, int] = dataclasses.field(default_factory=dict)


class _Round:
    """One shared bucket being assembled (``handle is None``) or in flight
    (``handle`` set, ``ys`` cached after the first collect).  ``src``,
    set when intra-bucket dedup dropped duplicate lanes, maps each
    ORIGINAL lane position to its representative's position in the
    dispatched bucket — the fan-out plan collect applies."""
    __slots__ = ("pts", "mal_u", "tags", "k", "handle", "ys", "src")

    def __init__(self):
        self.pts: List[np.ndarray] = []
        self.mal_u: List[np.ndarray] = []
        self.tags: List[np.ndarray] = []
        self.k = 0
        self.handle = None
        self.ys: Optional[np.ndarray] = None
        self.src: Optional[np.ndarray] = None


class LaneSlice:
    """One search's contiguous lanes inside a shared coalesced bucket —
    the multi-search counterpart of an ``EvalHandle``.  ``kp`` (the width
    the lanes were actually evaluated at, what the grid's bucket histogram
    records) resolves once the round has dispatched; collecting an
    undispatched slice force-flushes its round first, so the value is
    always available by the time a collector reads it."""
    __slots__ = ("round_", "offset", "k", "tag")

    def __init__(self, round_: _Round, offset: int, k: int, tag: int):
        self.round_ = round_
        self.offset = offset
        self.k = k
        self.tag = tag

    @property
    def kp(self) -> Optional[int]:
        h = self.round_.handle
        return None if h is None else h.kp


class _TaggedSubmitter:
    """Per-search façade bound to (coalescer, search id): the object a
    search's ``BatchedVolunteerGrid`` uses as its ``submitter`` seam."""
    __slots__ = ("_co", "tag")

    def __init__(self, co: "CoalescingSubmitter", tag: int):
        self._co = co
        self.tag = tag

    def submit(self, pts: np.ndarray,
               mal_u: Optional[np.ndarray] = None) -> LaneSlice:
        return self._co.submit(self.tag, pts, mal_u)

    def collect(self, lane: LaneSlice) -> np.ndarray:
        return self._co.collect(lane)


class CoalescingSubmitter:
    """Folds blocks from many searches into shared tagged buckets.

    Protocol: searches ``submit`` into the open round at any time; the
    scheduler calls ``flush()`` once per scheduling round (after stepping
    every live search) to dispatch the shared bucket.  A ``collect`` on a
    lane of the still-open round force-flushes it first — a search that
    must decide a phase transition mid-round never waits on the others.
    Rounds are created and flushed strictly in order, so at most one round
    is ever open.
    """

    def __init__(self, backend: EvalBackend, dedup: bool = True):
        self.backend = backend
        #: evaluate identical honest points coalesced from different
        #: searches in one round ONCE, fanning the value out to every
        #: tagged lane at collect — safe for exactly the reason serving a
        #: bit-exact cache hit is (row independence + width invariance:
        #: a lane's value is a pure function of its staged f32 bytes).
        #: Malicious lanes are never deduped (their value is the per-lane
        #: corrupted lie) and never act as representatives.
        self.dedup = dedup
        self._open: Optional[_Round] = None
        # flushed rounds per bucket shape, submission order: K searches
        # each pipelining a few lane handles can hold MORE uncollected
        # same-shape buckets than one search ever could, so the coalescer
        # — not the per-search depth clamp — must keep the staging ring
        # safe (see flush()); the backend still raises if this ever slips
        self._inflight: Dict[int, collections.deque] = {}
        self.stats = CoalesceStats()

    @property
    def ring_pressure(self) -> int:
        """Uncollected dispatched rounds still holding staging-ring slots
        (materialized mid-deque rounds hold none) — a live gauge for the
        metrics hub, complementing the ``ring_drains`` counter."""
        return sum(1 for dq in self._inflight.values()
                   for r in dq if r.ys is None and r.handle is not None)

    def lane_submitter(self, tag: int) -> _TaggedSubmitter:
        """The submit/collect façade a search's grid plugs in as its
        ``submitter``; ``tag`` is the search id stamped on its lanes."""
        return _TaggedSubmitter(self, tag)

    def submit(self, tag: int, pts: np.ndarray,
               mal_u: Optional[np.ndarray] = None) -> LaneSlice:
        r = self._open
        if r is None:
            r = self._open = _Round()
        k = len(pts)
        lane = LaneSlice(r, r.k, k, tag)
        r.pts.append(np.asarray(pts))
        r.mal_u.append(np.full(k, np.nan) if mal_u is None
                       else np.asarray(mal_u))
        r.tags.append(np.full(k, tag, np.int64))
        r.k += k
        self.stats.lane_blocks += 1
        self.stats.lanes += k
        self.stats.solo_padded_lanes += bucket_size(k,
                                                    self.backend.min_bucket)
        return lane

    def flush(self) -> None:
        """Dispatch the open round as ONE tagged backend bucket (no-op when
        nothing was submitted since the last flush).

        Ring safety: submitting the (STAGING_RING)-th uncollected bucket
        of one shape would restage a buffer the device may still read, so
        before dispatching, the oldest in-flight rounds of this shape are
        materialized early (their values are CACHED on the round — later
        lane collects slice the cache, so consumers never notice; collect
        timing is invisible to the engines by the §7 contract)."""
        r = self._open
        if r is None:
            return
        self._open = None
        pts = r.pts[0] if len(r.pts) == 1 else np.concatenate(r.pts)
        mal_u = r.mal_u[0] if len(r.mal_u) == 1 else np.concatenate(r.mal_u)
        tags = r.tags[0] if len(r.tags) == 1 else np.concatenate(r.tags)
        if self.dedup and r.k > 1:
            keep = self._dedup_plan(r, pts, mal_u)
            if keep is not None:
                pts, mal_u, tags = pts[keep], mal_u[keep], tags[keep]
        # ring pressure is keyed on the width actually dispatched (dedup
        # may have shrunk the bucket below the submitted lane count)
        kp = bucket_size(len(pts), self.backend.min_bucket)
        dq = self._inflight.setdefault(kp, collections.deque())
        # the ring is POSITIONAL (slots rotate round-robin), so the real
        # requirement is that everything older than the newest ring-2
        # submissions of this shape is materialized — pop oldest-first,
        # draining only rounds consumers haven't collected yet (a
        # materialized mid-deque round holds no slot and is not pressure)
        while len(dq) > STAGING_RING - 2:
            old = dq.popleft()
            if old.ys is None:
                old.ys = self._materialize(old)
                self.stats.ring_drains += 1
        r.handle = self.backend.submit(pts, mal_u, lane_tags=tags)
        dq.append(r)
        self.stats.dispatches += 1
        self.stats.padded_lanes += r.handle.kp
        self.stats.bucket_hist[r.handle.kp] = \
            self.stats.bucket_hist.get(r.handle.kp, 0) + 1

    def _dedup_plan(self, r: _Round, pts: np.ndarray,
                    mal_u: np.ndarray) -> Optional[np.ndarray]:
        """Indices of the lanes to dispatch, or ``None`` when every lane
        is unique.  Sets ``r.src`` (original lane -> dispatched position)
        when duplicates were dropped.  The cheap vectorized pre-check
        (all first coordinates distinct => no duplicates possible) keeps
        the common all-unique round at ~one ``np.unique`` call instead of
        a per-lane Python loop."""
        blk = canonical_block(pts)
        if len(np.unique(blk[:, 0])) == r.k:
            return None
        seen: Dict[bytes, int] = {}
        keep: List[int] = []
        src = np.empty(r.k, np.int64)
        dups = 0
        for i in range(r.k):
            if not np.isnan(mal_u[i]):    # malicious lane: its value is
                src[i] = len(keep)        # the per-lane lie — never dedup,
                keep.append(i)            # never a representative
                continue
            key = blk[i].tobytes()
            j = seen.get(key)
            if j is None:
                seen[key] = src[i] = len(keep)
                keep.append(i)
            else:
                src[i] = j
                dups += 1
        if not dups:
            return None
        r.src = src
        self.stats.lanes_deduped += dups
        return np.asarray(keep, np.int64)

    def _materialize(self, r: _Round) -> np.ndarray:
        """Collect a dispatched round and expand the dedup fan-out back
        to the full submitted lane order."""
        ys = self.backend.collect(r.handle)
        return ys if r.src is None else ys[r.src]

    def collect(self, lane: LaneSlice) -> np.ndarray:
        """Materialize one search's lanes.  The shared bucket is collected
        exactly once (first caller blocks, frees the staging slot, and
        caches the values); later lane collects slice the cache."""
        r = lane.round_
        if r.handle is None:
            if r is not self._open:
                raise RuntimeError(
                    "lane belongs to a round that was never dispatched")
            # a mid-round phase decision: dispatch what we have now
            self.stats.forced_flushes += 1
            self.flush()
        if r.ys is None:
            r.ys = self._materialize(r)
        return r.ys[lane.offset:lane.offset + lane.k]
