"""Persistent cross-search evaluation cache (DESIGN.md §10).

Port of ``repro/core/substrates/eval_cache.py``, over the port's
``EvalBackend``.

A bit-exact memo layer in front of ``EvalBackend.submit``: every honest
lane a backend ever evaluated can be SERVED instead of re-dispatched, as
long as the staged point is byte-identical and the objective fingerprint
matches.  The paper's economics make volunteer-grid evaluations the
expensive resource, so validation replicas, restarted searches and
crash-restored runs — all of which re-issue byte-identical points — should
pay for a fitness evaluation exactly once.

Why bit-exact-only serving is safe (the determinism argument, pinned by
the parity gates): the backend stages every block as float32
(``buf[:k] = pts``), and the repo-wide row-independence + width-invariance
contract (DESIGN.md §8) already established that a lane's value is a pure
function of its staged f32 bytes — independent of bucket width, bucket
composition and collect timing.  A cache keyed on exactly those bytes
(plus an objective fingerprint) therefore serves the SAME value the
dispatch would have produced, so cache-on runs commit bit-identical
iterates and identical ``EngineStats`` to cache-off runs, on any backend.
Near-miss (quantized) keys are deliberately NOT supported: they would
trade that guarantee for hit rate.

Canonicalization: keys are the f32 bytes of the staged row after mapping
every NaN payload to the canonical quiet NaN and -0.0 to +0.0 (the
objective cannot distinguish them: f(-0.0) == f(+0.0) bitwise for any
even-remotely-sane fitness, and the engine never produces signed zeros on
purpose).  Two float64 points that round to the same f32 row are the same
key — exactly the backend's own staging equivalence.

Malicious lanes (``mal_u`` non-NaN) are NEVER cached and NEVER served:
their value is the corrupted lie, a function of the per-(host, workunit)
draw, not of the point — and quorum validation exists precisely to
re-evaluate suspect results, so short-circuiting it would change what the
validator sees.  Honest validation replicas MAY be served: they carry the
deterministic true value by construction, which is what the quorum
compares.  Non-finite results are not cached either (a NaN fitness has no
reuse value and NaN payloads do not survive every store backend).

``CachingSubmitter`` is ``EvalBackend``-shaped (``submit``/``collect``/
``__call__``/``warm``/``min_bucket``), so it drops into every seam a
backend goes: a grid's ``submitter``/``backend``, the coalescer's inner
backend (cache stripping then applies to the whole shared multi-search
bucket), or the simulated client pool's sync-call backend.  On ``submit``
the exact-hit lanes are STRIPPED from the bucket before dispatch — a
bucket whose misses fit a smaller ladder width dispatches at that smaller
width (width invariance again), and a fully-served bucket dispatches
nothing at all — then spliced back at ``collect``.

Persistence is a seam: ``MemoryCacheStore`` (default),
``JsonlCacheStore`` (append-only, SIGKILL-torn-tail tolerant like the
server's replay log, exact float64 via JSON repr round-trip) and
``SqliteCacheStore`` (stdlib sqlite3).  The server composition —
cache file inside the checkpoint dir, flushed at every snapshot — lives
in ``server/checkpoint.py``/``sim.py`` (DESIGN.md §10).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import os
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.core.substrates.eval_backend import (STAGING_RING, bucket_size)


def canonical_block(pts: np.ndarray) -> np.ndarray:
    """The (k, n) float32 block the backend would stage, canonicalized
    for byte-keying: every NaN becomes THE quiet NaN, -0.0 becomes +0.0.
    The f32 cast is the same C round-to-nearest the backend's
    ``buf[:k] = pts`` assignment performs, so two inputs share a key iff
    they stage identically."""
    a = np.array(pts, np.float32, copy=True)
    if a.ndim == 1:
        a = a[None, :]
    nan = np.isnan(a)
    if nan.any():
        a[nan] = np.float32(np.nan)
    zero = a == 0.0                   # matches both +0.0 and -0.0
    if zero.any():
        a[zero] = np.float32(0.0)
    return np.ascontiguousarray(a)


@dataclasses.dataclass
class CacheStats:
    """Observability counters, shared by every submitter attached to one
    ``EvalCache`` (that sharing IS the cross-search story).  ``hits`` is
    also the lanes-saved count: every hit lane is stripped from its
    bucket before dispatch."""
    hits: int = 0                     # lanes served (== lanes stripped)
    misses: int = 0                   # honest lanes that had to dispatch
    mal_bypassed: int = 0             # malicious lanes (never looked up)
    stores: int = 0                   # new values inserted into the store
    full_buckets: int = 0             # submits fully served (no dispatch)
    ring_drains: int = 0              # early collects for ring pressure

    def hit_rate(self) -> float:
        return self.hits / max(self.hits + self.misses, 1)


# -- persistence seam ----------------------------------------------------------


class MemoryCacheStore:
    """The default store: a dict, process-lifetime only."""

    def __init__(self):
        self._d: Dict[bytes, float] = {}

    def get(self, key: bytes) -> Optional[float]:
        return self._d.get(key)

    def put(self, key: bytes, y: float) -> bool:
        """Insert-if-absent; returns True when a new entry landed.  A
        second put of one key is a no-op on purpose — values are
        deterministic, so the first writer is as right as any."""
        if key in self._d:
            return False
        self._d[key] = y
        return True

    def __len__(self) -> int:
        return len(self._d)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class JsonlCacheStore(MemoryCacheStore):
    """Append-only JSONL persistence over the in-memory dict: one
    ``{"k": hex-key, "y": value}`` record per insert, flushed every
    ``flush_every`` puts (and on ``flush``/``close``) — the same
    durability model as the server's replay log: a SIGKILL loses only an
    unflushed SUFFIX, never corrupts the prefix.  Loading tolerates a
    torn trailing line (the kill's half-append) and truncates it so
    resumed appends start on a fresh line; float64 values round-trip
    exactly through JSON repr."""

    def __init__(self, path: str, flush_every: int = 64):
        super().__init__()
        self.path = path
        self.flush_every = max(int(flush_every), 1)
        self._since_flush = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._truncate_torn_tail(path)
        try:
            with open(path) as f:
                for line in f:
                    if not line.endswith("\n"):
                        break         # torn tail: stop, don't die
                    try:
                        rec = json.loads(line)
                        self._d[bytes.fromhex(rec["k"])] = float(rec["y"])
                    except (ValueError, KeyError, TypeError):
                        break         # corrupt tail record: stop, don't die
        except FileNotFoundError:
            pass
        self._f = open(path, "a")

    @staticmethod
    def _truncate_torn_tail(path: str) -> int:
        """Drop a SIGKILL-torn trailing partial line so post-restore
        appends never concatenate onto the fragment (same rationale as
        ``ReplayLog.repair``).  Returns bytes dropped."""
        try:
            with open(path, "rb+") as f:
                data = f.read()
                if not data or data.endswith(b"\n"):
                    return 0
                keep = data.rfind(b"\n") + 1
                f.truncate(keep)
                return len(data) - keep
        except FileNotFoundError:
            return 0

    def put(self, key: bytes, y: float) -> bool:
        if not super().put(key, y):
            return False
        self._f.write(json.dumps({"k": key.hex(), "y": float(y)},
                                 separators=(",", ":")) + "\n")
        self._since_flush += 1
        if self._since_flush >= self.flush_every:
            self.flush()
        return True

    def flush(self) -> None:
        self._f.flush()
        self._since_flush = 0

    def close(self) -> None:
        self.flush()
        self._f.close()


class SqliteCacheStore:
    """Stdlib sqlite3 persistence: one ``(key BLOB PRIMARY KEY, y REAL)``
    table, committed every ``flush_every`` inserts.  REAL is float64, so
    values round-trip exactly (non-finite values are never stored — the
    submitter filters them — which sidesteps sqlite's NaN-to-NULL
    coercion)."""

    def __init__(self, path: str, flush_every: int = 64):
        import sqlite3

        self.path = path
        self.flush_every = max(int(flush_every), 1)
        self._since_flush = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._db = sqlite3.connect(path)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS eval_cache "
            "(key BLOB PRIMARY KEY, y REAL NOT NULL)")
        self._db.commit()

    def get(self, key: bytes) -> Optional[float]:
        row = self._db.execute(
            "SELECT y FROM eval_cache WHERE key = ?", (key,)).fetchone()
        return None if row is None else float(row[0])

    def put(self, key: bytes, y: float) -> bool:
        cur = self._db.execute(
            "INSERT OR IGNORE INTO eval_cache (key, y) VALUES (?, ?)",
            (key, float(y)))
        if cur.rowcount <= 0:
            return False
        self._since_flush += 1
        if self._since_flush >= self.flush_every:
            self.flush()
        return True

    def __len__(self) -> int:
        return int(self._db.execute(
            "SELECT COUNT(*) FROM eval_cache").fetchone()[0])

    def flush(self) -> None:
        self._db.commit()
        self._since_flush = 0

    def close(self) -> None:
        self.flush()
        self._db.close()


# -- the cache + its submitter -------------------------------------------------


class EvalCache:
    """Key derivation + store + shared counters.  ``fingerprint`` is the
    objective/spec identity (any stable string naming the fitness
    function and its data); its digest prefixes every key, so two caches
    over different objectives can share one store without ever serving
    each other's values (the isolation pin in the tests)."""

    def __init__(self, store=None, fingerprint: str = ""):
        self.store = MemoryCacheStore() if store is None else store
        self.fingerprint = fingerprint
        self._prefix = hashlib.sha256(fingerprint.encode()).digest()[:12]
        self.stats = CacheStats()

    def key_block(self, pts: np.ndarray) -> List[bytes]:
        blk = canonical_block(pts)
        prefix = self._prefix
        return [prefix + row.tobytes() for row in blk]

    def key(self, pt: np.ndarray) -> bytes:
        return self.key_block(np.asarray(pt)[None, :])[0]

    def __len__(self) -> int:
        return len(self.store)

    def status(self) -> dict:
        """The read-only counter doc surfaced by the wire protocol's
        ``status`` reply and the examples."""
        s = self.stats
        return {"hits": s.hits, "misses": s.misses,
                "lanes_saved": s.hits, "mal_bypassed": s.mal_bypassed,
                "stores": s.stores, "full_buckets": s.full_buckets,
                "hit_rate": s.hit_rate(), "store_size": len(self.store)}


class _CachedHandle:
    """In-flight submit through the cache: the inner backend handle (over
    the MISS lanes only, ``None`` when fully served) plus the splice
    plan.  Quacks enough like an ``EvalHandle`` (``kp``, ``seq``) for
    every consumer that inspects handles — a fully-served bucket reports
    ``kp == 0``, the honest width it paid."""
    __slots__ = ("inner", "k", "keys", "miss_idx", "hit_idx", "hit_vals",
                 "store_mask", "tags", "seq", "ys")

    def __init__(self, inner, k, keys, miss_idx, hit_idx, hit_vals,
                 store_mask, tags, seq):
        self.inner = inner
        self.k = k
        self.keys = keys
        self.miss_idx = miss_idx      # positions dispatched to the backend
        self.hit_idx = hit_idx        # positions served from the cache
        self.hit_vals = hit_vals
        self.store_mask = store_mask  # which dispatched lanes may be stored
        self.tags = tags
        self.seq = seq
        self.ys: Optional[np.ndarray] = None

    @property
    def kp(self) -> int:
        return 0 if self.inner is None else self.inner.kp


class CachingSubmitter:
    """The memo layer: an ``EvalBackend``-shaped wrapper that strips
    exact-hit honest lanes from every submitted bucket, dispatches only
    the misses (at the smaller ladder width they now fit), and splices
    the served values back at ``collect``.

    Ring safety: stripping changes dispatched bucket shapes, so shapes
    that were distinct upstream can collapse onto ONE inner staging ring
    — upstream pressure accounting (the coalescer's, a grid's depth
    clamp, the scheduler's shared guard) is keyed on pre-strip widths and
    cannot see that.  The submitter therefore keeps its own per-inner-
    shape in-flight deques and materializes the oldest handle early when
    a submit would overrun the ring (the §7 contract makes early collects
    invisible to engines; ``collect`` is idempotent via the cached
    ``ys``)."""

    def __init__(self, backend, cache: Optional[EvalCache] = None):
        self.backend = backend
        self.cache = EvalCache() if cache is None else cache
        self._inflight: Dict[int, Deque[_CachedHandle]] = {}
        self._seq = 0

    @property
    def min_bucket(self) -> int:
        return self.backend.min_bucket

    @property
    def device(self):
        """The wrapped backend's device: where a search's engine runs
        (``multi_start_specs`` reads it)."""
        return self.backend.device

    @property
    def compile_count(self) -> int:
        return self.backend.compile_count

    def warm(self, n_dims: int, max_k: int) -> "CachingSubmitter":
        self.backend.warm(n_dims, max_k)
        return self

    def submit(self, pts: np.ndarray,
               mal_u: Optional[np.ndarray] = None,
               lane_tags: Optional[np.ndarray] = None) -> _CachedHandle:
        pts = np.asarray(pts)
        k = len(pts)
        keys = self.cache.key_block(pts)
        stats = self.cache.stats
        store = self.cache.store
        if mal_u is None:
            honest = np.ones(k, bool)
        else:
            mal_u = np.asarray(mal_u, np.float64)
            honest = np.isnan(mal_u)
        hit = np.zeros(k, bool)
        hit_vals: List[float] = []
        for i in range(k):
            if not honest[i]:
                stats.mal_bypassed += 1   # no lookup, no store: quorum
                continue                  # validation must re-evaluate
            y = store.get(keys[i])
            if y is None:
                stats.misses += 1
            else:
                hit[i] = True
                hit_vals.append(y)
                stats.hits += 1
        miss_idx = np.flatnonzero(~hit)
        hit_idx = np.flatnonzero(hit)
        self._seq += 1
        tags = None if lane_tags is None else np.asarray(lane_tags)
        handle = _CachedHandle(None, k, keys, miss_idx, hit_idx,
                               np.asarray(hit_vals, np.float64), honest,
                               tags, self._seq)
        if len(miss_idx) == 0:            # fully served: no dispatch at all
            stats.full_buckets += 1
            return handle
        if len(miss_idx) == k:            # nothing served: dispatch as-is
            handle.inner = self._guarded_submit(
                k, pts, mal_u, lane_tags, handle)
        else:
            handle.inner = self._guarded_submit(
                len(miss_idx), pts[miss_idx],
                None if mal_u is None else mal_u[miss_idx],
                None if tags is None else tags[miss_idx], handle)
        return handle

    def _guarded_submit(self, n_miss, pts, mal_u, lane_tags, handle):
        """Drain this inner shape's oldest in-flight handles below the
        ring bound, then dispatch and track."""
        kp = bucket_size(n_miss, self.backend.min_bucket)
        dq = self._inflight.setdefault(kp, collections.deque())
        # positional ring (slots rotate round-robin): everything older
        # than the newest ring-2 submissions of this shape must be
        # materialized before staging another — already-collected handles
        # hold no slot and are not pressure
        while len(dq) > STAGING_RING - 2:
            old = dq.popleft()
            if old.ys is None:
                self._materialize(old)
                self.cache.stats.ring_drains += 1
        inner = self.backend.submit(pts, mal_u, lane_tags=lane_tags)
        dq.append(handle)
        return inner

    def _materialize(self, handle: _CachedHandle) -> None:
        ys = np.empty(handle.k, np.float64)
        if handle.inner is not None:
            got = self.backend.collect(handle.inner)
            ys[handle.miss_idx] = got
            stats = self.cache.stats
            store = self.cache.store
            for j, i in enumerate(handle.miss_idx):
                # store honest, finite results only — malicious lies are
                # per-(host, wu) draws, and NaN carries no reuse value
                if handle.store_mask[i] and np.isfinite(got[j]):
                    if store.put(handle.keys[i], float(got[j])):
                        stats.stores += 1
        if len(handle.hit_idx):
            ys[handle.hit_idx] = handle.hit_vals
        handle.ys = ys

    def collect(self, handle: _CachedHandle) -> np.ndarray:
        if handle.ys is None:
            self._materialize(handle)
        return handle.ys

    def __call__(self, pts: np.ndarray,
                 mal_u: Optional[np.ndarray] = None) -> np.ndarray:
        return self.collect(self.submit(pts, mal_u))
