"""Durable metrics retention: the post-mortem half of the obs plane (§14).

Port of ``repro/obs/retention.py``, plain Python; either package reads
the other's stores.  The JSONL store counts its data records as it
appends them instead of rescanning the file's records per append.

The live plane (§13) keeps every snapshot in a bounded in-memory ring, so a
SIGKILL erases the evidence exactly when it matters most.  This module
spills the ring into the §10 store family — the same append-only JSONL /
sqlite discipline as the eval cache and the replay log — WITHOUT touching
the recovery contract:

  * the store is never read back into server state, never logged, never
    replayed; §13's recovery-compatibility argument is untouched (replay
    logs are byte-identical with retention on or off);
  * a crash-restored server opens the SAME store and appends under a new
    **epoch marker**: the dead run's records stay intact (SIGKILL loses
    only an unflushed suffix, same torn-tail story as ``ReplayLog``), and
    the post-mortem CLI can tell the killed run's history from the
    restored run's;
  * retention is **size/age-bounded**: a long-running server compacts the
    store in place (atomic tmp + ``os.replace``, like snapshots) instead
    of growing without bound.

Record layout (one JSON object per line / sqlite row)::

    {"t": "epoch",   "epoch": N, "v": STORE_VERSION}
    {"t": "snap",    "epoch": N, "seq": k, "now": ..., "doc": snapshot}
    {"t": "span",    "epoch": N, "seq": -1, "now": ..., "doc": span}
    {"t": "anomaly", "epoch": N, "seq": k, "now": ..., "doc": event}

Every data record carries its epoch inline, so compaction may drop old
epoch markers without losing attribution.  ``RetentionSink`` is the only
writer during a run: it subscribes to the hub's sample boundary (already
off the per-message path — samples fire every ``interval`` virtual
seconds) and drains snapshot + trace-ring + anomaly records with buffered
writes; the checkpoint manager flushes the store at every snapshot via
``attach_store``, exactly like the eval cache.
"""
from __future__ import annotations

import collections
import json
import os
from typing import Dict, List, Optional

#: bumped when the record layout changes; stamped into epoch markers
STORE_VERSION = 1

#: canonical retention-store file inside a checkpoint dir — one
#: convention, so ``--resume`` and the post-mortem CLI find it with no
#: extra plumbing (the sqlite variant uses OBS_STORE_DB)
OBS_STORE_NAME = "obs_store.jsonl"
OBS_STORE_DB = "obs_store.sqlite"


def obs_store_path(ckpt_dir: str, backend: str = "jsonl") -> str:
    return os.path.join(
        ckpt_dir, OBS_STORE_DB if backend == "sqlite" else OBS_STORE_NAME)


def _truncate_torn_tail(path: str) -> int:
    """Drop a SIGKILL-torn trailing partial line so post-restore appends
    never concatenate onto the fragment (same rationale as
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


class SnapshotStore:
    """Append-only JSONL retention store with epoch markers.

    Opening for append (the default) truncates a torn tail, scans the
    survivors to find the last epoch, and appends a fresh epoch marker —
    a restored server's records are separable from the killed run's by
    construction.  ``read_only=True`` (the post-mortem CLI) opens without
    marking a new epoch and never writes.

    ``max_records`` bounds the store: once the live record count exceeds
    ``1.25 × max_records`` the file is compacted in place (atomic tmp +
    replace) down to the newest ``max_records`` data records;
    ``max_age`` additionally drops records older than that many virtual
    seconds behind the newest record at compaction time.  Readers see the
    bound as best-effort — durability of the RECENT window is the
    contract, not completeness of all history.
    """

    def __init__(self, path: str, flush_every: int = 32,
                 max_records: Optional[int] = 20_000,
                 max_age: Optional[float] = None,
                 read_only: bool = False):
        self.path = path
        self.flush_every = max(int(flush_every), 1)
        self.max_records = None if max_records is None else int(max_records)
        self.max_age = None if max_age is None else float(max_age)
        self.read_only = bool(read_only)
        self._since_flush = 0
        self._records: List[dict] = []
        self._n_data = 0              # records other than epoch markers
        self._f = None
        if not read_only:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            _truncate_torn_tail(path)
        self._load(path)
        last = max((int(r["epoch"]) for r in self._records), default=0)
        if read_only:
            self.epoch = last
        else:
            self.epoch = last + 1
            self._f = open(path, "a")
            self._append_raw({"t": "epoch", "epoch": self.epoch,
                              "v": STORE_VERSION})

    def _load(self, path: str) -> None:
        try:
            with open(path) as f:
                for line in f:
                    if not line.endswith("\n"):
                        break         # torn tail: stop, don't die
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        break         # corrupt tail record: stop, don't die
                    self._records.append(rec)
                    self._n_data += rec["t"] != "epoch"
        except FileNotFoundError:
            pass

    # -- writing -------------------------------------------------------------

    def _append_raw(self, rec: dict) -> None:
        self._records.append(rec)
        self._n_data += rec["t"] != "epoch"
        self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._since_flush += 1
        if self._since_flush >= self.flush_every:
            self.flush()

    def append(self, t: str, doc: dict, seq: int = -1,
               now: float = 0.0) -> None:
        if self.read_only:
            raise RuntimeError("store opened read-only")
        self._append_raw({"t": str(t), "epoch": self.epoch,
                          "seq": int(seq), "now": float(now), "doc": doc})
        if self.max_records is not None \
                and self._data_count() > 1.25 * self.max_records:
            self.compact()

    def _data_count(self) -> int:
        return self._n_data

    def compact(self) -> int:
        """Rewrite the file with only the retained window (newest
        ``max_records`` data records, minus anything older than
        ``max_age``).  Atomic: a crash mid-compaction leaves the previous
        file intact.  Returns the number of records dropped."""
        if self.read_only:
            raise RuntimeError("store opened read-only")
        data = [r for r in self._records if r["t"] != "epoch"]
        keep = data if self.max_records is None else data[-self.max_records:]
        if self.max_age is not None and keep:
            horizon = max(float(r.get("now", 0.0)) for r in keep) \
                - self.max_age
            keep = [r for r in keep if float(r.get("now", 0.0)) >= horizon]
        dropped = len(data) - len(keep)
        if dropped <= 0:
            return 0
        # keep one marker per surviving epoch (ordered), then the data
        epochs_kept = sorted({int(r["epoch"]) for r in keep} | {self.epoch})
        out = [{"t": "epoch", "epoch": e, "v": STORE_VERSION}
               for e in epochs_kept] + keep
        tmp = os.path.join(os.path.dirname(self.path) or ".",
                           f".tmp_obs_store_{os.getpid()}")
        with open(tmp, "w") as f:
            for rec in out:
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._f.close()
        os.replace(tmp, self.path)
        self._records = out
        self._n_data = len(keep)
        self._f = open(self.path, "a")
        self._since_flush = 0
        return dropped

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()
        self._since_flush = 0

    def close(self) -> None:
        if self._f is not None:
            self.flush()
            self._f.close()
            self._f = None

    # -- reading -------------------------------------------------------------

    def __len__(self) -> int:
        return self._data_count()

    def epochs(self) -> List[int]:
        return sorted({int(r["epoch"]) for r in self._records})

    def records(self, t: Optional[str] = None,
                epoch: Optional[int] = None) -> List[dict]:
        """Raw records (append order), optionally filtered by type and/or
        epoch.  Returns the record envelopes — ``r["doc"]`` is the
        payload."""
        out = []
        for r in self._records:
            if r["t"] == "epoch":
                continue
            if t is not None and r["t"] != t:
                continue
            if epoch is not None and int(r["epoch"]) != epoch:
                continue
            out.append(r)
        return out

    def snapshots(self, epoch: Optional[int] = None) -> List[dict]:
        return [r["doc"] for r in self.records("snap", epoch)]

    def summary(self) -> dict:
        by_t: Dict[str, int] = collections.Counter(
            r["t"] for r in self._records if r["t"] != "epoch")
        return {"path": self.path, "epoch": self.epoch,
                "epochs": self.epochs(), "records": len(self),
                "by_type": dict(by_t)}


class SqliteSnapshotStore:
    """The sqlite variant: one ``obs_records`` table, committed every
    ``flush_every`` appends (commit-every-N like the sqlite eval cache —
    a SIGKILL loses only the uncommitted suffix).  Same epoch/compaction
    semantics as the JSONL store; ``doc`` is stored as JSON text."""

    def __init__(self, path: str, flush_every: int = 32,
                 max_records: Optional[int] = 20_000,
                 max_age: Optional[float] = None,
                 read_only: bool = False):
        import sqlite3

        self.path = path
        self.flush_every = max(int(flush_every), 1)
        self.max_records = None if max_records is None else int(max_records)
        self.max_age = None if max_age is None else float(max_age)
        self.read_only = bool(read_only)
        self._since_flush = 0
        if not read_only:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._db = sqlite3.connect(path)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS obs_records ("
            "id INTEGER PRIMARY KEY AUTOINCREMENT, t TEXT NOT NULL, "
            "epoch INTEGER NOT NULL, seq INTEGER, now REAL, doc TEXT)")
        self._db.commit()
        row = self._db.execute(
            "SELECT MAX(epoch) FROM obs_records").fetchone()
        last = int(row[0]) if row and row[0] is not None else 0
        if read_only:
            self.epoch = last
        else:
            self.epoch = last + 1
            self._db.execute(
                "INSERT INTO obs_records (t, epoch, seq, now, doc) "
                "VALUES ('epoch', ?, -1, 0.0, ?)",
                (self.epoch, json.dumps({"v": STORE_VERSION})))
            self._db.commit()

    def append(self, t: str, doc: dict, seq: int = -1,
               now: float = 0.0) -> None:
        if self.read_only:
            raise RuntimeError("store opened read-only")
        self._db.execute(
            "INSERT INTO obs_records (t, epoch, seq, now, doc) "
            "VALUES (?, ?, ?, ?, ?)",
            (str(t), self.epoch, int(seq), float(now),
             json.dumps(doc, separators=(",", ":"))))
        self._since_flush += 1
        if self._since_flush >= self.flush_every:
            self.flush()
        if self.max_records is not None \
                and len(self) > 1.25 * self.max_records:
            self.compact()

    def compact(self) -> int:
        if self.read_only:
            raise RuntimeError("store opened read-only")
        n = len(self)
        drop = 0
        if self.max_records is not None and n > self.max_records:
            cut = self._db.execute(
                "SELECT id FROM obs_records WHERE t != 'epoch' "
                "ORDER BY id DESC LIMIT 1 OFFSET ?",
                (self.max_records - 1,)).fetchone()
            if cut is not None:
                cur = self._db.execute(
                    "DELETE FROM obs_records WHERE t != 'epoch' AND id < ?",
                    (int(cut[0]),))
                drop += cur.rowcount
        if self.max_age is not None:
            row = self._db.execute(
                "SELECT MAX(now) FROM obs_records WHERE t != 'epoch'"
            ).fetchone()
            if row and row[0] is not None:
                cur = self._db.execute(
                    "DELETE FROM obs_records WHERE t != 'epoch' AND now < ?",
                    (float(row[0]) - self.max_age,))
                drop += cur.rowcount
        if drop:
            self._db.commit()
        return drop

    def flush(self) -> None:
        self._db.commit()
        self._since_flush = 0

    def close(self) -> None:
        self.flush()
        self._db.close()

    def __len__(self) -> int:
        return int(self._db.execute(
            "SELECT COUNT(*) FROM obs_records WHERE t != 'epoch'"
        ).fetchone()[0])

    def epochs(self) -> List[int]:
        return [int(r[0]) for r in self._db.execute(
            "SELECT DISTINCT epoch FROM obs_records ORDER BY epoch")]

    def records(self, t: Optional[str] = None,
                epoch: Optional[int] = None) -> List[dict]:
        q = ("SELECT t, epoch, seq, now, doc FROM obs_records "
             "WHERE t != 'epoch'")
        args: list = []
        if t is not None:
            q += " AND t = ?"
            args.append(str(t))
        if epoch is not None:
            q += " AND epoch = ?"
            args.append(int(epoch))
        q += " ORDER BY id"
        return [{"t": r[0], "epoch": int(r[1]), "seq": int(r[2]),
                 "now": float(r[3]), "doc": json.loads(r[4])}
                for r in self._db.execute(q, args)]

    def snapshots(self, epoch: Optional[int] = None) -> List[dict]:
        return [r["doc"] for r in self.records("snap", epoch)]

    def summary(self) -> dict:
        by_t = {r[0]: int(r[1]) for r in self._db.execute(
            "SELECT t, COUNT(*) FROM obs_records WHERE t != 'epoch' "
            "GROUP BY t")}
        return {"path": self.path, "epoch": self.epoch,
                "epochs": self.epochs(), "records": len(self),
                "by_type": by_t}


def open_snapshot_store(path: str, **kwargs):
    """Pick the store backend by extension — ``.sqlite``/``.db`` gets the
    sqlite variant, anything else JSONL (the §10 convention)."""
    if path.endswith((".sqlite", ".db")):
        return SqliteSnapshotStore(path, **kwargs)
    return SnapshotStore(path, **kwargs)


class RetentionSink:
    """Drains the live plane into a ``SnapshotStore`` off the hot path.

    Subscribes at the hub's sample boundary — which fires every
    ``interval`` VIRTUAL seconds, never per message — and on each sample:
    appends the snapshot, drains any completed trace spans from the
    tracer's bounded ring, and appends anomaly events the defense emitted
    since the last sample.  All writes are buffered (the store's
    ``flush_every``); the checkpoint manager's ``attach_store`` flushes
    at every server snapshot, so a SIGKILL loses at most the unflushed
    suffix.  The sink is write-only w.r.t. server state: nothing here is
    logged, replayed, or consulted by recovery.
    """

    def __init__(self, hub, store, tracer=None, defense=None):
        self.store = store
        self.tracer = tracer
        self.snapshots_stored = 0
        self.spans_stored = 0
        self.anomalies_stored = 0
        hub.on_sample(self._on_sample)
        if defense is not None:
            defense.on_event(self._on_anomaly)

    def _on_sample(self, snap: dict) -> None:
        self.store.append("snap", snap, seq=int(snap["seq"]),
                          now=float(snap["now"]))
        self.snapshots_stored += 1
        if self.tracer is not None:
            for span in self.tracer.drain():
                self.store.append("span", span,
                                  now=float(span.get("reported_at")
                                            or span.get("issued_at") or 0.0))
                self.spans_stored += 1

    def _on_anomaly(self, ev) -> None:
        self.store.append("anomaly", ev.to_doc(), seq=int(ev.seq),
                          now=float(ev.now))
        self.anomalies_stored += 1

    def drain_remaining(self) -> None:
        """End-of-run sweep: push spans still sitting in the tracer ring
        (completed after the final sample) before the store closes."""
        if self.tracer is not None:
            for span in self.tracer.drain():
                self.store.append("span", span,
                                  now=float(span.get("reported_at")
                                            or span.get("issued_at") or 0.0))
                self.spans_stored += 1

    def summary(self) -> dict:
        return {"snapshots_stored": self.snapshots_stored,
                "spans_stored": self.spans_stored,
                "anomalies_stored": self.anomalies_stored,
                "store": self.store.summary()}
