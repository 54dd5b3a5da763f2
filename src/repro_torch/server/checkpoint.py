"""Crash-recoverable server state: append-only replay log + snapshots.

Port of ``repro/server/checkpoint.py``, whose files either package restores.

Recovery model (DESIGN.md §9).  The work server is a DETERMINISTIC message
handler: given a state and a request message, ``handle`` computes the next
state (every random draw lives inside the engine rng, which is part of the
state).  So durability needs exactly two artifacts:

  * an **append-only replay log** — one JSONL record per handled message,
    written (and flushed) right after the in-memory state change;
  * periodic **snapshots** — the full serialized server state every
    ``snapshot_every`` messages, written atomically (tmp + rename).

``recover`` loads the newest intact snapshot and re-handles every logged
message after it, which reconstructs the exact in-memory state the server
held at the last durable log record.  A SIGKILL can lose only a SUFFIX of
the log (appends are sequential), so the recovered state is always a
valid PREFIX state of the run — and because the simulated client world is
itself a deterministic function of the server's lease table and registry
(see ``server/sim.py``), continuing from a prefix state replays the
exact same future: the restored run commits bit-identical iterates to an
uninterrupted one.  A half-written final line (the append the kill
interrupted) is detected and ignored, not fatal.

Snapshots are JSON, not msgpack, on purpose: the engine rng state carries
128-bit PCG64 integers that msgpack cannot represent, while Python's JSON
round-trips arbitrary ints and exact float64 (repr shortest-round-trip).
Numpy arrays are tagged (``{"__nd__": dtype, shape, data}``) by
``to_jsonable``/``from_jsonable`` so dtypes survive exactly.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

SNAP_PREFIX = "snapshot_"
LOG_NAME = "replay.jsonl"
#: canonical eval-cache file inside a checkpoint dir (DESIGN.md §10): the
#: warm cross-search evaluation cache rides the same crash-recovery
#: lifecycle as the replay log — append-only, flushed at every snapshot
#: (see ``CheckpointManager.attach_store``), torn-tail tolerant on load
CACHE_NAME = "eval_cache.jsonl"


def eval_cache_path(ckpt_dir: str) -> str:
    """Where a crash-recoverable run persists its eval cache — one
    convention, so a ``--resume`` process finds the warm cache without
    any extra plumbing."""
    return os.path.join(ckpt_dir, CACHE_NAME)


def to_jsonable(obj):
    """Plain-python view of a state tree: numpy arrays become tagged dicts
    (dtype + shape preserved), numpy scalars become python scalars."""
    if isinstance(obj, np.ndarray):
        return {"__nd__": str(obj.dtype), "shape": list(obj.shape),
                "data": [v.item() for v in obj.ravel()]}
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, dict):
        return {k: to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    return obj


def from_jsonable(obj):
    if isinstance(obj, dict):
        if "__nd__" in obj:
            return np.array(obj["data"],
                            np.dtype(obj["__nd__"])).reshape(obj["shape"])
        return {k: from_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [from_jsonable(v) for v in obj]
    return obj


def save_snapshot(ckpt_dir: str, seq: int, state: dict,
                  fingerprint: str, keep: int = 2) -> str:
    """Atomic snapshot write: a crash mid-write leaves the previous
    snapshot intact (tmp file + ``os.replace``)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"{SNAP_PREFIX}{seq:010d}.json"
    tmp = os.path.join(ckpt_dir, f".tmp_{name}_{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump({"seq": seq, "fingerprint": fingerprint,
                   "state": to_jsonable(state)}, f,
                  separators=(",", ":"))
    path = os.path.join(ckpt_dir, name)
    os.replace(tmp, path)
    snaps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith(SNAP_PREFIX))
    for old in snaps[:-keep]:
        try:
            os.remove(os.path.join(ckpt_dir, old))
        except OSError:
            pass
    return path


def latest_snapshot(ckpt_dir: str) -> Optional[Tuple[int, dict, str]]:
    """Newest INTACT snapshot as (seq, state, fingerprint) — a snapshot
    that fails to parse (torn write of a pre-replace tmp never surfaces
    here, but a corrupt file might) falls back to the one before it."""
    try:
        snaps = sorted((d for d in os.listdir(ckpt_dir)
                        if d.startswith(SNAP_PREFIX)), reverse=True)
    except FileNotFoundError:
        return None
    for name in snaps:
        try:
            with open(os.path.join(ckpt_dir, name)) as f:
                doc = json.load(f)
            return int(doc["seq"]), from_jsonable(doc["state"]), \
                doc.get("fingerprint", "")
        except (OSError, ValueError, KeyError):
            continue
    return None


class ReplayLog:
    """Append-only JSONL of handled messages.  ``replay`` tolerates a
    truncated final line — the telltale of a kill mid-append.

    Appends are flushed every ``flush_every`` records (and on close):
    writes are sequential either way, so a kill still loses only a
    SUFFIX — recovery correctness never depends on the flush cadence,
    only the worst-case replay distance does — while per-message flushes
    would dominate the whole server loop."""

    def __init__(self, path: str, flush_every: int = 32):
        self.path = path
        self.flush_every = max(int(flush_every), 1)
        self._since_flush = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def append(self, record: dict) -> None:
        self._f.write(json.dumps(to_jsonable(record),
                                 separators=(",", ":")) + "\n")
        self._since_flush += 1
        if self._since_flush >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        self._f.flush()
        self._since_flush = 0

    def close(self) -> None:
        self._f.close()

    @staticmethod
    def repair(path: str) -> int:
        """Truncate a SIGKILL-torn trailing partial line (no final
        newline) so a resumed run's appends start on a fresh line —
        without this, the first post-resume record would concatenate
        onto the torn fragment into one corrupt merged line, and a
        SECOND crash's recovery would stop replaying there, silently
        discarding every durable record after the first crash.  Returns
        the number of bytes dropped."""
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

    @staticmethod
    def replay(path: str) -> Iterator[dict]:
        try:
            f = open(path)
        except FileNotFoundError:
            return
        with f:
            for line in f:
                if not line.endswith("\n"):
                    return            # torn tail: the kill's half-append
                try:
                    yield from_jsonable(json.loads(line))
                except ValueError:
                    return            # corrupt tail record: stop, don't die


class CheckpointManager:
    """Wires a server's ``handle`` loop to the log + snapshot cadence.

    Usage::

        mgr = CheckpointManager(ckpt_dir, snapshot_every=500)
        ...
        reply = server.handle(msg)
        mgr.record(msg, server)        # log (flushed) + periodic snapshot

    Read-only message kinds (``status``) are neither logged nor counted —
    replaying them would be harmless but pointlessly bloats the log.
    """

    READ_ONLY = frozenset({"status", "subscribe_stats"})

    def __init__(self, ckpt_dir: str, snapshot_every: int = 1000,
                 keep: int = 2):
        self.ckpt_dir = ckpt_dir
        self.snapshot_every = max(int(snapshot_every), 1)
        self.keep = keep
        self.seq = 0
        self.snapshots_written = 0
        os.makedirs(ckpt_dir, exist_ok=True)
        self._log = ReplayLog(os.path.join(ckpt_dir, LOG_NAME))
        self._stores: list = []

    def attach_store(self, store) -> None:
        """Durability composition for auxiliary append-only stores (the
        eval cache): flushed alongside the replay log at every snapshot
        and closed with the manager.  The cache never needs to be AHEAD
        of the log — a lost suffix only costs re-evaluations, never
        correctness (bit-exact serving is value-neutral) — but flushing
        on the snapshot cadence guarantees a restored run warms from at
        least the snapshot's cache."""
        self._stores.append(store)

    def record(self, msg: dict, server) -> None:
        if msg.get("kind") in self.READ_ONLY:
            return
        if not getattr(server, "last_applied", True):
            # the dedup layer absorbed this delivery (duplicate/stale cs):
            # it mutated nothing, and logging it would make the replay log
            # depend on the fault schedule — the log must stay exactly the
            # canonical applied-message sequence (DESIGN.md §12)
            return
        self.seq += 1
        self._log.append({"seq": self.seq, "msg": msg})
        if self.seq % self.snapshot_every == 0:
            self.snapshot(server)

    def snapshot(self, server) -> None:
        self._log.flush()             # the snapshot must never be AHEAD
        for store in self._stores:
            store.flush()
        save_snapshot(self.ckpt_dir, self.seq, server.state_dict(),
                      server.fingerprint(), keep=self.keep)
        self.snapshots_written += 1

    def close(self) -> None:
        self._log.close()
        for store in self._stores:
            store.close()

    @classmethod
    def recover(cls, ckpt_dir: str, build_server: Callable[[], "object"],
                snapshot_every: int = 1000,
                keep: int = 2) -> Tuple["object", "CheckpointManager", int]:
        """Rebuild the server at the last durable log record: newest intact
        snapshot + replay of the logged suffix.  Returns
        ``(server, manager, replayed)`` with the manager positioned to
        continue appending (seq picks up where the log left off)."""
        server = build_server()
        snap = latest_snapshot(ckpt_dir)
        seq0 = 0
        if snap is not None:
            seq0, state, fp = snap
            if fp and fp != server.fingerprint():
                raise ValueError(
                    "checkpoint fingerprint mismatch: the snapshot was "
                    "taken for a different server spec")
            server.load_state(state)
        replayed = 0
        last_seq = seq0
        log_path = os.path.join(ckpt_dir, LOG_NAME)
        ReplayLog.repair(log_path)    # drop the kill's torn half-line
        for rec in ReplayLog.replay(log_path):
            seq = int(rec["seq"])
            if seq <= seq0:
                continue
            server.handle(rec["msg"])
            replayed += 1
            last_seq = seq
        mgr = cls(ckpt_dir, snapshot_every=snapshot_every, keep=keep)
        mgr.seq = last_seq
        return server, mgr, replayed
