"""Client side of the ``subscribe_stats`` wire extension (DESIGN.md §13).

Port of ``repro/obs/stream.py``, over the port's ``server/protocol.py``.

The stream is cursor-based long-polling over the existing request/reply
framing: the subscriber sends ``{kind: subscribe_stats, since: cursor}``
and the server answers with every ring-retained snapshot newer than the
cursor plus the new cursor.  No server-side subscriber state, no push
channel, no transport changes — a monitoring connection is just another
client, and (like ``status``) its messages are unstamped, uncounted and
unlogged, so polling at ANY wall-clock rate cannot perturb the replayable
applied sequence.  A subscriber that polls slower than the ring turns
over resumes at the oldest retained snapshot — and since §14 the reply
carries an explicit ``dropped`` count for the gap (optionally shrunk by
``from_store`` retention backfill) instead of silently skipped seqs.
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional

from repro_torch.server import protocol


class StatsSubscriber:
    """Cursor-tracking poller over one connection (loopback or TCP)."""

    def __init__(self, conn, start_cursor: int = -1,
                 from_store: bool = False):
        self.conn = conn
        self.cursor = int(start_cursor)
        self.from_store = bool(from_store)
        self.received = 0                 # snapshots consumed so far
        self.dropped = 0                  # cumulative ring-gap reported
        self.last_dropped = 0             # gap in the most recent reply

    def poll(self) -> List[dict]:
        """One long-poll round-trip; returns the new snapshots (possibly
        empty).  Raises ``ProtocolError`` if the server has no metrics
        hub attached (stats are opt-in server-side)."""
        rep = self.conn.call(protocol.subscribe_stats(
            self.cursor, from_store=self.from_store))
        if rep.get("kind") == "error":
            raise protocol.ProtocolError(rep.get("error", "stats error"))
        if rep.get("kind") != "stats":
            raise protocol.ProtocolError(
                f"expected a stats reply, got {rep.get('kind')!r}")
        snaps = list(rep.get("snapshots", []))
        self.cursor = int(rep.get("cursor", self.cursor))
        self.last_dropped = int(rep.get("dropped", 0))
        self.dropped += self.last_dropped
        self.received += len(snaps)
        return snaps


class BackgroundSubscriber:
    """A daemon thread polling ``subscribe_stats`` while a run is live —
    the dryrun smoke's live TCP subscriber and the dashboard's feed.

    ``connect`` is called on the thread (so a TCP connect cannot block
    the caller); snapshots are appended under a lock and optionally
    forwarded to ``on_snapshot``.  Errors are collected, not raised: a
    monitoring sidecar must never take the run down.  ``stop()`` closes
    the connection out from under a thread blocked in a long-poll (a
    server shutting down mid-poll would otherwise leave the thread stuck
    until the socket times out) and suppresses the teardown error that
    close provokes — bounded join, nothing on stderr.
    """

    def __init__(self, connect: Callable[[], object], poll_s: float = 0.05,
                 on_snapshot: Optional[Callable[[dict], None]] = None,
                 from_store: bool = False):
        self._connect = connect
        self.poll_s = float(poll_s)
        self._on_snapshot = on_snapshot
        self.from_store = bool(from_store)
        self.snapshots: List[dict] = []
        self.errors: List[str] = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._conn = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "BackgroundSubscriber":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="obs-subscriber")
        self._thread.start()
        return self

    def _run(self) -> None:
        conn = None
        try:
            conn = self._connect()
            self._conn = conn
            sub = StatsSubscriber(conn, from_store=self.from_store)
            while not self._stop.is_set():
                try:
                    snaps = sub.poll()
                except protocol.ProtocolError as e:
                    if not self._stop.is_set():
                        with self._lock:
                            self.errors.append(str(e))
                    return
                with self._lock:
                    self.dropped = sub.dropped
                    if snaps:
                        self.snapshots.extend(snaps)
                if snaps and self._on_snapshot is not None:
                    for s in snaps:
                        self._on_snapshot(s)
                self._stop.wait(self.poll_s)
        except Exception as e:  # noqa: BLE001 — sidecar must not raise
            # a closed socket mid-poll after stop() is the EXPECTED
            # shutdown path, not an error worth surfacing
            if not self._stop.is_set():
                with self._lock:
                    self.errors.append(f"{type(e).__name__}: {e}")
        finally:
            self._conn = None
            if conn is not None:
                try:
                    conn.close()
                except Exception:
                    pass

    def stop(self) -> "BackgroundSubscriber":
        self._stop.set()
        # unblock a thread sitting in recv: close the connection under it
        conn = self._conn
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        return self

    def summary(self) -> dict:
        with self._lock:
            snaps = list(self.snapshots)
            errors = list(self.errors)
            dropped = self.dropped
        seqs = [int(s["seq"]) for s in snaps]
        return {
            "snapshots": len(snaps),
            "first_seq": seqs[0] if seqs else None,
            "last_seq": seqs[-1] if seqs else None,
            # every snapshot must arrive stamped (seq + virtual time) and
            # the seqs strictly increasing — the smoke gates this
            "stamped_ok": all("seq" in s and "now" in s
                              and s.get("stream_v") is not None
                              for s in snaps)
            and all(a < b for a, b in zip(seqs, seqs[1:])),
            "dropped": dropped,
            "errors": errors,
        }
