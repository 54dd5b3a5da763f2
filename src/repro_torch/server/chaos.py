"""Fault-injection transport layer: seeded chaos for the work service.

Port of ``repro/server/chaos.py``.

Real volunteer fleets sit behind lossy networks: requests vanish, replies
vanish, frames are duplicated by retransmitting middleboxes, writes tear
mid-frame, connections reset, and independent clients' messages interleave
arbitrarily.  The service's robustness claim (DESIGN.md §12) is that NONE
of that perturbs the committed trajectory — and a claim like that needs
the faults injected on purpose, reproducibly, not merely tolerated by
accident.

``FaultPlan`` is the reproducible schedule: every fault decision is a
counter-based draw keyed on ``(plan seed, host, client_seq, attempt)`` —
the same keying discipline as the client pool's per-workunit draws — so a
chaos run is determined by its plan, not by wall-clock races.  The plan
serializes (``to_doc``/``from_doc``) and is recorded into every chaos
artifact, which is what makes a failing schedule replayable.

``ChaosConnection`` wraps a real client connection (loopback or TCP) and
injects at the client edge of the wire, where every fault class a network
can produce is expressible:

  * **drop request** — the frame is never sent; the client retries;
  * **drop reply**   — the frame is sent and handled, the reply is lost;
    the retry re-sends the SAME ``client_seq``, exercising server-side
    idempotency (a retried report must not double-count a quorum vote);
  * **duplicate**    — the frame is sent twice back-to-back: two copies
    reach the handler, the second must be suppressed;
  * **delay**        — the send is held briefly; with concurrent clients
    this REORDERS arrival across connections, which the server's
    sequenced intake must absorb;
  * **torn write**   — a truncated prefix of the frame is written and the
    connection is torn down (a partial frame desyncs a byte stream, so
    tear-down is part of the fault, exactly like a real broken write);
  * **reset**        — the connection is closed before the send; the
    retry reconnects.

Retries use exponential backoff with seeded jitter (paper-adjacent BOINC
client behavior); because every injection is client-side, the retry loop
never needs a wall-clock timeout — it KNOWS what it broke — so chaos runs
stay fast while the server sees exactly the byte stream a faulty network
would have delivered.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np

from repro_torch.server.protocol import ProtocolError, encode_message, frame

#: domain salt for the chaos draw stream — distinct from the client pool's
#: ``_ONLINE_SALT``/``_WU_SALT`` so plans can never collide with workload
#: randomness
_CHAOS_SALT = 0xC4A05


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, serializable fault schedule.  Probabilities are per
    delivery attempt; all draws are keyed on (seed, host, client_seq,
    attempt) so the plan fully determines the fault sequence."""
    name: str = "custom"
    seed: int = 0
    drop_request: float = 0.0         # request frame vanishes before send
    drop_reply: float = 0.0           # handled, but the reply is lost
    duplicate: float = 0.0            # request frame delivered twice
    delay: float = 0.0                # send held briefly (reorders arrival)
    delay_ms: float = 2.0             # max hold per delayed send
    torn_write: float = 0.0           # truncated frame + connection teardown
    reset: float = 0.0                # connection reset before the send
    max_attempts: int = 64            # retry budget per logical message
    backoff_base_ms: float = 0.05     # exponential backoff base (wall ms)
    backoff_cap_ms: float = 2.0       # backoff ceiling

    def to_doc(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_doc(cls, doc: dict) -> "FaultPlan":
        return cls(**doc)

    def draws(self, host: int, cs: int, attempt: int) -> Dict[str, float]:
        """The per-attempt fault coin flips — counter-based, so a plan's
        decision for (host, message, attempt) is independent of every
        other message and of thread timing."""
        rng = np.random.default_rng(np.random.SeedSequence(
            (_CHAOS_SALT, int(self.seed), int(host), int(cs), int(attempt))))
        u = rng.random(6)
        return {
            "reset": u[0] < self.reset,
            "drop_request": u[1] < self.drop_request,
            "duplicate": u[2] < self.duplicate,
            "delay": u[3] < self.delay,
            "torn_write": u[4] < self.torn_write,
            "drop_reply": u[5] < self.drop_reply,
            "delay_frac": float(rng.random()),     # fraction of delay_ms
            "tear_frac": float(rng.random()),      # fraction of frame kept
            "jitter": float(rng.random()),         # backoff jitter in [0,1)
        }

    def backoff_s(self, attempt: int, jitter: float) -> float:
        """Full-jitter exponential backoff (attempt 0 pays nothing)."""
        if attempt <= 0:
            return 0.0
        cap = min(self.backoff_base_ms * (2.0 ** (attempt - 1)),
                  self.backoff_cap_ms)
        return cap * jitter / 1000.0


#: the named plans the parity gates cycle through — three distinct fault
#: mixes (loss+duplication, reordering delay, resets+torn writes) plus the
#: ledger's degraded-mode operating point (10% drop / 5% duplication)
PRESETS: Dict[str, FaultPlan] = {
    "drop_dup": FaultPlan(name="drop_dup", seed=101, drop_request=0.08,
                          drop_reply=0.06, duplicate=0.10),
    "reorder_delay": FaultPlan(name="reorder_delay", seed=202, delay=0.25,
                               delay_ms=2.0, duplicate=0.05),
    "reset_torn": FaultPlan(name="reset_torn", seed=303, reset=0.05,
                            torn_write=0.05, drop_reply=0.04),
    "degraded": FaultPlan(name="degraded", seed=404, drop_request=0.10,
                          duplicate=0.05),
}


@dataclasses.dataclass
class ChaosStats:
    sent: int = 0                     # frames actually written to the wire
    delivered: int = 0                # logical messages acknowledged
    drops_request: int = 0
    drops_reply: int = 0
    duplicates: int = 0
    delays: int = 0
    torn_writes: int = 0
    resets: int = 0
    retries: int = 0                  # attempts beyond the first
    stale_replies: int = 0            # non-matching replies skipped


class ChaosConnection:
    """A client connection with a fault injector between ``call`` and the
    wire.  Request/reply matching is by the ``cs`` (client_seq) echo: a
    duplicated frame produces two replies, and the read loop returns the
    first reply matching the in-flight ``cs``, discarding strays — which
    is why duplication is safe end-to-end."""

    def __init__(self, transport, plan: FaultPlan,
                 stats: Optional[ChaosStats] = None):
        self._transport = transport
        self.plan = plan
        self.stats = stats if stats is not None else ChaosStats()
        self._conn = None

    # -- inner-connection plumbing -------------------------------------------

    def _ensure(self):
        if self._conn is None:
            self._conn = self._transport.connect()
        return self._conn

    def _teardown(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except Exception:
                pass
            self._conn = None

    # -- the retry loop -------------------------------------------------------

    def call(self, msg: dict) -> dict:
        plan = self.plan
        host = int(msg.get("host_id", 0))
        cs = int(msg.get("cs", 0))
        seq = msg.get("intake_seq")
        last_err: Optional[BaseException] = None
        for attempt in range(plan.max_attempts):
            d = plan.draws(host, cs, attempt)
            if attempt:
                self.stats.retries += 1
                time.sleep(plan.backoff_s(attempt, d["jitter"]))
            if d["reset"]:
                self.stats.resets += 1
                self._teardown()
                continue
            if d["drop_request"]:
                self.stats.drops_request += 1
                continue
            try:
                conn = self._ensure()
                data = frame(encode_message(msg, conn.codec))
                if d["delay"]:
                    # holding THIS send while other connections proceed is
                    # exactly an arrival reorder at the server's intake
                    self.stats.delays += 1
                    time.sleep(plan.delay_ms * d["delay_frac"] / 1000.0)
                if d["torn_write"]:
                    # a partial frame desyncs the stream: write a strict
                    # prefix, then tear the connection down (the server's
                    # decoder is left holding an incomplete frame, which
                    # the disconnect discards)
                    self.stats.torn_writes += 1
                    keep = max(1, int(len(data) * 0.9 * d["tear_frac"]))
                    conn.send_bytes(data[:keep])
                    self._teardown()
                    continue
                copies = 2 if d["duplicate"] else 1
                if d["duplicate"]:
                    self.stats.duplicates += 1
                conn.send_bytes(data * copies)
                self.stats.sent += copies
                rep = self._read_matching(
                    conn, host, cs if "cs" in msg else None)
                if d["drop_reply"]:
                    # the server handled it; the client never hears back.
                    # The retry re-sends the same cs — idempotency's job.
                    self.stats.drops_reply += 1
                    continue
                self.stats.delivered += 1
                return rep
            except (ConnectionError, OSError, ProtocolError) as e:
                last_err = e
                self._teardown()
                continue
        raise ProtocolError(
            f"chaos retries exhausted for host={host} cs={cs} "
            f"(intake_seq={seq}, last_err={last_err})")

    def _read_matching(self, conn, host: int, cs: Optional[int]) -> dict:
        """Read replies until one matches the in-flight ``(host_id, cs)``
        echo (strays are duplicate acks of earlier frames — skip them).
        cs alone would be ambiguous: it is a PER-HOST counter, and one
        connection can multiplex several hosts.  Messages without a cs
        take the first reply, classic request/reply."""
        while True:
            rep = conn.read_reply()
            if cs is None or (rep.get("cs") == cs
                              and rep.get("host_id") == host):
                return rep
            self.stats.stale_replies += 1

    def close(self) -> None:
        self._teardown()


class ChaosTransport:
    """Transport decorator: the inner transport (loopback or TCP) carries
    the bytes; every connection handed out is chaos-wrapped under one
    shared ``FaultPlan`` + stats."""

    name = "chaos"

    def __init__(self, inner, plan: FaultPlan):
        self.inner = inner
        self.plan = plan
        self.stats = ChaosStats()

    def start(self, handler) -> "ChaosTransport":
        self.inner.start(handler)
        return self

    def connect(self) -> ChaosConnection:
        return ChaosConnection(self.inner, self.plan, self.stats)

    def stop(self) -> None:
        self.inner.stop()
