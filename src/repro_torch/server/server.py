"""The FGDO work server: leases, host registry, portfolio routing.

Port of ``repro/server/server.py``, over the port's engine, FGDO adapter and
director.

``WorkServer`` is the deterministic heart of the service layer
(DESIGN.md §9): a pure message handler over the BOINC-shaped
``FgdoAnmServer`` adapter (itself a thin substrate over ``AnmEngine`` —
the server builds on the engine's generate/assimilate seam, never on
phase logic).  Every mutation flows through ``handle(msg) -> reply``;
every random draw lives in the engines' rngs, which are part of the
state — so given a state and a message sequence, the server's behavior
is a pure function.  That is the whole crash-recovery story: the
checkpoint layer (``server/checkpoint.py``) snapshots
``state_dict()`` and replays the logged message suffix, and the restored
server is bit-identical to the killed one.

Leases.  Every granted workunit is a lease: ``(search, wu)`` → holder,
issue time, deadline.  A result reported within the lease settles it; a
lease past its deadline lapses (kept aside until the holder next makes
contact, because the crash-restored client world is rebuilt from exactly
these records) — the work itself is NOT re-generated: the paper's any-m
phase semantics already absorb lost work, and validation replicas have
their own reissue path inside ``FgdoAnmServer``.  A result arriving after
its lease lapsed is still assimilated (the engine's phase-stale filter is
the semantic authority) and counted as a late return.

Portfolio.  The server can front one search or a whole multi-search
portfolio: work requests round-robin across live searches (the PR-4
``SearchSpec.build_engine`` is THE spec→engine construction, shared with
the orchestrator), and the ``portfolio`` policy retires searches past
probation that trail the incumbent by the orchestrator's own
``dominated_cut`` margin — the same kill rule, imported, so the two
layers cannot drift.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.fgdo import FgdoAnmServer, WorkUnit
from repro_torch.core.orchestrator.director import SearchSpec, dominated_cut
from repro_torch.server import protocol
from repro_torch.server.registry import HostRegistry

RUNNING, DONE, KILLED = "running", "done", "killed"


class SequencedIntake:
    """Reorder buffer at the transport boundary (DESIGN.md §12).

    Concurrent connections deliver messages in whatever order the network
    produces; the coordinator that RELEASED them stamped each with a
    global monotone ``intake_seq``.  ``submit`` parks an early arrival
    until every lower stamp has been handled, so the handler — and hence
    the replay log, the engines, and the committed iterates — observes
    the canonical total order no matter the arrival interleaving.  The
    handler runs under the intake lock: the work server stays the
    single-threaded deterministic object it always was, and this class is
    the ONLY concurrency-aware thing in front of it.

    Deliveries of an already-handled stamp (retries and duplicated
    frames racing their original) are handled immediately instead of
    parked — the server's (host, cs) idempotency layer turns them into
    cached-reply no-ops, so their out-of-band timing is invisible.

    Unstamped messages (a serial client, a monitoring probe) are handled
    at arrival under the same lock WITHOUT consuming a stamp — serial
    traffic flows through untouched and a mid-run status poll can never
    desync the stamped stream, so intake sequencing is strictly additive.
    """

    def __init__(self, handler, timeout: float = 120.0):
        self._handler = handler
        self._cond = threading.Condition()
        self._next = 0
        self.timeout = timeout            # generous: a gap means a bug, and
        self.parked = 0                   # a loud ProtocolError beats a hang
        self.out_of_band = 0

    @property
    def next_seq(self) -> int:
        return self._next

    def submit(self, msg: dict) -> dict:
        with self._cond:
            seq = msg.get("intake_seq")
            if seq is None:
                return self._handler(msg)
            seq = int(seq)
            if seq > self._next:
                self.parked += 1
                deadline = time.monotonic() + self.timeout
                while seq > self._next:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise protocol.ProtocolError(
                            f"intake gap: stamp {seq} waited "
                            f"{self.timeout:.0f}s at next={self._next} — a "
                            f"released message never arrived")
                    self._cond.wait(left)
            if seq < self._next:
                self.out_of_band += 1
                return self._handler(msg)
            rep = self._handler(msg)
            self._next = seq + 1
            self._cond.notify_all()
            return rep


@dataclasses.dataclass
class Lease:
    search_id: int
    wu_id: int
    host_id: int
    issued_at: float
    deadline: float
    wu: WorkUnit


@dataclasses.dataclass
class ServerCounters:
    messages: int = 0
    registrations: int = 0
    leases_issued: int = 0
    leases_lapsed: int = 0            # deadline passed before the result
    leases_abandoned: int = 0         # holder re-requested without reporting
    late_returns: int = 0             # result arrived after its lease lapsed
    unknown_results: int = 0          # no lease on record (protocol misuse)
    dropped_results: int = 0          # result for a killed search
    nowork_replies: int = 0
    heartbeats: int = 0
    duplicates_suppressed: int = 0    # same (host, cs) again: cached reply
    stale_duplicates: int = 0         # cs older than the host's last applied
    duplicate_reports: int = 0        # re-report of already-settled work


@dataclasses.dataclass
class SearchEntry:
    search_id: int
    name: str
    fgdo: FgdoAnmServer
    status: str = RUNNING


#: why the port refuses the reference's observability plane for now
OBS_REFUSED = ("the obs plane (metrics hub, tracer, retention, defense, "
               "subscriber) is not ported yet: ROADMAP A.4, second half")


class WorkServer:
    """Deterministic message handler fronting one or many ANM searches."""

    def __init__(self, specs: Sequence[SearchSpec], *,
                 policy: str = "fixed", kill_margin: float = 0.5,
                 probation_iterations: int = 2,
                 lease_timeout: float = 480.0, idle_retry: float = 5.0,
                 backoff_cap: float = 60.0,
                 val_reissue_timeout: float = 600.0,
                 overcommit: Optional[float] = 2.0,
                 registry: Optional[HostRegistry] = None):
        if policy not in ("fixed", "portfolio"):
            raise ValueError(f"unknown policy {policy!r} (fixed|portfolio)")
        self.specs = list(specs)
        if not self.specs:
            raise ValueError("need at least one SearchSpec")
        self.policy = policy
        self.kill_margin = kill_margin
        self.probation_iterations = probation_iterations
        self.lease_timeout = lease_timeout
        self.idle_retry = idle_retry
        self.backoff_cap = backoff_cap
        self.val_reissue_timeout = val_reissue_timeout
        self.overcommit = overcommit
        self.registry = registry if registry is not None else HostRegistry()
        self.searches = [
            SearchEntry(i, spec.name, FgdoAnmServer(
                cfg=spec.anm, engine=spec.build_engine(),
                val_reissue_timeout=val_reissue_timeout,
                registry=self.registry, overcommit=overcommit))
            for i, spec in enumerate(self.specs)]
        self.leases: Dict[Tuple[int, int], Lease] = {}
        self.lapsed: Dict[Tuple[int, int], Lease] = {}
        self.cursor = 0               # round-robin start for the next grant
        self.now = 0.0
        self.stopping = False
        self.counters = ServerCounters()
        # hot-path indices (derived state, rebuilt on load): the message
        # loop must stay O(1)-ish per message, not O(n_hosts) — a 1024-host
        # fleet sends tens of thousands of messages per run
        self._host_lease: Dict[int, Tuple[int, int]] = {}   # ≤1 per host
        self._host_lapsed: Dict[int, Tuple[int, int]] = {}
        self._next_deadline = float("inf")
        self._last_sweep = float("-inf")
        self.sweep_interval = 5.0     # virtual seconds between churn sweeps
        self._cache_status = None     # read-only eval-cache probe (attach)
        # an intake probe only reads depth counters, outside state_dict,
        # so it cannot perturb the replay contract.  The reference's
        # metrics hub, tracer and retention store (DESIGN.md §13-§14) are
        # the obs plane, not ported yet (ROADMAP A.4)
        self._intake_probe = None
        # idempotency layer (DESIGN.md §12): per-host last applied client
        # sequence number + the reply it produced.  Clients are serial per
        # host (one logical message in flight), so a window of 1 is exact:
        # any retransmission is of the host's LATEST message.  Part of
        # state_dict — a restored server keeps deduplicating mid-retry.
        self._client_seq: Dict[int, int] = {}
        self._last_reply: Dict[int, dict] = {}
        # last settled (search, wu) per host: a re-reported result whose
        # lease records are already gone is recognized as a benign
        # retransmit instead of protocol misuse, and can never touch the
        # registry's returned count twice
        self._settled: Dict[int, Tuple[int, int]] = {}
        # False when the last handle() call was absorbed by the dedup
        # layer (or was read-only): the checkpoint layer skips logging it,
        # so the replay log stays exactly the canonical applied sequence
        self.last_applied = True

    def attach_cache(self, cache) -> None:
        """Surface an ``EvalCache``'s counters in the read-only ``status``
        reply (DESIGN.md §10).  Observability only: the probe is NOT part
        of ``state_dict`` — cache persistence is the store's own job
        (checkpoint-dir composition), and status is never logged or
        replayed, so attaching a cache cannot perturb recovery."""
        self._cache_status = cache.status

    def attach_intake(self, intake) -> None:
        """Surface a ``SequencedIntake``'s pressure counters in ``status``:
        next expected stamp, arrivals parked waiting for their turn,
        out-of-band retry deliveries.  Observability only, exactly like
        ``attach_cache``."""
        def probe() -> dict:
            return {"next_seq": intake.next_seq, "parked": intake.parked,
                    "out_of_band": intake.out_of_band}
        self._intake_probe = probe

    def attach_hub(self, hub) -> None:
        """The reference publishes into a ``MetricsHub`` here (DESIGN.md
        §13).  The port's obs plane is a later slice: refused."""
        raise ValueError(OBS_REFUSED)

    def attach_tracer(self, tracer) -> None:
        """The reference hooks a ``WorkUnitTracer`` (§14) here: refused
        until the port's obs plane lands."""
        raise ValueError(OBS_REFUSED)

    def attach_retention(self, store) -> None:
        """The reference exposes a retention ``SnapshotStore`` (§14) here:
        refused until the port's obs plane lands."""
        raise ValueError(OBS_REFUSED)

    def kill_search(self, search_id: int) -> None:
        """Director seam (§14): retire one search by verdict.  Same
        freeze semantics as the portfolio kill — the engine's committed
        history stays a prefix of its solo run.  The defense calls this
        at a deterministic sample boundary (live detectors or a replayed
        schedule), so live and replay runs kill at the same applied
        message."""
        e = self.searches[int(search_id)]
        if e.status == RUNNING:
            e.status = KILLED

    # -- introspection -------------------------------------------------------

    @property
    def done(self) -> bool:
        return self.stopping or all(e.status != RUNNING
                                    for e in self.searches)

    @property
    def engines(self):
        return [e.fgdo.engine for e in self.searches]

    def best(self) -> Tuple[Optional[int], float]:
        """Incumbent (search_id, fitness) over the whole portfolio."""
        best_id, best_y = None, float("inf")
        for e in self.searches:
            y = e.fgdo.engine.best_fitness
            if np.isfinite(y) and y < best_y:
                best_id, best_y = e.search_id, y
        return best_id, best_y

    def fingerprint(self) -> str:
        """Identity stamped into snapshots: restoring a checkpoint into a
        server built from different specs — or the same specs under
        different behavior-affecting knobs (kill margin, lease timeout,
        backoff, feeder throttle…) — must fail loudly, not produce a
        plausible-but-wrong continuation."""
        doc = [{
            "name": s.name, "x0": np.asarray(s.x0).tolist(),
            "lo": np.asarray(s.lo).tolist(),
            "hi": np.asarray(s.hi).tolist(),
            "step": np.asarray(s.step).tolist(),
            "anm": dataclasses.asdict(s.anm),
            "engine_seed": s.engine_seed,
            "validation_quorum": s.validation_quorum,
        } for s in self.specs]
        doc.append({
            "policy": self.policy, "kill_margin": self.kill_margin,
            "probation_iterations": self.probation_iterations,
            "lease_timeout": self.lease_timeout,
            "idle_retry": self.idle_retry,
            "backoff_cap": self.backoff_cap,
            "val_reissue_timeout": self.val_reissue_timeout,
            "overcommit": self.overcommit,
        })
        return hashlib.sha256(
            json.dumps(doc, sort_keys=True).encode()).hexdigest()[:16]

    # -- time / lease sweeps -------------------------------------------------

    def _advance(self, now: float) -> None:
        self.now = max(self.now, now)
        if self.now - self._last_sweep >= self.sweep_interval:
            # churn transitions move at suspect/dead granularity (hundreds
            # of virtual seconds), so sweeping every few virtual seconds
            # is exact enough AND keeps the per-message cost off the
            # O(n_hosts) scan; deterministic — driven by message times
            self.registry.sweep(self.now)
            self._last_sweep = self.now
        if self._next_deadline < self.now:
            nxt = float("inf")
            for k in list(self.leases):
                l = self.leases[k]
                if l.deadline < self.now:
                    self.lapsed[k] = self.leases.pop(k)
                    self._host_lease.pop(l.host_id, None)
                    self._host_lapsed[l.host_id] = k
                    self.counters.leases_lapsed += 1
                else:
                    nxt = min(nxt, l.deadline)
            self._next_deadline = nxt

    def _drop_lapsed_for(self, host_id: int) -> None:
        """A host making contact supersedes its lapsed leases — they were
        kept only so the crash-restored client world could reconstruct
        the host's in-flight computation."""
        k = self._host_lapsed.pop(host_id, None)
        if k is not None:
            self.lapsed.pop(k, None)

    def _abandon_outstanding_for(self, host_id: int) -> None:
        """A host ASKING for work holds nothing (clients compute one
        workunit at a time), so any outstanding lease it still has on
        record is abandoned — it vanished with the result.  Dropping it
        here keeps the per-host lease invariant (≤ 1 record across
        outstanding ∪ lapsed) that the crash-restored client world's
        event rebuild depends on."""
        k = self._host_lease.pop(host_id, None)
        if k is not None:
            del self.leases[k]
            self.counters.leases_abandoned += 1

    # -- message handling ----------------------------------------------------

    def handle(self, msg: dict) -> dict:
        kind = msg.get("kind")
        if kind == "status":
            # read-only by contract: not counted, not logged, no sweep —
            # a monitoring poll must never perturb the replayable state
            self.last_applied = False
            return self._status()
        if kind == "subscribe_stats":
            # same contract as status (§13): unstamped, uncounted, never
            # logged, never sampled — and serving the ring mutates nothing
            self.last_applied = False
            return self._subscribe_stats(msg)
        # idempotent delivery: before ANY state is touched (including the
        # message counter), a (host, cs) the server already applied short-
        # circuits to the cached reply — a retried report can't re-vote, a
        # duplicated request can't re-abandon or double-lease, and the
        # suppressed delivery never reaches the replay log
        cs, host = msg.get("cs"), msg.get("host_id")
        keyed = cs is not None and host is not None
        if keyed:
            cs, host = int(cs), int(host)
            last = self._client_seq.get(host, -1)
            if cs == last:
                self.last_applied = False
                self.counters.duplicates_suppressed += 1
                return dict(self._last_reply[host])
            if cs < last:
                # older than the last applied message: with serial-per-
                # host clients this is a stray duplicate of a reply the
                # client already consumed — refuse rather than guess (cs
                # still echoed so a reply-matching client isn't stranded)
                self.last_applied = False
                self.counters.stale_duplicates += 1
                rep = protocol.error_reply(
                    f"stale duplicate: host {host} cs={cs} already past "
                    f"{last}")
                rep["cs"], rep["host_id"] = cs, host
                return rep
        self.last_applied = True
        self.counters.messages += 1
        rep = self._dispatch(kind, msg)
        if keyed:
            # (host_id, cs) is the client's reply-matching key — cs alone
            # is ambiguous on a connection multiplexing several hosts
            rep = dict(rep)
            rep["cs"], rep["host_id"] = cs, host
            self._client_seq[host] = cs
            self._last_reply[host] = rep
        return rep

    def _dispatch(self, kind: str, msg: dict) -> dict:
        if kind == "register":
            return self._register(msg)
        if kind == "request_work":
            return self._request_work(msg)
        if kind == "report_result":
            return self._report_result(msg)
        if kind == "heartbeat":
            return self._heartbeat(msg)
        if kind == "shutdown":
            self.stopping = True
            _, best_y = self.best()
            return protocol.ack_reply(True, max(
                e.fgdo.engine.iteration for e in self.searches), best_y)
        return protocol.error_reply(f"unknown message kind {kind!r}")

    def _register(self, msg: dict) -> dict:
        self._advance(msg["now"])
        rec = self.registry.register(int(msg["host_id"]), msg["now"])
        # a freshly registered client requests immediately: pin its next
        # contact so a crash between register and first request rebuilds
        # the schedule exactly
        rec.next_contact_at = float(msg["now"])
        self.counters.registrations += 1
        return {"kind": "registered", "host_id": int(msg["host_id"])}

    def _request_work(self, msg: dict) -> dict:
        host, now = int(msg["host_id"]), float(msg["now"])
        self._advance(now)
        self.registry.touch(host, now)
        self._drop_lapsed_for(host)
        self._abandon_outstanding_for(host)
        if not self.done:
            n = len(self.searches)
            for i in range(n):
                e = self.searches[(self.cursor + i) % n]
                if e.status != RUNNING:
                    continue
                if e.fgdo.engine.done:
                    e.status = DONE
                    continue
                wu = e.fgdo.generate_work(host, now)
                if wu is None:
                    continue
                self.cursor = (e.search_id + 1) % n
                deadline = now + self.lease_timeout
                key = (e.search_id, wu.wu_id)
                self.leases[key] = Lease(
                    e.search_id, wu.wu_id, host, now, deadline, wu)
                self._host_lease[host] = key
                self._next_deadline = min(self._next_deadline, deadline)
                self.counters.leases_issued += 1
                # the registry's on_issue cleared next_contact_at: this
                # host's next contact now derives from the lease
                return protocol.work_reply(e.search_id, wu.wu_id,
                                           wu.phase_id, wu.point, wu.alpha,
                                           wu.validates, deadline)
        rec = self.registry.record(host)
        retry = min(self.idle_retry * (2 ** rec.nowork_streak),
                    self.backoff_cap)
        self.registry.on_no_work(host, now, retry)
        self.counters.nowork_replies += 1
        return protocol.no_work_reply(retry, self.done)

    def _report_result(self, msg: dict) -> dict:
        host, now = int(msg["host_id"]), float(msg["now"])
        search, wu_id = int(msg["search"]), int(msg["wu"])
        self._advance(now)
        key = (search, wu_id)
        late = False
        lease = self.leases.pop(key, None)
        if lease is not None:
            if self._host_lease.get(lease.host_id) == key:
                del self._host_lease[lease.host_id]
        else:
            lease = self.lapsed.pop(key, None)
            if lease is not None:
                late = True
                self.counters.late_returns += 1
                if self._host_lapsed.get(lease.host_id) == key:
                    del self._host_lapsed[lease.host_id]
        self._drop_lapsed_for(host)
        e = self.searches[search] if 0 <= search < len(self.searches) \
            else None
        if lease is None and self._settled.get(host) == key:
            # the host re-reported work this server already settled (its
            # first report raced a lapse, or an ack was lost below the cs
            # window) — a benign retransmit, NOT protocol misuse, and it
            # must never reach registry.on_result: ``returned`` (the
            # reliability numerator) counts each workunit at most once
            self.counters.duplicate_reports += 1
            self.registry.touch(host, now)
        elif lease is None or e is None:
            # no lease on record: without the workunit payload there is
            # nothing safe to assimilate — count and acknowledge
            self.counters.unknown_results += 1
            self.registry.touch(host, now)
        elif e.status == KILLED:
            # a killed search's engine is frozen (its committed history
            # stays a prefix of the solo run, like the orchestrator's
            # kill) — track the host's return, drop the result
            self.registry.on_result(host, now,
                                    max(now - lease.issued_at, 1e-9))
            self.counters.dropped_results += 1
        else:
            e.fgdo.assimilate(lease.wu, float(msg["y"]), host, now)
            if e.fgdo.engine.done:
                e.status = DONE
            if self.policy == "portfolio":
                self._apply_portfolio()
        if lease is not None:
            self._settled[host] = key
        _, best_y = self.best()
        iteration = (e.fgdo.engine.iteration if e is not None
                     else 0)
        return protocol.ack_reply(self.done, iteration, best_y)

    def _heartbeat(self, msg: dict) -> dict:
        self._advance(msg["now"])
        self.registry.touch(int(msg["host_id"]), msg["now"])
        self.counters.heartbeats += 1
        _, best_y = self.best()
        return protocol.ack_reply(self.done, 0, best_y)

    def _status(self) -> dict:
        # read-only on purpose: the checkpoint layer skips logging it
        best_id, best_y = self.best()
        return {
            "kind": "status", "now": self.now, "done": self.done,
            "searches": [{
                "search_id": e.search_id, "name": e.name,
                "status": e.status,
                "phase": e.fgdo.phase,
                "iteration": e.fgdo.engine.iteration,
                "best": e.fgdo.engine.best_fitness,
            } for e in self.searches],
            "incumbent": best_id, "best": best_y,
            "leases": len(self.leases), "lapsed": len(self.lapsed),
            "counters": dataclasses.asdict(self.counters),
            "registry": self.registry.summary(),
            "cache": (None if self._cache_status is None
                      else self._cache_status()),
            # service pressure (§13 satellite): lease depth is ``leases``
            # above; intake queue depth rides here when one is attached
            "intake": (None if self._intake_probe is None
                       else self._intake_probe()),
            # the obs plane's block (§14): no hub in the port yet
            "obs": None,
        }

    def _subscribe_stats(self, msg: dict) -> dict:
        # the reference serves the metrics hub's snapshots here (§13); the
        # port has no hub yet, as a reference server without one replies
        return protocol.error_reply(
            "no metrics hub attached (" + OBS_REFUSED + ")")

    def _apply_portfolio(self) -> None:
        _, best_y = self.best()
        if not np.isfinite(best_y):
            return
        cut = dominated_cut(best_y, self.kill_margin)
        for e in self.searches:
            if (e.status == RUNNING
                    and e.fgdo.engine.iteration >= self.probation_iterations
                    and e.fgdo.engine.best_fitness > cut):
                e.status = KILLED

    # -- crash-restore seams -------------------------------------------------

    def world_view(self) -> dict:
        """Everything a deterministic client world needs to rebuild its
        event schedule after a restore: the lease tables (outstanding AND
        lapsed — a lapsed lease's holder is still out there computing)
        and each known host's next contact time."""
        def lease_doc(l: Lease) -> dict:
            return {"search": l.search_id, "wu": l.wu_id,
                    "host_id": l.host_id, "issued_at": l.issued_at,
                    "deadline": l.deadline,
                    "phase": l.wu.phase_id,
                    "point": np.asarray(l.wu.point),
                    "alpha": l.wu.alpha, "validates": l.wu.validates}
        return {
            "now": self.now,
            "leases": [lease_doc(l) for l in self.leases.values()],
            "lapsed": [lease_doc(l) for l in self.lapsed.values()],
            "hosts": [{"host_id": h, "state": r.state,
                       "next_contact_at": r.next_contact_at,
                       # the host's last applied cs: a resumed client pool
                       # continues its per-host counters from here, so the
                       # regenerated future traffic carries the same
                       # idempotency keys as the uninterrupted run's
                       "client_seq": self._client_seq.get(h, -1)}
                      for h, r in self.registry.hosts.items()],
        }

    def state_dict(self) -> dict:
        return {
            "v": 2,
            "now": self.now, "cursor": self.cursor,
            "stopping": self.stopping,
            "counters": dataclasses.asdict(self.counters),
            "registry": self.registry.state_dict(),
            "searches": [{"search_id": e.search_id, "status": e.status,
                          "fgdo": e.fgdo.state_dict()}
                         for e in self.searches],
            "leases": [self._lease_state(l) for l in self.leases.values()],
            "lapsed": [self._lease_state(l) for l in self.lapsed.values()],
            # v2: the idempotency layer survives the crash — a retry that
            # straddles a restore must still deduplicate
            "client_seq": {str(h): c for h, c in self._client_seq.items()},
            "last_reply": {str(h): r for h, r in self._last_reply.items()},
            "settled": {str(h): list(k) for h, k in self._settled.items()},
        }

    @staticmethod
    def _lease_state(l: Lease) -> dict:
        return {"search_id": l.search_id, "wu_id": l.wu_id,
                "host_id": l.host_id, "issued_at": l.issued_at,
                "deadline": l.deadline,
                "wu": {"wu_id": l.wu.wu_id, "phase_id": l.wu.phase_id,
                       "point": np.asarray(l.wu.point),
                       "alpha": l.wu.alpha, "validates": l.wu.validates,
                       "issued_at": l.wu.issued_at}}

    @staticmethod
    def _lease_from_state(d: dict) -> Lease:
        w = d["wu"]
        wu = WorkUnit(int(w["wu_id"]), int(w["phase_id"]),
                      np.asarray(w["point"], np.float64), float(w["alpha"]),
                      None if w["validates"] is None else int(w["validates"]),
                      issued_at=float(w["issued_at"]))
        return Lease(int(d["search_id"]), int(d["wu_id"]),
                     int(d["host_id"]), float(d["issued_at"]),
                     float(d["deadline"]), wu)

    def load_state(self, d: dict) -> None:
        if len(d["searches"]) != len(self.searches):
            raise ValueError("state has a different number of searches")
        self.now = float(d["now"])
        self.cursor = int(d["cursor"])
        self.stopping = bool(d["stopping"])
        self.counters = ServerCounters(
            **{k: int(v) for k, v in d["counters"].items()})
        self.registry.load_state(d["registry"])
        for e, s in zip(self.searches, d["searches"]):
            e.status = s["status"]
            e.fgdo.load_state(s["fgdo"])
        self.leases = {}
        self._host_lease = {}
        self._next_deadline = float("inf")
        for ld in d["leases"]:
            l = self._lease_from_state(ld)
            self.leases[(l.search_id, l.wu_id)] = l
            self._host_lease[l.host_id] = (l.search_id, l.wu_id)
            self._next_deadline = min(self._next_deadline, l.deadline)
        self.lapsed = {}
        self._host_lapsed = {}
        for ld in d["lapsed"]:
            l = self._lease_from_state(ld)
            self.lapsed[(l.search_id, l.wu_id)] = l
            self._host_lapsed[l.host_id] = (l.search_id, l.wu_id)
        # v2 fields absent from a v1 snapshot default empty (the replayed
        # suffix then rebuilds whatever dedup state its messages carry)
        self._client_seq = {int(h): int(c)
                            for h, c in d.get("client_seq", {}).items()}
        self._last_reply = {int(h): dict(r)
                            for h, r in d.get("last_reply", {}).items()}
        self._settled = {int(h): (int(k[0]), int(k[1]))
                         for h, k in d.get("settled", {}).items()}
        self._last_sweep = float("-inf")
