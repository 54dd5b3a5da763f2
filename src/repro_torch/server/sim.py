"""Simulated volunteer clients + the end-to-end server substrate.

Port of ``repro/server/sim.py``, over the port's engine, grid and evaluation
backends.

``SimClientPool`` replays the batched grid's host distributions — lognormal
speeds, result loss, malicious corruption, staggered arrival, all from
``grid.sample_hosts``/``GridConfig`` — as REAL protocol clients: every
interaction is a framed request/reply through a transport (loopback bytes
or TCP sockets), driven in virtual time by a deterministic event loop.

Determinism and crash recovery hang on one property: **the client world is
a pure function of the server's state**.  Per-workunit behavior (latency
noise, result loss, the malicious draw) is keyed on ``(fleet seed, host,
wu)`` — counter-based, not sequential — so a host computing workunit X
produces the same result at the same virtual time whether or not the
server was killed and restored in between.  After a restore,
``resume_from(server.world_view())`` rebuilds the entire event schedule
from the lease tables (outstanding AND lapsed) plus each idle host's
``next_contact_at``: outstanding work is re-leased to exactly the hosts
that held it, so the restored run replays the uninterrupted future —
bit-identical committed iterates, the contract ``chip_smoke.py`` and the
tests gate.

Event ordering is canonical — ``(time, kind-priority, host)``, completions
before requests — NOT insertion order, so a rebuilt queue sorts exactly
like the original.  Fitness evaluation is lazily batched: all in-flight
points with unknown values go through ONE ``EvalBackend`` bucket (with
on-device malicious-corruption lanes) the first time any of them is
needed, which is what keeps the loopback server within striking distance
of the direct batched grid in the benchmark overhead row.

``ConcurrentClientPool`` is the same fleet with the serialization removed
(DESIGN.md §12): a coordinator thread owns the canonical virtual-time
heap and assigns each message a global **intake stamp at release time, in
canonical order**, while worker threads — each with its own REAL
connection — deliver them concurrently (optionally through the chaos
fault injector).  Release is governed by a lower-bound rule: the heap
minimum is released only once it provably sorts before every in-flight
host's earliest possible FOLLOW-UP event, so the stamp order equals the
serial pool's processing order exactly.  The server's sequenced intake
then handles arrivals in stamp order, and (host, cs) idempotency absorbs
retries/duplicates — which is why N racing connections under a seeded
fault schedule still commit bit-identical iterates to the serial
fault-free baseline.

``ServerSubstrate`` wires it all together: build (or recover) a
``WorkServer``, attach the checkpoint manager, start a transport (with
``concurrent``/``chaos``, a sequenced intake and/or fault-plan wrapper),
run the pool to completion.  ``python -m repro_torch.server.sim`` runs a
seeded single-search smoke (``--device cpu`` off the card); the
reference's dryrun harness launches its twin as a subprocess, SIGKILLs
it mid-search and relaunches it with ``--resume``.  The observability
plane (``--obs`` and its kin, DESIGN.md §13-§14) attaches after
recovery and reads host state only.  ``--backend pod_mesh`` evaluates
through the pod-mesh backend: the SDSS problem on ``make_data_mesh``'s
mesh (1 × 1 on one GPU), the LM problem on the production 16 × 16 mesh,
which needs 256 devices and raises ``make_production_mesh``'s
``RuntimeError`` elsewhere, as the reference does off a pod.
"""
from __future__ import annotations

import dataclasses
import heapq
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.grid import GridConfig, sample_hosts
from repro_torch.core.orchestrator.director import SearchSpec
from repro_torch.core.substrates.eval_backend import EvalBackend
from repro_torch.core.substrates.eval_cache import CachingSubmitter, EvalCache
from repro_torch.server import protocol
from repro_torch.server.chaos import ChaosTransport, FaultPlan, PRESETS
from repro_torch.server.checkpoint import CheckpointManager
from repro_torch.server.server import SequencedIntake, WorkServer
from repro_torch.server.transport import make_transport

PRIO_COMPLETE, PRIO_REQUEST = 0, 1

#: domain salts for the counter-based per-host / per-(host, wu) draws —
#: distinct streams that can never collide with each other or the
#: sequential ``sample_hosts`` population draw
_ONLINE_SALT = 0x0F51DE
_WU_SALT = 0x5EEDED


class SimulatedCrash(RuntimeError):
    """Raised by the pool when ``max_messages`` is hit — the in-process
    stand-in for a SIGKILL (tests recover from the checkpoint dir without
    paying for a subprocess)."""


def _wu_draws(fleet_seed: int, host: int, wu: int) -> Tuple[float, float, float]:
    """(latency noise in [0.8, 1.2], loss uniform, malicious u in
    [0.2, 0.8]) for one (host, workunit) pair — keyed, not sequential, so
    the draw survives a server crash/restore unchanged."""
    rng = np.random.default_rng(
        np.random.SeedSequence((_WU_SALT, fleet_seed, host, wu)))
    return (float(rng.uniform(0.8, 1.2)), float(rng.random()),
            float(rng.uniform(0.2, 0.8)))


@dataclasses.dataclass
class PoolStats:
    messages: int = 0
    work_received: int = 0
    results_reported: int = 0
    no_work: int = 0
    failed: int = 0                   # results lost to vanishing hosts
    corrupted: int = 0                # malicious lanes evaluated
    eval_batches: int = 0
    evals: int = 0
    resumed_leases: int = 0           # in-flight work rebuilt after restore
    sim_time: float = 0.0


@dataclasses.dataclass
class _InFlight:
    search: int
    wu: int
    point: np.ndarray
    issued_at: float


class SimClientPool:
    """Deterministic virtual-time client fleet over one connection."""

    def __init__(self, cfg: GridConfig, backend: EvalBackend,
                 max_messages: Optional[int] = None,
                 silence_at: Optional[float] = None,
                 silence_frac: float = 0.25):
        self.cfg = cfg
        self.backend = backend
        self.max_messages = max_messages
        # injected fleet failure (the obs smoke's churn anomaly): from
        # virtual time ``silence_at`` on, the deterministic cohort of the
        # ``silence_frac``·n_hosts LOWEST host ids stops contacting the
        # server — events are swallowed at pop time, so the server only
        # ever sees silence: leases lapse, the registry sweep flips the
        # cohort suspect, and the anomaly detector has something to page
        self.silence_at = None if silence_at is None else float(silence_at)
        n_sil = 0 if silence_at is None \
            else int(round(float(silence_frac) * cfg.n_hosts))
        self.silenced = frozenset(range(n_sil))
        self.speeds, self.malicious, _ = sample_hosts(cfg)
        online_rng = np.random.default_rng(
            np.random.SeedSequence((_ONLINE_SALT, cfg.seed)))
        self.online = online_rng.uniform(0, cfg.base_eval_time / 10,
                                         cfg.n_hosts)
        self.stats = PoolStats()
        self._events: List[Tuple[float, int, int]] = []
        self._inflight: Dict[int, _InFlight] = {}
        self._ycache: Dict[Tuple[int, int], float] = {}
        self._registered: set = set()
        self._stopped: set = set()
        self._seeded = False          # resume_from pre-seeded the schedule
        # per-host client sequence counters — the idempotency keys every
        # message carries (serial traffic too, so the wire is uniform);
        # after a resume they continue from the server's last applied cs
        self._cs: Dict[int, int] = {}
        self.request_wall: List[float] = []   # request_work round-trip walls

    # -- crash-restore rebuild ----------------------------------------------

    def resume_from(self, world: dict) -> None:
        """Rebuild the event schedule from a restored server's
        ``world_view()``: leased hosts resume their in-flight computation
        (completion or vanish-retry at the deterministic per-(host, wu)
        time), idle hosts re-contact at ``next_contact_at``, and hosts
        the run never saw come online on their original stagger."""
        leased = set()
        for l in world["leases"] + world["lapsed"]:
            h, wu = int(l["host_id"]), int(l["wu"])
            if h in leased:           # server keeps ≤ 1 lease per host
                continue
            leased.add(h)
            self._registered.add(h)
            noise, loss, _ = _wu_draws(self.cfg.seed, h, wu)
            dt = self.cfg.base_eval_time / self.speeds[h] * noise
            t0 = float(l["issued_at"])
            if loss < self.cfg.failure_prob:
                self.stats.failed += 1
                heapq.heappush(self._events, (t0 + 4 * dt, PRIO_REQUEST, h))
            else:
                self._inflight[h] = _InFlight(
                    int(l["search"]), wu,
                    np.asarray(l["point"], np.float64), t0)
                heapq.heappush(self._events, (t0 + dt, PRIO_COMPLETE, h))
            self.stats.resumed_leases += 1
        for rec in world["hosts"]:
            h = int(rec["host_id"])
            # cs continuity: the resumed fleet keeps counting from the
            # server's last applied message per host, so its traffic can
            # never collide with (or be deduplicated against) the prefix
            self._cs[h] = int(rec.get("client_seq", -1)) + 1
            if h in leased or rec["next_contact_at"] is None:
                continue
            self._registered.add(h)
            heapq.heappush(self._events,
                           (float(rec["next_contact_at"]), PRIO_REQUEST, h))
        known = leased | self._registered
        for h in range(self.cfg.n_hosts):
            if h not in known:
                heapq.heappush(self._events,
                               (float(self.online[h]), PRIO_REQUEST, h))
        self._seeded = True

    # -- evaluation ----------------------------------------------------------

    def _value(self, search: int, wu: int) -> float:
        key = (search, wu)
        y = self._ycache.pop(key, None)
        if y is not None:
            return y
        # lazily batch every in-flight unknown into ONE backend bucket;
        # row-independence (the repo-wide width-invariance contract) means
        # batch composition cannot change any lane's value
        todo = sorted((inf.search, inf.wu, h)
                      for h, inf in self._inflight.items()
                      if (inf.search, inf.wu) not in self._ycache)
        pts = np.stack([self._inflight[h].point for _, _, h in todo])
        mal_u = np.full(len(todo), np.nan)
        for i, (_, w, h) in enumerate(todo):
            if self.malicious[h]:
                mal_u[i] = _wu_draws(self.cfg.seed, h, w)[2]
                self.stats.corrupted += 1
        ys = self.backend(pts, mal_u)
        self.stats.eval_batches += 1
        self.stats.evals += len(todo)
        for (s, w, _), yv in zip(todo, ys):
            self._ycache[(s, w)] = float(yv)
        return self._ycache.pop(key)

    # -- the virtual-time loop ----------------------------------------------

    def _gone_silent(self, t: float, h: int) -> bool:
        """Whether this event belongs to the silenced cohort after the
        silence time (deterministic in virtual time, so every run sharing
        the silence parameters swallows exactly the same events)."""
        return self.silence_at is not None and t >= self.silence_at \
            and h in self.silenced

    def _next_cs(self, h: int) -> int:
        c = self._cs.get(h, 0)
        self._cs[h] = c + 1
        return c

    def _call(self, conn, msg: dict) -> dict:
        if self.max_messages is not None and \
                self.stats.messages >= self.max_messages:
            raise SimulatedCrash(
                f"simulated crash after {self.stats.messages} messages")
        self.stats.messages += 1
        t0 = time.perf_counter()
        rep = conn.call(msg)
        if msg.get("kind") == "request_work":
            self.request_wall.append(time.perf_counter() - t0)
        return rep

    def run(self, conn) -> PoolStats:
        cfg = self.cfg
        if not self._seeded:
            for h in range(cfg.n_hosts):
                heapq.heappush(self._events,
                               (float(self.online[h]), PRIO_REQUEST, h))
        done = False
        while self._events and not done:
            t, prio, h = heapq.heappop(self._events)
            if h in self._stopped or self._gone_silent(t, h):
                continue
            self.stats.sim_time = max(self.stats.sim_time, t)
            if prio == PRIO_REQUEST:
                if h not in self._registered:
                    self._call(conn,
                               protocol.register(h, t, cs=self._next_cs(h)))
                    self._registered.add(h)
                rep = self._call(
                    conn, protocol.request_work(h, t, cs=self._next_cs(h)))
                if rep["kind"] == "work":
                    self.stats.work_received += 1
                    wu = int(rep["wu"])
                    noise, loss, _ = _wu_draws(cfg.seed, h, wu)
                    dt = cfg.base_eval_time / self.speeds[h] * noise
                    if loss < cfg.failure_prob:
                        # the host vanishes with the result and re-requests
                        # much later — the server only ever sees silence
                        self.stats.failed += 1
                        heapq.heappush(self._events,
                                       (t + 4 * dt, PRIO_REQUEST, h))
                    else:
                        self._inflight[h] = _InFlight(
                            int(rep["search"]), wu,
                            np.asarray(rep["point"], np.float64), t)
                        heapq.heappush(self._events,
                                       (t + dt, PRIO_COMPLETE, h))
                else:                 # no_work (or done)
                    self.stats.no_work += 1
                    if rep.get("done"):
                        self._stopped.add(h)
                    else:
                        heapq.heappush(
                            self._events,
                            (t + float(rep["retry_after"]), PRIO_REQUEST, h))
            else:                     # PRIO_COMPLETE
                inf = self._inflight[h]
                y = self._value(inf.search, inf.wu)  # batches all in-flight
                del self._inflight[h]
                rep = self._call(conn, protocol.report_result(
                    h, inf.search, inf.wu, y, t, cs=self._next_cs(h)))
                self.stats.results_reported += 1
                if rep.get("done"):
                    done = True       # engines sealed; drain and stop
                else:
                    heapq.heappush(self._events, (t, PRIO_REQUEST, h))
        return self.stats


class ConcurrentClientPool(SimClientPool):
    """The same deterministic fleet, delivered by racing threads.

    A coordinator (the calling thread) pops the canonical virtual-time
    heap and RELEASES each event: it stamps the event's messages with
    consecutive global intake sequence numbers and hands them to one of
    ``n_workers`` worker threads (hosts are multiplexed host→worker, so a
    host's own messages stay ordered on one connection) which deliver
    them over real, concurrently racing connections.  Determinism is by
    construction, not by luck:

      * stamps are assigned at RELEASE time in canonical heap order, and
        the server's ``SequencedIntake`` handles messages in stamp order
        — so the applied sequence is the serial pool's sequence no matter
        how arrivals interleave (or how chaos delays/duplicates them);
      * the heap minimum ``e`` is released only when ``e`` sorts before
        every in-flight host's earliest possible follow-up event (a
        completion's follow-up request lands at the same virtual time;
        a request's earliest follow-up is bounded by the minimum
        latency-noise completion and the minimum no-work retry), so no
        event that the serial order would process before ``e`` can still
        be created by an outstanding reply;
      * replies only ever touch the reporting host's own schedule, so
        absorbing them as they arrive (in any order) commutes.

    Fitness values are computed by the coordinator at completion-release
    time through the same lazily-batched ``_value`` — the backend stays
    single-threaded, and row-independence makes batch composition
    value-neutral.  ``max_messages`` counts RELEASED messages, so the
    simulated-crash point is deterministic here too; because the server
    applies a stamp-prefix of the released sequence, the crashed state is
    always a canonical prefix and ``resume_from`` replays the same
    future.
    """

    #: generous safety net — a stuck reply means a real bug (or an
    #: exhausted chaos retry budget), and a loud error beats a hang
    REPLY_TIMEOUT = 120.0

    def __init__(self, cfg: GridConfig, backend: EvalBackend,
                 max_messages: Optional[int] = None, n_workers: int = 8,
                 silence_at: Optional[float] = None,
                 silence_frac: float = 0.25):
        super().__init__(cfg, backend, max_messages=max_messages,
                         silence_at=silence_at, silence_frac=silence_frac)
        self.n_workers = max(1, int(n_workers))
        self.next_stamp = 0
        self._crash: Optional[BaseException] = None
        self._done = False

    # -- release machinery ---------------------------------------------------

    def _follow_lb(self, t: float, prio: int, h: int):
        """Strict lower bound on the follow-up event an in-flight
        (t, prio, h) can push when its reply lands."""
        if prio == PRIO_COMPLETE:
            # a report's follow-up is the host's next request at the SAME
            # virtual time (or nothing, if the run is done)
            return (t, PRIO_REQUEST, h)
        # a request's follow-up: completion at t + dt (dt ≥ 0.8·base/speed
        # — the latency-noise floor), vanish-retry at t + 4·dt, or no-work
        # retry at t + retry_after (≥ idle_retry); prio 0 / host -1 keep
        # the bound below any real event at that time
        dt_min = 0.8 * self.cfg.base_eval_time / self.speeds[h]
        return (t + min(dt_min, self.cfg.idle_retry), PRIO_COMPLETE, -1)

    def _stamped(self, msg: dict) -> dict:
        if self.max_messages is not None and \
                self.stats.messages >= self.max_messages:
            raise SimulatedCrash(
                f"simulated crash after {self.stats.messages} messages")
        self.stats.messages += 1
        msg["intake_seq"] = self.next_stamp
        self.next_stamp += 1
        return msg

    def _release(self, ev, jobs, pending) -> None:
        """Build the event's message(s), stamp them in canonical order,
        and enqueue for the host's worker.  Raises SimulatedCrash at the
        configured release count — exactly like the serial pool, AFTER
        any earlier message of the same event went out (a crash can split
        a register+request pair, and recovery must cope)."""
        t, prio, h = ev
        self.stats.sim_time = max(self.stats.sim_time, t)
        msgs, crash = [], None
        try:
            if prio == PRIO_REQUEST:
                if h not in self._registered:
                    msgs.append(self._stamped(
                        protocol.register(h, t, cs=self._next_cs(h))))
                    self._registered.add(h)
                msgs.append(self._stamped(
                    protocol.request_work(h, t, cs=self._next_cs(h))))
            else:
                inf = self._inflight[h]
                y = self._value(inf.search, inf.wu)
                del self._inflight[h]
                msgs.append(self._stamped(protocol.report_result(
                    h, inf.search, inf.wu, y, t, cs=self._next_cs(h))))
        except SimulatedCrash as e:
            crash = e
        if msgs:
            # partial=True: the reply is drained but not absorbed — the
            # run is crashing and recovery rebuilds the world from the
            # server, exactly as for a mid-pair SIGKILL
            pending[h] = self._follow_lb(t, prio, h)
            jobs[h % self.n_workers].put((ev, msgs, crash is not None))
        if crash is not None:
            raise crash

    def _absorb(self, result, pending) -> None:
        ev, rep, err, partial = result
        t, prio, h = ev
        pending.pop(h, None)
        if err is not None:
            if self._crash is None:
                self._crash = err
            self._done = True
            return
        if partial:
            return
        if prio == PRIO_REQUEST:
            if rep["kind"] == "work":
                self.stats.work_received += 1
                wu = int(rep["wu"])
                noise, loss, _ = _wu_draws(self.cfg.seed, h, wu)
                dt = self.cfg.base_eval_time / self.speeds[h] * noise
                if loss < self.cfg.failure_prob:
                    self.stats.failed += 1
                    heapq.heappush(self._events,
                                   (t + 4 * dt, PRIO_REQUEST, h))
                else:
                    self._inflight[h] = _InFlight(
                        int(rep["search"]), wu,
                        np.asarray(rep["point"], np.float64), t)
                    heapq.heappush(self._events, (t + dt, PRIO_COMPLETE, h))
            else:
                self.stats.no_work += 1
                if rep.get("done"):
                    self._stopped.add(h)
                else:
                    heapq.heappush(
                        self._events,
                        (t + float(rep["retry_after"]), PRIO_REQUEST, h))
        else:
            self.stats.results_reported += 1
            if rep.get("done"):
                self._done = True
            else:
                heapq.heappush(self._events, (t, PRIO_REQUEST, h))

    # -- the concurrent loop -------------------------------------------------

    def run(self, transport) -> PoolStats:   # noqa: D102 — see class doc
        cfg = self.cfg
        if not self._seeded:
            for h in range(cfg.n_hosts):
                heapq.heappush(self._events,
                               (float(self.online[h]), PRIO_REQUEST, h))
        jobs = [queue.Queue() for _ in range(self.n_workers)]
        results: "queue.Queue" = queue.Queue()

        def worker(wid: int) -> None:
            conn = transport.connect()
            try:
                while True:
                    job = jobs[wid].get()
                    if job is None:
                        return
                    ev, msgs, partial = job
                    try:
                        rep = None
                        for m in msgs:
                            t0 = time.perf_counter()
                            rep = conn.call(m)
                            if m.get("kind") == "request_work":
                                self.request_wall.append(
                                    time.perf_counter() - t0)
                        results.put((ev, rep, None, partial))
                    except BaseException as e:  # noqa: BLE001 — surfaced
                        results.put((ev, None, e, partial))
            finally:
                conn.close()

        threads = [threading.Thread(target=worker, args=(i,), daemon=True,
                                    name=f"sim-client-{i}")
                   for i in range(self.n_workers)]
        for th in threads:
            th.start()
        pending: Dict[int, tuple] = {}
        try:
            while True:
                # absorb whatever replies already landed (order-free)
                while True:
                    try:
                        self._absorb(results.get_nowait(), pending)
                    except queue.Empty:
                        break
                if self._done:
                    if not pending:
                        break
                    self._absorb(results.get(timeout=self.REPLY_TIMEOUT),
                                 pending)
                    continue
                ev = self._events[0] if self._events else None
                while ev is not None and (ev[2] in self._stopped
                                          or self._gone_silent(ev[0], ev[2])):
                    heapq.heappop(self._events)
                    ev = self._events[0] if self._events else None
                releasable = ev is not None and all(
                    ev < lb for lb in pending.values())
                if releasable:
                    self._release(heapq.heappop(self._events), jobs,
                                  pending)
                elif pending:
                    self._absorb(results.get(timeout=self.REPLY_TIMEOUT),
                                 pending)
                elif ev is None:
                    break
                else:        # unreachable: nothing pending blocks release
                    raise RuntimeError("release stalled with empty pending")
        except queue.Empty:
            raise RuntimeError(
                f"no reply within {self.REPLY_TIMEOUT:.0f}s with "
                f"{len(pending)} deliveries in flight — lost message?")
        finally:
            for q in jobs:
                q.put(None)
            for th in threads:
                th.join(timeout=10.0)
        if self._crash is not None:
            raise self._crash
        return self.stats


@dataclasses.dataclass
class ServerRunResult:
    server: WorkServer
    pool: PoolStats
    resumed: bool = False
    replayed: int = 0                 # log records re-handled at recovery
    recovered_done: bool = False      # nothing left to do after restore
    cache: Optional[dict] = None      # eval-cache counters, when enabled
    chaos: Optional[dict] = None      # injected-fault counters + plan doc
    intake: Optional[dict] = None     # sequenced-intake counters
    request_p99_ms: Optional[float] = None  # p99 request_work round-trip
    obs: Optional[dict] = None        # metrics-hub summary, when observed
    subscriber: Optional[dict] = None  # live stats-poller summary
    defense: Optional[dict] = None    # anomaly summary + recorded schedule
    retention: Optional[dict] = None  # §14 sink + store summary
    trace: Optional[dict] = None      # §14 tracer counters

    @property
    def engines(self):
        return self.server.engines


class ServerSubstrate:
    """Run one search (or a portfolio) end-to-end through the work server:
    the BOINC bridge built on the engine's generate/assimilate seam
    (DESIGN.md §1/§9), exercised by the simulated client fleet over a real
    transport.  With ``ckpt_dir`` set the run is crash-recoverable: pass
    ``resume=True`` to continue a killed run from its snapshot + replay
    log."""

    def __init__(self, specs, fleet: GridConfig, backend: EvalBackend, *,
                 transport: str = "loopback", policy: str = "fixed",
                 kill_margin: float = 0.5, probation_iterations: int = 2,
                 ckpt_dir: Optional[str] = None, snapshot_every: int = 500,
                 lease_timeout: Optional[float] = None,
                 max_messages: Optional[int] = None,
                 throttle_s: float = 0.0, warm: bool = True,
                 cache: Optional[EvalCache] = None,
                 concurrent: int = 0, chaos=None,
                 chaos_seed: Optional[int] = None,
                 obs: bool = False, stats_interval: float = 25.0,
                 stats_ring: int = 256,
                 subscribe: bool = False, defense: bool = False,
                 defense_schedule: Optional[dict] = None,
                 retain: bool = False, retain_dir: Optional[str] = None,
                 retain_backend: str = "jsonl",
                 retain_max_records: Optional[int] = 20_000,
                 trace_rate: float = 0.0, trace_seed: int = 0,
                 stall_window: int = 0, turnaround_drift: float = 0.0,
                 silence_at: Optional[float] = None,
                 silence_frac: float = 0.25):
        self.specs = [specs] if isinstance(specs, SearchSpec) else list(specs)
        self.fleet = fleet
        self.backend = backend
        # the memo layer (DESIGN.md §10): the client pool evaluates
        # through it, so re-leased points after a crash-restore — and any
        # byte-identical re-evaluation — are served instead of paid for.
        # Bit-exact-only serving keeps the restored trajectory identical.
        self.cache = cache
        self.eval_backend = (backend if cache is None
                             else CachingSubmitter(backend, cache))
        self.transport_name = transport
        self.policy = policy
        self.kill_margin = kill_margin
        self.probation_iterations = probation_iterations
        self.ckpt_dir = ckpt_dir
        self.snapshot_every = snapshot_every
        self.lease_timeout = (8.0 * fleet.base_eval_time
                              if lease_timeout is None else lease_timeout)
        self.max_messages = max_messages
        self.throttle_s = throttle_s
        # concurrency + chaos (DESIGN.md §12): ``concurrent`` > 0 runs the
        # fleet as that many racing client threads behind a sequenced
        # intake; ``chaos`` (preset name | FaultPlan doc | FaultPlan)
        # wraps the transport in the fault injector, ``chaos_seed``
        # re-seeds a named plan without redefining it
        self.concurrent = int(concurrent)
        if chaos is None or isinstance(chaos, FaultPlan):
            plan = chaos
        elif isinstance(chaos, str):
            plan = PRESETS[chaos]
        elif isinstance(chaos, dict):
            plan = FaultPlan.from_doc(chaos)
        else:
            raise TypeError(f"chaos must be None|str|dict|FaultPlan, "
                            f"got {type(chaos).__name__}")
        if plan is not None and chaos_seed is not None:
            plan = dataclasses.replace(plan, seed=int(chaos_seed))
        self.chaos_plan: Optional[FaultPlan] = plan
        # observability plane (DESIGN.md §13): ``obs`` attaches a
        # MetricsHub sampled every ``stats_interval`` virtual seconds at
        # applied-message boundaries; ``subscribe`` runs a live
        # background poller over the raw transport; ``defense`` arms the
        # anomaly detectors (``defense_schedule`` replays a recorded run
        # instead).  Any of them implies the hub.
        self.subscribe = bool(subscribe)
        self.defense = bool(defense)
        self.defense_schedule = defense_schedule
        # §14 post-mortem plane: ``retain`` spills samples into a
        # SnapshotStore under retain_dir (default: the ckpt_dir),
        # ``trace_rate`` > 0 hooks a WorkUnitTracer onto the lease paths,
        # and the window-defense knobs arm the §14 detectors (implying a
        # live defense).  All of it implies the hub.
        self.retain_dir = retain_dir
        self.retain = bool(retain or retain_dir is not None)
        self.retain_backend = str(retain_backend)
        self.retain_max_records = retain_max_records
        self.trace_rate = float(trace_rate)
        self.trace_seed = int(trace_seed)
        self.stall_window = int(stall_window)
        self.turnaround_drift = float(turnaround_drift)
        if self.stall_window or self.turnaround_drift:
            self.defense = True
        self.obs = bool(obs or subscribe or self.defense
                        or defense_schedule is not None
                        or self.retain or self.trace_rate > 0)
        self.stats_interval = float(stats_interval)
        self.stats_ring = int(stats_ring)
        self.silence_at = silence_at
        self.silence_frac = float(silence_frac)
        if warm:
            # in-flight unknowns are bounded by the fleet (≤ 1 lease per
            # host), so warming the ladder to n_hosts runs every bucket
            # shape before the run starts
            self.backend.warm(len(np.asarray(self.specs[0].x0)),
                              fleet.n_hosts)

    def _build_server(self) -> WorkServer:
        return WorkServer(self.specs, policy=self.policy,
                          kill_margin=self.kill_margin,
                          probation_iterations=self.probation_iterations,
                          lease_timeout=self.lease_timeout,
                          idle_retry=self.fleet.idle_retry)

    def run(self, resume: bool = False) -> ServerRunResult:
        replayed = 0
        mgr = None
        if resume:
            if self.ckpt_dir is None:
                raise ValueError("resume=True needs a ckpt_dir")
            server, mgr, replayed = CheckpointManager.recover(
                self.ckpt_dir, self._build_server,
                snapshot_every=self.snapshot_every)
        else:
            server = self._build_server()
            if self.ckpt_dir is not None:
                mgr = CheckpointManager(self.ckpt_dir,
                                        snapshot_every=self.snapshot_every)
        recovered_done = server.done
        if self.cache is not None:
            server.attach_cache(self.cache)       # status counters (§10)
            if mgr is not None:
                mgr.attach_store(self.cache.store)
        # obs attaches AFTER recovery: the replayed prefix re-applies with
        # no hub (no samples), and the hub owns no replayable state — §13's
        # recovery-compatibility argument
        hub = None
        fleet_defense = None
        tracer = None
        store = None
        sink = None
        if self.obs:
            from repro_torch.obs import (FleetDefense, MetricsHub,
                                         RetentionSink, WorkUnitTracer,
                                         obs_store_path, open_snapshot_store)
            hub = MetricsHub(interval=self.stats_interval,
                             ring=self.stats_ring)
            server.attach_hub(hub)
            if self.trace_rate > 0:
                tracer = WorkUnitTracer(sample_rate=self.trace_rate,
                                        seed=self.trace_seed)
                server.attach_tracer(tracer)
            if self.defense_schedule is not None:
                # replay mode: recorded verdicts (incl. §14 stall kills)
                # re-applied at recorded seqs; the server is the director
                fleet_defense = FleetDefense.replay(server.registry, hub,
                                                    self.defense_schedule,
                                                    director=server)
            elif self.defense:
                fleet_defense = FleetDefense(
                    server.registry, hub, director=server,
                    stall_window=self.stall_window,
                    turnaround_drift=self.turnaround_drift)
            if self.retain:
                rdir = self.retain_dir or self.ckpt_dir
                if rdir is None:
                    raise ValueError("retain=True needs retain_dir or "
                                     "ckpt_dir")
                store = open_snapshot_store(
                    obs_store_path(rdir, self.retain_backend),
                    max_records=self.retain_max_records)
                sink = RetentionSink(hub, store, tracer=tracer,
                                     defense=fleet_defense)
                server.attach_retention(store)
                if mgr is not None:
                    # flushed at every snapshot, closed with the manager —
                    # the same §10 composition as the eval-cache store
                    mgr.attach_store(store)
        if mgr is None:
            handler = server.handle
        else:
            def handler(msg, _mgr=mgr, _srv=server):
                rep = _srv.handle(msg)
                _mgr.record(msg, _srv)
                if self.throttle_s:
                    time.sleep(self.throttle_s)
                return rep
        intake = None
        if self.concurrent:
            # the sequenced intake is what turns N racing connections into
            # the canonical applied order; a TCP handler that PARKS must
            # run off the loop thread (blocking_handler)
            intake = SequencedIntake(handler)
            handler = intake.submit
            server.attach_intake(intake)  # queue-depth in status + hub
        elif self.subscribe:
            # a live subscriber shares the handler with the serial pool:
            # serialize them (the intake's lock does this in concurrent
            # mode) so an unstamped poll can never interleave inside an
            # applied message's handle+record pair
            lock = threading.Lock()

            def handler(msg, _lk=lock, _inner=handler):
                with _lk:
                    return _inner(msg)
        tkwargs = {}
        if self.transport_name == "tcp" and self.concurrent:
            tkwargs["blocking_handler"] = True
        transport = make_transport(self.transport_name, **tkwargs)
        # the monitoring side-channel connects to the RAW transport: chaos
        # draws are keyed on (host, cs), which unstamped monitoring polls
        # do not carry — and perturbing the fault schedule with extra
        # traffic would defeat the chaos-parity gates
        raw_transport = transport
        if self.chaos_plan is not None:
            transport = ChaosTransport(transport, self.chaos_plan)
        transport.start(handler)
        subscriber = None
        if self.subscribe:
            from repro_torch.obs import BackgroundSubscriber
            subscriber = BackgroundSubscriber(raw_transport.connect).start()
        if self.concurrent:
            pool = ConcurrentClientPool(self.fleet, self.eval_backend,
                                        max_messages=self.max_messages,
                                        n_workers=self.concurrent,
                                        silence_at=self.silence_at,
                                        silence_frac=self.silence_frac)
        else:
            pool = SimClientPool(self.fleet, self.eval_backend,
                                 max_messages=self.max_messages,
                                 silence_at=self.silence_at,
                                 silence_frac=self.silence_frac)
        if resume:
            pool.resume_from(server.world_view())
        conn = None
        cache_status = None
        retention_doc = None
        try:
            if self.concurrent:
                pool.run(transport)       # workers open their own conns
            else:
                conn = transport.connect()
                pool.run(conn)
            # read the counters BEFORE the finally closes the store — a
            # sqlite-backed cache cannot answer len() once closed
            if self.cache is not None:
                cache_status = self.cache.status()
        finally:
            if subscriber is not None:
                subscriber.stop()
            if conn is not None:
                conn.close()
            transport.stop()
            if sink is not None:
                sink.drain_remaining()    # spans settled after last sample
                # summarized while the store can still answer (sqlite
                # cannot be queried once the manager closes it)
                retention_doc = sink.summary()
            if mgr is not None:
                mgr.close()               # closes attached cache stores too
            elif self.cache is not None:
                self.cache.store.flush()
            if store is not None and mgr is None:
                store.close()
        p99 = None
        if pool.request_wall:
            p99 = float(np.percentile(np.asarray(pool.request_wall),
                                      99.0) * 1000.0)
        obs_doc = None
        if hub is not None:
            latest = hub.latest()
            obs_doc = {"snapshots": hub.seq, "interval": hub.interval,
                       "ring": hub.ring,
                       "last_registry": None if latest is None
                       else latest["groups"].get("registry")}
        defense_doc = None
        if fleet_defense is not None:
            defense_doc = dict(fleet_defense.summary())
            defense_doc["schedule"] = fleet_defense.schedule_doc()
        return ServerRunResult(server=server, pool=pool.stats,
                               resumed=resume, replayed=replayed,
                               recovered_done=recovered_done,
                               cache=cache_status,
                               chaos=None if self.chaos_plan is None else {
                                   "plan": self.chaos_plan.to_doc(),
                                   **dataclasses.asdict(transport.stats)},
                               intake=None if intake is None else {
                                   "next_seq": intake.next_seq,
                                   "parked": intake.parked,
                                   "out_of_band": intake.out_of_band},
                               request_p99_ms=p99, obs=obs_doc,
                               subscriber=None if subscriber is None
                               else subscriber.summary(),
                               defense=defense_doc,
                               retention=retention_doc,
                               trace=None if tracer is None
                               else tracer.summary())


# -- the seeded smoke problem + CLI (dryrun's kill/restore subprocess) --------

def smoke_problem(n_stars: int = 400, n_hosts: int = 192, m: int = 24,
                  iterations: int = 4, engine_seed: int = 7,
                  grid_seed: int = 9, failure: float = 0.05,
                  malicious: float = 0.02, quorum: int = 2,
                  device="cuda"):
    """The fixed seeded workload every kill/restore gate compares across
    runs: (spec, fleet, f_batch).  Parameters ARE the identity — the
    reference's dryrun harness passes the same values to every
    subprocess.  The stars, the fitness and the engine's phase finish
    live on ``device``."""
    from repro_torch.core.anm import AnmConfig
    from repro_torch.data import sdss

    stripe = sdss.make_stripe("server_smoke", n_stars=n_stars, seed=23)
    f_batch, _ = sdss.make_fitness(stripe, device=device)
    rng = np.random.default_rng(3)
    x0 = np.clip(stripe.truth + rng.normal(0, 0.2, 8).astype(np.float32),
                 sdss.LO, sdss.HI)
    fleet = GridConfig(n_hosts=n_hosts, failure_prob=failure,
                       malicious_prob=malicious, seed=grid_seed)
    spec = SearchSpec(
        name="server_smoke", x0=np.asarray(x0, np.float64),
        lo=np.asarray(sdss.LO, np.float64),
        hi=np.asarray(sdss.HI, np.float64),
        step=np.asarray(sdss.DEFAULT_STEP, np.float64),
        anm=AnmConfig(m_regression=m, m_line_search=m,
                      max_iterations=iterations),
        grid=fleet, engine_seed=engine_seed, validation_quorum=quorum,
        device=str(device))
    return spec, fleet, f_batch


def lm_problem(arch: str = "rwkv6-7b", k: int = 6, n_hosts: int = 48,
               m: int = 12, iterations: int = 2, engine_seed: int = 7,
               grid_seed: int = 9, failure: float = 0.05,
               malicious: float = 0.02, quorum: int = 2,
               workload_seed: int = 3, device="cuda", **workload_kw):
    """The LM-loss counterpart of ``smoke_problem``: the search space is
    the k-dim subspace-coefficient box of an ``LmWorkload`` over one of
    the model configs, and every fitness evaluation is a real forward +
    loss (``LmLossEvalBackend``).  Returns (spec, fleet, workload); the
    caller builds the backend.  Parameters are the workload identity,
    exactly as for the SDSS smoke — same values in two processes ⇒
    bit-identical search.  ``workload_kw`` goes to ``make_lm_workload``
    (the port's ``full_width``, ``n_layers``, ``seq_len``, ...), which
    builds the workload on ``device``."""
    from repro_torch.core.substrates.lm_loss import make_lm_workload

    wl = make_lm_workload(arch, k=k, seed=workload_seed, device=device,
                          **workload_kw)
    return lm_search(wl, n_hosts=n_hosts, m=m, iterations=iterations,
                     engine_seed=engine_seed, grid_seed=grid_seed,
                     failure=failure, malicious=malicious, quorum=quorum)


def lm_search(wl, n_hosts: int = 48, m: int = 12, iterations: int = 2,
              engine_seed: int = 7, grid_seed: int = 9,
              failure: float = 0.05, malicious: float = 0.02,
              quorum: int = 2):
    """(spec, fleet, wl) of ``lm_problem`` around a workload already
    built; the engine runs on the workload's device."""
    from repro_torch.core.anm import AnmConfig

    fleet = GridConfig(n_hosts=n_hosts, failure_prob=failure,
                       malicious_prob=malicious, seed=grid_seed)
    spec = SearchSpec(
        name=f"lm_{wl.arch}", x0=wl.x0, lo=wl.lo, hi=wl.hi, step=wl.step,
        anm=AnmConfig(m_regression=m, m_line_search=m,
                      max_iterations=iterations),
        grid=fleet, engine_seed=engine_seed, validation_quorum=quorum,
        device=str(wl.proj.basis.device))
    return spec, fleet, wl


def result_doc(res: ServerRunResult) -> dict:
    """JSON-able run outcome: the full committed trajectory + stats, the
    exact objects the kill/restore gates compare bit-for-bit (float64
    round-trips exactly through JSON); and where the engine ran
    (``device``) and this process's kernel launches so far
    (``launches``), so that a run in a child process shows where it went."""
    from repro_torch.kernels import ops

    eng = res.server.engines[0]
    return {
        "device": str(eng.device), "launches": ops.launch_counts(),
        "resumed": res.resumed, "replayed": res.replayed,
        "recovered_done": res.recovered_done,
        "iteration": eng.iteration,
        "best_fitness": eng.best_fitness,
        "history": {
            "centers": [r.center.tolist() for r in eng.history],
            "best_fitness": [r.best_fitness for r in eng.history],
            "best_alpha": [r.best_alpha for r in eng.history],
            "evals_used": [r.evals_used for r in eng.history],
        },
        "engine_stats": dataclasses.asdict(eng.stats),
        "counters": dataclasses.asdict(res.server.counters),
        "registry": res.server.registry.summary(),
        "pool": dataclasses.asdict(res.pool),
        "cache": res.cache,
        "chaos": res.chaos,
        "intake": res.intake,
        "request_p99_ms": res.request_p99_ms,
        "obs": res.obs,
        "subscriber": res.subscriber,
        "defense": res.defense,
        "retention": res.retention,
        "trace": res.trace,
    }


def cli_parser():
    """The command line: the reference's flags, and ``--device``."""
    import argparse

    ap = argparse.ArgumentParser(
        description="seeded single-search server smoke (the port of the "
                    "reference's kill/restore subprocess)")
    ap.add_argument("--transport", default="loopback",
                    choices=["loopback", "tcp"])
    ap.add_argument("--backend", default="in_process",
                    choices=["in_process", "pod_mesh"])
    ap.add_argument("--problem", default="sdss", choices=["sdss", "lm"],
                    help="sdss: the 8-param stream fit; lm: the subspace-"
                         "Newton LM-loss workload (--arch/--k)")
    ap.add_argument("--arch", default="rwkv6-7b",
                    help="smoke model config for --problem lm")
    ap.add_argument("--k", type=int, default=6,
                    help="subspace dimension for --problem lm")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--out", default=None, help="result JSON path")
    ap.add_argument("--n-hosts", type=int, default=192)
    ap.add_argument("--n-stars", type=int, default=400)
    ap.add_argument("--m", type=int, default=24)
    ap.add_argument("--iterations", type=int, default=4)
    ap.add_argument("--engine-seed", type=int, default=7)
    ap.add_argument("--grid-seed", type=int, default=9)
    ap.add_argument("--failure", type=float, default=0.05)
    ap.add_argument("--malicious", type=float, default=0.02)
    ap.add_argument("--snapshot-every", type=int, default=250)
    ap.add_argument("--cache", action="store_true",
                    help="evaluate through a persistent eval cache "
                         "(JSONL store in --ckpt-dir, in-memory without "
                         "one); a --resume run warms from the survivor")
    ap.add_argument("--throttle-s", type=float, default=0.0,
                    help="wall-clock sleep per handled message (widens the "
                         "SIGKILL window; virtual time is unaffected, so "
                         "the trajectory is identical)")
    ap.add_argument("--concurrent", type=int, default=0,
                    help="run the fleet as N racing client threads behind "
                         "the sequenced intake (0: serial single-conn)")
    ap.add_argument("--chaos", default=None,
                    choices=sorted(PRESETS),
                    help="inject faults per this preset FaultPlan")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="re-seed the chosen --chaos plan")
    ap.add_argument("--obs", action="store_true",
                    help="attach the metrics hub (DESIGN.md §13): sampled "
                         "stats snapshots + the subscribe_stats wire "
                         "extension; the trajectory is unchanged")
    ap.add_argument("--stats-interval", type=float, default=25.0,
                    help="virtual seconds between hub snapshots")
    ap.add_argument("--stats-ring", type=int, default=256,
                    help="hub snapshot ring size (construction-path knob)")
    ap.add_argument("--retain", action="store_true",
                    help="spill snapshots/spans/anomalies into the §14 "
                         "retention store under --retain-dir or --ckpt-dir "
                         "(implies --obs)")
    ap.add_argument("--retain-dir", default=None,
                    help="retention store directory (default: --ckpt-dir)")
    ap.add_argument("--retain-backend", default="jsonl",
                    choices=["jsonl", "sqlite"])
    ap.add_argument("--trace-rate", type=float, default=0.0,
                    help="fraction of workunits lifecycle-traced, keyed "
                         "deterministically on workunit id (implies --obs)")
    ap.add_argument("--stall-window", type=int, default=0,
                    help="kill a search with no committed improvement for "
                         "this many snapshots (implies --defense)")
    ap.add_argument("--turnaround-drift", type=float, default=0.0,
                    help="page a state cohort whose fast turnaround EWMA "
                         "drifts this fraction above the slow baseline "
                         "(implies --defense)")
    ap.add_argument("--subscribe", action="store_true",
                    help="run a live background subscribe_stats poller "
                         "over the transport (implies --obs)")
    ap.add_argument("--silence-at", type=float, default=None,
                    help="inject fleet churn: the lowest --silence-frac "
                         "of host ids go silent at this virtual time")
    ap.add_argument("--silence-frac", type=float, default=0.25)
    ap.add_argument("--defense", action="store_true",
                    help="arm the anomaly detectors: suspect cohorts are "
                         "quarantined out of the reliable set, and the "
                         "verdict schedule is recorded (implies --obs)")
    ap.add_argument("--defense-out", default=None,
                    help="write the recorded anomaly schedule JSON here")
    ap.add_argument("--defense-replay", default=None,
                    help="replay a recorded anomaly schedule instead of "
                         "detecting (the solo-reproducibility twin)")
    ap.add_argument("--device", default="cuda",
                    help="where the fitness and the engines run (the "
                         "card unless 'cpu' is asked for)")
    return ap


def run_cli(argv: Optional[Sequence[str]] = None, **substrate_kw):
    """Parse ``argv`` and run the server smoke it describes; extra
    ``substrate_kw`` go to ``ServerSubstrate`` (``max_messages``: the
    simulated crash).  Returns (args, run result, result doc)."""
    import json
    import os

    args = cli_parser().parse_args(argv)

    if args.problem == "lm":
        spec, fleet, wl = lm_problem(
            arch=args.arch, k=args.k, n_hosts=args.n_hosts, m=args.m,
            iterations=args.iterations, engine_seed=args.engine_seed,
            grid_seed=args.grid_seed, failure=args.failure,
            malicious=args.malicious, device=args.device)
        from repro_torch.core.substrates.lm_loss import LmLossEvalBackend
        if args.backend == "pod_mesh":
            from repro_torch.launch.mesh import make_production_mesh
            backend = LmLossEvalBackend(wl, mesh=make_production_mesh())
        else:
            backend = LmLossEvalBackend(wl)
    else:
        spec, fleet, f_batch = smoke_problem(
            n_stars=args.n_stars, n_hosts=args.n_hosts, m=args.m,
            iterations=args.iterations, engine_seed=args.engine_seed,
            grid_seed=args.grid_seed, failure=args.failure,
            malicious=args.malicious, device=args.device)
        if args.backend == "pod_mesh":
            from repro_torch.core.substrates.pod_mesh import (
                PodMeshEvalBackend)
            backend = PodMeshEvalBackend(f_batch, device=args.device)
        else:
            from repro_torch.core.substrates.eval_backend import (
                InProcessEvalBackend)
            backend = InProcessEvalBackend(f_batch, device=args.device)
    cache = None
    if args.cache:
        from repro_torch.core.substrates.eval_cache import JsonlCacheStore
        from repro_torch.server.checkpoint import eval_cache_path
        # the fingerprint names the OBJECTIVE identity (stripe + fleet
        # shape — or the LM workload), so every process over the same
        # smoke problem — baseline, killed, resumed — shares keys, and a
        # different problem never collides
        if args.problem == "lm":
            fp = (f"lm_subspace/{args.arch}/{args.k}/{args.n_hosts}/"
                  f"{args.m}/{args.iterations}")
        else:
            fp = (f"server_smoke/{args.n_stars}/{args.n_hosts}/{args.m}/"
                  f"{args.iterations}")
        store = (JsonlCacheStore(eval_cache_path(args.ckpt_dir))
                 if args.ckpt_dir else None)
        cache = EvalCache(store, fingerprint=fp)
    defense_schedule = None
    if args.defense_replay:
        with open(args.defense_replay) as f:
            defense_schedule = json.load(f)
    sub = ServerSubstrate(spec, fleet, backend, transport=args.transport,
                          ckpt_dir=args.ckpt_dir,
                          snapshot_every=args.snapshot_every,
                          throttle_s=args.throttle_s, cache=cache,
                          concurrent=args.concurrent, chaos=args.chaos,
                          chaos_seed=args.chaos_seed,
                          obs=args.obs, stats_interval=args.stats_interval,
                          stats_ring=args.stats_ring,
                          subscribe=args.subscribe, defense=args.defense,
                          defense_schedule=defense_schedule,
                          retain=args.retain, retain_dir=args.retain_dir,
                          retain_backend=args.retain_backend,
                          trace_rate=args.trace_rate,
                          stall_window=args.stall_window,
                          turnaround_drift=args.turnaround_drift,
                          silence_at=args.silence_at,
                          silence_frac=args.silence_frac, **substrate_kw)
    res = sub.run(resume=args.resume)
    doc = result_doc(res)
    if args.defense_out and res.defense is not None:
        os.makedirs(os.path.dirname(os.path.abspath(args.defense_out)),
                    exist_ok=True)
        with open(args.defense_out, "w") as f:
            json.dump(res.defense["schedule"], f, indent=2)
    doc["transport"] = args.transport
    doc["backend"] = args.backend
    doc["problem"] = args.problem
    doc["concurrent"] = args.concurrent
    if args.problem == "lm":
        doc["arch"] = args.arch
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
    return args, res, doc


def main(argv: Optional[Sequence[str]] = None) -> int:
    args, res, doc = run_cli(argv)
    cache_note = ""
    if res.cache is not None:
        cache_note = (f" cache_hits={res.cache['hits']}"
                      f" cache_store={res.cache['store_size']}")
    if res.chaos is not None:
        cache_note += (f" chaos={res.chaos['plan']['name']}"
                       f" retries={res.chaos['retries']}")
    if args.concurrent:
        cache_note += f" workers={args.concurrent}"
    if res.obs is not None:
        cache_note += f" obs_snapshots={res.obs['snapshots']}"
    if res.subscriber is not None:
        cache_note += (f" subscribed={res.subscriber['snapshots']}"
                       f" stamped_ok={res.subscriber['stamped_ok']}")
    if res.defense is not None:
        cache_note += (f" defense={res.defense['mode']}"
                       f" anomalies={res.defense['events']}"
                       f" quarantined={res.defense['quarantined_now']}")
    print(f"[server.sim] transport={args.transport} backend={args.backend} "
          f"resumed={res.resumed} replayed={res.replayed} "
          f"iters={doc['iteration']} best={doc['best_fitness']:.6f} "
          f"messages={doc['pool']['messages']}{cache_note}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
