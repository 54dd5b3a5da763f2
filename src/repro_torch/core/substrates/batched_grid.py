"""Vectorized volunteer-grid substrate: pipelined, device-resident ticks.

Port of ``repro/core/substrates/batched_grid.py``, pointed at the port's
engine, grid and evaluation backend; the tick loop is the reference's.

The per-event simulator (core/grid.py) calls ``f(point)`` once per Python
event, so simulating the paper's m=1000-per-phase workloads at thousands of
hosts is Python/dispatch-bound.  This substrate keeps the same physics —
lognormal host speeds, result loss, malicious corruption, identical host
population per seed via ``grid.sample_hosts`` — but advances the whole
fleet with numpy array ops and evaluates ALL workunits completing in a tick
with a single backend bucket (padded to power-of-two shapes, so a run sees
O(log n_hosts) bucket shapes, not one per tick).

Since the pipelined refactor (DESIGN.md §7) the hot loop never waits for
the device inside a phase: a tick's bucket is ``submit``ted (enqueued on
the backend's CUDA stream) and the host immediately advances fleet physics
and issues the
next block SPECULATIVELY (``engine.peek_block``) instead of blocking on
``collect``.  That is safe because, within a phase, generated points
depend only on phase state and the engine rng — never on the pending
``ys`` — and assimilating a partial phase cannot change any of that.  The
grid predicts phase flips exactly (a phase flips iff the queued live
results reach the phase's remaining ``wanted()``), drains the pipeline
with ``collect`` only when assimilation must decide a transition, and the
committed iterates are bit-identical to the non-pipelined path at the same
seed — the hard parity contract, gated in the tests and ``chip_smoke.py``.

It drives the ``AnmEngine`` event API directly: requests out, results in,
in completion-time order, so stale filtering and quorum validation behave
exactly as on the per-event grid (DESIGN.md §3).

The run loop is RESUMABLE (DESIGN.md §8): ``run()`` is ``start()`` + a
``step()``-per-tick loop + ``finish()``, so an external driver — the
multi-search orchestrator — can interleave single ticks from several
concurrent searches over one shared backend.  WHERE a tick's bucket is
dispatched is a second seam, the ``submitter`` (default: the backend
itself): the orchestrator passes a per-search façade that coalesces
blocks from every live search into one shared tagged bucket per
scheduling round.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np

from repro_torch.core.engine import LINESEARCH, REGRESSION, AnmEngine
from repro_torch.core.grid import GridConfig, GridStats, sample_hosts
from repro_torch.core.substrates.eval_backend import (STAGING_RING,
                                                      EvalBackend,
                                                      EvalHandle,
                                                      InProcessEvalBackend)


@dataclasses.dataclass
class BatchedGridStats(GridStats):
    ticks: int = 0
    batch_calls: int = 0
    batched_evals: int = 0            # delivered results summed over ticks
    device_blocked_s: float = 0.0     # wall seconds blocked in collect()
    host_s: float = 0.0               # wall seconds of host-side simulation
    spec_blocks: int = 0              # blocks issued speculatively (peek)
    spec_discarded: int = 0           # speculative blocks rolled back
    max_in_flight: int = 0            # deepest device pipeline reached
    bucket_hist: Dict[int, int] = dataclasses.field(default_factory=dict)


class _PendingTick(NamedTuple):
    """One tick whose bucket is in flight on the device: the submitted
    handle plus the delivered-result arrays assimilation will need."""
    handle: Optional[EvalHandle]
    d_phase: np.ndarray
    d_ticket: np.ndarray
    d_point: np.ndarray
    d_alpha: np.ndarray
    d_validates: np.ndarray
    live_mask: np.ndarray
    live_n: int


@dataclasses.dataclass
class _RunState:
    """Everything one in-progress ``run`` owns: fleet arrays, simulated
    clock, and the in-flight pipeline.  Kept separate from the grid object
    so a run is an explicit ``start``/``step``/``finish`` lifecycle the
    orchestrator can drive tick-by-tick."""
    engine: AnmEngine
    max_ticks: int
    max_sim_time: float
    busy: np.ndarray
    lost: np.ndarray                  # host took work but will drop the result
    t_done: np.ndarray
    req_phase: np.ndarray             # phase_id of the workunit a host holds
    a_ticket: np.ndarray
    a_validates: np.ndarray
    a_alpha: np.ndarray
    a_point: np.ndarray
    online: np.ndarray                # staggered start, like the per-event sim
    now: float = 0.0
    # in-flight tick buckets, oldest first, and the predicted value of
    # engine.wanted() once they all assimilate (valid iff pending is
    # nonempty; > 0 by construction — a queued tick that would reach the
    # phase's m is flushed immediately, because only then can assimilation
    # flip the phase)
    pending: collections.deque = dataclasses.field(
        default_factory=collections.deque)
    spec_wanted: int = 0
    # host wall-clock accumulated inside start/step/finish calls only, so
    # interleaved multi-search runs don't charge each other's ticks here
    wall_s: float = 0.0
    blocked0: float = 0.0             # device_blocked_s at start()


class BatchedVolunteerGrid:
    """Tick-synchronous simulator over thousands of hosts.

    f_batch: (k, n) f32 tensor -> (k,) fitness, called inside the backend's
    bucket finalization.  ``tick_batch`` is how many completions are
    drained per tick (default: n_hosts/16, ≥ 1) — the per-event simulator
    corresponds to tick_batch=1.

    WHERE a tick's block is evaluated is a pluggable ``EvalBackend``
    (DESIGN.md §6): the default wraps ``f_batch`` in an
    ``InProcessEvalBackend`` on ``device``.

    ``pipelined=True`` (the default) overlaps host simulation with device
    evaluation: up to ``pipeline_depth`` tick buckets ride the device
    queue while the host runs ahead issuing speculative in-phase blocks;
    ``pipelined=False`` collects every bucket synchronously.  Both modes
    commit bit-identical iterates at a given seed.

    Unlike the per-event simulator, which hands work to every requesting
    host, this substrate throttles issuance to ``engine.wanted() ×
    overcommit`` outstanding current-phase workunits: a phase that needs m
    results gets ~2m in flight (straggler/failure slack), not n_hosts — so
    fleet size stops multiplying evaluation cost.
    """

    def __init__(self, f_batch: Optional[Callable], cfg: GridConfig,
                 tick_batch: Optional[int] = None, overcommit: float = 2.0,
                 backend: Optional[EvalBackend] = None,
                 pipelined: bool = True, pipeline_depth: int = 4,
                 submitter=None, device="cuda"):
        if backend is None:
            if f_batch is None:
                raise ValueError("need f_batch or an explicit backend")
            backend = InProcessEvalBackend(f_batch, device=device)
        self.backend = backend
        # WHERE a tick's block is dispatched: anything with the backend's
        # submit/collect shape.  The orchestrator passes a per-search
        # coalescing façade here (DESIGN.md §8); alone, the backend itself.
        self.submitter = backend if submitter is None else submitter
        self.cfg = cfg
        self.speeds, self.malicious, self.rng = sample_hosts(cfg)
        self.tick_batch = tick_batch or max(1, cfg.n_hosts // 16)
        self.overcommit = overcommit
        self.pipelined = pipelined
        # the backend's staging rings bound how many same-shape buckets may
        # be in flight at once (asynchronous copies read the pinned
        # buffers) — clamp the pipeline under that with one slot of
        # submit-before-flush slack
        self.pipeline_depth = max(1, min(pipeline_depth, STAGING_RING - 2))
        self.stats = BatchedGridStats()
        self._rs: Optional[_RunState] = None

    @staticmethod
    def warm_max_bucket(m: int, overcommit: float = 2.0) -> int:
        """Largest live block a run at phase size ``m`` can deliver in one
        tick (the issuance cap plus object-path slack) — THE formula for
        pre-warming a backend's bucket ladder.  ``run()`` warms with this
        internally; external callers that construct warmed backends must
        use it too, or a changed ``overcommit`` would silently put first
        runs of bucket shapes inside their timed windows."""
        return int(np.ceil(m * overcommit)) + 8

    # -- the run lifecycle: start / step / finish ---------------------------

    def start(self, engine: AnmEngine, max_ticks: int = 1_000_000,
              max_sim_time: float = float("inf")) -> None:
        """Bind an engine and begin a stepwise run.  Warms the backend's
        bucket ladder (live rows per tick are bounded by the issuance cap,
        so after this no bucket shape can compile mid-run; idempotent when
        already warmed) and initializes the fleet arrays: assignment is
        held in ARRAYS, not request objects — paired with the engine's
        generate_block/assimilate_arrays fast path so a tick moving
        thousands of results costs array ops, not object churn."""
        if self._rs is not None:
            raise RuntimeError("a run is already in progress; finish() it")
        cfg = self.cfg
        n = cfg.n_hosts
        max_live = min(n, self.warm_max_bucket(
            max(engine.cfg.m_regression, engine.cfg.m_line_search),
            self.overcommit))
        # warm BEFORE the wall timer opens: a cold backend's first run of
        # each bucket shape must not be booked as this run's host time
        self.backend.warm(engine.n, max_live)
        t0 = time.perf_counter()
        rs = _RunState(
            engine=engine, max_ticks=max_ticks, max_sim_time=max_sim_time,
            busy=np.zeros(n, bool), lost=np.zeros(n, bool),
            t_done=np.full(n, np.inf), req_phase=np.full(n, -1),
            a_ticket=np.full(n, -1, np.int64),
            a_validates=np.full(n, -1, np.int64),
            a_alpha=np.full(n, np.nan), a_point=np.zeros((n, engine.n)),
            # hosts come online staggered, like the per-event simulator
            online=self.rng.uniform(0, cfg.base_eval_time / 10, n),
            blocked0=self.stats.device_blocked_s)  # host_s per-run-sane
        self._rs = rs
        rs.wall_s += time.perf_counter() - t0

    def _issue(self, rs: _RunState, hosts, tickets, phase_id, pts, alphas,
               validates):
        k = hosts.size
        dt = self.cfg.base_eval_time / self.speeds[hosts] \
            * self.rng.uniform(0.8, 1.2, k)
        fail = self.rng.random(k) < self.cfg.failure_prob
        self.stats.failed += int(fail.sum())
        rs.busy[hosts] = True
        rs.lost[hosts] = fail
        # a vanishing host re-requests much later (4x the eval)
        rs.t_done[hosts] = rs.now + np.where(fail, 4 * dt, dt)
        rs.req_phase[hosts] = phase_id
        rs.a_ticket[hosts] = tickets
        rs.a_validates[hosts] = validates
        rs.a_alpha[hosts] = alphas
        rs.a_point[hosts] = pts

    def _flush_one(self, rs: _RunState) -> None:
        p = rs.pending.popleft()
        ys = np.full(p.d_phase.size, np.nan)
        if p.handle is not None:
            t0 = time.perf_counter()
            ys_live = self.submitter.collect(p.handle)
            self.stats.device_blocked_s += time.perf_counter() - t0
            ys[p.live_mask] = ys_live
            # bucket widths are recorded at collect time: a coalesced
            # lane's width is only known once the shared round dispatches
            kp = p.handle.kp
            self.stats.bucket_hist[kp] = self.stats.bucket_hist.get(kp, 0) + 1
        rs.engine.assimilate_arrays(p.d_phase, p.d_ticket, p.d_point,
                                    p.d_alpha, p.d_validates, ys)
        self.stats.completed += int(p.d_phase.size)
        self.stats.batched_evals += int(p.live_n)

    def _flush_all(self, rs: _RunState) -> None:
        while rs.pending:
            self._flush_one(rs)

    def _throttled_ask(self, rs: _RunState, idle_n: int, wanted: int) -> int:
        """Issuance throttle: top outstanding current-phase work up to
        ``wanted × overcommit`` — the ONE definition both the
        speculative and the engine-current paths share (a one-sided
        edit here would silently break the sync==pipelined parity)."""
        in_flight = int(np.sum(rs.busy
                               & (rs.req_phase == rs.engine.phase_id)))
        cap = int(np.ceil(wanted * self.overcommit))
        return min(idle_n, max(cap - in_flight, 0))

    def step(self) -> bool:
        """Advance the bound run by one tick.  Returns False once the run
        is over (engine done, or a tick/sim-time budget hit) — the caller
        then ``finish()``es to drain the pipeline and seal the stats."""
        rs = self._rs
        if rs is None:
            raise RuntimeError("no run in progress; start() one")
        engine = rs.engine
        if engine.done or self.stats.ticks >= rs.max_ticks \
                or rs.now > rs.max_sim_time:
            return False
        t0 = time.perf_counter()
        cfg = self.cfg
        rng = self.rng
        idle = np.flatnonzero(~rs.busy & (rs.online <= rs.now))
        if idle.size:
            if rs.pending:
                # speculated state: results are still in flight, but
                # they provably cannot flip the phase (spec_wanted > 0),
                # so current-phase issuance needs no ys — generate the
                # next block via the engine's revertible peek
                k_ask = self._throttled_ask(rs, int(idle.size),
                                            rs.spec_wanted)
                if k_ask:
                    block = engine.peek_block(k_ask)
                    if block is None:
                        # the no-flip invariant guarantees a block
                        # phase here; if it ever breaks, roll the peek
                        # back and fall off the speculative path
                        engine.cancel_block()
                        self.stats.spec_discarded += 1
                        self._flush_all(rs)
                    else:
                        self.stats.spec_blocks += 1
                        tickets, phase_id, pts, alphas = block
                        self._issue(rs, idle[:len(tickets)], tickets,
                                    phase_id, pts, alphas, -1)
                        engine.accept_block()
            if not rs.pending:
                k_ask = self._throttled_ask(rs, int(idle.size),
                                            engine.wanted())
                block = engine.generate_block(k_ask) if k_ask else None
                if block is not None:
                    tickets, phase_id, pts, alphas = block
                    self._issue(rs, idle[:len(tickets)], tickets, phase_id,
                                pts, alphas, -1)
                elif k_ask or engine.validating:
                    # bootstrap probes and quorum replicas are handed
                    # out as objects (tiny phases); reissue a replica if
                    # every pending one was lost in flight, or the run
                    # deadlocks
                    reqs = engine.generate(k_ask) if k_ask else []
                    if not reqs and engine.validating and not np.any(
                            rs.busy & (rs.req_phase == engine.phase_id)):
                        r = engine.reissue_validation()
                        reqs = [r] if r is not None else []
                    for h, r in zip(idle, reqs):
                        self._issue(rs, np.array([h]), r.ticket, r.phase_id,
                                    r.point, r.alpha,
                                    -1 if r.validates is None
                                    else r.validates)
        if not rs.busy.any():
            self._flush_all(rs)
            rs.now += cfg.idle_retry
            rs.wall_s += time.perf_counter() - t0
            return True

        # advance to the k-th earliest CURRENT-PHASE completion and drain
        # everything (stale included) that finished by then — ONE batched
        # evaluation for all of it.  k never exceeds what the phase still
        # needs: the phase commits on its first m results and later
        # arrivals go stale, so jumping past the m-th completion would
        # wait on stragglers the paper's any-m semantics exist to ignore.
        busy_idx = np.flatnonzero(rs.busy)
        cur = busy_idx[rs.req_phase[busy_idx] == engine.phase_id]
        # while validating, the phase needs the full outstanding quorum
        # (wanted() is 0 once replicas are handed out) — jump to the
        # last missing vote in ONE tick instead of draining one replica
        # per tick.  With ticks in flight the phase is mid-regression/
        # line-search and the remaining need is the exact prediction.
        if rs.pending:
            want = rs.spec_wanted
        else:
            want = (engine.validation_votes_outstanding
                    if engine.validating else engine.wanted())
        # the horizon counts LIVE completions: a host that will drop its
        # result can't contribute the k-th arrival the phase is waiting
        # for, and the simulator already knows the drop (it drew it at
        # issuance) — server-visible behavior is identical, the tick
        # just stops splitting a phase's drain on phantom arrivals
        cur_live = cur[~rs.lost[cur]]
        pool = (cur_live if cur_live.size
                else (cur if cur.size else busy_idx))
        kth = min(pool.size, self.tick_batch, want if want > 0 else 1)
        horizon = np.partition(rs.t_done[pool], kth - 1)[kth - 1]
        rs.now = float(horizon)
        ready = busy_idx[rs.t_done[busy_idx] <= horizon]
        ready = ready[np.lexsort((ready, rs.t_done[ready]))]  # completion order

        delivered = ready[~rs.lost[ready]]
        tick = None
        if delivered.size:
            # pay the backend only for results the engine can still use:
            # workunits from an already-finished phase are provably
            # discarded by the engine's phase_id check BEFORE it reads
            # y, so stale lanes are delivered as NaN without an
            # evaluation — the engine's decisions and stale counts are
            # identical, the wasted fitness work is not
            live_mask = rs.req_phase[delivered] == engine.phase_id
            live = delivered[live_mask]
            handle = None
            if live.size:
                # corruption ships WITH the bucket as mask lanes (NaN ==
                # honest) and is applied on-device; same sign-safe model
                # and rng draw order as the per-event simulator
                mal = self.malicious[live]
                mal_u = np.full(live.size, np.nan)
                if mal.any():
                    mal_u[mal] = rng.uniform(0.2, 0.8, int(mal.sum()))
                    self.stats.corrupted += int(mal.sum())
                handle = self.submitter.submit(rs.a_point[live], mal_u)
                self.stats.batch_calls += 1
            tick = _PendingTick(handle, rs.req_phase[delivered],
                                rs.a_ticket[delivered],
                                rs.a_point[delivered],
                                rs.a_alpha[delivered],
                                rs.a_validates[delivered],
                                live_mask, int(live.size))
        rs.busy[ready] = False
        rs.lost[ready] = False
        rs.t_done[ready] = np.inf
        rs.req_phase[ready] = -1
        rs.a_ticket[ready] = -1
        rs.a_validates[ready] = -1
        self.stats.ticks += 1

        if tick is not None:
            if rs.pending:
                base = rs.spec_wanted
                block_phase = True       # invariant: mid-REG/LS
            else:
                block_phase = engine.phase in (REGRESSION, LINESEARCH)
                base = engine.wanted() if block_phase else 0
            rs.pending.append(tick)
            # depth counts actual device buckets, not handle-less
            # stale-only ticks riding the queue
            self.stats.max_in_flight = max(
                self.stats.max_in_flight,
                sum(1 for t in rs.pending if t.handle is not None))
            if (self.pipelined and block_phase
                    and base - tick.live_n > 0):
                # in-phase results (a stale-only tick included: its
                # live_n of 0 cannot flip anything): defer the collect,
                # keep the device busy while the host runs ahead
                rs.spec_wanted = base - tick.live_n
                if len(rs.pending) >= self.pipeline_depth:
                    self._flush_one(rs)
            else:
                # this bucket reaches the phase's m (or the phase is
                # bootstrap/validating, whose votes decide transitions):
                # assimilation must decide, so drain the pipeline
                self._flush_all(rs)
        rs.wall_s += time.perf_counter() - t0
        return True

    def finish(self) -> BatchedGridStats:
        """Drain the pipeline, seal sim-time and the host/device wall split,
        and release the run state.  Safe to call on a run stopped early
        (a ``max_ticks`` budget, or a driver that stops stepping)."""
        rs = self._rs
        if rs is None:
            raise RuntimeError("no run in progress; start() one")
        t0 = time.perf_counter()
        self._flush_all(rs)
        self.stats.sim_time = rs.now
        rs.wall_s += time.perf_counter() - t0
        # accumulate like every other stats field: this run's in-call wall
        # minus this run's device-blocked share (not the all-runs
        # cumulative, and not other searches' ticks between our steps)
        self.stats.host_s += rs.wall_s - (self.stats.device_blocked_s
                                          - rs.blocked0)
        self._rs = None
        return self.stats

    def run(self, engine: AnmEngine, max_ticks: int = 1_000_000,
            max_sim_time: float = float("inf")) -> BatchedGridStats:
        self.start(engine, max_ticks, max_sim_time)
        while self.step():
            pass
        return self.finish()
