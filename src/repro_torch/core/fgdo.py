"""FGDO: the asynchronous work-generator / validator / assimilator (paper §V).

Port of ``repro/core/fgdo.py``, over the port's ``AnmEngine``.

Since the engine refactor (DESIGN.md §1) this server holds NO phase logic:
``AnmEngine`` owns regression, line search, quorum validation and commits.
What remains here is the BOINC-shaped substrate adapter —

  * workunit ids and the outstanding-work table,
  * stale filtering (the engine discards by phase id; this layer merely
    carries it through the WorkUnit),
  * per-host reliability through the shared ``HostRegistry``
    (``server/registry.py``, DESIGN.md §9): turnaround AND
    return-rate tracking for reliable-host scheduling — validation
    replicas, which gate the next iteration, go only to hosts with
    below-median observed turnaround that actually return the work they
    take (a fast host that vanishes with its results records no
    turnaround at all, so turnaround alone would keep it "reliable"
    forever), with a minimum-sample cold-start grace so a brand-new host
    is not excluded before its first result could possibly arrive,
  * a reissue timeout for validation replicas lost to vanished hosts.

The registry is injectable: the service layer (``server/``) shares
ONE registry across every search it fronts and serializes it into its
crash checkpoints; standalone use builds a private one.

Semantics reproduced from the paper:
  * work is generated on demand — a fresh random point per request, no
    dependencies between outstanding workunits (§IV);
  * a phase advances when ANY m results have been assimilated; late results
    are simply discarded as stale (§III — failures never stall);
  * only results that will be USED to generate new work are validated
    (the best line-search point), by quorum re-evaluation (§V, ref [7]);
  * malicious/corrupt fitness values additionally face a MAD outlier guard
    before entering the regression (beyond-paper robustness, DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.engine import (AnmConfig, AnmEngine, EngineStats, EvalRequest,
                               EvalResult, IterationRecord, LINESEARCH,
                               Transition, VALIDATING)
from repro_torch.server.registry import HostRegistry

ServerStats = EngineStats             # back-compat alias


@dataclasses.dataclass
class WorkUnit:
    wu_id: int
    phase_id: int
    point: np.ndarray
    alpha: float = float("nan")
    validates: Optional[int] = None   # wu_id of the result this re-checks
    issued_at: float = 0.0


class FgdoAnmServer:
    """Asynchronous Newton method as a BOINC-style server over AnmEngine.
    ``device`` is where an engine built here runs its phase finish."""

    def __init__(self, x0=None, lo=None, hi=None, step=None,
                 cfg: AnmConfig = AnmConfig(),
                 seed: int = 0, validation_quorum: int = 2,
                 validation_rtol: float = 1e-6,
                 val_reissue_timeout: float = 600.0,
                 min_return_rate: float = 0.5, min_issued_for_rate: int = 4,
                 *, engine: Optional[AnmEngine] = None,
                 registry: Optional[HostRegistry] = None,
                 overcommit: Optional[float] = None, device="cuda"):
        if engine is None:
            engine = AnmEngine(x0, lo, hi, step, cfg, seed=seed,
                               validation_quorum=validation_quorum,
                               validation_rtol=validation_rtol,
                               device=device)
        self.engine = engine
        self.cfg = engine.cfg
        self.val_reissue_timeout = val_reissue_timeout
        # one registry per fleet: the service layer shares it across every
        # search it fronts, standalone adapters own a private one
        self.registry = registry if registry is not None else HostRegistry(
            min_return_rate=min_return_rate,
            min_issued_for_rate=min_issued_for_rate)
        # feeder throttle (BOINC's bounded shared-memory feeder, the same
        # policy as the batched grid's issuance cap): outstanding
        # current-phase work is held under ``wanted() × overcommit``.
        # ``None`` (the default) keeps the historical fire-hose behavior —
        # the per-event simulator tests pin trajectories against it — while
        # the service layer passes 2.0 so a phase that needs m results
        # costs ~2m evaluations instead of n_hosts.
        self.overcommit = overcommit
        self._last_val_issue = 0.0
        self.outstanding: Dict[int, WorkUnit] = {}

    # -- engine views (back-compat surface) ---------------------------------

    @property
    def center(self) -> np.ndarray:
        return self.engine.center

    @property
    def step(self) -> np.ndarray:
        return self.engine.step

    @property
    def best_fitness(self) -> float:
        return self.engine.best_fitness

    @property
    def iteration(self) -> int:
        return self.engine.iteration

    @property
    def done(self) -> bool:
        return self.engine.done

    @property
    def phase(self) -> str:
        # validation is the tail of the phase that produced the candidate:
        # the f(x0) probe's quorum round still reads as "bootstrap", any
        # other validation as the line-search tail (BOINC terms)
        p = self.engine.phase
        if p == VALIDATING:
            return "bootstrap" if self.engine.bootstrapping else LINESEARCH
        return p

    @property
    def validating(self) -> bool:
        return self.engine.validating

    @property
    def direction(self) -> Optional[np.ndarray]:
        return self.engine.direction

    @property
    def alpha_range(self) -> Tuple[float, float]:
        return self.engine.alpha_range

    @property
    def stats(self) -> EngineStats:
        return self.engine.stats

    @property
    def history(self) -> List[IterationRecord]:
        return self.engine.history

    # registry views kept for inspection/back-compat (tests read these)

    @property
    def _host_issued(self) -> Dict[int, int]:
        return {h: r.issued for h, r in self.registry.hosts.items()}

    @property
    def _host_returned(self) -> Dict[int, int]:
        return {h: r.returned for h, r in self.registry.hosts.items()}

    @property
    def _host_turnaround(self) -> Dict[int, float]:
        return {h: r.ewma_latency for h, r in self.registry.hosts.items()
                if r.ewma_latency is not None}

    # -- reliable-host scheduling -------------------------------------------

    def _host_returns(self, host_id: int) -> bool:
        """Return-rate gate (cold-start grace included) — see
        ``HostRegistry.returns_work``.  Never bypassed, not even by the
        reissue timeout: handing a latency-critical replica to a known
        black hole guarantees another loss."""
        return self.registry.returns_work(host_id)

    def _host_reliable(self, host_id: int) -> bool:
        return self.registry.reliable(host_id)

    # -- work generation ----------------------------------------------------

    def generate_work(self, host_id: int, now: float) -> Optional[WorkUnit]:
        eng = self.engine
        if eng.done:
            return None
        if eng.validating:
            timed_out = now - self._last_val_issue > self.val_reissue_timeout
            # liveness escape: if even the return-rate gate has starved the
            # quorum for 2x the reissue timeout, hand work to anyone — on a
            # fleet where EVERY host drops most work, refusing forever
            # would deadlock the validation instead of merely retrying
            starving = now - self._last_val_issue > 2 * self.val_reissue_timeout
            if eng.validation_pending <= 0 and not timed_out:
                return None          # quorum already issued; host retries later
            if not self._host_returns(host_id) and not starving:
                return None          # black holes never get validation work
            if not self._host_reliable(host_id) and not timed_out:
                return None          # latency-critical WU: reliable hosts only
            if eng.validation_pending > 0:
                req = eng.generate(1)[0]
            else:
                req = eng.reissue_validation()
            if req is None:
                return None
            self._last_val_issue = now
        else:
            if eng.phase == "bootstrap":
                # the f(x0) probe is identical for every host: keep ~2
                # copies in flight (straggler/loss slack, like the batched
                # grid's overcommit) instead of handing one to each of
                # n_hosts; probes older than the reissue timeout count as
                # lost so a dropped probe can't stall the start forever
                live = sum(1 for wu in self.outstanding.values()
                           if wu.phase_id == eng.phase_id and
                           now - wu.issued_at <= self.val_reissue_timeout)
                if live >= 2:
                    return None
            if self.overcommit is not None:
                # entries from finished phases only feed live counts, so
                # they are pruned rather than held forever (their results,
                # if they ever arrive, are assimilated from the caller's
                # own workunit record and discarded as phase-stale)
                for wid in [wid for wid, wu in self.outstanding.items()
                            if wu.phase_id != eng.phase_id]:
                    del self.outstanding[wid]
                live = sum(1 for wu in self.outstanding.values()
                           if now - wu.issued_at <= self.val_reissue_timeout)
                if live >= int(np.ceil(eng.wanted() * self.overcommit)):
                    return None
            reqs = eng.generate(1)
            if not reqs:
                return None
            req = reqs[0]
        wu = WorkUnit(req.ticket, req.phase_id, np.asarray(req.point),
                      req.alpha, req.validates, issued_at=now)
        self.outstanding[wu.wu_id] = wu
        self.registry.on_issue(host_id, now)
        return wu

    # -- assimilation -------------------------------------------------------

    def assimilate(self, wu: WorkUnit, y: float, host_id: int,
                   now: float) -> List[Transition]:
        self.outstanding.pop(wu.wu_id, None)
        # per-host return rate + turnaround feed reliable-host scheduling;
        # phase-staleness is knowable before the engine sees the result,
        # so the registry's per-host valid-rate costs nothing extra
        self.registry.on_result(host_id, now,
                                max(now - wu.issued_at, 1e-9),
                                stale=wu.phase_id != self.engine.phase_id)
        if self.engine.done:
            return []
        req = EvalRequest(wu.wu_id, wu.phase_id, wu.point, wu.alpha,
                          wu.validates)
        transitions = self.engine.assimilate([EvalResult(req, float(y))])
        # every new validation round (first candidate or post-rejection
        # promotion) restarts the reissue-timeout clock, so the reliable-host
        # gate isn't bypassed by a stale timestamp from the previous round
        if any(t.kind == "validating" for t in transitions):
            self._last_val_issue = now
        return transitions

    # -- state serialization (service layer, DESIGN.md §9) ------------------

    def state_dict(self) -> dict:
        """Adapter state for the crash checkpoint: the engine, the
        outstanding-work table and the reissue clock.  The shared registry
        is serialized ONCE by the owning work server, not per adapter."""
        return {
            "engine": self.engine.state_dict(),
            "last_val_issue": self._last_val_issue,
            "outstanding": [{
                "wu_id": wu.wu_id, "phase_id": wu.phase_id,
                "point": np.asarray(wu.point),
                "alpha": wu.alpha, "validates": wu.validates,
                "issued_at": wu.issued_at,
            } for wu in self.outstanding.values()],
        }

    def load_state(self, d: dict) -> None:
        self.engine.load_state(d["engine"])
        self._last_val_issue = float(d["last_val_issue"])
        self.outstanding = {}
        for w in d["outstanding"]:
            wu = WorkUnit(int(w["wu_id"]), int(w["phase_id"]),
                          np.asarray(w["point"], np.float64),
                          float(w["alpha"]),
                          None if w["validates"] is None
                          else int(w["validates"]),
                          issued_at=float(w["issued_at"]))
            self.outstanding[wu.wu_id] = wu
