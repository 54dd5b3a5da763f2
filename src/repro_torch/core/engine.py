"""The ANM engine: one substrate-agnostic Newton state machine (DESIGN.md §1).

Port of ``repro/core/engine.py``: the numpy phase machine is the
reference's, unchanged in behaviour; only the phase finish
(``_regression_direction``) is PyTorch, on the engine's ``device``.

The paper's central claim is that a single phase-structured state machine —
box-sampled regression → damped Newton direction → randomized line search →
quorum validation → commit/shrink — runs unchanged on any computing
substrate, from a synchronous MPI batch to an asynchronous, faulty BOINC
grid.  ``AnmEngine`` is that state machine, extracted so it exists exactly
once.  Substrates drive it through a two-call event API:

    reqs = engine.generate(k)        # up to k evaluation requests
    engine.assimilate(results)       # any completed subset, in any order

and never see phase logic.  Two substrates ship with the port:

  * core/anm.py                      — synchronous batch driver
                                       (one ``f_batch`` call per phase);
  * core/substrates/batched_grid.py  — vectorized grid simulator
                                       (thousands of hosts per tick, one
                                       ``f_batch`` bucket per tick).
(The reference's BOINC adapter, ``core/fgdo.py``, is not ported yet.)

Robustness semantics reproduced from the paper (see DESIGN.md §2):
  * the engine's first requests evaluate f(x0) (bootstrap phase), so the
    improvement threshold is seeded on EVERY substrate — the first commit
    can never accept a candidate worse than the start by comparing to inf;
  * a phase advances when ANY m results have been assimilated; results from
    an earlier phase are discarded as stale — stragglers never stall (§III);
  * only results that will be USED to generate new work (the best
    line-search point) are validated, by quorum re-evaluation (§V);
  * malicious/corrupt fitness values additionally face a MAD outlier guard
    before entering the regression.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import regression, sampling


def _regression_direction(deltas, ys, center, lo, hi, *, outlier_guard,
                          ridge, damping, a_min, a_max):
    """The phase finish: robust (MAD value + residual pass) quadratic fit
    -> damped Newton direction -> alpha-range clip, on the tensors' device.
    It runs eagerly (a few dozen small launches); capturing it as one CUDA
    graph is later work."""
    if outlier_guard:
        _, g, H = regression.fit_quadratic_robust(deltas, ys, ridge)
    else:
        _, g, H = regression.fit_quadratic(deltas, ys, None, ridge)
    d = regression.newton_direction(g, H, damping)
    a_lo, a_hi = sampling.clip_alpha_range(center, d, lo, hi, a_min, a_max)
    return d, a_lo, a_hi

BOOTSTRAP, REGRESSION, LINESEARCH, VALIDATING, DONE = \
    "bootstrap", "regression", "linesearch", "validating", "done"


@dataclasses.dataclass(frozen=True)
class AnmConfig:
    m_regression: int = 1000          # paper §VI: 1000 per regression phase
    m_line_search: int = 1000         # paper §VI: 1000 per line-search phase
    alpha_min: float = 0.0
    alpha_max: float = 2.0
    ridge: float = 1e-8
    damping: float = 1e-6
    max_iterations: int = 50
    tol: float = 1e-10                # stop when best fitness stops improving
    outlier_guard: bool = True        # MAD rejection of malicious results
    shrink_on_fail: float = 0.5       # shrink step vector if no improvement


@dataclasses.dataclass
class IterationRecord:
    iteration: int
    best_fitness: float
    avg_line_fitness: float
    center: np.ndarray
    evals_used: int
    best_alpha: float


class EvalRequest(NamedTuple):
    """One requested fitness evaluation.  ``ticket`` is unique per engine;
    ``validates`` carries the ticket of the candidate result this request
    re-checks (quorum replicas only).  A NamedTuple, not a dataclass: the
    batched substrates create one per evaluation, and C-speed construction
    matters at thousands of results per tick."""
    ticket: int
    phase_id: int
    point: np.ndarray
    alpha: float = float("nan")
    validates: Optional[int] = None


class EvalResult(NamedTuple):
    request: EvalRequest
    y: float


@dataclasses.dataclass(frozen=True)
class Transition:
    """Phase-machine event returned by ``assimilate`` so substrates can log
    or react without inspecting engine internals."""
    kind: str                 # bootstrap|direction|validating|rejected|commit|done
    iteration: int
    improved: bool = False


@dataclasses.dataclass
class EngineStats:
    issued: int = 0
    assimilated: int = 0
    stale: int = 0                    # results from an already-finished phase
    validations_issued: int = 0
    validations_stale: int = 0        # replicas for an already-decided candidate
    validations_failed: int = 0
    candidates_rejected: int = 0


def identical_trajectories(a: "AnmEngine", b: "AnmEngine") -> bool:
    """True iff two engines committed bit-identical iterate histories —
    same iteration count AND same centers AND same fitness values.  The
    canonical comparison for backend/substrate parity checks (zipping the
    histories alone would vacuously pass on a shorter, diverged run)."""
    return bool(
        a.iteration == b.iteration and
        len(a.history) == len(b.history) and
        all(np.array_equal(x.center, y.center)
            for x, y in zip(a.history, b.history)) and
        [r.best_fitness for r in a.history] ==
        [r.best_fitness for r in b.history])


class AnmEngine:
    """The unified ANM phase machine.  Owns all decision state; substrates
    own time, hosts, and evaluation."""

    def __init__(self, x0, lo, hi, step, cfg: AnmConfig = AnmConfig(),
                 seed: int = 0, validation_quorum: int = 2,
                 validation_rtol: float = 1e-6, device="cuda"):
        self.cfg = cfg
        #: where the phase finish (fit, direction, alpha clip) runs
        self.device = torch.device(device)
        #: host seconds of each regression phase finish (telemetry only:
        #: not decision state, so not part of ``state_dict``)
        self.phase_finish_s: List[float] = []
        self.center = np.asarray(x0, np.float64)
        self.lo = np.asarray(lo, np.float64)
        self.hi = np.asarray(hi, np.float64)
        self.step = np.asarray(step, np.float64)
        self.n = self.center.shape[0]
        self.rng = np.random.default_rng(seed)
        self.quorum = validation_quorum
        self.vrtol = validation_rtol

        # every run starts by evaluating f(x0): until that bootstrap result
        # lands, best_fitness is inf and the first commit would count ANY
        # validated candidate as an improvement — even one worse than the
        # start.  The engine owns the guard so every substrate gets it, not
        # just drivers that can afford a synchronous up-front evaluation.
        self.phase = BOOTSTRAP
        self.phase_id = 0
        self.iteration = 0
        self.best_fitness = float("inf")
        self.direction: Optional[np.ndarray] = None
        self.alpha_range: Tuple[float, float] = (cfg.alpha_min, cfg.alpha_max)
        # phase results are stored as array CHUNKS (one per assimilated
        # block), concatenated only at phase finish — the block fast path
        # (``assimilate_arrays``) appends thousands of results without
        # creating a Python object per evaluation
        self._res_pts: List[np.ndarray] = []
        self._res_ys: List[np.ndarray] = []
        self._res_alphas: List[np.ndarray] = []
        self._res_tickets: List[np.ndarray] = []
        self._res_count = 0
        self.stats = EngineStats()
        self.history: List[IterationRecord] = []
        self._next_ticket = 0
        # validation bookkeeping: ranked candidate arrays (+ cursor) and
        # votes for the current candidate
        self._candidates: Optional[Tuple[np.ndarray, ...]] = None
        self._cand_next = 0
        self._candidate: Optional[Tuple[float, np.ndarray, float, int]] = None
        self._votes: List[float] = []
        self._pending_validation = 0
        self._bootstrapping = False   # validating the f(x0) probe itself
        self._line_avg = float("nan")
        # block-speculation snapshot (peek_block/cancel_block): rng state +
        # ticket counter + issuance stats + validation ticket state, enough
        # to make a speculatively generated block fully revertible even
        # when the peek lands mid-validation
        self._spec_snapshot: Optional[Tuple] = None

    # -- introspection ------------------------------------------------------

    def _take_ticket(self) -> int:
        t = self._next_ticket
        self._next_ticket += 1
        return t

    @property
    def results(self) -> List[Tuple[np.ndarray, float, float, int]]:
        """Current-phase results as (point, y, alpha, ticket) tuples —
        materialized from the chunk storage; meant for tests/inspection,
        not hot paths."""
        return [(p, float(y), float(a), int(t))
                for pts, ys, als, tks in zip(self._res_pts, self._res_ys,
                                             self._res_alphas,
                                             self._res_tickets)
                for p, y, a, t in zip(pts, ys, als, tks)]

    @property
    def done(self) -> bool:
        return self.phase == DONE

    @property
    def validating(self) -> bool:
        return self.phase == VALIDATING

    @property
    def bootstrapping(self) -> bool:
        """True until the f(x0) probe has been issued AND quorum-confirmed
        (the bootstrap's own validation round included)."""
        return self.phase == BOOTSTRAP or self._bootstrapping

    @property
    def validation_pending(self) -> int:
        """Quorum replicas not yet handed out for the current candidate."""
        return self._pending_validation

    @property
    def validation_votes_outstanding(self) -> int:
        """Votes still missing for the current candidate (issued or not).
        Substrates batching completions can safely advance time until this
        many replicas have landed — the phase cannot commit on fewer."""
        if self.phase != VALIDATING or self._candidate is None:
            return 0
        return max(self.quorum + 1 - len(self._votes), 0)

    def set_initial_fitness(self, y: float) -> None:
        """Short-circuit the bootstrap phase with a known f(x0) when the
        substrate can afford an up-front evaluation (the synchronous driver
        does) — saves the one-request bootstrap round-trip."""
        self.best_fitness = float(y)
        if self.phase == BOOTSTRAP:
            self._advance(REGRESSION)

    def wanted(self) -> int:
        """Natural batch size for the current phase — what a substrate with
        unlimited capacity should request."""
        if self.phase == BOOTSTRAP:
            return 1
        if self.phase == REGRESSION:
            return max(self.cfg.m_regression - self._res_count, 0)
        if self.phase == LINESEARCH:
            return max(self.cfg.m_line_search - self._res_count, 0)
        if self.phase == VALIDATING:
            return self._pending_validation
        return 0

    # -- work generation ----------------------------------------------------

    def generate(self, k: Optional[int] = None) -> List[EvalRequest]:
        """Return up to ``k`` evaluation requests (``k=None``: the phase's
        natural batch).  While validating, only outstanding quorum replicas
        are handed out; an empty list means "nothing to do right now"."""
        if self.phase == DONE:
            return []
        if self.phase == VALIDATING:
            k = self._pending_validation if k is None else \
                min(k, self._pending_validation)
            reqs = []
            for _ in range(max(k, 0)):
                self._pending_validation -= 1
                reqs.append(self._validation_request())
            return reqs
        if self.phase == BOOTSTRAP:
            # redundant copies of the f(x0) probe are fine (first one in
            # wins, the rest go stale) — a single copy could be lost on a
            # faulty substrate and deadlock the run before it starts
            k = 1 if k is None else k
            if k <= 0:
                return []
            self.stats.issued += k
            return [EvalRequest(self._take_ticket(), self.phase_id,
                                self.center.copy()) for _ in range(k)]
        block = self.generate_block(k)
        if block is None:
            return []
        tickets, phase_id, pts, alphas = block
        return [EvalRequest(int(tickets[i]), phase_id, pts[i],
                            float(alphas[i])) for i in range(len(tickets))]

    def generate_block(self, k: Optional[int] = None):
        """Vectorized work generation for array-based substrates: returns
        ``(tickets (k,), phase_id, points (k, n), alphas (k,))`` with no
        per-request objects, or ``None`` when the phase has nothing to hand
        out this way (empty batch, done, or the tiny bootstrap/validation
        phases — use ``generate()`` there)."""
        if self.phase not in (REGRESSION, LINESEARCH):
            return None
        k = self.wanted() if k is None else k
        if k <= 0:
            return None
        if self.phase == REGRESSION:
            u = self.rng.uniform(-1.0, 1.0, (k, self.n))
            pts = np.clip(self.center[None, :] + u * self.step[None, :],
                          self.lo, self.hi)
            alphas = np.full(k, np.nan)
        else:  # LINESEARCH
            a_lo, a_hi = self.alpha_range
            alphas = self.rng.uniform(a_lo, a_hi, k)
            pts = self.center[None, :] + alphas[:, None] * self.direction[None, :]
        self.stats.issued += k
        tickets = np.arange(self._next_ticket, self._next_ticket + k)
        self._next_ticket += k
        return tickets, self.phase_id, pts, alphas

    # -- block speculation (pipelined substrates, DESIGN.md §7) -------------

    def peek_block(self, k: Optional[int] = None):
        """Speculatively generate a block for the CURRENT phase: exactly the
        draws ``generate_block(k)`` would make, but revertible.  A pipelined
        substrate calls this while earlier results are still in flight on
        the device, betting that assimilating them will not flip the phase
        (within a phase, generated points depend only on phase state and the
        engine rng — never on pending ``ys``).  If the bet loses, the block
        is stale under the new phase_id: ``cancel_block()`` rewinds the rng
        stream, ticket counter and issuance stat as if the peek never
        happened, so a discarded speculation is invisible to the committed
        trajectory.  ``accept_block()`` (or the next peek) drops the
        snapshot once the block has really been handed out.

        The snapshot also covers the validation ticket state
        (``stats.validations_issued`` and the pending-replica budget): a
        peek taken while a validation is pending generates nothing (blocks
        only exist in regression/line-search), but the cancel must still
        leave the quorum bookkeeping exactly as it found it — a substrate
        that interleaves peeks with validation phases (the multi-search
        orchestrator steps many engines in one loop) relies on that."""
        self._spec_snapshot = (self.rng.bit_generator.state,
                               self._next_ticket, self.stats.issued,
                               self.stats.validations_issued,
                               self._pending_validation)
        return self.generate_block(k)

    def accept_block(self) -> None:
        """Commit the last peeked block: the snapshot is dropped, making
        the speculation indistinguishable from a plain ``generate_block``."""
        self._spec_snapshot = None

    def cancel_block(self) -> None:
        """Discard the last peeked block, rewinding every side effect of
        the peek (rng stream, tickets, ``stats.issued``, and the
        validation ticket state the snapshot carries)."""
        if self._spec_snapshot is None:
            return
        state, ticket, issued, val_issued, val_pending = self._spec_snapshot
        self.rng.bit_generator.state = state
        self._next_ticket = ticket
        self.stats.issued = issued
        self.stats.validations_issued = val_issued
        self._pending_validation = val_pending
        self._spec_snapshot = None

    # -- state serialization (service layer, DESIGN.md §9) ------------------

    def state_dict(self) -> dict:
        """The COMPLETE restartable engine state as plain python + numpy:
        an engine built from the same constructor arguments and fed this
        dict through ``load_state`` continues the search bit-identically —
        same rng stream, ticket numbering, phase bookkeeping, candidate
        ranking and stats.  The layout is the reference engine's, key for
        key, so a state taken from either package loads into the other
        (``repro_torch.convert.engine_from_state``); keep every mutable
        field here or a restore silently diverges.  Numpy arrays stay
        arrays — a checkpoint layer owns any JSON encoding."""
        cand = None
        if self._candidates is not None:
            cand = [np.asarray(a).copy() for a in self._candidates]
        spec = None
        if self._spec_snapshot is not None:
            st, ticket, issued, val_issued, val_pending = self._spec_snapshot
            spec = {"rng_state": st, "ticket": ticket, "issued": issued,
                    "validations_issued": val_issued,
                    "pending_validation": val_pending}
        return {
            "cfg": dataclasses.asdict(self.cfg),
            "n": self.n, "quorum": self.quorum, "vrtol": self.vrtol,
            "center": self.center.copy(), "lo": self.lo.copy(),
            "hi": self.hi.copy(), "step": self.step.copy(),
            "rng_state": self.rng.bit_generator.state,
            "phase": self.phase, "phase_id": self.phase_id,
            "iteration": self.iteration, "best_fitness": self.best_fitness,
            "direction": None if self.direction is None
            else self.direction.copy(),
            "alpha_range": list(self.alpha_range),
            "res_pts": [np.asarray(a).copy() for a in self._res_pts],
            "res_ys": [np.asarray(a).copy() for a in self._res_ys],
            "res_alphas": [np.asarray(a).copy() for a in self._res_alphas],
            "res_tickets": [np.asarray(a).copy() for a in self._res_tickets],
            "res_count": self._res_count,
            "stats": dataclasses.asdict(self.stats),
            "history": [{
                "iteration": r.iteration, "best_fitness": r.best_fitness,
                "avg_line_fitness": r.avg_line_fitness,
                "center": np.asarray(r.center).copy(),
                "evals_used": r.evals_used, "best_alpha": r.best_alpha,
            } for r in self.history],
            "next_ticket": self._next_ticket,
            "candidates": cand, "cand_next": self._cand_next,
            "candidate": None if self._candidate is None else {
                "y": self._candidate[0],
                "point": np.asarray(self._candidate[1]).copy(),
                "alpha": self._candidate[2], "ticket": self._candidate[3]},
            "votes": list(self._votes),
            "pending_validation": self._pending_validation,
            "bootstrapping": self._bootstrapping,
            "line_avg": self._line_avg,
            "spec_snapshot": spec,
        }

    def load_state(self, d: dict) -> None:
        """Restore the state captured by ``state_dict`` into this engine
        (which must have been built with a matching config/dimension —
        checked, since a silent mismatch would produce a plausible but
        wrong continuation)."""
        if int(d["n"]) != self.n:
            raise ValueError(f"state is {d['n']}-dimensional, engine is "
                             f"{self.n}-dimensional")
        if dict(d["cfg"]) != dataclasses.asdict(self.cfg):
            raise ValueError("state was captured under a different AnmConfig")
        self.quorum = int(d["quorum"])
        self.vrtol = float(d["vrtol"])
        self.center = np.asarray(d["center"], np.float64)
        self.lo = np.asarray(d["lo"], np.float64)
        self.hi = np.asarray(d["hi"], np.float64)
        self.step = np.asarray(d["step"], np.float64)
        self.rng.bit_generator.state = d["rng_state"]
        self.phase = d["phase"]
        self.phase_id = int(d["phase_id"])
        self.iteration = int(d["iteration"])
        self.best_fitness = float(d["best_fitness"])
        self.direction = (None if d["direction"] is None
                          else np.asarray(d["direction"], np.float64))
        self.alpha_range = (float(d["alpha_range"][0]),
                            float(d["alpha_range"][1]))
        self._res_pts = [np.asarray(a, np.float64) for a in d["res_pts"]]
        self._res_ys = [np.asarray(a, np.float64) for a in d["res_ys"]]
        self._res_alphas = [np.asarray(a, np.float64)
                            for a in d["res_alphas"]]
        self._res_tickets = [np.asarray(a, np.int64)
                             for a in d["res_tickets"]]
        self._res_count = int(d["res_count"])
        self.stats = EngineStats(**{k: int(v) for k, v in d["stats"].items()})
        self.history = [IterationRecord(
            iteration=int(r["iteration"]),
            best_fitness=float(r["best_fitness"]),
            avg_line_fitness=float(r["avg_line_fitness"]),
            center=np.asarray(r["center"], np.float64),
            evals_used=int(r["evals_used"]),
            best_alpha=float(r["best_alpha"])) for r in d["history"]]
        self._next_ticket = int(d["next_ticket"])
        c = d["candidates"]
        self._candidates = None if c is None else (
            np.asarray(c[0], np.float64), np.asarray(c[1], np.float64),
            np.asarray(c[2], np.float64), np.asarray(c[3], np.int64))
        self._cand_next = int(d["cand_next"])
        cd = d["candidate"]
        self._candidate = None if cd is None else (
            float(cd["y"]), np.asarray(cd["point"], np.float64),
            float(cd["alpha"]), int(cd["ticket"]))
        self._votes = [float(v) for v in d["votes"]]
        self._pending_validation = int(d["pending_validation"])
        self._bootstrapping = bool(d["bootstrapping"])
        self._line_avg = float(d["line_avg"])
        sp = d["spec_snapshot"]
        self._spec_snapshot = None if sp is None else (
            sp["rng_state"], int(sp["ticket"]), int(sp["issued"]),
            int(sp["validations_issued"]), int(sp["pending_validation"]))

    def reissue_validation(self) -> Optional[EvalRequest]:
        """Extra quorum replica beyond the pending budget — for substrates
        whose replicas can be lost (host failure / reissue timeout)."""
        if self.phase != VALIDATING or self._candidate is None:
            return None
        return self._validation_request()

    def _validation_request(self) -> EvalRequest:
        y, pt, alpha, ticket = self._candidate
        self.stats.validations_issued += 1
        self.stats.issued += 1
        return EvalRequest(self._take_ticket(), self.phase_id, pt.copy(),
                           alpha, validates=ticket)

    # -- assimilation -------------------------------------------------------

    def assimilate(self, results: Iterable[EvalResult]) -> List[Transition]:
        """Fold any completed evaluations into the phase machine.  Returns
        the phase transitions they caused (possibly none, possibly several —
        e.g. a rejected candidate followed by a commit)."""
        transitions: List[Transition] = []
        for res in results:
            if self.phase == DONE:
                break
            req = res.request
            self._assimilate_one(req.phase_id, req.ticket, req.point,
                                 req.alpha, req.validates, res.y, transitions)
        return transitions

    def _assimilate_one(self, phase_id: int, ticket: int, point, alpha,
                        validates: Optional[int], y: float,
                        transitions: List[Transition]) -> None:
        """One result through the phase machine — the single source of
        truth shared by the object API and the array fast path."""
        if phase_id != self.phase_id:
            self.stats.stale += 1
            return
        self.stats.assimilated += 1
        if validates is not None:
            if self._candidate is not None and validates == self._candidate[3]:
                self._votes.append(float(y))
                transitions.extend(self._check_validation())
            else:
                # replica for an already-decided candidate: same phase,
                # so not phase-stale — count it separately or the
                # benchmarks' staleness numbers conflate the two
                self.stats.validations_stale += 1
            return
        if self.phase == BOOTSTRAP:
            if not np.isfinite(y):
                # a non-finite start is unusable as a threshold either way;
                # don't spend quorum on it
                self._advance(REGRESSION)
                transitions.append(Transition("bootstrap", self.iteration))
                return
            # the f(x0) claim gates EVERY commit, so it gets the same
            # quorum treatment as a line-search winner (§2): one malicious
            # probe must not be able to poison the improvement threshold
            self._advance(VALIDATING)
            self._bootstrapping = True
            self._candidate = (float(y), self.center.copy(), float("nan"),
                               ticket)
            self._votes = [float(y)]
            self._pending_validation = self.quorum
            transitions.append(Transition("validating", self.iteration))
            return
        self._append_results(np.asarray(point)[None, :],
                             np.array([y], np.float64),
                             np.array([alpha], np.float64),
                             np.array([ticket]), transitions)

    def _append_results(self, pts, ys, alphas, tickets,
                        transitions: List[Transition]) -> None:
        """Buffer current-phase results (a whole chunk at once) and finish
        the phase when it reaches its m."""
        self._res_pts.append(pts)
        self._res_ys.append(ys)
        self._res_alphas.append(alphas)
        self._res_tickets.append(tickets)
        self._res_count += len(ys)
        m_needed = (self.cfg.m_regression if self.phase == REGRESSION
                    else self.cfg.m_line_search)
        if self._res_count >= m_needed:
            if self.phase == REGRESSION:
                transitions.extend(self._finish_regression())
            else:
                transitions.extend(self._finish_line_search())

    def assimilate_arrays(self, phase_ids: np.ndarray, tickets: np.ndarray,
                          points: np.ndarray, alphas: np.ndarray,
                          validates: np.ndarray,
                          ys: np.ndarray) -> List[Transition]:
        """Array fast path of ``assimilate``: semantically identical to
        feeding ``EvalResult``s one by one (same completion order, same
        transitions), but bulk-appends runs of plain current-phase results
        instead of touching Python objects per evaluation.  ``validates``
        uses -1 for "not a replica"."""
        transitions: List[Transition] = []
        k = len(ys)
        i = 0
        while i < k and self.phase != DONE:
            if self.phase in (REGRESSION, LINESEARCH):
                # During regression/line search, current-phase results are
                # the only ones that change state: quorum replicas only
                # carry a VALIDATING phase id, and stale results are merely
                # counted wherever they sit.  So the remaining block
                # collapses to ONE step — append the first `need`
                # current-phase results, count everything else stale.
                # That equals element-wise processing exactly, including
                # the phase flip at the m-th result: later entries all
                # carry an older phase id (they were issued before this
                # drain), so the flip stales them regardless of position.
                cur = phase_ids[i:] == self.phase_id
                idx = np.flatnonzero(cur) + i
                if idx.size and (validates[idx] >= 0).any():
                    # can't happen with our substrates; keep the slow path
                    # as the semantic reference just in case
                    v = int(validates[i])
                    self._assimilate_one(int(phase_ids[i]), int(tickets[i]),
                                         points[i], float(alphas[i]),
                                         None if v < 0 else v, float(ys[i]),
                                         transitions)
                    i += 1
                    continue
                m_needed = (self.cfg.m_regression if self.phase == REGRESSION
                            else self.cfg.m_line_search)
                take = min(idx.size, m_needed - self._res_count)
                self.stats.assimilated += take
                if take > 0:
                    sel = idx[:take]
                    self._append_results(points[sel],
                                         ys[sel].astype(np.float64),
                                         alphas[sel].astype(np.float64),
                                         tickets[sel], transitions)
                if self.phase != DONE:
                    # the tail is stale under whatever phase the take
                    # flipped to — but if the take finished the RUN, the
                    # object path drops the tail uncounted (its loop
                    # breaks at DONE), so mirror that exactly
                    self.stats.stale += (k - i) - take
                i = k
                continue
            # bootstrap/validating: bulk-skip stale stretches, then handle
            # the (rare, tiny) current-phase events one by one
            cur_rest = np.flatnonzero(phase_ids[i:] == self.phase_id)
            nxt = i + int(cur_rest[0]) if cur_rest.size else k
            if nxt > i:
                self.stats.stale += nxt - i
                i = nxt
                continue
            v = int(validates[i])
            self._assimilate_one(int(phase_ids[i]), int(tickets[i]),
                                 points[i], float(alphas[i]),
                                 None if v < 0 else v, float(ys[i]),
                                 transitions)
            i += 1
        # everything after DONE is dropped exactly like the object path
        return transitions

    # -- phase transitions --------------------------------------------------

    def _finish_regression(self) -> List[Transition]:
        t0 = time.perf_counter()
        pts = np.concatenate(self._res_pts)
        ys = np.concatenate(self._res_ys)

        # deltas in f64 numpy, then cast to f32 — as the reference feeds it
        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float64).astype(np.float32),
                                   device=self.device)

        d, a_lo, a_hi = _regression_direction(
            f32(pts - self.center[None, :]), f32(ys), f32(self.center),
            f32(self.lo), f32(self.hi),
            outlier_guard=self.cfg.outlier_guard, ridge=self.cfg.ridge,
            damping=self.cfg.damping, a_min=self.cfg.alpha_min,
            a_max=self.cfg.alpha_max)
        # one device-to-host copy for the direction and both alpha bounds
        out = torch.cat([d, a_lo[None], a_hi[None]]).cpu().numpy()
        d, a_lo, a_hi = out[:-2].astype(np.float64), out[-2], out[-1]
        self.phase_finish_s.append(time.perf_counter() - t0)
        if not np.all(np.isfinite(d)):
            # degenerate fit (f32 eigh/solve can overflow when corrupted
            # samples blow the surrogate up): a zero direction makes the
            # line search re-sample the center, the iteration commits as
            # "no improvement" and the step shrinks — the standard
            # recovery — instead of 0*inf=NaN poisoning every line point
            d = np.zeros_like(d)
            self.alpha_range = (0.0, 0.0)
        else:
            self.alpha_range = (float(a_lo), float(a_hi))
        self.direction = d
        self._advance(LINESEARCH)
        return [Transition("direction", self.iteration)]

    def _finish_line_search(self) -> List[Transition]:
        pts = np.concatenate(self._res_pts)
        ys = np.concatenate(self._res_ys)
        alphas = np.concatenate(self._res_alphas)
        tickets = np.concatenate(self._res_tickets)
        fin = np.isfinite(ys)
        self._line_avg = (float(np.mean(ys[fin])) if fin.any()
                          else float("nan"))
        self._advance(VALIDATING)
        # stable sort by fitness == the element-wise ranking (ties keep
        # completion order); candidates stay as arrays + a cursor
        order = np.argsort(ys[fin], kind="stable")
        self._candidates = (ys[fin][order], pts[fin][order],
                            alphas[fin][order], tickets[fin][order])
        self._cand_next = 0
        return self._start_validation()

    def _start_validation(self) -> List[Transition]:
        if self._candidates is None or \
                self._cand_next >= len(self._candidates[0]):
            # nothing usable: shrink step, next iteration from the same center
            return self._commit(self.center, self.best_fitness, float("nan"),
                                improved=False)
        cy, cp, ca, ct = self._candidates
        i = self._cand_next
        self._cand_next += 1
        self._candidate = (float(cy[i]), cp[i], float(ca[i]), int(ct[i]))
        self._votes = [self._candidate[0]]
        self._pending_validation = self.quorum
        return [Transition("validating", self.iteration)]

    def _check_validation(self) -> List[Transition]:
        need = self.quorum + 1
        if len(self._votes) < need:
            return []
        votes = np.array(self._votes)
        med = np.median(votes)
        agree = np.sum(np.abs(votes - med) <= self.vrtol * max(1.0, abs(med)))
        cand_y, cand_pt, cand_a, _ = self._candidate
        self._candidate = None
        if agree >= (need // 2 + 1) and \
                abs(cand_y - med) <= self.vrtol * max(1.0, abs(med)):
            if self._bootstrapping:
                # confirmed f(x0): seed the threshold, no iteration consumed
                self._bootstrapping = False
                if np.isfinite(med):
                    self.best_fitness = float(med)
                self._advance(REGRESSION)
                return [Transition("bootstrap", self.iteration)]
            improved = med < self.best_fitness - self.cfg.tol
            return self._commit(cand_pt, float(med), cand_a, improved)
        self.stats.validations_failed += 1
        self.stats.candidates_rejected += 1
        if self._bootstrapping:
            # the probe lied (or a replica did): re-run the bootstrap from
            # scratch rather than trusting any of the disputed claims
            self._bootstrapping = False
            self._advance(BOOTSTRAP)
            return [Transition("rejected", self.iteration)]
        return [Transition("rejected", self.iteration)] + self._start_validation()

    def _commit(self, x_next, f_best, alpha, improved: bool) -> List[Transition]:
        if improved:
            self.center = np.asarray(x_next, np.float64)
            self.best_fitness = f_best
        else:
            self.step = self.step * self.cfg.shrink_on_fail
        self.iteration += 1
        self.history.append(IterationRecord(
            iteration=self.iteration, best_fitness=self.best_fitness,
            avg_line_fitness=self._line_avg, center=self.center.copy(),
            evals_used=self.stats.assimilated, best_alpha=alpha))
        transitions = [Transition("commit", self.iteration, improved)]
        if self.iteration >= self.cfg.max_iterations or \
                (not improved and float(np.max(self.step)) < 1e-12):
            self._advance(DONE)
            transitions.append(Transition("done", self.iteration))
        else:
            self._advance(REGRESSION)
        return transitions

    def _advance(self, phase: str) -> None:
        self.phase = phase
        self.phase_id += 1
        self._res_pts = []
        self._res_ys = []
        self._res_alphas = []
        self._res_tickets = []
        self._res_count = 0
        self._candidates = None
        self._cand_next = 0
        self._candidate = None
        self._votes = []
        self._pending_validation = 0
