"""Synchronous ANM driver — the thinnest substrate over the shared engine.

Port of ``repro/core/anm.py``.  All phase logic (regression fit, alpha
clipping, candidate ranking, quorum validation, commit/shrink) lives in
core/engine.py; this module only turns each batch of engine requests into
ONE ``f_batch`` call and feeds every result straight back.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.engine import (AnmConfig, AnmEngine, EvalResult,  # noqa: F401
                                     IterationRecord)


@dataclasses.dataclass
class AnmState:
    """Snapshot of the engine exposed to callers of ``anm_minimize``."""
    center: torch.Tensor              # x' — regression center
    step: torch.Tensor                # s  — user step vector
    lo: torch.Tensor
    hi: torch.Tensor
    best_fitness: float = float("inf")
    iteration: int = 0
    direction: Optional[torch.Tensor] = None
    history: List[IterationRecord] = dataclasses.field(default_factory=list)
    #: host seconds of each regression phase finish (the engine's list)
    phase_finish_s: List[float] = dataclasses.field(default_factory=list)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _sync(state: AnmState, engine: AnmEngine) -> None:
    state.center = _f32(engine.center, engine.device)
    state.step = _f32(engine.step, engine.device)
    state.best_fitness = engine.best_fitness
    state.iteration = engine.iteration
    if engine.direction is not None:
        state.direction = _f32(engine.direction, engine.device)


def anm_minimize(f_batch: Callable[[torch.Tensor], torch.Tensor], x0, lo, hi,
                 step, cfg: AnmConfig = AnmConfig(), seed: int = 0,
                 device="cuda", callback=None) -> AnmState:
    """Synchronous reference driver (each phase evaluated as one batch).

    f_batch: (m, n) f32 tensor on ``device`` -> (m,) fitness (lower is
    better).  ``seed`` seeds the engine's numpy sampler; the reference
    takes a jax key and derives this int from it (``int(
    jax.random.randint(key, (), 0, 2**31 - 1))``), so passing that int
    draws the same points.  With a deterministic ``f_batch`` the quorum
    validation trivially confirms every candidate, so this driver follows
    the same commit path as the asynchronous substrates.
    """
    engine = AnmEngine(x0, lo, hi, step, cfg, seed=seed, device=device)
    engine.set_initial_fitness(float(f_batch(_f32(x0, device)[None, :])[0]))
    state = AnmState(center=_f32(x0, device), step=_f32(step, device),
                     lo=_f32(lo, device), hi=_f32(hi, device),
                     best_fitness=engine.best_fitness,
                     history=engine.history,
                     phase_finish_s=engine.phase_finish_s)
    while not engine.done:
        reqs = engine.generate()
        if not reqs:
            break                     # defensive: a stuck engine cannot loop
        pts = _f32(np.stack([r.point for r in reqs]), device)
        ys = f_batch(pts).cpu().numpy().astype(np.float64)
        transitions = engine.assimilate(
            [EvalResult(r, float(y)) for r, y in zip(reqs, ys)])
        for tr in transitions:
            if tr.kind == "commit":
                _sync(state, engine)
                if callback is not None:
                    callback(state)
    _sync(state, engine)
    return state
