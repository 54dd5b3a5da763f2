"""Discrete-event simulator of a volunteer computing grid (BOINC-like).

Copy of ``repro/core/grid.py`` (pure numpy), so the port needs nothing of
the reference package.  Hosts are heterogeneous (lognormal speeds),
unreliable (may never return a result) and possibly malicious (return
corrupted fitness).  The simulator drives any server exposing
generate_work/assimilate — the reference's FgdoAnmServer, whose port is
later work.

Deterministic given a seed; used by the fault-tolerance tests and the
scalability benchmark (time-to-solution vs. #hosts, paper §VI discussion).

This simulator evaluates ONE point per Python event, which makes it the
fidelity reference, not the fast path: at thousands of hosts the run is
Python-bound.  core/substrates/batched_grid.py advances the same host
population (via ``sample_hosts``) in vectorized ticks with one batched
fitness call per tick — use it for scale sweeps (DESIGN.md §3).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, List, Tuple

import numpy as np


@dataclasses.dataclass
class GridConfig:
    n_hosts: int = 256
    base_eval_time: float = 60.0        # seconds for a speed-1.0 host
    speed_sigma: float = 0.8            # lognormal spread (heterogeneity)
    failure_prob: float = 0.05          # result never returned
    malicious_prob: float = 0.01        # host returns corrupted fitness
    idle_retry: float = 5.0             # delay before re-request when no work
    seed: int = 0


@dataclasses.dataclass
class GridStats:
    completed: int = 0
    failed: int = 0
    corrupted: int = 0
    sim_time: float = 0.0


def sample_hosts(cfg: GridConfig) -> Tuple[np.ndarray, np.ndarray,
                                           np.random.Generator]:
    """Draw the host population (speeds, malicious mask) for a grid config.
    Shared by the per-event and the batched simulators so a given seed means
    the same fleet in both."""
    rng = np.random.default_rng(cfg.seed)
    speeds = rng.lognormal(0.0, cfg.speed_sigma, cfg.n_hosts)
    malicious = rng.random(cfg.n_hosts) < cfg.malicious_prob
    return speeds, malicious, rng


def malicious_lie(y, u):
    """Sign-safe corrupted fitness shared by both grid simulators AND the
    evaluation backends' on-device corruption lanes.

    Fitness is minimized, so a malicious host "wins" by under-reporting.
    The additive margin is scaled to ``|y| + 1`` so the lie beats the truth
    by at least ``0.2 * (|y| + 1)`` for ``u`` drawn in [0.2, 0.8] — unlike a
    multiplicative ``y * u``, which only fakes an improvement when ``y > 0``
    and silently becomes harmless (or self-defeating) for the negative or
    near-zero fitness values that dominate close to an optimum.

    Array-module agnostic on purpose: the dtype follows the inputs and the
    builtin ``abs`` dispatches to the operand, so the SAME helper runs on
    host floats and numpy arrays (the per-event simulator) and on torch
    tensors inside the backends' bucket finalization (DESIGN.md §7), where
    corruption is applied on-device as mask lanes shipped with the bucket.
    """
    return y - (abs(y) + 1.0) * u


class VolunteerGrid:
    def __init__(self, f: Callable[[np.ndarray], float], cfg: GridConfig):
        self.f = f
        self.cfg = cfg
        self.speeds, self.malicious, self.rng = sample_hosts(cfg)
        self.stats = GridStats()

    def run(self, server, max_events: int = 2_000_000,
            max_sim_time: float = float("inf")) -> GridStats:
        cfg = self.cfg
        rng = self.rng
        seq = itertools.count()
        events: List = []
        for h in range(cfg.n_hosts):
            heapq.heappush(events, (float(rng.uniform(0, cfg.base_eval_time / 10)),
                                    next(seq), h, "request", None))
        n_events = 0
        now = 0.0
        while events and not server.done and n_events < max_events:
            now, _, host, kind, payload = heapq.heappop(events)
            if now > max_sim_time:
                break
            n_events += 1
            if kind == "request":
                wu = server.generate_work(host, now)
                if wu is None:
                    if not server.done:
                        heapq.heappush(events, (now + cfg.idle_retry, next(seq),
                                                host, "request", None))
                    continue
                dt = cfg.base_eval_time / self.speeds[host] * \
                    float(rng.uniform(0.8, 1.2))
                if rng.random() < cfg.failure_prob:
                    # host vanishes with the result; it re-requests much later
                    self.stats.failed += 1
                    heapq.heappush(events, (now + 4 * dt, next(seq), host,
                                            "request", None))
                else:
                    heapq.heappush(events, (now + dt, next(seq), host,
                                            "complete", wu))
            else:  # complete
                wu = payload
                y = float(self.f(wu.point))
                if self.malicious[host]:
                    y = float(malicious_lie(y, rng.uniform(0.2, 0.8)))
                    self.stats.corrupted += 1
                server.assimilate(wu, y, host, now)
                self.stats.completed += 1
                heapq.heappush(events, (now, next(seq), host, "request", None))
        self.stats.sim_time = now
        return self.stats
