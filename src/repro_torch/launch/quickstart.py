"""Quickstart on the port: the asynchronous Newton method on a 2-D bowl.

Port of ``examples/quickstart.py``: a Rosenbrock-like bowl fitted with the
paper's three ingredients (box-sampled regression, the damped Newton
direction, the randomized line search) through ``anm_minimize``, which
runs the same ``AnmEngine`` as the grid substrates synchronously, quorum
validation of every committed point included.  The example's gate:
a best fitness under 1e-3.

    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.anm import AnmConfig, anm_minimize
from repro_torch.launch.acts import ActLog, fit_elements, record_search

#: the int ``repro/core/anm.py:56`` derives from the example's
#: ``jax.random.key(0)`` (``int(jax.random.randint(key, (), 0, 2**31 - 1))``):
#: the engine's seed, so both packages draw the same first sample
QUICKSTART_SEED = 31327077
#: the example's problem and settings
X0 = np.array([-1.2, 1.0])
LO, HI = np.array([-3.0, -3.0]), np.array([3.0, 3.0])
STEP = np.array([0.25, 0.25])
CONFIG = AnmConfig(m_regression=64, m_line_search=64, max_iterations=25,
                   alpha_max=2.0)
#: the example's gate on the best fitness
GATE = 1e-3


def rosenbrock_batch(xs: torch.Tensor) -> torch.Tensor:
    """(m, 2) -> (m,): the example's bowl, minimum 0 at (1, 1)."""
    x, y = xs[:, 0], xs[:, 1]
    return (1 - x) ** 2 + 5.0 * (y - x * x) ** 2


def run(device="cuda"):
    """The example's search; returns its ``AnmState``."""
    return anm_minimize(rosenbrock_batch, X0, LO, HI, STEP, CONFIG,
                        seed=QUICKSTART_SEED, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="result JSON path")
    args = ap.parse_args(argv)
    log = ActLog("quickstart", args.device)
    with log.act("quickstart") as rec:
        state = run(args.device)
        record_search(rec, state)
        rec["center"] = state.center.tolist()
        rec["evaluations"] = (state.history[-1].evals_used
                              if state.history else 0)
        rec["fit_elements"] = fit_elements(CONFIG.m_regression, len(X0))
        rec["gates"]["best_fitness_below_1e-3"] = state.best_fitness < GATE
    print(f"optimum found at {np.round(state.center.cpu().numpy(), 4)} "
          f"(truth: [1, 1]), fitness {state.best_fitness:.2e}")
    for r in state.history[:6]:
        print(f"  iter {r.iteration}: best={r.best_fitness:.5f} "
              f"avg_line={r.avg_line_fitness:.5f}")
    return log.finish(args.out)


if __name__ == "__main__":
    raise SystemExit(main())
