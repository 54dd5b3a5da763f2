"""Paper Fig. 3 on the port: the randomized line search escaping local
optima.

Port of ``benchmarks/fig3_linesearch.py``.  24 trials of one ANM
iteration (m = 48 regression + 256 line-search evaluations, α_max = 30)
from the origin of a multimodal 2-D landscape: the regression picks a
descent direction in the shallow basin near α = 0, and the line search
samples far beyond it.  A trial escapes when its best point reaches
f < −0.5, past the barrier at t ≈ 0.5, which a sequential
nearest-optimum line search (Brent, backtracking) cannot do.  Reports
the escape count and each trial's (best α, best fitness).

    PYTHONPATH=src python -m repro_torch.launch.fig3 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core.anm import AnmConfig, anm_minimize

#: trial i's engine seed: the int ``repro/core/anm.py:56`` derives from
#: ``jax.random.key(i)``, so both packages draw the same samples
ENGINE_SEEDS = (31327077, 1733648124, 2128942160, 111646283, 591994711,
                359975681, 828436750, 752193312, 2077877176, 586447873,
                151637111, 473836374, 1822728158, 1052476859, 698714937,
                1519957003, 1037020121, 2145406767, 2108256716, 488858325,
                1579582864, 1201750254, 529036465, 960939843)
TRIALS = len(ENGINE_SEEDS)
#: the fitness a trial's best point must reach to count as an escape
ESCAPE_BELOW = -0.5
CONFIG = AnmConfig(m_regression=48, m_line_search=256, max_iterations=1,
                   alpha_max=30.0)


def multimodal_f(xs: torch.Tensor) -> torch.Tensor:
    """Multimodal 2-D landscape, (m, 2) -> (m,): a shallow basin near the
    start, deeper basins farther along the gradient direction (a
    full-rank Hessian, so the Newton direction is well posed).
    Elementwise steps only, so a point's value does not depend on its
    batch."""
    t, y = xs[:, 0], xs[:, 1]
    return (0.4 * (t - 0.15) ** 2 + 0.3 * y ** 2
            - 0.8 * torch.exp(-40.0 * (t - 0.9) ** 2)
            - 1.6 * torch.exp(-50.0 * (t - 1.7) ** 2))


def run(device="cuda") -> dict:
    device = torch.device(device)
    samples, escapes = [], 0
    t0 = time.perf_counter()
    for trial, seed in enumerate(ENGINE_SEEDS):
        state = anm_minimize(multimodal_f, np.zeros(2), -np.ones(2) * 4,
                             np.ones(2) * 4, np.array([0.05, 0.05]), CONFIG,
                             seed=seed, device=device)
        rec = state.history[0]
        escapes += int(rec.best_fitness < ESCAPE_BELOW)
        samples.append({"trial": trial, "best_alpha": rec.best_alpha,
                        "best_fitness": rec.best_fitness})
    return {"trials": TRIALS, "escapes": escapes,
            "escape_rate": escapes / TRIALS, "samples": samples,
            "wall_s": time.perf_counter() - t0, "device": str(device)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="write the results to this JSON file "
                                  "instead of standard output")
    args = ap.parse_args()
    text = json.dumps(run(args.device), indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)


if __name__ == "__main__":
    main()
