"""Paper Fig. 2 on the port: ANM best/average fitness per iteration on two
SDSS stripes.

Port of ``benchmarks/fig2_convergence.py``.  The figure's claim: stripe
79 converges in ~5 iterations, stripe 86 within ~20, at 1000 regression +
1000 line-search evaluations per iteration over 100k stars
(``--paper-scale``; the default is the reference's scaled-down CPU
setting, 200 + 200 over 20k stars).  At paper scale the regression's
design matrix (m·cols = 45,000) is routed through the gram kernel.

    PYTHONPATH=src python -m repro_torch.launch.fig2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.fig2 --paper-scale
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core.anm import AnmConfig, anm_minimize
from repro_torch.data import sdss

#: (stripe, data seed, start-point seed, engine seed).  The engine seed is
#: the int the reference derives from ``jax.random.key(data seed)``
#: (``repro/core/anm.py:56``), so both packages draw the same first sample.
STRIPES = (("stripe79", 79, 5, 1596649523),
           ("stripe86", 86, 9, 1791432280))


def start_point(stripe: sdss.Stripe, start_seed: int) -> np.ndarray:
    """The reference's x0: the truth perturbed by a seeded draw, clipped."""
    rng = np.random.default_rng(start_seed)
    return np.clip(stripe.truth + rng.normal(0, 0.25, 8).astype(np.float32)
                   * (sdss.HI - sdss.LO) * 0.25, sdss.LO, sdss.HI)


def run_stripe(name: str, seed: int, start_seed: int, engine_seed: int, *,
               n_stars: int, m: int, iters: int, device="cuda") -> dict:
    """One stripe's Fig. 2 run; returns its convergence record, wall time
    and (on CUDA) peak device memory."""
    device = torch.device(device)
    stripe = sdss.make_stripe(name, n_stars=n_stars, seed=seed)
    f_batch, f_single = sdss.make_fitness(stripe, device)
    x0 = start_point(stripe, start_seed)
    f0 = float(f_single(x0))
    f_truth = float(f_single(stripe.truth))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = anm_minimize(
        f_batch, x0, sdss.LO, sdss.HI, sdss.DEFAULT_STEP,
        AnmConfig(m_regression=m, m_line_search=m, max_iterations=iters),
        seed=engine_seed, device=device)
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    target = f0 - 0.9 * (f0 - f_truth)
    conv_iter = next((r.iteration for r in state.history
                      if r.best_fitness <= target), None)
    fin = state.phase_finish_s
    return {
        "start_fitness": f0, "truth_fitness": f_truth,
        "final_fitness": state.best_fitness,
        "iterations_to_90pct": conv_iter,
        "iterations": state.iteration,
        "evals_per_iteration": 2 * m,
        "total_evals": state.history[-1].evals_used if state.history else 0,
        "wall_s": wall,
        "phase_finish_ms_mean": 1e3 * float(np.mean(fin)) if fin else None,
        "peak_device_bytes": peak,
        "history": [{"iteration": r.iteration, "best": r.best_fitness,
                     "avg_line": r.avg_line_fitness, "evals": r.evals_used}
                    for r in state.history],
    }


def run(paper_scale: bool = False, device="cuda", iters: int = 20) -> dict:
    n_stars = 100_000 if paper_scale else 20_000
    m = 1000 if paper_scale else 200
    return {name: run_stripe(name, seed, start_seed, engine_seed,
                             n_stars=n_stars, m=m, iters=iters, device=device)
            for name, seed, start_seed, engine_seed in STRIPES}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paper-scale", action="store_true",
                    help="m = 1000 per phase over 100k stars")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", help="write the full records to this JSON file")
    args = ap.parse_args()
    results = run(args.paper_scale, args.device, args.iters)
    for name, r in results.items():
        print(f"fig2_{name}: iters_to_90pct={r['iterations_to_90pct']} "
              f"final={r['final_fitness']:.5f} "
              f"truth={r['truth_fitness']:.5f} "
              f"start={r['start_fitness']:.5f} evals={r['total_evals']} "
              f"wall={r['wall_s']:.3f}s on {args.device}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)


if __name__ == "__main__":
    main()
