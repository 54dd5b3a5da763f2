"""Paper §VI on the port: ANM against conjugate gradient descent and the
numerical-Hessian Newton method on the stream-fitting problem.

Port of ``benchmarks/anm_vs_baselines.py``, at its settings: stripe
"cmp" with 15k stars (data seed 41), x0 from ``default_rng(287)``, the
target 75 % of the way from the start to the truth; ANM at m = 150 + 150
for 25 iterations, CGD for 150 iterations, Newton for 12.  Reports the
iterations and evaluations to the target, the finals, each method's wall
and the parallelism each exposes (CGD 2n concurrent evaluations,
numerical Newton 4n²−n, ANM any m).  The fitness is the port's SDSS
likelihood on ``--device``: ANM calls it on a phase's batch, CGD and
Newton on one point at a time.

    PYTHONPATH=src python -m repro_torch.launch.baselines --device cpu
    PYTHONPATH=src python -m repro_torch.launch.baselines --out base.json
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core.anm import AnmConfig, anm_minimize
from repro_torch.data import sdss
from repro_torch.optim.cgd import cgd_minimize
from repro_torch.optim.newton_ref import newton_minimize

#: the reference's data seed, and the int ``repro/core/anm.py:56`` derives
#: from ``jax.random.key(41)``: ANM's engine seed, so both packages draw
#: the same first sample
DATA_SEED = 41
ENGINE_SEED = 1967807208
#: the reference's start-point seed (41 * 7) and the share of the gap to
#: the truth that counts as reaching the target
START_SEED = 287
TARGET_SHARE = 0.75


def start_point(stripe: sdss.Stripe) -> np.ndarray:
    """The reference's x0: the truth perturbed by a seeded draw, clipped."""
    rng = np.random.default_rng(START_SEED)
    return np.clip(stripe.truth + rng.normal(0, 1.0, 8).astype(np.float32)
                   * (sdss.HI - sdss.LO) * 0.15, sdss.LO, sdss.HI)


def _timed(device: torch.device, fn):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def run(n_stars: int = 15_000, device="cuda") -> dict:
    device = torch.device(device)
    stripe = sdss.make_stripe("cmp", n_stars=n_stars, seed=DATA_SEED)
    f_batch, f_single = sdss.make_fitness(stripe, device)

    def fnp(p) -> float:
        return float(f_single(np.asarray(p, np.float32)))

    x0 = start_point(stripe)
    f0 = fnp(x0)
    f_truth = fnp(stripe.truth)
    target = f0 - TARGET_SHARE * (f0 - f_truth)
    n = sdss.N_PARAMS
    results = {"start": f0, "truth": f_truth, "target": target,
               "n_stars": n_stars, "device": str(device)}

    st, wall = _timed(device, lambda: anm_minimize(
        f_batch, x0, sdss.LO, sdss.HI, sdss.DEFAULT_STEP,
        AnmConfig(m_regression=150, m_line_search=150,
                  max_iterations=25),
        seed=ENGINE_SEED, device=device))
    anm_iter = next((r.iteration for r in st.history
                     if r.best_fitness <= target), None)
    results["anm"] = {
        "iterations_to_target": anm_iter, "final": st.best_fitness,
        "iterations": st.iteration, "evals_per_iter": 300,
        "evals_to_target": (anm_iter or st.iteration) * 300,
        "wall_s": wall, "max_parallelism": "unbounded (any m of M)"}

    cg, wall = _timed(device, lambda: cgd_minimize(
        fnp, x0, sdss.LO, sdss.HI, sdss.DEFAULT_STEP,
        max_iterations=150))
    cgd_iter = next((i for i, v in enumerate(cg.history) if v <= target),
                    None)
    results["cgd"] = {
        "iterations_to_target": cgd_iter, "final": cg.fitness,
        "iterations": cg.iterations, "evals_total": cg.evals,
        "wall_s": wall, "max_parallelism": f"2n = {2 * n}"}

    nw, wall = _timed(device, lambda: newton_minimize(
        fnp, x0, sdss.LO, sdss.HI, sdss.DEFAULT_STEP,
        max_iterations=12, device=device))
    nw_iter = next((i for i, v in enumerate(nw.history) if v <= target),
                   None)
    results["newton_numerical"] = {
        "iterations": nw.iterations, "iterations_to_target": nw_iter,
        "final": nw.fitness, "evals_total": nw.evals, "wall_s": wall,
        "max_parallelism": f"4n^2-n = {4 * n * n - n}"}
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-stars", type=int, default=15_000)
    ap.add_argument("--out", help="write the results to this JSON file "
                                  "instead of standard output")
    args = ap.parse_args()
    results = run(args.n_stars, args.device)
    text = json.dumps(results, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)


if __name__ == "__main__":
    main()
