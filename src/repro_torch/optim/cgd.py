"""Conjugate gradient descent baseline (paper §II).

Port of ``repro/optim/cgd.py``, numpy only, kept as the port's own copy.
Polak–Ribière nonlinear CG with the paper's central-difference gradient
(eq. 1, 2n evaluations per iteration) and a sequential backtracking line
search.  Function evaluations are counted (the paper's comparison
metric) exactly as the reference counts them, and the line search is
*inherently sequential*: its scalability ceiling, which ANM's randomized
line search removes.  Given one and the same callable, both packages
take the same steps bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List

import numpy as np


@dataclasses.dataclass
class CgdResult:
    x: np.ndarray
    fitness: float
    iterations: int
    evals: int
    history: List[float]


def finite_diff_gradient(f, x, step, count):
    """Central differences, (f(x + sᵢeᵢ) − f(x − sᵢeᵢ)) / 2sᵢ; adds 2n to
    ``count[0]``."""
    n = len(x)
    g = np.zeros(n)
    for i in range(n):
        e = np.zeros(n)
        e[i] = step[i]
        g[i] = (f(x + e) - f(x - e)) / (2 * step[i])
        count[0] += 2
    return g


def cgd_minimize(f: Callable[[np.ndarray], float], x0, lo, hi, step,
                 max_iterations: int = 500, tol: float = 1e-10,
                 ls_shrink: float = 0.5, ls_max: int = 40) -> CgdResult:
    x = np.asarray(x0, np.float64).copy()
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    step = np.asarray(step, np.float64)
    count = [0]
    fx = f(x)
    count[0] += 1
    history = [fx]
    g = finite_diff_gradient(f, x, step, count)
    d = -g
    for it in range(max_iterations):
        # backtracking line search along d (sequential: one eval at a time)
        alpha = 1.0
        improved = False
        gd = float(np.dot(g, d))
        if gd > 0:          # not a descent direction: restart with -g
            d = -g
            gd = -float(np.dot(g, g))
        for _ in range(ls_max):
            xn = np.clip(x + alpha * d, lo, hi)
            fn = f(xn)
            count[0] += 1
            if fn < fx + 1e-4 * alpha * gd:
                improved = True
                break
            alpha *= ls_shrink
        if not improved:
            history.append(fx)
            break
        x, f_prev = xn, fx
        fx = fn
        history.append(fx)
        if abs(f_prev - fx) < tol:
            break
        g_new = finite_diff_gradient(f, x, step, count)
        beta = max(0.0, float(np.dot(g_new, g_new - g)
                              / max(np.dot(g, g), 1e-30)))
        d = -g_new + beta * d
        g = g_new
    return CgdResult(x=x, fitness=float(fx), iterations=it + 1,
                     evals=count[0], history=history)
