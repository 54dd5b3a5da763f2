"""Numerical-Hessian Newton baseline (paper §II, eq. 1–3).

Port of ``repro/optim/newton_ref.py``.  The 4n²−n finite-difference
evaluations per iteration are the cost ANM's regression replaces; this
baseline validates the ANM direction against the classical one and
measures the evaluation-count gap.  The finite differences are numpy, as
in the reference; the damped direction is the port's
``regression.newton_direction`` in f32 on ``device``, and the m_line
random step scales come from numpy ``default_rng(seed)``, so both
packages draw the same scales.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List

import numpy as np
import torch

from repro_torch.core import regression as reg
from repro_torch.optim.cgd import finite_diff_gradient as numerical_gradient


@dataclasses.dataclass
class NewtonResult:
    x: np.ndarray
    fitness: float
    iterations: int
    evals: int
    history: List[float]


def numerical_hessian(f, x, s, count):
    """Paper eq. (2): H_ij = [f(+i+j) - f(+i-j) - f(-i+j) + f(-i-j)] / 4 s_i s_j."""
    n = len(x)
    H = np.zeros((n, n))
    fx = f(x)
    count[0] += 1
    for i in range(n):
        ei = np.zeros(n)
        ei[i] = s[i]
        fpi = f(x + ei)
        fmi = f(x - ei)
        count[0] += 2
        H[i, i] = (fpi - 2 * fx + fmi) / (s[i] ** 2)
        for j in range(i + 1, n):
            ej = np.zeros(n)
            ej[j] = s[j]
            H[i, j] = (f(x + ei + ej) - f(x + ei - ej)
                       - f(x - ei + ej) + f(x - ei - ej)) / (4 * s[i] * s[j])
            H[j, i] = H[i, j]
            count[0] += 4
    return H


def newton_minimize(f: Callable[[np.ndarray], float], x0, lo, hi, step,
                    max_iterations: int = 50, m_line: int = 64,
                    alpha_max: float = 2.0, damping: float = 1e-6,
                    seed: int = 0, tol: float = 1e-10,
                    device="cuda") -> NewtonResult:
    """``device``: where the (n, n) damped direction is solved."""
    rng = np.random.default_rng(seed)
    x = np.asarray(x0, np.float64).copy()
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    s = np.asarray(step, np.float64).copy()
    count = [0]
    fx = f(x)
    count[0] += 1
    history = [fx]
    for it in range(max_iterations):
        g = numerical_gradient(f, x, s, count)
        H = numerical_hessian(f, x, s, count)
        d = reg.newton_direction(
            torch.as_tensor(g, dtype=torch.float32, device=device),
            torch.as_tensor(H, dtype=torch.float32, device=device), damping)
        d = d.cpu().numpy().astype(np.float64)
        alphas = rng.uniform(0.0, alpha_max, m_line)
        best_f, best_x = fx, x
        for a in alphas:
            xn = np.clip(x + a * d, lo, hi)
            fn = f(xn)
            count[0] += 1
            if fn < best_f:
                best_f, best_x = fn, xn
        if best_f < fx - tol:
            x, fx = best_x, best_f
        else:
            s *= 0.5
        history.append(fx)
        if np.max(s) < 1e-12:
            break
    return NewtonResult(x=x, fitness=float(fx), iterations=it + 1,
                        evals=count[0], history=history)
