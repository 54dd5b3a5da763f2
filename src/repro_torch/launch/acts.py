"""The result document of an example launcher (``--out``).

Each of the example launchers (``quickstart``, ``volunteer_grid``,
``multi_search``, ``fgdo_service``, ``observability``, ``serve_lm``,
``train_lm``) runs its example's acts and writes one JSON document, as
``server/sim.py``'s ``--out`` writes a run's: where the work ran, and per
act its gates, iterations, best fitness, wall seconds, the kernel launches
of ``kernels/ops.py`` over the act, the fitness evaluations it made and
the size of its quadratic fits (``fit_elements`` = m · cols, which decides
whether ``fit_quadratic`` routes to the gram kernel).  A gate that fails
makes the launcher exit 1, as the example's ``assert`` would stop it.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import time

import torch

from repro_torch.core.regression import n_columns
from repro_torch.kernels import ops


def fit_elements(m: int, n: int) -> int:
    """m · cols of a quadratic fit of m samples in n parameters."""
    return m * n_columns(n)


def record_search(rec: dict, eng) -> None:
    """An engine's (or an ``AnmState``'s) outcome into the act record
    ``rec``: its iterations, best fitness and committed history."""
    rec["iterations"] = eng.iteration
    rec["best_fitness"] = float(eng.best_fitness)
    rec["history"] = {
        "best_fitness": [r.best_fitness for r in eng.history],
        "best_alpha": [r.best_alpha for r in eng.history],
        "centers": [[float(v) for v in r.center] for r in eng.history]}


class ActLog:
    """The acts of one launcher run, on ``device``."""

    def __init__(self, example: str, device):
        self.device = torch.device(device)
        self.doc = {"example": example, "device": str(self.device),
                    "acts": {}}

    @contextlib.contextmanager
    def act(self, name: str):
        """Time the act ``name`` and count its launches; yields its record,
        a dict the act fills (``gates``, ``iterations``, ``best_fitness``,
        ``evaluations``, ``fit_elements``, ...)."""
        rec = {"gates": {}}
        self._sync()
        before = ops.launch_counts()
        t0 = time.perf_counter()
        try:
            yield rec
        finally:
            self._sync()
            rec["wall_s"] = time.perf_counter() - t0
            after = ops.launch_counts()
            rec["launches"] = {k: after[k] - before[k] for k in after}
            self.doc["acts"][name] = rec

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def ok(self) -> bool:
        """Every gate of every act held."""
        return all(all(rec["gates"].values())
                   for rec in self.doc["acts"].values())

    def finish(self, out: str = None) -> int:
        """Write the document to ``out`` (if given); the exit code: 0 when
        every gate held, else 1 with the failed gates on stderr."""
        self.doc["ok"] = self.ok
        if out:
            os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
            with open(out, "w") as f:
                json.dump(self.doc, f, indent=2)
        if self.ok:
            return 0
        failed = [f"{act}: {gate}"
                  for act, rec in self.doc["acts"].items()
                  for gate, held in rec["gates"].items() if not held]
        print(f"{self.doc['example']}: failed gates: {', '.join(failed)}",
              file=sys.stderr)
        return 1


class _Tee(io.TextIOBase):
    def __init__(self, out):
        self.out, self.text = out, io.StringIO()

    def write(self, s):
        self.text.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


@contextlib.contextmanager
def tee_stdout():
    """Standard output goes on as before and is also kept: yields a
    ``StringIO`` that holds it."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        yield tee.text
