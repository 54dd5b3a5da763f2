"""What the tests of the four server substrate smokes share
(``tests/test_torch_{server,chaos,obs,postmortem}_substrates.py``, one
runner a file so that the runners run on four test workers): the
reference's report keys, its runners' defaults read from its source, the
runner run once a module on the CPU, and the reference's outcome on the
same seeds.

Each runner runs at the reference's sizes (its defaults), its children
on one thread each (small CPU ops run fastest so).  The outcome is held
as ``tests/test_torch_server.py::test_smoke_server_run_tracks_the_reference``
holds the smoke server: the two packages' f32 fits differ in their last
bits and commit different line-search winners, so the baseline child
commits as many iterations as the reference's in-process
``ServerSubstrate`` run on the same seeds, and the port's fitness at the
reference's committed centers is the reference's committed fitness
within ``FITNESS_TOL``.
"""
import ast
import inspect
import json
import os

import numpy as np
import pytest
import torch

from repro.core.substrates.eval_backend import \
    InProcessEvalBackend as JInProcessEvalBackend
from repro.server.sim import ServerSubstrate as JServerSubstrate
from repro.server.sim import result_doc as j_result_doc
from repro.server.sim import smoke_problem as j_smoke_problem
from repro_torch.launch import dryrun as D
from repro_torch.server.sim import smoke_problem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "src", "repro", "launch", "dryrun.py")
FITNESS_TOL = 1e-3

#: every key of the reference's reports, nested where a value is a dict
#: with fixed keys (src/repro/launch/dryrun.py:682-1526)
KILL = {"killed_mid_run": None, "recovered_done": None, "replayed": None,
        "resumed_leases": None, "trajectory_equal": None, "ok": None}
SIZES = {"n_hosts": None, "m": None, "iterations": None}
OBS_SIZES = dict(SIZES, n_clients=None, silence_at=None, silence_frac=None)
PLAN = {"trajectory_equal": None, "faults_injected": None, "chaos": None,
        "ok": None}
KEYS = {
    "server": dict(
        SIZES, parity_ok=None, backend_parity_ok=None,
        production_mesh_parity_ok=None,
        baseline={"iterations": None, "best": None, "messages": None,
                  "registry": None},
        kill_restore={"loopback": KILL, "tcp": KILL,
                      "loopback_cache": dict(KILL, cache=None,
                                             warm_after_restore=None)}),
    "chaos_server": dict(
        SIZES, n_clients=None, parity_ok=None,
        concurrent_clean={"trajectory_equal": None, "intake": None,
                          "ok": None},
        fault_plans={"drop_dup": PLAN, "reorder_delay": PLAN,
                     "reset_torn": PLAN},
        kill_restore=KILL,
        production_mesh_chaos={"trajectory_equal": None, "chaos": None,
                               "ok": None}),
    "obs_server": dict(
        OBS_SIZES, parity_ok=None,
        observed_live={"trajectory_equal": None, "hub_snapshots": None,
                       "subscriber": None, "ok": None},
        observed_chaos={"trajectory_equal": None, "faults_injected": None,
                        "ok": None},
        kill_restore={"killed_mid_run": None, "recovered_done": None,
                      "replayed": None, "hub_snapshots": None,
                      "trajectory_equal": None, "ok": None},
        defense={"events": None, "by_action": None, "quarantined_now": None,
                 "reliable_set_defended": None,
                 "reliable_set_undefended": None,
                 "reliable_set_shrunk": None,
                 "replay_trajectory_equal": None, "ok": None}),
    "postmortem": dict(
        OBS_SIZES, parity_ok=None,
        replay_log_byte_compat={"bytes": None, "identical": None,
                                "retention": None, "trace": None,
                                "ok": None},
        flight_recorder={"killed_mid_run": None, "dead_epochs": None,
                         "dead_snapshots": None, "dead_spans": None,
                         "dead_phase_transitions": None,
                         "replay_log_records": None,
                         "post_restore_epochs": None, "replayed": None,
                         "trajectory_equal": None, "ok": None},
        stall_kill={"searches_killed": None, "by_action": None,
                    "defended_iteration": None, "baseline_iteration": None,
                    "replay_trajectory_equal": None, "ok": None}),
}
RUNNERS = {"server": "run_server_smoke",
           "chaos_server": "run_chaos_server_smoke",
           "obs_server": "run_obs_server_smoke",
           "postmortem": "run_postmortem_smoke"}


def missing(report: dict, keys: dict, path: str = "") -> list:
    """The reference's keys that ``report`` lacks, by path."""
    out = []
    for key, sub in keys.items():
        if key not in report:
            out.append(path + key)
        elif sub is not None:
            out += missing(report[key], sub, f"{path}{key}/")
    return out


def reference_defaults(runner: str) -> dict:
    """The keyword defaults of the reference's ``runner``, read from its
    source (importing it would force a 512-device platform on this
    process's JAX)."""
    with open(REFERENCE) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == runner)
    names = [a.arg for a in fn.args.args]
    return {name: ast.literal_eval(d) for name, d in
            zip(names[len(names) - len(fn.args.defaults):], fn.args.defaults)}


def port_defaults(name: str) -> dict:
    """The defaults of the port's ``name`` runner that the reference's
    runner also has (all but the keyword-only ``device`` and ``mesh``)."""
    return {arg: p.default for arg, p in inspect.signature(
        getattr(D, RUNNERS[name])).parameters.items()
        if p.default is not inspect.Parameter.empty
        and p.kind is not p.KEYWORD_ONLY}


def run(name: str, tmp_path_factory) -> tuple:
    """(returned, report) of the ``name`` runner at its defaults on the
    CPU, its children on one thread each."""
    out = tmp_path_factory.mktemp(name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        ok = getattr(D, RUNNERS[name])(str(out), device="cpu")
    with open(out / f"substrate_{name}.json") as f:
        return ok, json.load(f)


def reference_outcome(name: str) -> tuple:
    """(the reference's in-process result doc, the port's fitness at its
    committed centers) on the seeds and sizes of the ``name`` runner's
    baseline leg."""
    kw = reference_defaults(RUNNERS[name])
    sizes = {k: kw[k] for k in ("n_stars", "n_hosts", "m", "iterations")}
    silence = ({"silence_at": 150.0, "silence_frac": 0.25}
               if name in ("obs_server", "postmortem") else {})
    spec, fleet, f_batch = j_smoke_problem(**sizes)
    ref = j_result_doc(JServerSubstrate(
        spec, fleet, JInProcessEvalBackend(f_batch), **silence).run())
    _, _, p_f = smoke_problem(device="cpu", **sizes)
    centers = torch.tensor(ref["history"]["centers"], dtype=torch.float32)
    return ref, p_f(centers).numpy().astype(np.float64)


def check_outcome(name: str, report: dict) -> None:
    """The runner's baseline child (its ``report``'s ``baseline``)
    against the reference's in-process run (module doc)."""
    ref, got = reference_outcome(name)
    assert report["baseline"]["iterations"] == ref["iteration"]
    np.testing.assert_allclose(got, ref["history"]["best_fitness"],
                               rtol=0, atol=FITNESS_TOL)
