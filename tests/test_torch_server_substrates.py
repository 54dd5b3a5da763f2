"""The port's ``server`` substrate smoke (``repro_torch/launch/dryrun.py::
run_server_smoke``, the reference's ``src/repro/launch/dryrun.py:682``)
on the CPU at the reference's sizes: its legs as child processes of
``server/sim.py``, three of them SIGKILLed mid-run and restored.  The
shared checks are in ``tests/torch_server_smoke.py``; the runner runs
once for the module.
"""
import os

import pytest

from repro_torch.launch import child
from repro_torch.launch import dryrun as D
from torch_server_smoke import (KEYS, check_outcome, missing,
                                port_defaults, reference_defaults, run)

NAME = "server"


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    return run(NAME, tmp_path_factory)


def test_the_runner_keeps_the_reference_defaults():
    assert port_defaults(NAME) == reference_defaults("run_server_smoke")


def test_returns_true_with_every_reference_key(smoke):
    ok, report = smoke
    assert ok and report["parity_ok"]
    assert missing(report, KEYS[NAME]) == []
    assert report["backend_parity_ok"]
    assert report["production_mesh_parity_ok"]
    assert report["mesh"] == "16x16"


@pytest.mark.parametrize("leg", ["loopback", "tcp", "loopback_cache"])
def test_each_kill_leg_was_killed_mid_run_and_restored(smoke, leg):
    kill = smoke[1]["kill_restore"][leg]
    assert kill["killed_mid_run"] and not kill["recovered_done"]
    assert kill["trajectory_equal"] and kill["replayed"] > 0
    assert kill["ok"]


def test_the_cached_restore_came_back_warm(smoke):
    kill = smoke[1]["kill_restore"]["loopback_cache"]
    assert kill["warm_after_restore"]
    assert kill["cache"]["hits"] > 0 and kill["cache"]["store_size"] > 0


def test_every_child_ran_on_the_cpu(smoke):
    report = smoke[1]
    # base, pod and the three restores (a SIGKILLed child writes no doc)
    assert report["children"] == {"children": 5, "devices": ["cpu"],
                                  "row_mean_launches": [0] * 5, "ok": True}
    assert report["device"] == "cpu"
    assert set(report["wall_s"]) == {
        "base", "pod", *(f"{what}_{leg}" for what in ("kill", "resume")
                         for leg in ("loopback", "tcp", "loopback_cache"))}


def test_the_baseline_matches_the_reference_outcome(smoke):
    check_outcome(NAME, smoke[1])


def _doc(**changes):
    doc = {"history": {"centers": [[1.0, 2.0]], "best_fitness": [3.0]},
           "iteration": 1, "best_fitness": 3.0,
           "engine_stats": {"stale": 0, "corrupted": 1}}
    doc.update(changes)
    return doc


def test_trajectories_equal_refuses_docs_apart_in_engine_stats_alone():
    assert D.trajectories_equal(_doc(), _doc(pool={"messages": 9}))
    assert not D.trajectories_equal(
        _doc(), _doc(engine_stats={"stale": 1, "corrupted": 1}))


def test_a_forked_child_gives_its_exit_code_and_output(tmp_path):
    """``launch/child.py``: a forked command line's exit code, stdout and
    stderr, as ``subprocess.run`` gives them; after ``stop`` a child
    starts a new forkserver."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    ok = child.run("repro_torch.launch.obs_postmortem", ["--help"], env)
    assert ok.returncode == 0 and ok.stdout.startswith("usage:")
    bad = child.run("repro_torch.launch.obs_postmortem",
                    [str(tmp_path / "nothing"), "--json"], env)
    assert bad.returncode != 0 and bad.stderr
    child.stop()
    again = child.run("repro_torch.launch.obs_postmortem", ["--help"], env)
    assert again.returncode == 0 and again.stdout == ok.stdout
