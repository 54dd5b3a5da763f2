"""The port's ``chaos_server`` substrate smoke (``repro_torch/launch/
dryrun.py::run_chaos_server_smoke``, the reference's
``src/repro/launch/dryrun.py:873``) on the CPU at the reference's sizes:
8 concurrent TCP clients, clean and under the three fault presets, a
SIGKILL mid-chaos, each leg a child process; the pod backend over the
virtual 16 × 16 mesh in the runner's process.  The shared checks are in
``tests/torch_server_smoke.py``; the runner runs once for the module.
"""
import pytest

from repro_torch.launch import dryrun as D
from torch_server_smoke import (KEYS, check_outcome, missing,
                                port_defaults, reference_defaults, run)

NAME = "chaos_server"


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    return run(NAME, tmp_path_factory)


def test_the_runner_keeps_the_reference_defaults():
    assert port_defaults(NAME) == reference_defaults("run_chaos_server_smoke")


def test_returns_true_with_every_reference_key(smoke):
    ok, report = smoke
    assert ok and report["parity_ok"]
    assert missing(report, KEYS[NAME]) == []


def test_clean_concurrency_parked_arrivals(smoke):
    clean = smoke[1]["concurrent_clean"]
    assert clean["ok"] and clean["trajectory_equal"]
    assert clean["intake"]["parked"] > 0


@pytest.mark.parametrize("preset", ["drop_dup", "reorder_delay",
                                    "reset_torn"])
def test_each_fault_plan_injected_and_equals_the_baseline(smoke, preset):
    plan = smoke[1]["fault_plans"][preset]
    assert plan["ok"] and plan["trajectory_equal"]
    assert plan["faults_injected"] > 0


def test_the_kill_leg_was_killed_mid_chaos_and_restored(smoke):
    kill = smoke[1]["kill_restore"]
    assert kill["killed_mid_run"] and not kill["recovered_done"]
    assert kill["trajectory_equal"] and kill["ok"]


def test_the_pod_backend_under_chaos_on_16x16(smoke):
    mesh = smoke[1]["production_mesh_chaos"]
    assert mesh["ok"] and mesh["mesh"] == "16x16"
    assert sum(mesh["chaos"][k] for k in D._FAULTS) > 0


def test_every_child_ran_on_the_cpu(smoke):
    report = smoke[1]
    # base, concurrent, three presets and the restore
    assert report["children"] == {"children": 6, "devices": ["cpu"],
                                  "row_mean_launches": [0] * 6, "ok": True}


def test_the_baseline_matches_the_reference_outcome(smoke):
    check_outcome(NAME, smoke[1])
