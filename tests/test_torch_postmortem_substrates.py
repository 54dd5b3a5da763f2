"""The port's ``postmortem`` substrate smoke (``repro_torch/launch/
dryrun.py::run_postmortem_smoke``, the reference's
``src/repro/launch/dryrun.py:1291``) on the CPU at the reference's
sizes, a quarter of the hosts silent from virtual time 150: replay logs
byte-identical with retention and tracing on and off, the flight
recorder SIGKILLed under chaos and read by ``python -m
repro_torch.launch.obs_postmortem``, the stall window's kill and its
replay, each leg a child process.  The shared checks are in
``tests/torch_server_smoke.py``; the runner runs once for the module.
"""
import pytest

from repro_torch.launch import dryrun as D
from torch_server_smoke import (KEYS, check_outcome, missing,
                                port_defaults, reference_defaults, run)

NAME = "postmortem"


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    return run(NAME, tmp_path_factory)


def test_the_runner_keeps_the_reference_defaults():
    assert port_defaults(NAME) == reference_defaults("run_postmortem_smoke")


def test_returns_true_with_every_reference_key(smoke):
    ok, report = smoke
    assert ok and report["parity_ok"]
    assert missing(report, KEYS[NAME]) == []


def test_replay_logs_are_byte_identical_with_retention_on_and_off(smoke):
    compat = smoke[1]["replay_log_byte_compat"]
    assert compat["ok"] and compat["identical"] and compat["bytes"] > 0
    assert compat["retention"]["snapshots_stored"] > 0
    assert compat["retention"]["spans_stored"] > 0


def test_the_flight_recorder_reads_epoch_1_then_1_and_2(smoke):
    rec = smoke[1]["flight_recorder"]
    assert rec["killed_mid_run"] and rec["ok"] and rec["trajectory_equal"]
    assert rec["dead_epochs"] == [1] and rec["post_restore_epochs"] == [1, 2]
    assert rec["dead_snapshots"] > 0 and rec["dead_spans"] > 0
    assert rec["dead_phase_transitions"] > 0


def test_the_stall_window_killed_search_0_and_replays(smoke):
    stall = smoke[1]["stall_kill"]
    assert stall["ok"] and stall["searches_killed"] == [0]
    assert stall["by_action"]["kill_search"] >= 1
    assert stall["defended_iteration"] < stall["baseline_iteration"]
    assert stall["replay_trajectory_equal"]


def test_every_server_child_ran_on_the_cpu(smoke):
    report = smoke[1]
    # base, retention off and on, the restore, stalled, stall replay (the
    # two post-mortem readers write no server doc)
    assert report["children"] == {"children": 6, "devices": ["cpu"],
                                  "row_mean_launches": [0] * 6, "ok": True}
    assert {"pm_dead", "pm_post"} <= set(report["wall_s"])


def test_the_baseline_matches_the_reference_outcome(smoke):
    check_outcome(NAME, smoke[1])
