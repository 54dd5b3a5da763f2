"""The port's ``obs_server`` substrate smoke (``repro_torch/launch/
dryrun.py::run_obs_server_smoke``, the reference's
``src/repro/launch/dryrun.py:1071``) on the CPU at the reference's sizes,
a quarter of the hosts silent from virtual time 150: observed live with
a subscriber, observed under chaos, SIGKILLed and restored, the live
defense and its replay, each leg a child process.  The shared checks are
in ``tests/torch_server_smoke.py``; the runner runs once for the module.
"""
import pytest

from repro_torch.launch import dryrun as D
from torch_server_smoke import (KEYS, check_outcome, missing,
                                port_defaults, reference_defaults, run)

NAME = "obs_server"


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    return run(NAME, tmp_path_factory)


def test_the_runner_keeps_the_reference_defaults():
    assert port_defaults(NAME) == reference_defaults("run_obs_server_smoke")


def test_returns_true_with_every_reference_key(smoke):
    ok, report = smoke
    assert ok and report["parity_ok"]
    assert missing(report, KEYS[NAME]) == []
    assert (report["silence_at"], report["silence_frac"]) == (150.0, 0.25)


def test_the_live_subscriber_got_stamped_snapshots_in_order(smoke):
    live = smoke[1]["observed_live"]
    assert live["ok"] and live["trajectory_equal"]
    assert live["hub_snapshots"] >= 2
    sub = live["subscriber"]
    assert sub["snapshots"] >= 2 and sub["stamped_ok"] and not sub["errors"]


def test_observed_under_chaos_injected_and_equals_the_baseline(smoke):
    chaos = smoke[1]["observed_chaos"]
    assert chaos["ok"] and chaos["trajectory_equal"]
    assert chaos["faults_injected"] > 0


def test_the_kill_leg_was_killed_mid_stream_and_restored(smoke):
    kill = smoke[1]["kill_restore"]
    assert kill["killed_mid_run"] and not kill["recovered_done"]
    assert kill["trajectory_equal"] and kill["ok"]
    assert kill["hub_snapshots"] >= 1


def test_the_defense_shrank_the_reliable_set_and_replays(smoke):
    d = smoke[1]["defense"]
    assert d["ok"] and d["quarantined_now"] > 0 and d["reliable_set_shrunk"]
    assert d["reliable_set_defended"] < d["reliable_set_undefended"]
    assert d["replay_trajectory_equal"]


def test_every_child_ran_on_the_cpu(smoke):
    report = smoke[1]
    # base, observed, observed under chaos, the restore, defended, replay
    assert report["children"] == {"children": 6, "devices": ["cpu"],
                                  "row_mean_launches": [0] * 6, "ok": True}


def test_the_baseline_matches_the_reference_outcome(smoke):
    check_outcome(NAME, smoke[1])
