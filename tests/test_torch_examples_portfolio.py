"""Acts 2-3 of ``examples/multi_search.py`` on the port
(``repro_torch/launch/multi_search.py --policy portfolio|restart``)
against the example run as written, on the CPU at the example's size: 6
searches at m = 96 / 48 over 768 hosts, 4 iterations, stripe79 at 500
stars and 512 quadrature points.

The portfolio policy kills a search whose best trails the incumbent by
more than ``kill_margin`` after its probation, and the restart policy
starts perturbed restarts of the incumbent as searches finish.  Both
decisions read the fitness, and the two packages' f32 fitnesses differ in
the last bits; at this size every decision falls the same way in both
packages: they kill the same searches and start the same restarts, every
search commits as many iterations, and each best agrees within 1e-3
relative.
"""
import json

import numpy as np
import pytest

from torch_examples import one_thread  # noqa: F401 (autouse fixture)
from torch_examples import load_example, recording, run_example
from repro_torch.launch import multi_search

#: what the reference example's acts 2 and 3 do on the CPU
KILLED = ["search-0", "search-3", "search-5"]
RESTARTS = ["search-3~r0", "search-5~r1", "search-1~r2"]


@pytest.fixture(scope="module", params=["portfolio", "restart"])
def act(request, tmp_path_factory):
    policy = request.param
    ex = load_example("multi_search")
    runs = []
    ex.SearchDirector = recording(ex.SearchDirector, runs)
    run_example(ex, ["--policy", policy])
    (_, ref), = runs
    out = tmp_path_factory.mktemp(policy) / "doc.json"
    rc = multi_search.main(["--policy", policy, "--device", "cpu",
                            "--out", str(out)])
    return policy, ref, rc, json.loads(out.read_text())


def test_the_launcher_exits_0_with_every_gate(act):
    policy, _, rc, doc = act
    assert rc == 0 and doc["ok"] and doc["device"] == "cpu"
    assert list(doc["acts"]) == [policy]
    assert all(doc["acts"][policy]["gates"].values())


def test_the_same_searches_are_killed_or_restarted(act):
    policy, ref, _, doc = act
    mine = doc["acts"][policy]
    if policy == "portfolio":
        ref_killed = [o.spec.name for o in ref.outcomes
                      if o.status == "killed"]
        assert mine["killed"] == ref_killed == KILLED
    else:
        ref_restarts = [o.spec.name for o in ref.outcomes
                        if "~r" in o.spec.name]
        assert mine["restarts"] == ref_restarts == RESTARTS


def test_each_search_commits_as_many_iterations(act):
    policy, ref, _, doc = act
    mine = doc["acts"][policy]["searches"]
    assert [s["name"] for s in mine] == [o.spec.name for o in ref.outcomes]
    assert [s["status"] for s in mine] == [o.status for o in ref.outcomes]
    assert [s["iterations"] for s in mine] == [o.engine.iteration
                                              for o in ref.outcomes]


def test_each_search_best_within_1e_3(act):
    policy, ref, _, doc = act
    mine = [s["best_fitness"] for s in doc["acts"][policy]["searches"]]
    np.testing.assert_allclose(mine, [o.engine.best_fitness
                                      for o in ref.outcomes],
                               rtol=1e-3, atol=0)


def test_no_launch_on_the_cpu_and_fits_under_the_gram_route(act):
    policy, _, _, doc = act
    rec = doc["acts"][policy]
    # the fits (96 x 45) stay under the gram kernel's 32768 elements on
    # either device
    assert not any(rec["launches"].values())
    assert rec["fit_elements"] == 96 * 45 < 32768
    assert rec["evaluations"] > 0
