"""``examples/fgdo_service.py`` and ``examples/observability.py`` on the
port (``repro_torch/launch/{fgdo_service,observability}.py``) against the
examples run as written, on the CPU at their own sizes.

Each launcher's ``main`` runs every act with ``--device cpu`` and exits 0:
its gates (restored == uninterrupted and warm, TCP == loopback, the
chaotic concurrent run == the clean serial one; observed == unobserved,
the silenced cohort paged, the replayed defense == the live one) hold
port against port.  Against the reference: the fleet's counts (messages,
leases, results, lost, corrupted, rejected) and the defense's verdicts
are equal, since both packages draw the same fleet.  m = 24 and m = 16
samples fit 45 coefficients, so the first direction rests on last-place
f32 differences and the two packages commit different line-search
winners (5.43504 against the reference's 5.40333 in fgdo_service's act 1);
as in ``tests/test_torch_server.py``, the port is held at the reference's
committed centers: its fitness there is the reference's committed
fitness within 1e-3.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.launch import fgdo_service, observability
from repro_torch.server.sim import smoke_problem
from torch_examples import one_thread  # noqa: F401 (autouse fixture)
from torch_examples import load_example, recording, run_example


def _reference(name: str, argv=()):
    """Run ``examples/<name>.py`` as written; returns (the kwargs of its
    ``smoke_problem`` call, [(ServerSubstrate kwargs, run result)])."""
    ex = load_example(name)
    runs, problems = [], []
    real = ex.smoke_problem

    def caught(**kw):
        problems.append(kw)
        return real(**kw)
    ex.smoke_problem = caught
    ex.ServerSubstrate = recording(ex.ServerSubstrate, runs)
    run_example(ex, argv)
    return problems[0], runs


def _port(module, tmp_path):
    out = tmp_path / "doc.json"
    rc = module.main(["--device", "cpu", "--out", str(out)])
    return rc, json.loads(out.read_text())


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    problem, runs = _reference("fgdo_service", ["--act", "1"])
    rc, doc = _port(fgdo_service, tmp_path_factory.mktemp("service"))
    return problem, runs[0][1], rc, doc


@pytest.fixture(scope="module")
def obs(tmp_path_factory):
    problem, runs = _reference("observability")
    rc, doc = _port(observability, tmp_path_factory.mktemp("obs"))
    return problem, runs, rc, doc


def test_the_problems_are_the_examples(service, obs):
    assert service[0] == fgdo_service.PROBLEM
    assert obs[0] == observability.PROBLEM


@pytest.mark.parametrize("which,acts", [
    ("service", ["loopback", "crash_restore", "tcp", "concurrent_chaos"]),
    ("obs", ["observe", "defense", "replay"])])
def test_main_exits_0_with_every_gate(service, obs, which, acts):
    rc, doc = (service if which == "service" else obs)[2:]
    assert rc == 0 and doc["ok"] and doc["device"] == "cpu"
    assert list(doc["acts"]) == acts
    for act in acts:
        rec = doc["acts"][act]
        assert rec["gates"] and all(rec["gates"].values()), act
        assert rec["evaluations"] > 0
        assert rec["fit_elements"] < 32768        # no gram route


def test_service_act_2_restores_warm(service):
    acts = service[3]["acts"]
    rec = acts["crash_restore"]
    assert rec["crash_at"] == acts["loopback"]["messages"] // 3
    assert rec["cache"]["hits"] > 0 and rec["replayed"] > 0


def test_service_act_4_injects_faults(service):
    ch = service[3]["acts"]["concurrent_chaos"]["chaos"]
    assert ch["retries"] > 0
    assert ch["drops_request"] + ch["drops_reply"] + ch["duplicates"] > 0


def test_service_fleet_counts_equal_the_references(service):
    _, ref, _, doc = service
    p = ref.pool
    assert doc["acts"]["loopback"]["pool"] == {
        "messages": p.messages, "leases": p.work_received,
        "results": p.results_reported, "lost": p.failed,
        "corrupted": p.corrupted, "no_work": p.no_work}
    assert (p.messages, p.work_received, p.results_reported, p.failed,
            p.corrupted) == (3237, 292, 271, 9, 10)
    assert ref.engines[0].stats.candidates_rejected == 1


def _at_centers(problem, engine):
    _, _, f_batch = smoke_problem(**problem, device="cpu")
    centers = torch.tensor(np.stack([r.center for r in engine.history]),
                           dtype=torch.float32)
    return f_batch(centers).numpy().astype(np.float64)


def test_service_port_at_the_references_centers(service):
    problem, ref, _, doc = service
    eng = ref.engines[0]
    np.testing.assert_allclose(_at_centers(problem, eng),
                               [r.best_fitness for r in eng.history],
                               rtol=0, atol=1e-3)
    assert doc["acts"]["loopback"]["iterations"] == eng.iteration == 3
    assert doc["status"]["iteration"] == 3


def test_obs_port_at_the_references_centers(obs):
    problem, runs, _, doc = obs
    eng = runs[0][1].engines[0]
    np.testing.assert_allclose(_at_centers(problem, eng),
                               [r.best_fitness for r in eng.history],
                               rtol=0, atol=1e-3)
    assert doc["acts"]["observe"]["iterations"] == eng.iteration == 3


def test_obs_defense_equals_the_references(obs):
    _, runs, _, doc = obs
    dark = [r for kw, r in runs
            if kw.get("silence_at") and not kw.get("defense")
            and kw.get("defense_schedule") is None][0]
    defended = [r for kw, r in runs if kw.get("defense")][0]
    rec = doc["acts"]["defense"]
    d = defended.defense
    assert (rec["events"], rec["by_action"], rec["quarantined_now"]) == (
        d["events"], d["by_action"], d["quarantined_now"])
    assert (rec["reliable_set_undefended"], rec["reliable_set_defended"]) \
        == (dark.server.registry.summary()["reliable_set"],
            defended.server.registry.summary()["reliable_set"])
    assert (d["events"], d["quarantined_now"]) == (18, 24)
    assert (rec["reliable_set_undefended"],
            rec["reliable_set_defended"]) == (60, 36)
