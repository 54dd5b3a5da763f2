"""The port's substrate-smoke registry and its four in-process runners
(``repro_torch/launch/substrates.py``, ``repro_torch/launch/dryrun.py``).

* The registry: the reference's eight names and descriptions (the port of
  ``tests/test_server.py::test_substrate_registry_names``), runners in
  the port's dry-run, an import that loads neither the dry-run nor the
  model stack.
* Each runner at a tiny size on the CPU returns True and writes a report
  holding every key of the reference's report
  (``src/repro/launch/dryrun.py:216-679``).
* Each runner's in-process sync leg against the reference's in-process
  ``BatchedVolunteerGrid`` / ``SearchDirector`` run on the same seeds.
  The two packages' f32 fits differ in their last bits, so the port is
  held at the reference's committed centers (ROADMAP note (e)), as
  ``tests/test_torch_server.py`` holds the smoke server: the port's
  fitness there is the reference's committed fitness within 1e-3 (SDSS)
  or 2e-2 relative (the LM's bf16 loss, ``tests/test_torch_lm_backend.py``
  ``LOSS_TOL``), it commits as many iterations, and its outcome (the
  runner's final fitness) is the reference's within the same tolerance.
* The command line: ``--list-substrates``, ``--substrate pod_mesh
  --device cpu``, an unknown name refused at parse time.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core.anm import AnmConfig as JAnmConfig
from repro.core.engine import AnmEngine as JAnmEngine
from repro.core.grid import GridConfig as JGridConfig
from repro.core.orchestrator import FleetScheduler as JFleetScheduler
from repro.core.orchestrator import SearchDirector as JSearchDirector
from repro.core.orchestrator import multi_start_specs as j_multi_start_specs
from repro.core.orchestrator.director import SearchSpec as JSearchSpec
from repro.core.substrates.batched_grid import BatchedVolunteerGrid as JGrid
from repro.core.substrates.eval_backend import \
    InProcessEvalBackend as JInProcessEvalBackend
from repro.core.substrates.eval_backend import bucket_size as j_bucket_size
from repro.core.substrates.lm_loss import LmLossEvalBackend as JLmBackend
from repro.core.substrates.lm_loss import make_lm_workload as j_workload
from repro.data import sdss as jsdss
from repro.launch import substrates as JS
from repro_torch.convert import lm_workload_from_reference
from repro_torch.core.substrates.lm_loss import LmLossEvalBackend
from repro_torch.launch import dryrun as D
from repro_torch.launch import substrates as S
from repro_torch.launch.mesh import Mesh, virtual_devices
from repro_torch.server.sim import lm_search

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the runners' tiny sizes here.  m = 96 keeps every search's fit
#: determined (m // 2 = 48 samples for the quadratic model's 45
#: coefficients in 8 dimensions): below that the ridge decides the
#: direction and f32 last bits move it (ROADMAP note (e)).  At m = 24 the
#: reference's own portfolio ends 0.11 apart when its fitness is scaled
#: by 1 + 2**-22; at m = 96, 5e-5, so an outcome can be held at 1e-3
SDSS = dict(n_stars=300, m=96, iterations=2)
HOSTS = 64

#: every key of the reference's reports, nested where a value is a dict
#: with fixed keys (src/repro/launch/dryrun.py:268-288, 378-398, 476-493,
#: 620-666)
LEGS = {"in_process": None, "in_process_pipelined": None, "pod_mesh": None}
POD_MESH_KEYS = {
    "mesh": None, "data_shards": None, "min_bucket": None, "n_hosts": None,
    "m": None, "iterations": LEGS, "final": LEGS, "batch_calls": LEGS,
    "wall_s": LEGS,
    "pipeline": {"spec_blocks": None, "spec_discarded": None,
                 "max_in_flight": None, "pod_max_in_flight": None},
    "centers_equal": None, "fitness_equal": None,
    "pipelined_parity_ok": None, "pod_parity_ok": None, "parity_ok": None}
MULTI_BACKEND = {"parity_per_search": None, "iterations": None,
                 "final": None, "rounds": None, "dispatches": None,
                 "lane_blocks": None, "padded_lanes": None,
                 "solo_padded_lanes": None, "wall_s": None}
MULTI_SEARCH_KEYS = {
    "mesh": None, "n_searches": None, "fleet_hosts": None,
    "backends": {"in_process": MULTI_BACKEND, "pod_mesh": MULTI_BACKEND},
    "cross_backend_ok": None, "parity_ok": None}
CACHED_BACKEND = {"cold_parity": None, "warm_parity": None,
                  "warm_fully_served": None, "cache": None,
                  "lanes_deduped": None,
                  "wall_s": {"off": None, "cold": None, "warm": None}}
CACHED_PORTFOLIO_KEYS = {
    "mesh": None, "n_searches": None, "fleet_hosts": None,
    "backends": {"in_process": CACHED_BACKEND, "pod_mesh": CACHED_BACKEND},
    "parity_ok": None}
LM_LEGS = {"sync": None, "pipelined": None, "pod": None}
LM_SUBSPACE_KEYS = {
    "arch": None, "k": None, "m": None, "iterations": None, "mesh": None,
    "n_params": None, "data_shards": None, "min_bucket": None,
    "model_spec_fallbacks": None, "warm_s": None,
    "compiles": {"in_process": None, "pod": None, "zero_after_warm": None},
    "grid": {"iterations": LM_LEGS, "final": LM_LEGS,
             "batch_calls": LM_LEGS, "wall_s": LM_LEGS,
             "pipelined_parity_ok": None, "pod_parity_ok": None},
    "orchestrator": {"solo_parity": None, "warm_replay_parity": None,
                     "warm_fully_served": None, "cache": None,
                     "wall_s": None, "parity_ok": None},
    "server": {"iterations": None, "best": None, "messages": None,
               "backend_parity_ok": None, "crashed_mid_run": None,
               "replayed": None, "resumed_leases": None,
               "restore_parity_ok": None, "wall_s": None},
    "parity_ok": None}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU ops run fastest on one thread (as in
    tests/test_torch_lm_backend.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _missing(report: dict, keys: dict, path: str = "") -> list:
    """The reference's keys that ``report`` lacks, by path."""
    out = []
    for key, sub in keys.items():
        if key not in report:
            out.append(path + key)
        elif sub is not None:
            out += _missing(report[key], sub, f"{path}{key}/")
    return out


def _read(out_dir, name) -> dict:
    with open(os.path.join(out_dir, f"substrate_{name}.json")) as f:
        return json.load(f)


def _mesh_2x2():
    return Mesh((2, 2), ("data", "model"), virtual_devices(4, "cpu"))


def _sdss_reference(name: str, seed: int):
    """(reference f_batch, x0, the port's f_batch) of a runner's stripe."""
    stripe = jsdss.make_stripe(name, n_stars=SDSS["n_stars"], seed=seed)
    jf, _ = jsdss.make_fitness(stripe)
    rng = np.random.default_rng(3)
    x0 = np.clip(stripe.truth + rng.normal(0, 0.2, 8).astype(np.float32),
                 jsdss.LO, jsdss.HI)
    mine, my_x0 = D._sdss_problem(name, seed, SDSS["n_stars"], "cpu")
    assert np.array_equal(my_x0, x0)
    return jf, x0, mine


def _held_at_reference_centers(f_batch, ref_engine, iterations: int,
                               final: float):
    """The port's fitness at the reference's committed centers is the
    reference's committed fitness within 1e-3; both commit as many
    iterations, and the runner's outcome is the reference's within
    1e-3."""
    assert iterations == ref_engine.iteration == SDSS["iterations"]
    assert abs(final - ref_engine.best_fitness) <= 1e-3
    centers = torch.tensor(np.stack([r.center for r in ref_engine.history]),
                           dtype=torch.float32)
    got = f_batch(centers).numpy().astype(np.float64)
    np.testing.assert_allclose(
        got, [r.best_fitness for r in ref_engine.history], rtol=0, atol=1e-3)


# -- the registry ---------------------------------------------------------------

def test_substrate_registry_names():
    """The reference's eight names and descriptions, in its order; each
    runner in the port's dry-run; all eight resolve."""
    assert list(S.SUBSTRATES) == list(JS.SUBSTRATES)
    for name, smoke in S.SUBSTRATES.items():
        ref = JS.SUBSTRATES[name]
        assert (smoke.name, smoke.description) == (ref.name, ref.description)
        assert smoke.runner == ref.runner.replace("repro.", "repro_torch.", 1)
    assert S.list_substrates() == JS.list_substrates()
    for smoke in S.SUBSTRATES.values():
        assert smoke.resolve() is getattr(D, smoke.runner.split(":")[1])


def test_registry_import_loads_neither_the_dry_run_nor_the_models():
    code = ("import sys, repro_torch.launch.substrates; "
            "print(sorted(m for m in sys.modules if m.startswith("
            "('repro_torch.launch.dryrun', 'repro_torch.models', 'jax', "
            "'repro.'))))")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(ROOT, "src")))
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == "[]"


# -- the runners: tiny, against the reference's in-process run -------------------

def test_pod_mesh_runner(tmp_path):
    """Sync == pipelined == pod on the virtual 16 × 16 mesh, their engine
    stats equal; the sync leg at the reference's committed centers and
    its outcome."""
    assert D.run_substrate_smoke(str(tmp_path), n_hosts=HOSTS, device="cpu",
                                 **SDSS)
    report = _read(tmp_path, "pod_mesh")
    assert _missing(report, POD_MESH_KEYS) == []
    assert report["mesh"] == "16x16" and report["data_shards"] == 16
    assert report["new_shapes_after_warm"] == 0
    assert report["device"] == "cpu"
    assert report["stats_equal"] == {"in_process_pipelined": True,
                                     "pod_mesh": True}

    jf, x0, mine = _sdss_reference("podmesh_smoke", 17)
    ref = JAnmEngine(x0, jsdss.LO, jsdss.HI, jsdss.DEFAULT_STEP,
                     JAnmConfig(m_regression=SDSS["m"],
                                m_line_search=SDSS["m"],
                                max_iterations=SDSS["iterations"]), seed=7)
    JGrid(jf, JGridConfig(n_hosts=HOSTS, failure_prob=0.05,
                          malicious_prob=0.01, seed=9),
          backend=JInProcessEvalBackend(jf), pipelined=False).run(ref)
    _held_at_reference_centers(mine, ref, report["iterations"]["in_process"],
                               report["final"]["in_process"])


def _reference_portfolio(jf, x0, n_searches, configs):
    sched = JFleetScheduler(JInProcessEvalBackend(jf),
                            JGridConfig(n_hosts=HOSTS, failure_prob=0.05,
                                        malicious_prob=0.01, seed=9))
    specs = j_multi_start_specs(sched, x0, jsdss.LO, jsdss.HI,
                                jsdss.DEFAULT_STEP, configs[0], n_searches,
                                seed=7, jitter=0.3, configs=configs)
    return JSearchDirector(sched, specs).run()


def _anm(m):
    return JAnmConfig(m_regression=m, m_line_search=m,
                      max_iterations=SDSS["iterations"])


def test_multi_search_runner(tmp_path):
    """Each search == its solo run on both backends (the pod on 2 × 2),
    the backends agree; each in-process search at the reference's
    committed centers and its outcome."""
    assert D.run_multi_search_smoke(str(tmp_path), n_searches=2,
                                    fleet_hosts=HOSTS, device="cpu",
                                    mesh=_mesh_2x2(), **SDSS)
    report = _read(tmp_path, "multi_search")
    assert _missing(report, MULTI_SEARCH_KEYS) == []
    for b in report["backends"].values():
        assert b["parity_per_search"] == [True, True]
    assert report["cross_backend_ok"]
    assert report["cross_backend_stats_equal"]

    jf, x0, mine = _sdss_reference("multisearch_smoke", 23)
    ref = _reference_portfolio(jf, x0, 2, [_anm(SDSS["m"]),
                                           _anm(SDSS["m"] // 2)])
    ip = report["backends"]["in_process"]
    for o, iters, final in zip(ref.outcomes, ip["iterations"], ip["final"]):
        _held_at_reference_centers(mine, o.engine, iters, final)


def test_cached_portfolio_runner(tmp_path):
    """Cold == warm == cache off on both backends (the pod on 2 × 2), the
    warm run served whole; the cache-off searches at the reference's
    committed centers and its outcomes."""
    assert D.run_cached_portfolio_smoke(str(tmp_path), n_searches=2,
                                        fleet_hosts=HOSTS, device="cpu",
                                        mesh=_mesh_2x2(), **SDSS)
    report = _read(tmp_path, "cached_portfolio")
    assert _missing(report, CACHED_PORTFOLIO_KEYS) == []
    for b in report["backends"].values():
        assert b["cold_parity"] and b["warm_parity"]
        assert b["warm_fully_served"] and b["cache"]["hits"] > 0

    jf, x0, mine = _sdss_reference("cached_portfolio_smoke", 23)
    ref = _reference_portfolio(jf, x0, 2, [_anm(SDSS["m"])])
    ip = report["backends"]["in_process"]
    for o, iters, final in zip(ref.outcomes, ip["iterations"], ip["final"]):
        _held_at_reference_centers(mine, o.engine, iters, final)


def _ref_leaves(params) -> dict:
    def path(kp):
        return "/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                        for e in kp)
    return {path(kp): np.asarray(x, np.float32)
            for kp, x in jax.tree_util.tree_leaves_with_path(params)}


#: the LM runner's workload here: danube's smoke config at 1 × 16 tokens
#: (the runner's default arch, rwkv6, runs on the card through chip_smoke)
LM = dict(arch="h2o-danube-3-4b", k=6, batch_size=1, seq_len=16, seed=3)


def test_lm_subspace_runner(tmp_path):
    """The three gates on a 2 × 2 mesh over the reference's workload
    carried across, engine stats equal in gates 1 and 2; the sync leg's
    losses at the reference's committed centers and its outcome."""
    wl = j_workload(LM["arch"], k=LM["k"], batch_size=LM["batch_size"],
                    seq_len=LM["seq_len"], seed=LM["seed"],
                    use_kernels=False)
    mine = lm_workload_from_reference(
        arch=wl.arch, cfg=dataclasses.asdict(wl.cfg),
        theta0=_ref_leaves(wl.proj.theta0), basis=np.asarray(wl.proj.basis),
        batch=wl.batch, k=wl.k, coeff_bound=wl.coeff_bound, seed=wl.seed,
        device="cpu")
    spec, fleet, _ = problem = lm_search(mine)
    assert D.run_lm_subspace_smoke(str(tmp_path), device="cpu",
                                   mesh=_mesh_2x2(), problem=problem)
    report = _read(tmp_path, "lm_subspace")
    assert _missing(report, LM_SUBSPACE_KEYS) == []
    assert report["mesh"] == "2x2" and report["data_shards"] == 2
    assert report["compiles"]["zero_after_warm"]
    assert report["grid"]["stats_equal"] == {"pipelined": True, "pod": True}
    orch = report["orchestrator"]
    assert orch["solo_stats_equal"] == [True, True]
    assert orch["warm_stats_equal"]
    lanes = sum(g["lanes"] for g in report["kernels"].values())
    assert lanes > 0 and report["n_layers"] == mine.cfg.n_layers

    ref_spec = JSearchSpec(
        name=spec.name, x0=wl.x0, lo=wl.lo, hi=wl.hi, step=wl.step,
        anm=JAnmConfig(m_regression=spec.anm.m_regression,
                       m_line_search=spec.anm.m_line_search,
                       max_iterations=spec.anm.max_iterations),
        grid=JGridConfig(**dataclasses.asdict(fleet)),
        engine_seed=spec.engine_seed,
        validation_quorum=spec.validation_quorum)
    m = spec.anm.m_regression
    backend = JLmBackend(wl, n_dims=wl.k,
                         max_bucket=j_bucket_size(JGrid.warm_max_bucket(m)))
    ref = ref_spec.build_engine()
    JGrid(None, ref_spec.grid, backend=backend, pipelined=False).run(ref)
    assert report["grid"]["iterations"]["sync"] == ref.iteration == 2
    centers = np.stack([r.center for r in ref.history])
    got = LmLossEvalBackend(mine)(centers)
    np.testing.assert_allclose(got, [r.best_fitness for r in ref.history],
                               rtol=2e-2)
    np.testing.assert_allclose(report["grid"]["final"]["sync"],
                               ref.best_fitness, rtol=2e-2)


# -- the command line ----------------------------------------------------------

def test_list_substrates_prints_the_eight(capsys):
    assert D.main(["--list-substrates"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split()[0] for line in lines] == list(JS.SUBSTRATES)


def test_substrate_pod_mesh_through_the_command_line(tmp_path, capsys):
    assert D.main(["--substrate", "pod_mesh", "--device", "cpu", "--out",
                   str(tmp_path)]) == 0
    assert os.listdir(tmp_path) == ["substrate_pod_mesh.json"]
    assert _missing(_read(tmp_path, "pod_mesh"), POD_MESH_KEYS) == []
    assert "[ok] substrate pod_mesh:" in capsys.readouterr().out


def test_unknown_substrate_fails_at_parse_time(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        D.main(["--substrate", "no_such_smoke", "--out", str(tmp_path)])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err
    assert not os.listdir(tmp_path)
