"""The LM-loss backend's mesh route over ranks (``launch/ranks.py``), on
the CPU with 2 gloo ranks.

The reference's smoke workloads (danube and rwkv6, bf16 and f32) carried
across by ``convert.lm_workload_from_reference`` and written for the
ranks to read; each rank builds the workload from it, holds the whole
batch and the leaves of its own positions (a model axis of 1: every leaf
whole, the workload's own tensors), scores its own lanes and all-gathers
the rest.  Every rank's lanes equal the one-process (2, 1) virtual mesh
bit for bit, and the reference's in-process backend within the model
tests' tolerances (bf16 2e-2, f32 1e-4).  Then act 1 over ranks, each
rank building ``lm_problem`` from its seeds (``dryrun.lm_grid_rank``,
the leg ``chip_smoke.py`` runs at published widths): every rank commits
the in-process sync run's iterates and engine stats.
"""
import dataclasses
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from repro.core.subspace import SubspaceProjection as JProjection
from repro.core.substrates.lm_loss import LmLossEvalBackend as JBackend
from repro.core.substrates.lm_loss import make_lm_workload as j_workload
from repro.models import transformer as JT
from repro_torch.convert import lm_workload_from_reference
from repro_torch.core.substrates.lm_loss import LmLossEvalBackend
from repro_torch.launch import anm_lm, dryrun, ranks
from repro_torch.launch.mesh import Mesh, virtual_devices
from repro_torch.server.sim import lm_problem

ARCHS = ("h2o-danube-3-4b", "rwkv6-7b")
LOSS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
K = 4
ENV = dict(os.environ, OMP_NUM_THREADS="1")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(params) -> dict:
    def path(kp):
        return "/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                        for e in kp)
    return {path(kp): np.asarray(x, np.float32)
            for kp, x in jax.tree_util.tree_leaves_with_path(params)}


def _ref_workload(arch: str, dtype: str, base=None):
    """The reference's smoke workload, as ``test_torch_lm_backend.py``
    builds it (f32: its configuration's dtype replaced, re-drawn), from
    ``base``, the bf16 one, where given."""
    wl = base or j_workload(arch, k=K, batch_size=1, seq_len=16, seed=1)
    if dtype == "bfloat16":
        return wl
    cfg = dataclasses.replace(wl.cfg, dtype=dtype)
    init_key, basis_key = jax.random.split(jax.random.key(1), 2)
    params = jax.jit(JT.init_params, static_argnums=0)(cfg, init_key)
    return dataclasses.replace(wl, cfg=cfg,
                               proj=JProjection.create(params, K, basis_key))


def _carry_args(wl) -> dict:
    return dict(arch=wl.arch, cfg=dataclasses.asdict(wl.cfg),
                theta0=_leaves(wl.proj.theta0),
                basis=np.asarray(wl.proj.basis), batch=dict(wl.batch),
                k=wl.k, coeff_bound=wl.coeff_bound, seed=wl.seed)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_two_rank_lanes_equal_one_process_and_track_the_reference(
        tmp_path, arch, dtype):
    ref = _ref_workload(arch, dtype)
    args = _carry_args(ref)
    path = tmp_path / "workload.pkl"
    with open(path, "wb") as f:
        pickle.dump(args, f)
    res = ranks.run("torch_ranks:lm_lanes",
                    {"workload": str(path), "mesh_shape": [2, 1]}, world=2,
                    backend="gloo", devices=["cpu", "cpu"],
                    workdir=str(tmp_path / "ranks"), timeout=180, env=ENV)
    assert res.returncode == 0, res.failed

    wl = lm_workload_from_reference(**args, device="cpu")
    pts = np.random.default_rng(5).uniform(-0.3, 0.3, (19, wl.k))
    one = LmLossEvalBackend(wl, mesh=Mesh((2, 1), ("data", "model"),
                                          virtual_devices(2, "cpu")))
    want = one(pts)
    be = JBackend(ref)
    reference = be.collect(be.submit(pts, np.full(len(pts), np.nan),
                                     list(range(len(pts)))))
    for doc in res.docs:
        got = np.array(doc["values"])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, reference, rtol=LOSS_TOL[dtype])
        # each rank scored its half of the lanes of the bucket of 32
        assert doc["lanes"] == 16
        assert doc["batch_pieces"] == [1, 1] and doc["basis_whole"]


def test_act1_over_two_ranks_commits_the_in_process_iterates(monkeypatch):
    """rwkv6's act 1 (``lm_problem``'s defaults) on the (2, 1) mesh over
    2 ranks: every rank builds the workload from its seed, and commits
    the in-process sync run's iterates and engine stats; each rank
    evaluates half of the lanes of the in-process pipelined run."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")          # the ranks' too
    search, fleet, wl = lm_problem(arch="rwkv6-7b", device="cpu")
    backend = anm_lm.warmed_backend(wl, search.anm.m_regression)
    sync, _, _ = anm_lm.run(search, fleet, backend, pipelined=False)
    _, stats, _ = anm_lm.run(search, fleet, backend, pipelined=True)
    rep = dryrun.over_ranks(
        "repro_torch.launch.dryrun:lm_grid_rank",
        dict(arch="rwkv6-7b", mesh_shape=[2, 1],
             axis_names=["data", "model"]), 2, "gloo", "cpu", sync)
    assert rep["ranks_parity_ok"], rep["ranks_failed"]
    lanes = sum(kp * n for kp, n in stats.bucket_hist.items())
    for doc in rep["per_rank"]:
        assert doc["device"] == "cpu" and doc["n_layers"] == 2
        assert doc["data_shards"] == 1
        assert doc["lanes"] == lanes // 2
        assert doc["new_shapes_after_warm"] == 0
