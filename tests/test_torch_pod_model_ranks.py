"""The evaluation backends on a mesh whose model axis spans ranks, on the
CPU with 2 and 4 gloo ranks: act 1 over the LM loss, the SDSS pod
backend, the rank function of the card's published-width leg, the
placement of a leaf cut over model ranks, and the dry-run's refusals.

On the (W/M, M) grid of ``Mesh.over_ranks(model_ranks=M)`` the M ranks
of a model group hold one data block and score the same lanes, the
lane values all-gathered over the data group.  Held:

* rwkv6's act 1 (``lm_problem``'s defaults) on the production 16 × 16
  mesh over 4 ranks in a (2, 2) grid (``dryrun.lm_grid_rank``): every
  rank commits the in-process sync run's iterates and engine stats,
  scores half of the one-process 16 × 16 pod leg's lanes, runs no bucket
  shape first after warm, frees the whole chart, and stores and hands
  the bytes a count by hand from the reference's ``enforce_divisible``
  gives (8 × 8 positions a rank: half of each leaf cut 16 ways);
* ``PodMeshEvalBackend`` over (2, 2): every bucket's values equal the
  one-process mesh's bit for bit, and every rank commits the in-process
  grid's iterates;
* ``dryrun.lm_points_rank`` (the card's (p1) at smoke size) on (1, 2):
  both buckets' values equal in-process bit for bit, each hands the
  reckoned bytes in the reckoned all-gathers;
* ``Sharded`` keeps a contiguous copy of a rank's model block, its
  pieces views of it, and refuses to gather a leaf also cut over data;
* ``--model-ranks`` without ``--ranks``, or that does not divide the
  ranks or the mesh's model axis, is refused before any rank starts.
"""
import dataclasses
import math
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import torch_ranks as TR
from repro.configs import get_smoke_config as j_smoke_config
from repro.models.sharding import enforce_divisible as j_enforce_divisible
from repro_torch.core.engine import identical_trajectories
from repro_torch.core.substrates.eval_backend import bucket_size
from repro_torch.core.substrates.lm_loss import (LmLossEvalBackend,
                                                 make_lm_workload,
                                                 reckon_model_ranks)
from repro_torch.core.substrates.pod_mesh import PodMeshEvalBackend
from repro_torch.launch import anm_lm, dryrun, ranks
from repro_torch.launch.mesh import Mesh, virtual_devices
from repro_torch.models import sharding
from repro_torch.server.sim import lm_problem

ENV = dict(os.environ, OMP_NUM_THREADS="1")
AXES = ("data", "model")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(tmp_path, target, world, **kwargs):
    res = ranks.run(target, kwargs, world=world, backend="gloo",
                    devices=["cpu"] * world,
                    workdir=str(tmp_path / "ranks"), timeout=180, env=ENV)
    assert res.returncode == 0, res.failed
    return res.docs


def _one_process(shape):
    return Mesh(shape, AXES, virtual_devices(math.prod(shape), "cpu"))


# -- act 1 over the LM loss on (2, 2) ----------------------------------------

def _by_hand(arch, cfg, params, shape, model_ranks, k) -> dict:
    """A rank's chart counts from the parameters' own leaves and the
    reference's ``enforce_divisible`` on its smoke configuration: a leaf
    whose spec names ``model`` is stored and handed as numel / M ×
    (itemsize + 4k) bytes a bucket in two all-gathers, any other stored
    whole."""
    specs, _ = j_enforce_divisible(
        dataclasses.replace(j_smoke_config(arch), dtype=cfg.dtype),
        _one_process(shape))
    flat = {"/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                     for e in kp): spec
            for kp, spec in jax.tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda x: isinstance(x, PartitionSpec))}
    out = dict(stored_bytes=0, gather_bytes=0, gathers=0)
    for path, leaf in sharding.spec_leaves(params):
        size = leaf.numel() * (leaf.element_size() + 4 * k)
        if "model" in tuple(flat[path]):
            out["stored_bytes"] += size // model_ranks
            out["gather_bytes"] += size // model_ranks
            out["gathers"] += 2
        else:
            out["stored_bytes"] += size
    return out


def test_act1_over_a_two_by_two_grid_commits_the_in_process_iterates(
        monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")          # the ranks' too
    search, fleet, wl = lm_problem(arch="rwkv6-7b", device="cpu")
    m = search.anm.m_regression
    sync, _, _ = anm_lm.run(search, fleet, anm_lm.warmed_backend(wl, m),
                            pipelined=False)
    pod = anm_lm.warmed_backend(wl, m, mesh=_one_process((16, 16)))
    lanes0 = pod.lanes_evaluated
    on_pod, _, _ = anm_lm.run(search, fleet, pod)
    lanes = pod.lanes_evaluated - lanes0
    assert identical_trajectories(on_pod, sync)
    grid = Mesh.over_ranks((16, 16), AXES, rank=0, rank_devices=["cpu"] * 4,
                           model_ranks=2)
    want = _by_hand(wl.arch, wl.cfg, wl.proj.theta0, (16, 16), 2, wl.k)
    assert reckon_model_ranks(wl.cfg, grid, wl.k) == want
    assert 0 < want["gathers"] < 2 * len(sharding.spec_leaves(
        wl.proj.theta0))
    rep = dryrun.over_ranks(
        "repro_torch.launch.dryrun:lm_grid_rank",
        dict(arch="rwkv6-7b", mesh_shape=[16, 16], axis_names=list(AXES),
             model_ranks=2), 4, "gloo", "cpu", sync,
        counts=dryrun.chart_counts(wl.cfg, grid, wl.k))
    assert rep["ranks_parity_ok"] and rep["ranks_counts_ok"], \
        rep["ranks_failed"]
    blocks = set()
    for doc in rep["per_rank"]:
        blocks.add((doc["data_block"], doc["model_block"]))
        assert doc["model_ranks"] == 2 and doc["data_shards"] == 8
        assert doc["lanes"] * 2 == lanes
        assert doc["new_shapes_after_warm"] == 0
        assert doc["chart_freed"]
        n = doc["gathered_buckets"]
        assert n > 0
        assert doc["stored_bytes"] == want["stored_bytes"]
        assert doc["model_gather_bytes"] == n * want["gather_bytes"]
        assert doc["model_gathers"] == n * want["gathers"]
    assert blocks == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_the_counts_gate_fails_a_leg_whose_counts_differ():
    """``over_ranks``' parity needs the reckoned counts as well as the
    iterates: a rank that stored a byte more fails it."""
    search, fleet, wl = lm_problem(arch="rwkv6-7b", device="cpu")
    grid = Mesh.over_ranks((16, 16), AXES, rank=0, rank_devices=["cpu"] * 4,
                           model_ranks=2)
    ok = dryrun.chart_counts(wl.cfg, grid, wl.k)
    want = reckon_model_ranks(wl.cfg, grid, wl.k)
    doc = dict(stored_bytes=want["stored_bytes"], gathered_buckets=3,
               model_gather_bytes=3 * want["gather_bytes"],
               model_gathers=3 * want["gathers"], chart_freed=True)
    assert ok(doc)
    assert not ok(dict(doc, stored_bytes=want["stored_bytes"] + 1))
    assert not ok(dict(doc, model_gathers=doc["model_gathers"] - 1))
    assert not ok(dict(doc, chart_freed=False))


# -- the SDSS pod backend over (2, 2) ----------------------------------------

@pytest.mark.parametrize("shape", [(2, 2), (16, 16)])
def test_sdss_bucket_values_over_a_two_by_two_grid_equal_one_process(
        tmp_path, shape):
    f_batch, n = TR.quad_fitness()
    one = PodMeshEvalBackend(f_batch, mesh=_one_process(shape), device="cpu")
    docs = _run(tmp_path, "torch_ranks:bucket_values", 4,
                mesh_shape=list(shape), model_ranks=2)
    for doc in docs:
        assert doc["local_shards"] == shape[0] // 2
        assert doc["positions"] == shape[0] * shape[1] // 4
        for k in TR.KS:
            h = one.submit(TR.points(k, n))
            want = one.collect(h)
            assert doc["kp"][str(k)] == h.kp
            np.testing.assert_array_equal(doc["values"][str(k)], want)


def test_sdss_grid_over_a_two_by_two_grid_commits_the_in_process_iterates(
        tmp_path):
    want = TR.in_process_grid()
    docs = _run(tmp_path, "torch_ranks:grid_run", 4, mesh_shape=[16, 16],
                model_ranks=2)
    lanes = {doc.pop("lanes") for doc in docs}
    assert len(lanes) == 1 and lanes.pop() > 0    # a model group's twins
    for doc in docs:
        assert doc.pop("new_shapes") == 0
        assert doc == want


# -- the card's (p1) rank function at smoke size -----------------------------

def test_points_in_given_buckets_over_model_ranks_equal_in_process(
        tmp_path):
    kw = dict(arch="rwkv6-7b", k=2, seed=3, seq_len=32)
    pts = np.random.default_rng(35).uniform(-0.3, 0.3, (13, 2))
    buckets = [pts[:8], pts[8:]]
    wl = make_lm_workload(device="cpu", **kw)
    one = LmLossEvalBackend(wl)
    want = [one(b).tolist() for b in buckets]
    grid = Mesh.over_ranks((1, 2), AXES, rank=0, rank_devices=["cpu"] * 2,
                           model_ranks=2)
    reckoned = reckon_model_ranks(wl.cfg, grid, 2)
    docs = _run(tmp_path, "repro_torch.launch.dryrun:lm_points_rank", 2,
                mesh_shape=[1, 2], axis_names=list(AXES), model_ranks=2,
                buckets=[b.tolist() for b in buckets], **kw)
    for r, doc in enumerate(docs):
        assert (doc["data_block"], doc["model_block"]) == (0, r)
        assert doc["chart_freed"]
        assert doc["stored_bytes"] == reckoned["stored_bytes"]
        assert doc["gathered_buckets"] == 2
        for b, values in zip(doc["buckets"], want):
            assert b["values"] == values
            assert b["gather_bytes"] == reckoned["gather_bytes"]
            assert b["gathers"] == reckoned["gathers"]
        assert [len(b["values"]) for b in doc["buckets"]] == [8, 5]
        assert bucket_size(5) == 8


# -- Sharded over model ranks ------------------------------------------------

@pytest.mark.parametrize("rank", range(4))
def test_a_rank_keeps_a_contiguous_copy_of_its_model_block(rank):
    """16 × 16 over (2, 2): rank r holds model columns [8·(r % 2), +8), so
    8 of a leaf's 16 model blocks, one contiguous half kept as a copy;
    the pieces are views of it, none of the source."""
    mesh = Mesh.over_ranks((16, 16), AXES, rank=rank,
                           rank_devices=["cpu"] * 4, model_ranks=2)
    x = torch.arange(6 * 32.0).reshape(6, 32)
    sh = sharding.Sharded(x, sharding.P(None, "model"), mesh)
    half = 16 * (rank % 2)
    assert sh.over_model == 1 and sh.held.is_contiguous()
    assert torch.equal(sh.held, x[:, half:half + 16])
    assert sh.held.untyped_storage().data_ptr() != \
        x.untyped_storage().data_ptr()
    assert sorted(sh.pieces) == [(0, j) for j in range(half // 2,
                                                        half // 2 + 8)]
    for (_, j), piece in sh.pieces.items():
        assert piece.untyped_storage().data_ptr() == \
            sh.held.untyped_storage().data_ptr()
        assert torch.equal(piece, x[:, 2 * j:2 * j + 2])
    assert sh.nbytes == sh.held.numel() * 4
    whole = sharding.Sharded(x, sharding.P(), mesh)
    assert whole.over_model is None and torch.equal(whole.held, x)
    assert whole.whole() is whole.held


def test_a_leaf_also_cut_over_data_ranks_is_not_gathered():
    mesh = Mesh.over_ranks((16, 16), AXES, rank=3, rank_devices=["cpu"] * 4,
                           model_ranks=2)
    x = torch.zeros(32, 32)
    sh = sharding.Sharded(x, sharding.P("data", "model"), mesh)
    with pytest.raises(ValueError, match="holds 64 of the 256 blocks"):
        sh.gather()


# -- the dry-run's refusals --------------------------------------------------

@pytest.mark.parametrize("argv,message", [
    (["--model-ranks", "2"], "--model-ranks runs with --ranks"),
    (["--ranks", "4", "--model-ranks", "3"],
     "4 ranks do not divide into model groups of 3"),
    (["--ranks", "3", "--model-ranks", "3"],
     "a model axis of 16 does not divide over 3 ranks"),
    (["--ranks", "6", "--model-ranks", "2"],
     "a data axis of 16 does not divide over 3 ranks"),
], ids=["no-ranks", "m-not-dividing-n", "model-axis", "data-axis"])
@pytest.mark.parametrize("substrate", ["lm_subspace", "pod_mesh"])
def test_the_dryrun_refuses_a_model_rank_count_before_any_rank_starts(
        capsys, substrate, argv, message):
    with pytest.raises(SystemExit):
        dryrun.main(["--substrate", substrate, "--device", "cpu"] + argv)
    assert message in capsys.readouterr().err
