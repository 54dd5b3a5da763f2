"""The port's LM-loss backend, subspace chart and act 1 against the JAX package.

The reference's workload (θ0, basis, batch) is carried into the port by
``convert.lm_workload_from_reference`` and both backends evaluate the
same (k,) points.  Tolerances are the model tests': the loss agrees to
2e-2 relative in bf16 (the workloads' type) and 1e-4 in f32.  The port's
own contracts are held port against port, bitwise: a lane's loss does
not depend on its bucket's width, an honest lane does not move when a
neighbour lies, no bucket shape runs first after ``warm``, and act 1
commits the same iterates pipelined and sync.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core.subspace import SubspaceProjection as JProjection
from repro.core.subspace import tree_lift as j_tree_lift
from repro.core.substrates.batched_grid import BatchedVolunteerGrid as JGrid
from repro.core.substrates.eval_backend import bucket_size as j_bucket_size
from repro.core.substrates.lm_loss import LmLossEvalBackend as JBackend
from repro.core.substrates.lm_loss import make_lm_workload as j_workload
from repro.models import transformer as JT
from repro.server.sim import lm_problem as j_lm_problem
from repro_torch.convert import lm_workload_from_reference
from repro_torch.core.engine import identical_trajectories
from repro_torch.core.subspace import orthonormal_basis
from repro_torch.core.substrates.lm_loss import (LmLossEvalBackend,
                                                 make_lm_workload,
                                                 synthetic_batch)
from repro_torch.core.tree import leaves_with_paths
from repro_torch.launch import anm_lm

ARCHS = ("h2o-danube-3-4b", "rwkv6-7b")
LOSS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
K = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_leaves(params) -> dict:
    """{leaf path: f32 numpy} of a reference parameter pytree."""
    def path(kp):
        return "/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                        for e in kp)
    return {path(kp): np.asarray(x, np.float32)
            for kp, x in jax.tree_util.tree_leaves_with_path(params)}


def carry(wl):
    """The port's copy of a reference ``LmWorkload``, on the CPU."""
    return lm_workload_from_reference(
        arch=wl.arch, cfg=dataclasses.asdict(wl.cfg),
        theta0=ref_leaves(wl.proj.theta0), basis=np.asarray(wl.proj.basis),
        batch=wl.batch, k=wl.k, coeff_bound=wl.coeff_bound, seed=wl.seed,
        device="cpu")


@functools.lru_cache(maxsize=None)
def _ref_workload(arch: str, dtype: str):
    """The reference's workload (read only: shared by the tests)."""
    wl = j_workload(arch, k=K, batch_size=1, seq_len=16, seed=1)
    if dtype == "bfloat16":
        return wl
    cfg = dataclasses.replace(wl.cfg, dtype=dtype)
    init_key, basis_key = jax.random.split(jax.random.key(1), 2)
    params = jax.jit(JT.init_params, static_argnums=0)(cfg, init_key)
    proj = JProjection.create(params, K, basis_key)
    return dataclasses.replace(wl, cfg=cfg, proj=proj)


def _ref_eval(wl, pts):
    be = JBackend(wl)
    return be.collect(be.submit(pts, np.full(len(pts), np.nan),
                                list(range(len(pts)))))


@pytest.fixture(scope="module")
def act1_problem():
    """The reference's act-1 problem (``lm_problem``'s defaults: rwkv6,
    k = 6, 2 × 32 tokens, workload seed 3)."""
    return j_lm_problem(arch="rwkv6-7b")


@pytest.fixture(scope="module")
def rwkv(act1_problem):
    """(reference workload, the port's copy, a port backend on it)."""
    wl = act1_problem[2]
    mine = carry(wl)
    return wl, mine, LmLossEvalBackend(mine)


# -- carrying a workload across -------------------------------------------

def test_carried_workload_holds_the_reference_s_values(rwkv):
    wl, mine, _ = rwkv
    assert mine.cfg.use_kernels and mine.cfg.dtype == "bfloat16"
    for path, x in leaves_with_paths(mine.proj.theta0):
        want = ref_leaves(wl.proj.theta0)[path]
        assert x.dtype == torch.bfloat16
        assert np.array_equal(x.float().numpy(), want), path
    assert np.array_equal(mine.proj.basis.numpy(), np.asarray(wl.proj.basis))
    for key in ("tokens", "labels"):
        assert np.array_equal(mine.batch[key].numpy(), wl.batch[key])
    for name in ("x0", "lo", "hi", "step"):
        assert np.array_equal(getattr(mine, name), getattr(wl, name))


def test_basis_tree_leaves_are_views_of_the_flat_basis(rwkv):
    _, mine, _ = rwkv
    basis = mine.proj.basis
    for _, leaf in leaves_with_paths(mine.proj.basis_tree):
        assert leaf.untyped_storage().data_ptr() == \
            basis.untyped_storage().data_ptr()


def test_lift_matches_the_reference_lift(rwkv):
    wl, mine, _ = rwkv
    c = np.asarray([0.3, -0.2, 0.1, 0.05, -0.4, 0.15], np.float32)
    want = ref_leaves(j_tree_lift(wl.proj.theta0, wl.proj.basis_tree, c))
    work = mine.proj.lift(torch.zeros(wl.k))            # a fresh tree
    zero = dict(leaves_with_paths(work))
    for path, x in leaves_with_paths(mine.proj.theta0):
        assert torch.equal(zero[path], x)               # lift(0) == θ0
    got = mine.proj.lift(torch.from_numpy(c), out=work)
    assert got is work
    for path, x in leaves_with_paths(got):
        # the same f32 sums up to their order, then one bf16 rounding: at
        # most one bf16 ulp apart
        np.testing.assert_allclose(x.float().numpy(), want[path],
                                   rtol=2 ** -7, atol=1e-6)


def test_port_basis_is_orthonormal():
    basis = orthonormal_basis(20_000, 6, torch.Generator().manual_seed(2),
                              "cpu")
    gram = (basis.double() @ basis.double().T).numpy()
    np.testing.assert_allclose(gram, np.eye(6), atol=1e-6)


def test_port_workload_matches_the_reference_s_shape():
    ref = _ref_workload("h2o-danube-3-4b", "bfloat16")
    mine = make_lm_workload("h2o-danube-3-4b", k=K, batch_size=1,
                            seq_len=16, seed=1, device="cpu")
    assert mine.proj.n_params == ref.proj.n_params
    assert mine.cfg == carry(ref).cfg
    batch = synthetic_batch(mine.cfg.vocab_size, 1, 16, 1)
    for key in ("tokens", "labels"):
        assert np.array_equal(batch[key], ref.batch[key])
        assert np.array_equal(mine.batch[key].numpy(), ref.batch[key])
    gram = (mine.proj.basis.double() @ mine.proj.basis.double().T).numpy()
    np.testing.assert_allclose(gram, np.eye(K), atol=1e-6)


# -- lane values against the reference backend ----------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lane_values_match_the_reference_backend(arch, dtype):
    wl = _ref_workload(arch, dtype)
    pts = np.random.default_rng(7).uniform(-0.4, 0.4, (3, K))
    pts[0] = 0.0                                        # θ0 itself
    want = _ref_eval(wl, pts)
    got = LmLossEvalBackend(carry(wl))(pts)
    assert got.shape == (3,) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL[dtype])


# -- the port's own contracts, port against port --------------------------

def test_lane_loss_does_not_depend_on_bucket_width(rwkv):
    _, mine, be = rwkv
    pts = np.random.default_rng(3).uniform(-0.5, 0.5, (20, mine.k))
    narrow = be(pts[:3])                                # bucket of 8
    wide = be(pts)                                      # bucket of 32
    assert np.array_equal(narrow, wide[:3])


def test_honest_lane_unchanged_when_a_neighbour_lies(rwkv):
    _, _, be = rwkv
    pts = np.tile(np.asarray([0.1, -0.2, 0.3, 0.0, 0.2, -0.1]), (2, 1))
    honest = be(pts, np.full(2, np.nan))
    lied = be(pts, np.asarray([np.nan, 0.4]))
    assert honest[0] == lied[0]
    assert lied[1] != honest[1] and np.isfinite(lied[1])


def test_warm_runs_every_bucket_shape_once():
    mine = carry(_ref_workload("h2o-danube-3-4b", "bfloat16"))
    be = LmLossEvalBackend(mine, n_dims=K, max_bucket=16)
    warmed = be.compile_count
    assert warmed == 2                                  # buckets 8 and 16
    rng = np.random.default_rng(0)
    for k in (1, 5, 9, 16, 3):
        be(rng.uniform(-0.3, 0.3, (k, K)))
    assert be.compile_count == warmed


# -- act 1 -----------------------------------------------------------------

def test_act1_pipelined_equals_sync_and_tracks_the_reference(act1_problem,
                                                           rwkv):
    """Act 1 on rwkv6 (examples/anm_lm.py's default arch) with the
    reference's ``lm_problem`` and seeds: the port's sync and pipelined
    searches commit bit-identical iterates and engine stats and improve on
    the start; the port's backend gives the reference's committed losses
    at the reference's committed centers."""
    spec, fleet, wl = act1_problem
    ref_backend = JBackend(
        wl, n_dims=wl.k,
        max_bucket=j_bucket_size(JGrid.warm_max_bucket(12)))
    ref_engine = spec.build_engine()
    JGrid(None, fleet, backend=ref_backend, pipelined=True).run(ref_engine)

    search, fleet_p, mine = anm_lm.lm_search(rwkv[1])
    assert dataclasses.asdict(fleet_p) == dataclasses.asdict(fleet)
    backend = anm_lm.warmed_backend(mine, m=12)
    shapes = backend.compile_count
    runs = {mode: anm_lm.run(search, fleet_p, backend, pipelined=mode)[0]
            for mode in (True, False)}
    pipe, sync = runs[True], runs[False]
    assert backend.compile_count == shapes
    assert identical_trajectories(pipe, sync)
    assert pipe.stats == sync.stats
    assert pipe.iteration == ref_engine.iteration == 2
    start = backend(np.zeros((1, mine.k)))[0]          # the loss at θ0
    assert pipe.best_fitness < start

    centers = np.stack([r.center for r in ref_engine.history])
    got = backend(centers)
    want = [r.best_fitness for r in ref_engine.history]
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL["bfloat16"])
