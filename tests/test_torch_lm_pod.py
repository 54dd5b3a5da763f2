"""The port's LM-loss backend on a mesh (its ``mesh=`` route) on the CPU.

The reference's pod route (``repro/core/substrates/lm_loss.py:164-229``)
shards lanes over ``data`` and stores θ0 and the subspace basis cut over
``model`` with the model's own ``param_specs`` after
``enforce_divisible``, gathering the whole leaves back before a shard
evaluates its lanes.  Here, port against port at smoke size, on the
(1, 1) mesh and on virtual meshes of 2 and 16 data shards: lane values
bit-equal to in-process, the stored pieces views of the workload's own
tensors, act 1 pipelined on the 16 × 16 mesh == in-process sync with no
bucket shape first run after ``warm``, and the work server on the pod
backend == in-process (the reference dryrun's ``run_lm_subspace_smoke``
gates 1 and 3).  Against the reference: ``spec_fallbacks`` equal its
``enforce_divisible`` on the same configuration and mesh shape, and the
pod lanes give its in-process backend's losses within 2e-2 relative (the
bf16 tolerance of the model tests).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke_config
from repro.core.substrates.lm_loss import LmLossEvalBackend as JBackend
from repro.core.substrates.lm_loss import make_lm_workload as j_workload
from repro.models.sharding import enforce_divisible as j_enforce_divisible
from repro.server.sim import lm_problem as j_lm_problem
from repro_torch.convert import lm_workload_from_reference
from repro_torch.core.engine import identical_trajectories
from repro_torch.core.substrates.eval_backend import bucket_size
from repro_torch.core.substrates.lm_loss import LmLossEvalBackend
from repro_torch.launch import anm_lm
from repro_torch.launch.mesh import Mesh, make_production_mesh, virtual_devices
from repro_torch.models import sharding
from repro_torch.server.sim import ServerSubstrate, lm_problem, result_doc

ARCHS = ("h2o-danube-3-4b", "rwkv6-7b")
MESHES = {
    "host_1x1": lambda: Mesh((1, 1), ("data", "model"), ["cpu"]),
    "virtual_2x1": lambda: Mesh((2, 1), ("data", "model"),
                                virtual_devices(2, "cpu")),
    "virtual_16x16": lambda: make_production_mesh(
        devices=virtual_devices(256, "cpu")),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PROBLEMS = {}


def _problem(arch):
    """``lm_problem``'s act-1 search on ``arch`` on the CPU (shared, read
    only: each test builds its own backends)."""
    if arch not in _PROBLEMS:
        _PROBLEMS[arch] = lm_problem(arch=arch, device="cpu")
    return _PROBLEMS[arch]


def _carry(wl):
    """The port's copy of a reference ``LmWorkload``, on the CPU."""
    theta0 = {"/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                       for e in kp): np.asarray(x, np.float32)
              for kp, x in jax.tree_util.tree_leaves_with_path(
                  wl.proj.theta0)}
    return lm_workload_from_reference(
        arch=wl.arch, cfg=dataclasses.asdict(wl.cfg), theta0=theta0,
        basis=np.asarray(wl.proj.basis), batch=wl.batch, k=wl.k,
        coeff_bound=wl.coeff_bound, seed=wl.seed, device="cpu")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_pod_lanes_equal_in_process(arch, mesh_name):
    _, _, wl = _problem(arch)
    pod = LmLossEvalBackend(wl, mesh=MESHES[mesh_name]())
    assert pod.n_shards == pod.mesh.shape["data"]
    assert pod.min_bucket == bucket_size(pod.n_shards)
    pts = np.random.default_rng(5).uniform(-0.3, 0.3, (19, wl.k))
    np.testing.assert_array_equal(LmLossEvalBackend(wl)(pts), pod(pts))


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_fallbacks_equal_the_reference(arch):
    """The same downgrades, leaf by leaf, as the reference's
    ``enforce_divisible`` on its own smoke configuration and a mesh of the
    same shape; the parameters stored cut over ``model`` are the leaves
    whose surviving spec names it."""
    _, _, wl = _problem(arch)
    mesh = MESHES["virtual_16x16"]()
    pod = LmLossEvalBackend(wl, mesh=mesh)
    _, want = j_enforce_divisible(j_smoke_config(arch), mesh)
    assert pod.spec_fallbacks == want and want
    specs, _ = sharding.enforce_divisible(wl.cfg, mesh)
    cut = sum(p.numel() for (_, s), (_, p) in zip(
        sharding.spec_leaves(specs),
        sharding.spec_leaves(wl.proj.theta0)) if "model" in s)
    assert pod.sharded_params == (cut, wl.proj.n_params)
    assert 0 < cut < wl.proj.n_params


@pytest.mark.parametrize("arch", ARCHS)
def test_stored_pieces_are_views_of_the_workload(arch):
    """On a virtual mesh θ0 and the basis are stored as pieces that are
    views of the workload's own tensors: the storage costs no memory; the
    cut leaves really are cut 16 ways."""
    _, _, wl = _problem(arch)
    pod = LmLossEvalBackend(wl, mesh=MESHES["virtual_16x16"]())
    base = wl.proj.basis.untyped_storage().data_ptr()
    n_cut = 0
    for _, sh in sharding.spec_leaves(pod._basis):
        assert all(p.untyped_storage().data_ptr() == base
                   for p in sh.pieces.values())
        n_cut += len(sh.pieces) == 16
    assert n_cut > 0
    for (_, sh), (_, leaf) in zip(sharding.spec_leaves(pod._theta),
                                  sharding.spec_leaves(wl.proj.theta0)):
        ptr = leaf.untyped_storage().data_ptr()
        assert all(p.untyped_storage().data_ptr() == ptr
                   for p in sh.pieces.values())
        assert torch.equal(sh.gather(), leaf)


def test_pod_over_distinct_devices_is_refused():
    _, _, wl = _problem("rwkv6-7b")
    mesh = Mesh((2, 1), ("data", "model"),
                [torch.device("cuda", 0), torch.device("cuda", 1)])
    with pytest.raises(NotImplementedError,
                       match=r"Mesh\.over_ranks\(model_ranks=\)"):
        LmLossEvalBackend(wl, mesh=mesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_pod_act1_pipelined_equals_in_process_sync(arch):
    """Gate 1 of the reference's LM smoke: in-process sync == in-process
    pipelined == pod pipelined on the 16 × 16 mesh, bit for bit, and the
    warmed pod backend runs no new bucket shape mid-search."""
    search, fleet, wl = _problem(arch)
    inp = anm_lm.warmed_backend(wl, search.anm.m_regression)
    pod = anm_lm.warmed_backend(wl, search.anm.m_regression,
                                mesh=MESHES["virtual_16x16"]())
    shapes = pod.compile_count
    sync, _, _ = anm_lm.run(search, fleet, inp, pipelined=False)
    pipe, _, _ = anm_lm.run(search, fleet, inp, pipelined=True)
    on_pod, stats, _ = anm_lm.run(search, fleet, pod, pipelined=True)
    assert pod.compile_count == shapes
    assert identical_trajectories(sync, pipe)
    assert identical_trajectories(sync, on_pod)
    assert sync.stats == on_pod.stats
    assert min(stats.bucket_hist) >= 16


def test_pod_work_server_equals_in_process():
    """Gate 3: the work server over the pod backend commits what it
    commits in-process."""
    search, fleet, wl = _problem("rwkv6-7b")
    base = result_doc(ServerSubstrate(search, fleet,
                                      LmLossEvalBackend(wl)).run())
    pod = LmLossEvalBackend(wl, mesh=MESHES["virtual_16x16"]())
    got = result_doc(ServerSubstrate(search, fleet, pod).run())
    assert got["history"] == base["history"]
    assert got["engine_stats"] == base["engine_stats"]


def test_pod_lanes_track_the_reference_backend():
    """The reference's smoke workload carried across: the port's pod
    lanes give the reference's in-process losses within 2e-2."""
    wl = j_workload("h2o-danube-3-4b", k=4, batch_size=1, seq_len=16, seed=1)
    mine = _carry(wl)
    pts = np.random.default_rng(2).uniform(-0.3, 0.3, (5, wl.k))
    be = JBackend(wl)
    want = be.collect(be.submit(pts))
    got = LmLossEvalBackend(mine, mesh=MESHES["virtual_16x16"]())(pts)
    np.testing.assert_allclose(got, want, rtol=2e-2)


_REFERENCE_TWO_SHARDS = """
import json, jax, numpy as np
from repro.server.sim import lm_problem
from repro.core.substrates.lm_loss import LmLossEvalBackend
_, _, wl = lm_problem(arch="h2o-danube-3-4b")
mesh = jax.make_mesh((2, 1), ("data", "model"), devices=jax.devices()[:2])
pts = np.random.default_rng(5).uniform(-0.3, 0.3, (4, wl.k))
print(json.dumps({"in_process": LmLossEvalBackend(wl)(pts).tolist(),
                  "pod": LmLossEvalBackend(wl, mesh=mesh)(pts).tolist()}))
"""


def test_two_shard_pod_keeps_the_whole_batch_where_the_reference_splits_it():
    """ROADMAP C: on a (2, 1) mesh ``input_specs`` shards a 2-row batch
    over ``data``, and the reference's pod route evaluates each lane on
    its shard's row alone, so its pod losses leave its in-process ones
    (run here on 2 forced host devices).  The port gathers the whole
    batch for every shard: its pod lanes equal its in-process lanes
    bitwise (``test_pod_lanes_equal_in_process``) and track the
    reference's in-process lanes, within 2e-2, not its pod lanes."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    out = subprocess.run([sys.executable, "-c", _REFERENCE_TWO_SHARDS],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    print(f"reference in-process {ref['in_process']}, pod (2, 1) "
          f"{ref['pod']}")
    ref_in, ref_pod = np.array(ref["in_process"]), np.array(ref["pod"])
    assert np.all(np.abs(ref_pod - ref_in) > 1e-3 * np.abs(ref_in))

    wl = _carry(j_lm_problem(arch="h2o-danube-3-4b")[2])
    pts = np.random.default_rng(5).uniform(-0.3, 0.3, (4, wl.k))
    pod = LmLossEvalBackend(wl, mesh=MESHES["virtual_2x1"]())
    assert pod._batch["tokens"].pieces.keys() == {(0, 0), (1, 0)}
    got = pod(pts)
    np.testing.assert_allclose(got, ref_in, rtol=2e-2)
