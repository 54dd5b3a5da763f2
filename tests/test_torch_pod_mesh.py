"""The port's pod-mesh evaluation backend and its meshes (DESIGN.md §6).

The reference's tests/test_substrates_pod_mesh.py and the pod cases of
tests/test_substrates_pipelined.py (:88, :111), port against port on the
CPU, on the degenerate (1, 1) mesh and on virtual meshes of 2 and of 16
data shards (the production 16 × 16 mesh over ``virtual_devices``): the
bucket floor of 4 rows a shard, values equal to in-process, bit-identical
committed iterates, pipelined pod == sync in-process, and no bucket shape
first run after ``warm``.  Then the port's backend against the
reference's on a (1, 1) mesh: the same bucket ladder and values within
1e-6 relative.  The toy fitness is written as elementwise steps, each row
on its own (ROADMAP note (a)): a lane's value must be its own bytes'
function for any of these contracts to hold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.substrates.pod_mesh import PodMeshEvalBackend as JPod
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro_torch.core.anm import AnmConfig
from repro_torch.core.engine import AnmEngine, identical_trajectories
from repro_torch.core.grid import GridConfig
from repro_torch.core.substrates.batched_grid import BatchedVolunteerGrid
from repro_torch.core.substrates.eval_backend import (InProcessEvalBackend,
                                                      bucket_size)
from repro_torch.core.substrates.pod_mesh import (PodMeshEvalBackend,
                                                  make_data_mesh)
from repro_torch.launch import volunteer_grid
from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh, virtual_devices)

#: the meshes every contract runs on: name -> (builder, data shards)
MESHES = {
    "host_1x1": (lambda: make_data_mesh("cpu"), 1),
    "virtual_2x1": (lambda: Mesh((2, 1), ("data", "model"),
                                 virtual_devices(2, "cpu")), 2),
    "virtual_16x16": (lambda: make_production_mesh(
        devices=virtual_devices(256, "cpu")), 16),
}


def _quad_fitness(n=8, seed=3, record=None):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)).astype(np.float32)
    H_np = A @ A.T + n * np.eye(n, dtype=np.float32)
    x_np = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    H, x_opt = torch.from_numpy(H_np), torch.from_numpy(x_np)

    def f_batch(xs):
        # ½ dᵀHd in elementwise steps, each row on its own
        if record is not None:
            record.append(xs.shape[0])
        d = xs - x_opt[None, :]
        hd = sum(d[:, j, None] * H[j][None, :] for j in range(n))
        return 0.5 * sum(hd[:, i] * d[:, i] for i in range(n))

    def j_f_batch(xs):
        d = xs - jnp.asarray(x_np)[None, :]
        Hj = jnp.asarray(H_np)
        hd = sum(d[:, j, None] * Hj[j][None, :] for j in range(n))
        return 0.5 * sum(hd[:, i] * d[:, i] for i in range(n))

    f_batch.reference = jax.jit(j_f_batch)
    return f_batch, n


def _pod(f_batch, mesh_name, **kw):
    build, _ = MESHES[mesh_name]
    return PodMeshEvalBackend(f_batch, mesh=build(), device="cpu", **kw)


def _run_grid(f_batch, n, *, pipelined, backend=None, n_hosts=256,
              tick_batch=None, m=48, iters=4, failure_prob=0.1,
              malicious_prob=0.02):
    cfg = AnmConfig(m_regression=m, m_line_search=m, max_iterations=iters)
    grid_cfg = GridConfig(n_hosts=n_hosts, failure_prob=failure_prob,
                          malicious_prob=malicious_prob, seed=3)
    engine = AnmEngine(np.ones(n), -10 * np.ones(n), 10 * np.ones(n),
                       0.5 * np.ones(n), cfg, seed=7, device="cpu")
    if backend is None:
        backend = InProcessEvalBackend(f_batch, device="cpu")
    stats = BatchedVolunteerGrid(f_batch, grid_cfg, tick_batch=tick_batch,
                                 backend=backend,
                                 pipelined=pipelined).run(engine)
    return engine, stats


# -- meshes -------------------------------------------------------------------

def test_production_mesh_needs_its_devices():
    with pytest.raises(RuntimeError, match="needs 256 devices but only 3"):
        make_production_mesh(devices=virtual_devices(3, "cpu"))
    with pytest.raises(RuntimeError, match="needs 512 devices"):
        make_production_mesh(multi_pod=True,
                             devices=virtual_devices(256, "cpu"))


def test_production_mesh_over_virtual_devices():
    mesh = make_production_mesh(devices=virtual_devices(256, "cpu"))
    assert mesh.axis_names == ("data", "model")
    assert list(mesh.shape.items()) == [("data", 16), ("model", 16)]
    assert mesh.devices.shape == (16, 16) and mesh.size == 256
    assert mesh.distinct_devices() == [torch.device("cpu")]
    pods = make_production_mesh(multi_pod=True,
                                devices=virtual_devices(512, "cpu"))
    assert list(pods.shape.items()) == [("pod", 2), ("data", 16),
                                        ("model", 16)]


def test_host_and_data_meshes_are_one_by_one_on_the_cpu():
    for mesh in (make_host_mesh("cpu"), make_data_mesh("cpu")):
        assert list(mesh.shape.items()) == [("data", 1), ("model", 1)]
        assert mesh.distinct_devices() == [torch.device("cpu")]


def test_mesh_over_distinct_devices_is_refused():
    """One process, one device: a mesh over two GPUs waits for the
    multi-GPU leg and says so, before touching either card."""
    f_batch, _ = _quad_fitness()
    mesh = Mesh((2, 1), ("data", "model"),
                [torch.device("cuda", 0), torch.device("cuda", 1)])
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        PodMeshEvalBackend(f_batch, mesh=mesh, device="cpu")


def test_mesh_on_another_device_is_refused():
    f_batch, _ = _quad_fitness()
    mesh = Mesh((1, 1), ("data", "model"), [torch.device("cuda", 0)])
    with pytest.raises(ValueError, match="lies on cuda:0"):
        PodMeshEvalBackend(f_batch, mesh=mesh, device="cpu")


def test_data_axis_must_be_a_power_of_two():
    f_batch, _ = _quad_fitness()
    mesh = Mesh((3, 1), ("data", "model"), virtual_devices(3, "cpu"))
    with pytest.raises(ValueError, match="power of two"):
        PodMeshEvalBackend(f_batch, mesh=mesh, device="cpu")


# -- bucket framing -----------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_pod_backend_bucket_floor_is_four_rows_a_shard(mesh_name):
    f_batch, _ = _quad_fitness()
    pod = _pod(f_batch, mesh_name)
    assert pod.n_shards == MESHES[mesh_name][1]
    assert pod.min_bucket == bucket_size(4 * pod.n_shards)
    assert pod.min_bucket >= pod.n_shards
    assert pod.min_bucket & (pod.min_bucket - 1) == 0


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_pod_backend_splits_each_bucket_into_shard_blocks(mesh_name):
    """Each bucket is n_shards contiguous blocks of kp / n_shards rows,
    one f_batch call each: the P(data, None) layout."""
    seen = []
    f_batch, n = _quad_fitness(record=seen)
    pod = _pod(f_batch, mesh_name)
    for k in (1, 100):
        del seen[:]
        handle = pod.submit(np.random.default_rng(k).uniform(-1, 1, (k, n)))
        pod.collect(handle)
        assert seen == [handle.kp // pod.n_shards] * pod.n_shards


# -- backend value parity -----------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_pod_backend_values_match_in_process_exactly(mesh_name):
    f_batch, n = _quad_fitness()
    inp = InProcessEvalBackend(f_batch, device="cpu")
    pod = _pod(f_batch, mesh_name)
    for k in (1, 7, 32, 200):
        pts = np.random.default_rng(k).uniform(-2, 2, (k, n))
        np.testing.assert_array_equal(inp(pts), pod(pts))


# -- end-to-end committed-iterate parity --------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_pod_and_in_process_backends_commit_identical_iterates(mesh_name):
    """Same engine seed + same grid config => bit-identical committed
    centers, fitness history, iteration counts and sim time, whichever
    backend evaluates the buckets."""
    f_batch, n = _quad_fitness()
    e_in, s_in = _run_grid(f_batch, n, pipelined=True)
    e_pod, s_pod = _run_grid(f_batch, n, pipelined=True,
                             backend=_pod(f_batch, mesh_name))
    assert identical_trajectories(e_in, e_pod)
    assert e_in.iteration == e_pod.iteration
    assert e_in.stats == e_pod.stats
    assert s_in.sim_time == s_pod.sim_time
    assert s_in.completed == s_pod.completed


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_pipelined_matches_sync_on_pod_backend(mesh_name):
    f_batch, n = _quad_fitness()
    e_pipe, _ = _run_grid(f_batch, n, pipelined=True, tick_batch=4,
                          backend=_pod(f_batch, mesh_name))
    e_sync, _ = _run_grid(f_batch, n, pipelined=False, tick_batch=4)
    assert identical_trajectories(e_pipe, e_sync)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_warmed_pod_backend_never_compiles_mid_run(mesh_name):
    """Constructing with n_dims/max_bucket runs the whole bucket ladder up
    front; a full grid run (both loop modes) adds no bucket shape."""
    f_batch, n = _quad_fitness()
    be = _pod(f_batch, mesh_name, n_dims=n, max_bucket=128)
    warmed = be.compile_count
    assert warmed > 0
    _run_grid(f_batch, n, pipelined=True, m=48, backend=be)
    _run_grid(f_batch, n, pipelined=False, m=48, backend=be)
    assert be.compile_count == warmed


# -- the port against the reference ------------------------------------------

def test_pod_backend_matches_the_reference_pod_backend():
    """The port's (1, 1) pod backend and the reference's on its host mesh:
    the same bucket for every block size, values within 1e-6 relative."""
    f_batch, n = _quad_fitness()
    pod = _pod(f_batch, "host_1x1")
    ref = JPod(f_batch.reference, mesh=j_host_mesh())
    assert pod.min_bucket == ref.min_bucket
    for k in (1, 5, 8, 13, 64, 100):
        pts = np.random.default_rng(k).uniform(-2, 2, (k, n))
        h, jh = pod.submit(pts), ref.submit(pts)
        assert h.kp == jh.kp == bucket_size(k, pod.min_bucket)
        np.testing.assert_allclose(pod.collect(h), ref.collect(jh),
                                   rtol=1e-6, atol=0)


def test_volunteer_grid_takes_either_substrate(monkeypatch):
    """The launcher's ``--substrate``: the SDSS grid on either backend
    commits the same iterates (a small fleet and stripe here)."""
    monkeypatch.setattr(volunteer_grid, "FLEET",
                        GridConfig(n_hosts=128, failure_prob=0.1,
                                   malicious_prob=0.03, seed=5))
    f_batch, x0 = volunteer_grid.make_problem(n_stars=300, device="cpu")
    runs = {}
    for name in volunteer_grid.SUBSTRATES:
        backend = volunteer_grid.make_backend(name, f_batch, device="cpu")
        assert isinstance(backend, PodMeshEvalBackend) == (name == "pod_mesh")
        runs[name], _, _ = volunteer_grid.run(f_batch, x0, m=16, iters=2,
                                              device="cpu", backend=backend)
    assert identical_trajectories(runs["in_process"], runs["pod_mesh"])
