"""Rank bodies for the tests of meshes over ranks (``launch/ranks.py``).

Each function here runs in a rank, a child process forked from the
port's forkserver, as ``target(group, **kwargs)``: it imports torch and
the port only (no jax, no reference), builds its inputs from seeds, and
returns a JSON doc.  The tests compare the docs with the one-process
backends and with the reference.
"""
import gc
import os
import pickle
import signal
import weakref

import numpy as np
import torch

from repro_torch.core.anm import AnmConfig
from repro_torch.core.engine import AnmEngine
from repro_torch.core.grid import GridConfig
from repro_torch.core.substrates.batched_grid import BatchedVolunteerGrid
from repro_torch.core.substrates.eval_backend import InProcessEvalBackend
from repro_torch.core.substrates.pod_mesh import (PodMeshEvalBackend,
                                                  make_data_mesh)
from repro_torch.launch import dryrun
from repro_torch.models import sharding

#: the bucket widths the value tests evaluate
KS = (1, 5, 8, 13, 64, 100)


def quad_fitness(n=8, seed=3):
    """``tests/test_torch_pod_mesh.py``'s toy fitness, ½ dᵀHd in
    elementwise steps, each row on its own (ROADMAP note (a)); returns
    (f_batch, n)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)).astype(np.float32)
    H = torch.from_numpy(A @ A.T + n * np.eye(n, dtype=np.float32))
    x_opt = torch.from_numpy(rng.uniform(-0.5, 0.5, n).astype(np.float32))

    def f_batch(xs):
        d = xs - x_opt[None, :]
        hd = sum(d[:, j, None] * H[j][None, :] for j in range(n))
        return 0.5 * sum(hd[:, i] * d[:, i] for i in range(n))
    return f_batch, n


def points(k, n):
    """The seeded block of ``k`` points the value tests submit."""
    return np.random.default_rng(k).uniform(-2, 2, (k, n))


def run_grid(f_batch, n, backend, m=48, iters=4):
    """``tests/test_torch_pod_mesh.py``'s pipelined grid run at m = 48;
    returns (engine, grid stats)."""
    cfg = AnmConfig(m_regression=m, m_line_search=m, max_iterations=iters)
    grid_cfg = GridConfig(n_hosts=256, failure_prob=0.1, malicious_prob=0.02,
                          seed=3)
    engine = AnmEngine(np.ones(n), -10 * np.ones(n), 10 * np.ones(n),
                       0.5 * np.ones(n), cfg, seed=7, device="cpu")
    stats = BatchedVolunteerGrid(f_batch, grid_cfg, backend=backend,
                                 pipelined=True).run(engine)
    return engine, stats


def grid_doc(engine, stats) -> dict:
    return dict(dryrun.engine_doc(engine), sim_time=stats.sim_time,
                completed=stats.completed)


def bucket_values(group, *, mesh_shape, model_ranks=1):
    """The pod backend on the mesh ``mesh_shape`` over the group (its
    model axis over groups of ``model_ranks``): each of ``KS``' blocks
    submitted, and its bucket's width and values; and the shape of
    ``make_data_mesh`` with the group up."""
    data_mesh = make_data_mesh("cpu")
    f_batch, n = quad_fitness()
    pod = PodMeshEvalBackend(
        f_batch, mesh=group.mesh(mesh_shape, model_ranks=model_ranks),
        device="cpu")
    out = {"min_bucket": pod.min_bucket, "local_shards": pod.local_shards,
           "positions": len(pod.mesh.local_positions()), "values": {},
           "kp": {}, "data_mesh": list(data_mesh.shape.values()),
           "data_mesh_spans": data_mesh.spans_ranks}
    handles = [pod.submit(points(k, n)) for k in KS]   # all in flight
    for k, h in zip(KS, handles):
        out["values"][k] = pod.collect(h).tolist()
        out["kp"][k] = h.kp
    return out


def grid_run(group, *, mesh_shape, model_ranks=1):
    """The pipelined grid over the pod backend on ``mesh_shape`` over the
    group (its model axis over groups of ``model_ranks``), warmed
    first."""
    f_batch, n = quad_fitness()
    pod = PodMeshEvalBackend(
        f_batch, mesh=group.mesh(mesh_shape, model_ranks=model_ranks),
        n_dims=n, max_bucket=128, device="cpu")
    warmed = pod.compile_count
    doc = grid_doc(*run_grid(f_batch, n, pod))
    return dict(doc, new_shapes=pod.compile_count - warmed,
                lanes=pod.lanes_evaluated)


def in_process_grid():
    """The same grid through the in-process backend, in this process."""
    f_batch, n = quad_fitness()
    return grid_doc(*run_grid(f_batch, n,
                              InProcessEvalBackend(f_batch, device="cpu")))


def lm_lanes(group, *, workload, mesh_shape, n_points=19):
    """The LM backend on a workload the test wrote (``workload``: a
    pickle of ``convert.lm_workload_from_reference``'s arguments) on the
    mesh over the group: each lane's loss over ``n_points`` seeded
    points, and what the rank held."""
    from repro_torch.convert import lm_workload_from_reference
    from repro_torch.core.substrates.lm_loss import LmLossEvalBackend

    with open(workload, "rb") as f:
        wl = lm_workload_from_reference(**pickle.load(f), device="cpu")
    pod = LmLossEvalBackend(wl, mesh=group.mesh(mesh_shape))
    pts = np.random.default_rng(5).uniform(-0.3, 0.3, (n_points, wl.k))
    return {"values": pod(pts).tolist(), "lanes": pod.lanes_evaluated,
            "batch_pieces": [len(s.pieces) for s in pod._batch.values()],
            "basis_whole": all(
                p.untyped_storage().data_ptr()
                == wl.proj.basis.untyped_storage().data_ptr()
                for p in _pieces(pod._basis))}


def lm_model_lanes(group, *, workloads, mesh_shape, model_ranks,
                   n_points=19):
    """The LM backend on each workload the test wrote (``workloads``: name
    -> a pickle of ``convert.lm_workload_from_reference``'s arguments) on
    the mesh over the group, its model axis over groups of
    ``model_ranks``: each lane's loss over ``n_points`` seeded points,
    whether a piece shares storage with the workload's whole tensors,
    whether the whole chart is freed once the workload is dropped,
    tensors as large as the basis still alive after the backend is built
    and after its bucket, and the chart counts."""
    from repro_torch.convert import lm_workload_from_reference
    from repro_torch.core.substrates.lm_loss import LmLossEvalBackend

    out = {}
    for name, path in workloads.items():
        with open(path, "rb") as f:
            wl = lm_workload_from_reference(**pickle.load(f), device="cpu")
        wholes = [wl.proj.basis] + [x for _, x in
                                    sharding.spec_leaves(wl.proj.theta0)]
        refs = [weakref.ref(x) for x in wholes]
        ptrs = {x.untyped_storage().data_ptr() for x in wholes}
        pod = LmLossEvalBackend(wl, mesh=group.mesh(mesh_shape,
                                                    model_ranks=model_ranks))
        shares = any(p.untyped_storage().data_ptr() in ptrs
                     for p in _pieces({"t": pod._theta, "b": pod._basis}))
        size = wl.k * wl.proj.n_params * 4
        pts = np.random.default_rng(5).uniform(-0.3, 0.3, (n_points, wl.k))
        del wl, wholes
        gc.collect()
        built = _as_large(size)
        values = pod(pts).tolist()
        gc.collect()
        out[name] = dict(
            values=values, lanes=pod.lanes_evaluated, shares_whole=shares,
            chart_freed=all(r() is None for r in refs),
            large_built=built, large_after=_as_large(size),
            stored_bytes=pod.stored_bytes,
            model_gather_bytes=pod.model_gather_bytes,
            model_gathers=pod.model_gathers,
            gathered_buckets=pod.gathered_buckets,
            pieces=sum(len(sh.pieces) for _, sh in
                       sharding.spec_leaves(pod._basis)))
        try:
            pod.lane_loss(torch.zeros(len(pts[0])))
            out[name]["lane_loss"] = "scored"
        except RuntimeError as e:
            out[name]["lane_loss"] = str(e)
    return out


def _as_large(nbytes):
    """The shapes of live tensors whose storage holds ``nbytes`` or
    more."""
    return [list(o.shape) for o in gc.get_objects()
            if isinstance(o, torch.Tensor)
            and o.untyped_storage().nbytes() >= nbytes]


def _pieces(tree):
    if isinstance(tree, dict):
        for sub in tree.values():
            yield from _pieces(sub)
    elif isinstance(tree, list):
        for sub in tree:
            yield from _pieces(sub)
    else:
        yield from tree.pieces.values()


def killed_mid_run(group, *, mesh_shape, marker):
    """Rank 1 SIGKILLs itself after its first bucket; rank 0 runs on into
    the next all-gather, which never completes.  Rank 0 writes its pid to
    ``marker`` first, so the test can see it gone."""
    with open(f"{marker}.{group.rank}", "w") as f:
        f.write(str(os.getpid()))
    f_batch, n = quad_fitness()
    pod = PodMeshEvalBackend(f_batch, mesh=group.mesh(mesh_shape),
                             device="cpu")
    pod(points(8, n))
    if group.rank == 1:
        os.kill(os.getpid(), signal.SIGKILL)
    for k in range(1, 1000):
        pod(points(k % 64 + 1, n))
    return {}
