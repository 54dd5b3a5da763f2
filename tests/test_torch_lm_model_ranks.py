"""The LM-loss backend with the mesh's model axis cut over ranks, on the
CPU with 2 and 4 gloo ranks (``Mesh.over_ranks(model_ranks=2)``).

The reference's smoke workloads (danube and rwkv6, bf16 and f32, built
in a subprocess as ``test_torch_lm_ranks.py`` builds them) are carried
across and written for the ranks to read.  On (1, 2) over 2 ranks and
(2, 2) over 4, each rank keeps a contiguous copy of its model block of
every cut leaf of θ0 and the basis, drops the workload's whole chart,
and before each bucket all-gathers the cut leaves over its model group;
the ranks of a model group score the same data block's lanes.  Held:

* every rank's lanes equal the port's one-process backend on the same
  mesh shape over virtual devices, bit for bit, and lie within the
  reference's in-process losses (bf16 2e-2, f32 1e-4);
* the port's (1, 2) lanes lie within the same tolerances of the
  reference's own model-cut pod route (``shard_map`` with a tiled
  all-gather over ``model``) on a (1, 2) mesh over 2 forced host
  devices, run in the same subprocess;
* no piece shares storage with the workload's tensors, the whole chart
  is freed once the rank drops the workload, no tensor as large as the
  (k, P) basis lives between buckets, and ``lane_loss`` names
  ``submit`` / ``__call__``;
* the stored bytes and the bytes and all-gathers a bucket hands equal a
  count by hand from the reference's own ``enforce_divisible``, and
  ``lm_loss.reckon_model_ranks``.
"""
import dataclasses
import json
import math
import os
import pickle
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import get_smoke_config as j_smoke_config
from repro.models.sharding import enforce_divisible as j_enforce_divisible
from repro_torch.convert import lm_workload_from_reference
from repro_torch.core.substrates.lm_loss import (LmLossEvalBackend,
                                                 reckon_model_ranks)
from repro_torch.launch import ranks
from repro_torch.launch.mesh import Mesh, virtual_devices

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("h2o-danube-3-4b", "rwkv6-7b")
DTYPES = ("bfloat16", "float32")
LOSS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
K = 4
#: grid -> (mesh shape, ranks); both cut the model axis over 2 ranks
GRIDS = {"1x2": ([1, 2], 2), "2x2": ([2, 2], 4)}
ENV = dict(os.environ, OMP_NUM_THREADS="1")
CASES = [(arch, dtype) for arch in ARCHS for dtype in DTYPES]
#: the seeded points each backend scores: one bucket of 8, the floor
N_POINTS = 5

#: the reference's side for one arch, in a subprocess with 2 forced host
#: devices: its smoke workloads (f32: ``test_torch_lm_ranks.
#: _ref_workload``'s re-draw) pickled for the port, then each one's
#: in-process lanes and its pod route's on a (1, 2) mesh, both over the
#: same seeded points
_REFERENCE = """
import json, os, pickle, sys
import jax, numpy as np
sys.path.insert(0, {tests!r})
from test_torch_lm_ranks import _carry_args, _ref_workload
from repro.core.substrates.lm_loss import LmLossEvalBackend
out_dir, arch = {out!r}, {arch!r}
wls, base = {{}}, None
for dtype in {dtypes!r}:
    wl = base = _ref_workload(arch, dtype, base)
    with open(os.path.join(out_dir, f"{{arch}}-{{dtype}}.pkl"), "wb") as f:
        pickle.dump(_carry_args(wl), f)
    wls[dtype] = wl
open(os.path.join(out_dir, f"{{arch}}.carried"), "w").close()
mesh = jax.make_mesh((1, 2), ("data", "model"), devices=jax.devices()[:2])
values = {{}}
for dtype, wl in wls.items():
    pts = np.random.default_rng(5).uniform(-0.3, 0.3, ({n}, wl.k))
    values[f"{{arch}}-{{dtype}}"] = {{
        "in_process": LmLossEvalBackend(wl)(pts).tolist(),
        "pod": LmLossEvalBackend(wl, mesh=mesh)(pts).tolist()}}
with open(os.path.join(out_dir, f"{{arch}}.json"), "w") as f:
    json.dump(values, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocesses started, one an arch; once they have
    pickled the workloads, the ranks on each grid and the port's
    one-process backend on each mesh shape, while they score their
    lanes.  Returns (carry arguments, reference values, rank docs by
    grid, one-process values by grid)."""
    out = tmp_path_factory.mktemp("reference")
    env = dict(ENV, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    procs = {}
    for arch in ARCHS:
        script = _REFERENCE.format(tests=os.path.join(ROOT, "tests"),
                                   out=str(out), arch=arch, dtypes=DTYPES,
                                   n=N_POINTS)
        with open(out / f"{arch}.log", "w") as f:
            procs[arch] = subprocess.Popen([sys.executable, "-c", script],
                                           env=env, stdout=f,
                                           stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 300
        for arch, proc in procs.items():
            while not (out / f"{arch}.carried").exists():
                assert proc.poll() is None, \
                    (out / f"{arch}.log").read_text()[-4000:]
                assert time.monotonic() < deadline, "no workloads carried"
                time.sleep(0.2)
        names = {f"{a}-{d}": str(out / f"{a}-{d}.pkl") for a, d in CASES}
        docs, one = {}, {}
        for grid, (shape, world) in GRIDS.items():
            res = ranks.run("torch_ranks:lm_model_lanes",
                            {"workloads": names, "mesh_shape": shape,
                             "model_ranks": 2, "n_points": N_POINTS},
                            world=world, backend="gloo",
                            devices=["cpu"] * world,
                            workdir=str(out / f"ranks_{grid}"), timeout=180,
                            env=ENV)
            assert res.returncode == 0, res.failed
            docs[grid] = res.docs
        carried = {}
        for name, path in names.items():
            with open(path, "rb") as f:
                carried[name] = pickle.load(f)
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            for grid, (shape, _) in GRIDS.items():
                mesh = Mesh(shape, ("data", "model"),
                            virtual_devices(math.prod(shape), "cpu"))
                for name, args in carried.items():
                    wl = lm_workload_from_reference(**args, device="cpu")
                    pts = np.random.default_rng(5).uniform(
                        -0.3, 0.3, (N_POINTS, wl.k))
                    one[grid, name] = LmLossEvalBackend(wl, mesh=mesh)(pts)
        finally:
            torch.set_num_threads(n)
        for arch, proc in procs.items():
            assert proc.wait(timeout=300) == 0, \
                (out / f"{arch}.log").read_text()[-4000:]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    reference = {}
    for arch in ARCHS:
        reference.update(json.loads((out / f"{arch}.json").read_text()))
    return carried, reference, docs, one


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("arch,dtype", CASES)
def test_rank_lanes_equal_one_process_and_track_the_reference(
        runs, arch, dtype, grid):
    _, reference, docs, one = runs
    name = f"{arch}-{dtype}"
    want = one[grid, name]
    shape, world = GRIDS[grid]
    for doc in docs[grid]:
        got = np.array(doc[name]["values"])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, reference[name]["in_process"],
                                   rtol=LOSS_TOL[dtype])
        # the points' bucket of 8, a data block's share a rank
        assert doc[name]["lanes"] == 8 // shape[0]


@pytest.mark.parametrize("arch,dtype", CASES)
def test_model_rank_lanes_track_the_reference_model_cut_pod_route(
        runs, arch, dtype):
    """The reference's pod route on its own (1, 2) mesh gathers each
    shard's leaves over ``model`` inside ``shard_map``; the port's ranks
    on (1, 2) lie within the model tests' tolerance of its lanes."""
    _, reference, docs, _ = runs
    name = f"{arch}-{dtype}"
    ref_pod = np.array(reference[name]["pod"])
    np.testing.assert_allclose(ref_pod, reference[name]["in_process"],
                               rtol=LOSS_TOL[dtype])
    for doc in docs["1x2"]:
        np.testing.assert_allclose(doc[name]["values"], ref_pod,
                                   rtol=LOSS_TOL[dtype])


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("arch,dtype", CASES)
def test_a_rank_keeps_only_its_pieces(runs, arch, dtype, grid):
    """No piece is a view of the workload's tensors; once the rank drops
    the workload its θ0 and basis are freed, and no tensor as large as
    the (k, P) basis lives after the build or after a bucket; the cut
    basis leaves hold 1 block a rank (a model axis of 2 over 2 ranks);
    ``lane_loss`` points to the bucket route."""
    _, _, docs, _ = runs
    name = f"{arch}-{dtype}"
    for doc in docs[grid]:
        d = doc[name]
        assert not d["shares_whole"] and d["chart_freed"]
        assert d["large_built"] == [] and d["large_after"] == []
        assert "submit / __call__" in d["lane_loss"]


def _by_hand(args: dict, shape: list) -> dict:
    """A rank's chart counts on ``shape`` over model groups of 2, from the
    carried θ0's leaves and the reference's ``enforce_divisible`` on its
    own configuration: a leaf whose spec names ``model`` is stored and
    handed as numel / 2 × (itemsize + 4k) bytes a bucket in two
    all-gathers, any other stored whole."""
    cfg = dataclasses.replace(j_smoke_config(args["arch"]),
                              dtype=args["cfg"]["dtype"])
    mesh = Mesh(shape, ("data", "model"),
                virtual_devices(math.prod(shape), "cpu"))
    specs, _ = j_enforce_divisible(cfg, mesh)
    flat = {"/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                     for e in kp): spec
            for kp, spec in jax.tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda x: isinstance(x, PartitionSpec))}
    item = torch.empty((), dtype=getattr(torch, args["cfg"]["dtype"])
                       ).element_size()
    k = args["k"]
    out = dict(stored_bytes=0, gather_bytes=0, gathers=0)
    for path, leaf in args["theta0"].items():
        size = leaf.size * (item + 4 * k)
        if "model" in tuple(flat[path]):
            out["stored_bytes"] += size // 2
            out["gather_bytes"] += size // 2
            out["gathers"] += 2
        else:
            out["stored_bytes"] += size
    return out


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("arch,dtype", CASES)
def test_stored_and_gathered_bytes_equal_a_count_by_hand(runs, arch, dtype,
                                                         grid):
    carried, _, docs, _ = runs
    name = f"{arch}-{dtype}"
    shape, world = GRIDS[grid]
    want = _by_hand(carried[name], shape)
    assert want["gathers"] > 0
    mesh = Mesh.over_ranks(shape, ("data", "model"), rank=0,
                           rank_devices=["cpu"] * world, model_ranks=2)
    cfg = lm_workload_from_reference(**carried[name], device="cpu").cfg
    assert reckon_model_ranks(cfg, mesh, K) == want
    for doc in docs[grid]:
        d = doc[name]
        assert d["gathered_buckets"] == 1
        assert d["stored_bytes"] == want["stored_bytes"]
        assert d["model_gather_bytes"] == want["gather_bytes"]
        assert d["model_gathers"] == want["gathers"]
