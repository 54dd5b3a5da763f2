"""The pod mesh's data axis over ranks: ``Mesh.over_ranks``,
``launch/ranks.py`` and ``PodMeshEvalBackend`` on a mesh over gloo ranks,
on the CPU.

Each rank is a child process forked from the port's forkserver and joined
over a ``FileStore`` under ``tmp_path`` (no port, so xdist workers never
race for one); its body is in ``tests/torch_ranks.py`` (torch and the
port only).  Port against port: bucket values over 2 and 4 ranks bitwise
equal to the one-process virtual mesh of the same data axis and to
in-process, and a pipelined grid whose every rank commits the in-process
iterates and engine stats.  Against the reference: its
``PodMeshEvalBackend`` ``shard_map``ped over 4 forced host devices (a
subprocess) and 4 port ranks, values within 1e-6 relative.  Then the
refusals (nccl on shared devices or the CPU, a data axis the ranks do not
divide), a rank SIGKILLed mid-run, the dry-run's ``--ranks``, and ranks
under an import blocker for jax and the reference.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_ranks as TR
from repro_torch.core.substrates.eval_backend import (InProcessEvalBackend,
                                                      bucket_size)
from repro_torch.core.substrates.pod_mesh import PodMeshEvalBackend
from repro_torch.launch import dryrun, ranks
from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh, virtual_devices)
from repro_torch.models import sharding

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, OMP_NUM_THREADS="1")


def _run(tmp_path, target, world, **kwargs):
    res = ranks.run(f"torch_ranks:{target}", kwargs, world=world,
                    backend="gloo", devices=["cpu"] * world,
                    workdir=str(tmp_path / "ranks"), timeout=120, env=ENV)
    assert res.returncode == 0, res.failed
    assert res.exitcodes == [0] * world
    return res.docs


def _one_process(shape):
    return Mesh(shape, ("data", "model"),
                virtual_devices(int(np.prod(shape)), "cpu"))


# -- the mesh over ranks ----------------------------------------------------

def test_two_ranks_of_eight_virtual_shards_are_the_production_mesh():
    for rank in (0, 1):
        mesh = Mesh.over_ranks((16, 16), ("data", "model"), rank=rank,
                               rank_devices=["cpu", "cpu"])
        assert mesh.spans_ranks and mesh.world == 2 and mesh.rank == rank
        assert list(mesh.shape.items()) == [("data", 16), ("model", 16)]
        assert mesh.size == 256
        local = mesh.local_positions()
        assert len(local) == 8 * 16
        assert {c[0] for c in local} == set(range(8 * rank, 8 * rank + 8))
        assert {c[1] for c in local} == set(range(16))
        assert mesh.require_one_device("cpu") == torch.device("cpu")
        assert "rank 1 of 2" in repr(Mesh.over_ranks(
            (2, 1), ("data", "model"), rank=1, rank_devices=["cpu"] * 2))
    one = make_production_mesh(devices=virtual_devices(256, "cpu"))
    assert not one.spans_ranks and one.world == 1
    assert len(one.local_positions()) == 256


def test_the_rank_to_device_map():
    """Every position lies on its owner rank's device: rank r's block of
    the data axis, whatever the other axes."""
    devices = [torch.device("cpu"), torch.device("meta"),
               torch.device("cpu"), torch.device("meta")]
    mesh = Mesh.over_ranks((2, 8, 2), ("pod", "data", "model"), rank=3,
                           rank_devices=devices)
    for c in np.ndindex(2, 8, 2):
        assert mesh.devices[c] == devices[c[1] // 2]
    assert {c[1] for c in mesh.local_positions()} == {6, 7}
    assert mesh.require_one_device("meta") == torch.device("meta")
    with pytest.raises(ValueError, match="lies on meta"):
        mesh.require_one_device("cpu")


@pytest.mark.parametrize("d, world", [(12, 5), (16, 3), (2, 4)])
def test_a_data_axis_the_ranks_do_not_divide_is_refused(d, world):
    with pytest.raises(ValueError, match=f"data axis of {d} does not "
                                         f"divide over {world} ranks"):
        Mesh.over_ranks((d, 1), ("data", "model"), rank=0,
                        rank_devices=["cpu"] * world)


def test_a_one_process_mesh_over_distinct_devices_names_the_ranks_route():
    mesh = Mesh((2, 1), ("data", "model"),
                [torch.device("cuda", 0), torch.device("cuda", 1)])
    with pytest.raises(NotImplementedError,
                       match="Mesh.over_ranks, launch/ranks.py"):
        mesh.require_one_device("cpu")


def test_a_rank_keeps_its_own_blocks_and_gathers_only_whole_ones():
    mesh = Mesh.over_ranks((2, 2), ("data", "model"), rank=1,
                           rank_devices=["cpu", "cpu"])
    x = torch.arange(16.0).reshape(4, 4)
    rows = sharding.Sharded(x, sharding.P("data", None), mesh)
    assert list(rows.pieces) == [(1, 0)]
    assert torch.equal(rows.pieces[(1, 0)], x[2:])
    with pytest.raises(ValueError, match="holds 1 of the 2 blocks"):
        rows.gather()
    cols = sharding.Sharded(x, sharding.P(None, "model"), mesh)
    assert torch.equal(cols.gather(), x)            # model stays in a rank
    assert cols.whole() is None
    whole = sharding.Sharded(x, sharding.P(), mesh)
    assert whole.whole() is x
    assert sharding.held_whole({"a": whole})["a"] is x
    assert sharding.held_whole({"a": whole, "b": cols}) is None


def test_the_host_mesh_defaults_to_the_card():
    assert make_host_mesh("cpu").distinct_devices() == [torch.device("cpu")]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        make_host_mesh()


# -- the launcher's refusals --------------------------------------------------

def test_nccl_on_ranks_sharing_a_device_is_refused():
    with pytest.raises(ValueError, match=r"distinct CUDA device for each of "
                       r"2 ranks.*torch.cuda.device_count\(\) = "
                       f"{torch.cuda.device_count()}"):
        ranks.check_backend("nccl", ["cuda:0", "cuda:0"])


def test_nccl_on_the_cpu_is_refused_before_any_rank_starts(tmp_path):
    with pytest.raises(ValueError, match="nccl needs a CUDA device"):
        ranks.run("torch_ranks:bucket_values", {}, world=2, backend="nccl",
                  devices=["cpu", "cpu"], workdir=str(tmp_path))
    assert not os.listdir(tmp_path)
    with pytest.raises(ValueError, match="is not one of"):
        ranks.check_backend("mpi", ["cpu"])


def test_default_devices_never_switch_backend():
    assert ranks.default_devices("gloo", 3, "cpu") == \
        [torch.device("cpu")] * 3
    assert ranks.default_devices("nccl", 2) == [torch.device("cuda", 0),
                                                torch.device("cuda", 1)]
    assert ranks.check_backend("gloo", ["cpu", "cpu"]) == \
        [torch.device("cpu")] * 2


# -- values and iterates over ranks ----------------------------------------

@pytest.mark.parametrize("world, shape", [(2, (2, 1)), (2, (16, 16)),
                                          (4, (4, 1)), (4, (16, 16))])
def test_bucket_values_over_ranks_equal_one_process(tmp_path, world, shape):
    """k ∈ {1, 5, 8, 13, 64, 100}, all in flight at once: every rank
    gets the one-process virtual mesh's bucket and its values bit for bit
    (so in-process's), the floor over the whole data axis."""
    f_batch, n = TR.quad_fitness()
    one = PodMeshEvalBackend(f_batch, mesh=_one_process(shape), device="cpu")
    inp = InProcessEvalBackend(f_batch, device="cpu")
    docs = _run(tmp_path, "bucket_values", world, mesh_shape=list(shape))
    for doc in docs:
        assert doc["min_bucket"] == one.min_bucket == bucket_size(
            4 * shape[0])
        assert doc["local_shards"] == shape[0] // world
        assert doc["positions"] == shape[0] * shape[1] // world
        assert doc["data_mesh"] == [world, 1] and doc["data_mesh_spans"]
        for k in TR.KS:
            pts = TR.points(k, n)
            h = one.submit(pts)
            want = one.collect(h)
            assert doc["kp"][str(k)] == h.kp
            got = np.array(doc["values"][str(k)])
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, inp(pts))


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_commits_the_in_process_iterates(tmp_path, world):
    """The pipelined grid at m = 48 on the 16 × 16 mesh over ``world``
    ranks: every rank commits the in-process run's centers, fitness
    history, engine stats, sim time and completions, with no bucket
    shape first run after warm."""
    want = TR.in_process_grid()
    docs = _run(tmp_path, "grid_run", world, mesh_shape=[16, 16])
    for doc in docs:
        assert doc.pop("new_shapes") == 0
        assert doc.pop("lanes") > 0
        assert doc == want


_REFERENCE_FOUR_DEVICES = """
import json, jax, jax.numpy as jnp, numpy as np
from repro.core.substrates.pod_mesh import PodMeshEvalBackend
n = 8
rng = np.random.default_rng(3)
A = rng.normal(size=(n, n)).astype(np.float32)
H = jnp.asarray(A @ A.T + n * np.eye(n, dtype=np.float32))
x = jnp.asarray(rng.uniform(-0.5, 0.5, n).astype(np.float32))

def f_batch(xs):
    d = xs - x[None, :]
    hd = sum(d[:, j, None] * H[j][None, :] for j in range(n))
    return 0.5 * sum(hd[:, i] * d[:, i] for i in range(n))

mesh = jax.make_mesh((4, 1), ("data", "model"), devices=jax.devices()[:4])
pod = PodMeshEvalBackend(jax.jit(f_batch), mesh=mesh)
out = {"min_bucket": pod.min_bucket, "values": {}, "kp": {}}
for k in (1, 5, 8, 13, 64, 100):
    h = pod.submit(np.random.default_rng(k).uniform(-2, 2, (k, n)))
    out["kp"][str(k)] = h.kp
    out["values"][str(k)] = pod.collect(h).tolist()
print(json.dumps(out))
"""


def test_four_ranks_match_the_reference_four_device_shard_map(tmp_path):
    """The reference's backend ``shard_map``s each bucket over 4 forced
    host devices; the port's over 4 gloo ranks: the same floor and
    buckets, values within 1e-6 relative."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", _REFERENCE_FOUR_DEVICES],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    docs = _run(tmp_path, "bucket_values", 4, mesh_shape=[4, 1])
    assert docs[0]["min_bucket"] == ref["min_bucket"]
    for k in TR.KS:
        assert docs[0]["kp"][str(k)] == ref["kp"][str(k)]
        for doc in docs:
            np.testing.assert_allclose(doc["values"][str(k)],
                                       ref["values"][str(k)], rtol=1e-6,
                                       atol=0)


# -- failures ----------------------------------------------------------------

def test_a_rank_that_raises_fails_the_run(tmp_path):
    """A rank whose mesh the ranks cannot cut raises in its body: the run
    returns non-zero and names it."""
    res = ranks.run("torch_ranks:bucket_values", {"mesh_shape": [16, 1]},
                    world=3, backend="gloo", devices=["cpu"] * 3,
                    workdir=str(tmp_path), timeout=120, env=ENV)
    assert res.returncode == 1
    assert "data axis of 16 does not divide over 3 ranks" in res.failed


def test_a_rank_killed_mid_run_fails_the_run_and_leaves_no_process(
        tmp_path):
    """Rank 1 SIGKILLs itself after its first bucket while rank 0 waits
    in the next all-gather: the launcher returns non-zero well inside its
    timeout, rank 0 killed or failed, and neither process lives on."""
    marker = str(tmp_path / "pid")
    res = ranks.run("torch_ranks:killed_mid_run",
                    {"mesh_shape": [2, 1], "marker": marker}, world=2,
                    backend="gloo", devices=["cpu"] * 2,
                    workdir=str(tmp_path / "ranks"), timeout=60, env=ENV)
    assert res.returncode != 0 and res.wall_s < 60
    assert res.exitcodes[1] == -9 and res.exitcodes[0] != 0
    assert "exited" in res.failed
    for rank in (0, 1):
        with open(f"{marker}.{rank}") as f:
            pid = int(f.read())
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


# -- the dry-run's --ranks -------------------------------------------------

def test_the_dryrun_pod_mesh_smoke_over_two_ranks(tmp_path):
    """``--substrate pod_mesh --ranks 2``: the reference's keys, and every
    rank on the CPU with its 8 of the 16 data shards, == the pod leg."""
    code = dryrun.main(["--substrate", "pod_mesh", "--ranks", "2",
                        "--device", "cpu", "--out", str(tmp_path)])
    assert code == 0
    report = json.loads((tmp_path / "substrate_pod_mesh.json").read_text())
    assert report["parity_ok"] and report["ranks_parity_ok"]
    assert report["ranks"] == 2 and report["dist_backend"] == "gloo"
    assert [r["device"] for r in report["per_rank"]] == ["cpu", "cpu"]
    assert [r["data_shards"] for r in report["per_rank"]] == [8, 8]
    assert all(r["new_shapes_after_warm"] == 0 for r in report["per_rank"])


def test_the_dryrun_refuses_ranks_for_other_substrates(capsys):
    with pytest.raises(SystemExit):
        dryrun.main(["--substrate", "multi_search", "--ranks", "2",
                     "--device", "cpu"])
    assert "--ranks runs with --substrate pod_mesh or lm_subspace" in \
        capsys.readouterr().err


_SITE_BLOCK = textwrap.dedent("""
    import sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
""")


def test_ranks_import_no_jax_or_reference(tmp_path):
    """The parent, its forkserver and every rank run where jax and repro
    cannot load: the pod_mesh runner's rank leg over 2 gloo ranks."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_SITE_BLOCK)
    script = textwrap.dedent(f"""
        import sys
        from repro_torch.launch import child, ranks
        res = ranks.run("repro_torch.launch.dryrun:pod_mesh_rank",
                        dict(m=12, iterations=1, n_stars=200, n_hosts=48,
                             mesh_shape=[2, 1], axis_names=["data", "model"]),
                        world=2, backend="gloo", devices=["cpu", "cpu"],
                        workdir={str(tmp_path / "ranks")!r}, timeout=120)
        child.stop()
        assert res.returncode == 0, res.failed
        assert [d["device"] for d in res.docs] == ["cpu", "cpu"]
        assert res.docs[0]["history"] == res.docs[1]["history"]
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
    """)
    env = dict(ENV, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                                str(site)]))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
