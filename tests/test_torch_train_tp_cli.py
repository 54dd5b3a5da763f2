"""The training launcher with its parameters cut over the model axis
across ranks (``launch/train.py --ranks W --model-ranks M``) through
``over_ranks``, and its checkpoints, on the CPU with gloo ranks.

The configuration is the tiny preset in f32, taken as a ``cfg``
override (the reference's ``lower_cell(cfg_override=)``).

* ``--ranks 2 --model-ranks 2`` and ``--ranks 4 --model-ranks 2`` train,
  each step's loss within 1e-5 of the launcher's one-process run on the
  data ranks' concatenated batches, and every rank's clip norms the same.
* A ``--model-ranks`` run resumed from its step-2 checkpoint ends with
  the uninterrupted run's step-4 checkpoint, bit for bit (the reference's
  restored == uninterrupted contract).  The checkpoint holds the whole
  tree, rank 0 writing the leaves gathered one by one over the model
  group, in the format a one-process run writes.
* Each rank's restored state is its ``model`` blocks (``restore`` with
  ``shardings`` / ``mesh`` over ranks).
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core.tree import leaves_with_paths
from repro_torch.launch import train
from repro_torch.launch.mesh import Mesh
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW, opt_state_specs

CFG = dataclasses.replace(train.PRESETS["tiny"], dtype="float32")
FIELDS = dataclasses.asdict(CFG)
BASE = ["--device", "cpu", "--batch", "4", "--seq", "32", "--log-every",
        "1", "--ckpt-every", "2", "--steps", "4"]
#: port against port: the f32 sums' order only
PORT_TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")          # the ranks' too
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _over(world: int, extra: list):
    res, out = train.over_ranks(
        BASE + ["--ranks", str(world), "--model-ranks", "2",
                "--dist-backend", "gloo"] + extra, cfg=FIELDS)
    assert res.returncode == 0, res.failed
    return res, out


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The uninterrupted (1, 2) run, checkpointing at steps 2 and 4."""
    where = str(tmp_path_factory.mktemp("tp_ckpt") / "st")
    res, out = _over(2, ["--ckpt-dir", where])
    return where, res.docs, out


def _arrays(path):
    with np.load(os.path.join(path, "arrays.npz")) as a:
        return {k: a[k] for k in a.files}


@pytest.mark.parametrize("world", [2, 4])
def test_the_launcher_trains_over_the_model_axis(straight, world):
    if world == 2:
        _, docs, out = straight
    else:
        res, out = _over(4, [])
        docs = res.docs
    assert "[train] done" in out
    one = train.run(BASE, hosts=world // 2, cfg=FIELDS)
    np.testing.assert_allclose(docs[0]["losses"], one["losses"],
                               rtol=PORT_TOL)
    for doc in docs:
        assert doc["losses"] == docs[0]["losses"]
        assert doc["gnorms"] == docs[0]["gnorms"]
        assert doc["model_calls"]["block"] == 4 * 2 * CFG.n_layers * 2
        assert not any(doc["kernel_launches"].values())


def test_resumed_equals_the_uninterrupted_run(straight, tmp_path):
    where, _, _ = straight
    src = str(tmp_path / "ck")
    shutil.copytree(where, src)
    shutil.rmtree(os.path.join(src, "step_00000004"))
    with open(os.path.join(src, "LATEST"), "w") as f:
        f.write("step_00000002")
    _, out = _over(2, ["--ckpt-dir", src, "--resume"])
    assert "resumed from step 2" in out
    a = _arrays(os.path.join(src, "step_00000004"))
    b = _arrays(os.path.join(where, "step_00000004"))
    assert sorted(a) == sorted(b) and len(a) > 30
    for key in a:
        assert a[key].dtype == b[key].dtype
        assert np.array_equal(a[key], b[key]), key
    # the whole tree, as one process writes it, the moments too
    for path, leaf in leaves_with_paths(T.param_specs(CFG)):
        for prefix in ("params/", "opt/mu/", "opt/nu/"):
            assert a[prefix + path].shape == leaf.shape, prefix + path


def test_restore_over_ranks_keeps_each_ranks_block(straight):
    where, _, _ = straight
    want = _arrays(os.path.join(where, "step_00000004"))
    for rank in range(2):
        mesh = Mesh.over_ranks((1, 2), ("data", "model"), rank=rank,
                               rank_devices=["cpu", "cpu"], model_ranks=2)
        shards = S.ModelShards(mesh, CFG)
        assert "embed/tok" in shards.cuts and "head/w" in shards.cuts
        params = shards.shard(T.init_params(
            CFG, torch.Generator().manual_seed(1), "cpu"))
        opt = AdamW()
        tree, step, _ = ckpt.restore(
            where, {"params": params, "opt": opt.init(params)},
            shardings={"params": shards.specs,
                       "opt": opt_state_specs(shards.specs)}, mesh=mesh)
        assert step == 4
        for path, dim in shards.cuts.items():
            for part in ("params", "opt/mu"):
                got = tree
                for key in f"{part}/{path}".split("/"):
                    got = got[int(key)] if isinstance(got, list) else got[key]
                whole = torch.from_numpy(want[f"{part}/{path}"])
                n = whole.shape[dim] // 2
                assert torch.equal(got, whole.narrow(dim, rank * n, n)), path
