"""The training launcher with its parameters cut over the ranks
(``launch/train.py --ranks 2 --fsdp``) through ``over_ranks``, and its
checkpoints, on the CPU with gloo ranks.

The configuration is the tiny preset (bf16) with a vocabulary of 16384,
so that its embedding and head reach 2²⁰ elements and are cut; the
launcher takes it as a ``cfg`` override, as the reference's
``lower_cell(cfg_override=)`` does.

* A ``--fsdp`` run crashed at step 4 and resumed from its step-2
  checkpoint ends with the uninterrupted ``--fsdp`` run's checkpoint, bit
  for bit (the reference's restored == uninterrupted contract).  The
  checkpoint holds the whole tree, rank 0 writing the leaves gathered
  one by one, in the format a one-process run writes.
* That checkpoint restores into a one-process run, which continues from
  it on the two hosts' concatenated batches; its losses track the
  ``--fsdp`` run's over the same steps within bf16's loss tolerance.
* Each rank's restored state is its blocks (``restore`` with
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

CFG = dataclasses.replace(train.PRESETS["tiny"], vocab_size=16384)
FIELDS = dataclasses.asdict(CFG)
BASE = ["--device", "cpu", "--batch", "4", "--seq", "32", "--log-every",
        "1", "--ckpt-every", "2"]
FSDP = ["--ranks", "2", "--dist-backend", "gloo", "--fsdp"]
#: bf16 losses of another summation order (the model tests' bf16)
BF16_LOSS_TOL = 2e-2


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")          # the ranks' too
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _over(argv):
    res, out = train.over_ranks(argv, cfg=FIELDS)
    return res, out


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(crashed and resumed, uninterrupted) checkpoint directories of 6
    ``--fsdp`` steps, and the uninterrupted run's rank docs."""
    base = tmp_path_factory.mktemp("fsdp_ckpt")
    crashed, straight = str(base / "ck"), str(base / "st")
    run = BASE + FSDP + ["--steps", "6"]
    res, out = _over(run + ["--ckpt-dir", crashed, "--crash-at", "4"])
    assert 42 in res.exitcodes and "simulated crash at step 4" in out
    assert sorted(os.listdir(crashed)) == ["LATEST", "step_00000002"]
    res, out = _over(run + ["--ckpt-dir", crashed, "--resume"])
    assert res.returncode == 0, res.failed
    assert "resumed from step 2" in out
    res, _ = _over(run + ["--ckpt-dir", straight])
    assert res.returncode == 0, res.failed
    return crashed, straight, res.docs


def _arrays(path):
    with np.load(os.path.join(path, "arrays.npz")) as a:
        return {k: a[k] for k in a.files}


def test_fsdp_crash_and_resume_equal_the_uninterrupted_run(checkpoints):
    crashed, straight, docs = checkpoints
    assert docs[0]["gathers"] > 0 and docs[0]["scatters"] > 0
    a = _arrays(os.path.join(crashed, "step_00000006"))
    b = _arrays(os.path.join(straight, "step_00000006"))
    assert sorted(a) == sorted(b) and len(a) > 30
    for key in a:
        assert a[key].dtype == b[key].dtype
        assert np.array_equal(a[key], b[key]), key
    # the whole tree, as one process writes it: every leaf at its full
    # shape, the moments too
    whole = dict(leaves_with_paths(T.param_specs(CFG)))
    for path, leaf in whole.items():
        for prefix in ("params/", "opt/mu/", "opt/nu/"):
            assert a[prefix + path].shape == leaf.shape, prefix + path


def test_an_fsdp_checkpoint_restores_into_one_process(checkpoints, tmp_path):
    _, straight, docs = checkpoints
    # one process continues from the --fsdp run's step-4 checkpoint
    src = tmp_path / "ck"
    shutil.copytree(straight, src)
    shutil.rmtree(src / "step_00000006", ignore_errors=True)
    (src / "LATEST").write_text("step_00000004")
    one = train.run(BASE + ["--steps", "6", "--ckpt-dir", str(src),
                            "--resume"], hosts=2, cfg=FIELDS)
    assert len(one["losses"]) == 2
    np.testing.assert_allclose(one["losses"], docs[0]["losses"][4:],
                               rtol=BF16_LOSS_TOL)
    # and restores as the whole tree into a one-process template
    params = T.init_params(CFG, torch.Generator().manual_seed(1), "cpu")
    opt = AdamW()
    tree, step, _ = ckpt.restore(str(straight), {
        "params": params, "opt": opt.init(params)})
    assert step == 6
    want = _arrays(os.path.join(straight, "step_00000006"))
    for path, x in leaves_with_paths(tree):
        assert np.array_equal(x.view(torch.int16).numpy().view(np.uint16)
                              if x.dtype == torch.bfloat16 else x.numpy(),
                              want[path]), path


def test_restore_over_ranks_keeps_each_ranks_block(checkpoints):
    _, straight, _ = checkpoints
    want = _arrays(os.path.join(straight, "step_00000006"))
    for rank in range(2):
        mesh = Mesh.over_ranks((2, 1), ("data", "model"), rank=rank,
                               rank_devices=["cpu", "cpu"])
        shards = S.RankShards(mesh, CFG)
        assert set(shards.cuts) == {"embed/tok", "head/w"}
        params = shards.shard(T.init_params(
            CFG, torch.Generator().manual_seed(1), "cpu"))
        opt = AdamW()
        tree, _, _ = ckpt.restore(
            str(straight), {"params": params, "opt": opt.init(params)},
            shardings={"params": shards.specs,
                       "opt": opt_state_specs(shards.specs)}, mesh=mesh)
        for path, dim in shards.cuts.items():
            got = tree["opt"]["mu"]
            for key in path.split("/"):
                got = got[key]
            whole = torch.from_numpy(want[f"opt/mu/{path}"])
            n = whole.shape[dim] // 2
            assert torch.equal(got, whole.narrow(dim, rank * n, n)), path
