"""The training launcher over ranks (``launch/train.py --ranks W
--dist-backend gloo``) on the CPU, and the dry-run's gradient all-reduce
bytes.

* ``python -m repro_torch.launch.train --ranks 2 --dist-backend gloo
  --device cpu --preset tiny`` runs its ranks through ``launch/child.py``
  and prints rank 0's ``[train]`` lines, once; nccl is refused on the CPU
  and on a card two ranks would share, and a batch the ranks do not
  divide is refused by name.
* A crash at step 4 over 2 ranks exits 42, and the resumed run's final
  checkpoint equals the uninterrupted run's over ranks, bit for bit.
* ``--compress-grads``, ``--line-search 4`` and ``--optimizer
  subspace-newton`` over 2 ranks: every rank's parameters and error state
  the same bits after every step, and each step's loss within 2e-2
  relative of the one-process port on the hosts' concatenated batches
  (the tiny preset is bf16, whose sums the ranks take in another order:
  the model tests' bf16 loss tolerance).
* On meta tensors, the dry-run's data-parallel gradient entries on a
  (W, 1) mesh are 2 x the parameters' bytes for tiny and lm-100m
  (``reckon``) and for h2o-danube-3-4b at its published depth (the
  collective model alone), and a real tiny step over 2 ranks hands its
  all-reduces exactly half of it.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.tree import leaves_with_paths
from repro_torch.launch import dryrun, train
from repro_torch.launch.mesh import Mesh, virtual_devices
from repro_torch.models import sharding as S
from repro_torch.roofline.analysis import collective_bytes_from_specs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--device", "cpu", "--preset", "tiny", "--batch", "4", "--seq",
        "32"]
RANKS = ["--ranks", "2", "--dist-backend", "gloo"]
#: bf16 losses over ranks against one process (the model tests' bf16)
BF16_LOSS_TOL = 2e-2


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")          # the ranks' too
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lines(text: str) -> list:
    return [json.loads(line.split(" ", 1)[1]) for line in text.splitlines()
            if line.startswith("[train] {")]


def test_the_cli_over_two_ranks_prints_rank_zeros_lines():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *RANKS,
         "--device", "cpu", "--preset", "tiny", "--steps", "4", "--batch",
         "4", "--seq", "32", "--log-every", "2"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("[train] config=tiny-lm") == 1
    lines = _lines(r.stdout)
    assert [x["step"] for x in lines] == [2, 4]
    assert all(np.isfinite(x["loss"]) for x in lines)


def test_nccl_is_refused_on_the_cpu_and_on_a_shared_card(monkeypatch):
    with pytest.raises(ValueError, match="nccl needs a CUDA device"):
        train.main(BASE + ["--ranks", "2", "--dist-backend", "nccl"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="device_count"):
        train.main(["--preset", "tiny", "--ranks", "2", "--dist-backend",
                    "nccl"])


def test_a_batch_the_ranks_do_not_divide_is_refused():
    with pytest.raises(ValueError, match="batch of 4 does not divide over "
                                         "3 ranks"):
        train.main(BASE + ["--ranks", "3"])
    with pytest.raises(ValueError, match="batch of 5 does not divide over "
                                         "2 data-parallel hosts"):
        train.host_data(train.PRESETS["tiny"], 32, 5, 0, n_hosts=2)


def test_a_crash_and_resume_over_ranks_equal_the_uninterrupted_run(
        tmp_path, capsys):
    run = BASE + RANKS + ["--steps", "6", "--ckpt-every", "2",
                          "--log-every", "1"]
    crashed, straight = str(tmp_path / "ck"), str(tmp_path / "st")
    assert train.main(run + ["--ckpt-dir", crashed, "--crash-at", "4"]) == 42
    out = capsys.readouterr().out
    assert "simulated crash at step 4" in out
    assert sorted(os.listdir(crashed)) == ["LATEST", "step_00000002"]
    assert train.main(run + ["--ckpt-dir", crashed, "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert [x["step"] for x in _lines(out)] == [3, 4, 5, 6]
    assert train.main(run + ["--ckpt-dir", straight]) == 0
    a = np.load(os.path.join(crashed, "step_00000006", "arrays.npz"))
    b = np.load(os.path.join(straight, "step_00000006", "arrays.npz"))
    assert sorted(a.files) == sorted(b.files) and len(a.files) > 30
    for key in a.files:
        assert a[key].dtype == b[key].dtype
        assert np.array_equal(a[key], b[key]), key


@pytest.mark.parametrize("option", [
    ["--compress-grads"], ["--line-search", "4"],
    ["--optimizer", "subspace-newton"]], ids=lambda o: o[-1].lstrip("-"))
def test_options_over_ranks_track_the_one_process_port(option):
    argv = BASE + ["--steps", "3", "--log-every", "10"] + option
    res, _ = train.over_ranks(argv + RANKS, measure=True)
    assert res.returncode == 0, res.failed
    one = train.run(argv, hosts=2, measure=True)
    docs = res.docs
    assert docs[0]["digests"] == docs[1]["digests"]   # params (and error)
    assert docs[0]["losses"] == docs[1]["losses"]
    np.testing.assert_allclose(docs[0]["losses"], one["losses"],
                               rtol=BF16_LOSS_TOL)
    if option[0] == "--optimizer":                    # no gradient at all
        assert docs[0]["gradient_bytes"] == 0
    else:
        assert docs[0]["gradient_all_reduces"] == 3


def _param_bytes(cfg) -> int:
    return sum(x.numel() * x.element_size()
               for _, x in leaves_with_paths(dryrun.meta_params(cfg)))


def _mesh(world: int) -> Mesh:
    return Mesh((world, 1), ("data", "model"),
                virtual_devices(world, dryrun.META))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("preset", ["tiny", "lm-100m"])
def test_the_dryrun_gradient_entries_are_twice_the_parameters(preset,
                                                               world):
    cfg = train.PRESETS[preset]
    report = dryrun.reckon(cfg, ShapeConfig("t", 128, 8, "train"),
                           _mesh(world))
    assert report["gradient_all_reduce_bytes"] == 2 * _param_bytes(cfg)
    # no model axis to reduce over: beside the gradients, the loss's two
    # f32 sums over data alone (2 x 8 B, the ring)
    assert report["loss_all_reduce_bytes"] == 2 * 8
    assert report["collective_bytes_by_kind"]["all-reduce"] == \
        report["gradient_all_reduce_bytes"] + report["loss_all_reduce_bytes"]


@pytest.mark.parametrize("world", [2, 4])
def test_danubes_gradient_entries_at_published_depth(world):
    cfg = get_config("h2o-danube-3-4b")
    mesh = _mesh(world)
    specs, _ = S.enforce_divisible(cfg, mesh, S.param_specs(cfg, mesh))
    stats = collective_bytes_from_specs(
        cfg, ShapeConfig("t", 128, 8, "train"), mesh, specs)
    assert stats.gradient_all_reduce_bytes == 2 * _param_bytes(cfg)
    assert len([k for k in stats.ops if k.endswith(" gradient")]) == len(
        leaves_with_paths(dryrun.meta_params(cfg)))


def test_a_real_step_over_two_ranks_hands_half_the_dryrun_bytes():
    cfg = train.PRESETS["tiny"]
    res, _ = train.over_ranks(BASE + RANKS + ["--steps", "2"])
    assert res.returncode == 0, res.failed
    report = dryrun.reckon(cfg, ShapeConfig("t", 32, 4, "train"), _mesh(2))
    for doc in res.docs:
        assert doc["gradient_all_reduces"] == 2           # one a step
        per_step = doc["gradient_bytes"] // 2
        assert 2 * per_step == doc["gradient_bytes"]
        assert 2 * per_step == report["gradient_all_reduce_bytes"]
