"""The port's training path port against port, its launcher, and the
kernel wrappers' refusal of a backward.

* ``remat`` (each unit under ``torch.utils.checkpoint``, "full" or
  "dots") gives the loss and every gradient of the plain backward, bit
  for bit, and the chunked loss's recomputed logits the same; both
  really recompute (the checkpoint is entered).
* The launcher, ``python -m repro_torch.launch.train --device cpu``, as
  tests/test_system.py drives the reference's: a simulated crash exits
  42, ``--resume`` continues from step 8 to step 12, and the resumed
  step-12 checkpoint equals an uninterrupted run's bit for bit; short
  runs of ``--compress-grads``, ``--line-search 4``, ``--optimizer
  subspace-newton`` and the audio stub's masked frames.
* The kernels have no backward: every wrapper refuses a call autograd
  would record, on the CPU route and on a CUDA tensor (before any kernel
  is loaded), and a ``use_kernels=True`` model refuses its train step;
  the same calls under ``no_grad`` still run.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.tree import leaves_with_paths
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grads(cfg, seed=0):
    params = T.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=2, seed=seed))
    batch = train.batch_to(data.batch(0), cfg, "cpu")
    return T.value_and_grad(T.make_loss_fn(cfg), params, batch)


def _same(a, b) -> None:
    ga, la, _ = a
    gb, lb, _ = b
    assert torch.equal(la, lb)
    for (path, x), (_, y) in zip(leaves_with_paths(ga),
                                 leaves_with_paths(gb)):
        assert torch.equal(x, y), path


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["qwen2-72b", "deepseek-v2-lite-16b",
                                  "zamba2-2.7b", "rwkv6-7b"])
def test_remat_gives_the_plain_backward(arch, policy, monkeypatch):
    base = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    plain = _grads(dataclasses.replace(base, remat=False))
    entered = []
    real = T.ckpt.checkpoint

    def spy(fn, *args, **kwargs):
        entered.append(fn)
        return real(fn, *args, **kwargs)
    monkeypatch.setattr(T.ckpt, "checkpoint", spy)
    remat = _grads(dataclasses.replace(base, remat=True,
                                       remat_policy=policy))
    _same(plain, remat)
    units = sum(repeat for _, repeat in T.find_segments(T.layer_sigs(base)))
    assert sum(fn is not T._chunk_loss for fn in entered) == units


def test_chunked_loss_recompute_gives_the_plain_backward(monkeypatch):
    rng = np.random.default_rng(0)
    hidden = torch.from_numpy(rng.normal(size=(2, 20, 24)).astype(
        np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.normal(size=(24, 40)).astype(
        np.float32)).requires_grad_(True)
    labels = torch.from_numpy(rng.integers(0, 40, (2, 20)))

    def run():
        loss = T.chunked_cross_entropy(hidden, w, labels, chunk=8)
        return (loss,) + torch.autograd.grad(loss, (hidden, w))

    entered = []
    real = T.ckpt.checkpoint

    def spy(fn, *args, **kwargs):
        entered.append(fn)
        return real(fn, *args, **kwargs)
    monkeypatch.setattr(T.ckpt, "checkpoint", spy)
    recomputed = run()
    assert entered == [T._chunk_loss] * 3
    monkeypatch.setattr(T.ckpt, "checkpoint",
                        lambda fn, *args, **kwargs: fn(*args))
    plain = run()
    for a, b in zip(recomputed, plain):
        assert torch.equal(a, b)
    with torch.no_grad():                 # nothing to recompute
        entered.clear()
        monkeypatch.setattr(T.ckpt, "checkpoint", spy)
        T.chunked_cross_entropy(hidden, w, labels, chunk=8)
        assert entered == []


def test_a_decode_step_refuses_autograd():
    cfg = get_smoke_config("qwen2-72b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    live = {k: v for k, v in params.items()}
    live["final_norm"] = {"scale": params["final_norm"]["scale"]
                          .detach().requires_grad_(True)}
    cache = T.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(RuntimeError, match="no_grad"):
        T.forward(live, cfg, {"tokens": torch.zeros(1, 1, dtype=torch.long)},
                  cache=cache, t=0)
    logits, _ = T.make_serve_step(cfg)(live, cache,
                                       torch.zeros(1, 1, dtype=torch.long), 0)
    assert logits.shape == (1, 1, cfg.vocab_size)


# -- the launcher ----------------------------------------------------------

def _launch(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--preset", "tiny", "--steps", "12", "--ckpt-every", "4",
         "--batch", "2", "--seq", "32", *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=timeout)


def test_train_crash_restart_resumes_bit_for_bit(tmp_path):
    """tests/test_system.py::test_train_crash_restart on the port, and the
    resumed run's step-12 checkpoint against an uninterrupted run's."""
    crashed = str(tmp_path / "ck")
    r1 = _launch("--ckpt-dir", crashed, "--crash-at", "9")
    assert r1.returncode == 42, r1.stdout + r1.stderr
    assert "simulated crash at step 9" in r1.stdout
    r2 = _launch("--ckpt-dir", crashed, "--resume")
    assert r2.returncode == 0, r2.stdout + r2.stderr
    assert "resumed from step 8" in r2.stdout
    assert '"step": 12' in r2.stdout
    straight = str(tmp_path / "straight")
    r3 = _launch("--ckpt-dir", straight)
    assert r3.returncode == 0, r3.stdout + r3.stderr
    a = np.load(os.path.join(crashed, "step_00000012", "arrays.npz"))
    b = np.load(os.path.join(straight, "step_00000012", "arrays.npz"))
    assert sorted(a.files) == sorted(b.files) and len(a.files) > 30
    for key in a.files:
        assert a[key].dtype == b[key].dtype
        assert np.array_equal(a[key], b[key]), key


def _main(capsys, *args) -> list:
    """The launcher in this process; its [train] JSON lines."""
    assert train.main(["--device", "cpu", *args]) == 0
    out = capsys.readouterr().out
    return [json.loads(line.split(" ", 1)[1]) for line in out.splitlines()
            if line.startswith("[train] {")]


def test_compress_grads_runs_and_checkpoints_the_residual(capsys, tmp_path):
    was = torch.are_deterministic_algorithms_enabled()
    lines = _main(capsys, "--preset", "tiny", "--steps", "6", "--batch", "2",
                  "--seq", "32", "--compress-grads", "--log-every", "1",
                  "--ckpt-dir", str(tmp_path))
    assert torch.are_deterministic_algorithms_enabled() == was
    losses = [line["loss"] for line in lines]
    assert len(losses) == 6 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    arrays = np.load(tmp_path / "step_00000006" / "arrays.npz")
    err = [k for k in arrays.files if k.startswith("err/")]
    assert len(err) == len([k for k in arrays.files
                            if k.startswith("params/")])
    assert any(np.any(arrays[k] != 0) for k in err)


def test_line_search_runs(capsys):
    lines = _main(capsys, "--preset", "tiny", "--steps", "4", "--batch", "2",
                  "--seq", "32", "--line-search", "4", "--log-every", "2")
    assert [line["step"] for line in lines] == [2, 4]
    for line in lines:
        assert np.isfinite(line["loss"]) and 0.25 <= line["ls_alpha"] <= 2.0


def test_subspace_newton_runs(capsys):
    lines = _main(capsys, "--preset", "tiny", "--steps", "2", "--batch", "2",
                  "--seq", "16", "--optimizer", "subspace-newton",
                  "--log-every", "1")
    assert len(lines) == 2 and all(np.isfinite(x["loss"]) for x in lines)


def test_the_audio_stub_trains_on_masked_frames(capsys):
    lines = _main(capsys, "--arch", "hubert-xlarge", "--steps", "2",
                  "--batch", "2", "--seq", "16", "--log-every", "1")
    assert len(lines) == 2 and all(np.isfinite(x["loss"]) for x in lines)


# -- the kernels have no backward -------------------------------------------

class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device (a stub device check)."""

    @property
    def device(self):
        return torch.device("cuda")


def _inputs(cuda: bool, grad: bool):
    def t(*shape, dtype=torch.float32):
        x = torch.randn(*shape, generator=torch.Generator().manual_seed(0),
                        dtype=dtype)
        x = x.as_subclass(_FakeCuda) if cuda else x
        return x.requires_grad_(grad)
    return {
        "gram": lambda: ops.gram(t(64, 5), t(64)),
        "flash_attention": lambda: ops.flash_attention(
            t(1, 8, 4, 16), t(1, 8, 2, 16), t(1, 8, 2, 16)),
        "routed_attention": lambda: ops.routed_attention(
            t(1, 8, 2, 16), t(1, 8, 2, 16), t(1, 8, 2, 16)),
        "wkv6": lambda: ops.wkv6(t(1, 8, 2, 16), t(1, 8, 2, 16),
                                 t(1, 8, 2, 16), -torch.ones(1, 8, 2, 16),
                                 t(2, 16)),
        "routed_wkv6": lambda: ops.routed_wkv6(
            t(1, 8, 2, 16), t(1, 8, 2, 16), t(1, 8, 2, 16),
            -torch.ones(1, 8, 2, 16), t(2, 16)),
        "row_mean": lambda: ops.row_mean(t(4, 100)),
    }


@pytest.mark.parametrize("name", list(_inputs(False, False)))
@pytest.mark.parametrize("route", ["cpu", "cuda"])
def test_every_kernel_wrapper_refuses_a_backward(name, route, monkeypatch):
    def no_kernel(*_, **__):
        raise AssertionError("a kernel was reached")
    monkeypatch.setattr(ops, "_kernel_fn", no_kernel)
    monkeypatch.setattr(ops, "_gram_fn", no_kernel)
    before = (ops.gram_launches, ops.flash_attention_launches,
              ops.wkv6_launches, ops.row_mean_launches)
    with pytest.raises(RuntimeError, match="has no backward"):
        _inputs(route == "cuda", True)[name]()
    assert (ops.gram_launches, ops.flash_attention_launches,
            ops.wkv6_launches, ops.row_mean_launches) == before
    if route == "cpu":           # no_grad, or no input requiring grad: runs
        with torch.no_grad():
            _inputs(False, True)[name]()
        _inputs(False, False)[name]()


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "rwkv6-7b"])
def test_a_kernel_route_model_refuses_its_train_step(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), use_kernels=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = train.batch_to(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)).batch(0),
        cfg, "cpu")
    opt = AdamW(lr=1e-3)
    with pytest.raises(RuntimeError, match="use_kernels=False"):
        T.make_train_step(cfg, opt)(params, opt.init(params), batch)
    with torch.no_grad():        # the forward alone still takes the route
        loss, _ = T.make_loss_fn(cfg)(params, batch)
    assert torch.isfinite(loss)
