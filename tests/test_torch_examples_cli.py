"""The port's launchers of ``examples/quickstart.py``,
``examples/serve_lm.py`` and ``examples/train_lm.py`` against the
examples, on the CPU.

The quickstart runs in both packages at the example's settings: the port
seeds its engine with the int the reference derives from
``jax.random.key(0)``, so both draw the same first samples.  The two f32
bowls (XLA's fused ``jax.jit`` of the example, eager torch) differ in the
last bits (1.9e-6 on the first phase's samples); those bits move each
committed center a little (up to 8e-5), so later samples differ, and
each iteration's best differs by up to 1.6e-3 relative (iteration 9:
2.5579e-4 against 2.5619e-4, 4e-7 apart).  Neither fit is farther from
the truth than the other: on every phase finish each package's f32
direction lies as close to the f64 fit of its own samples (within
4.9e-2 at the worst, iterations 13-14, in both).  The bests are held
within 2e-3 relative, the centers within 1e-3, and the port's bowl at the
reference's committed centers within 1e-6 of the reference's bests.  The serve and
train examples only pass a command line to the launcher's ``main``; their
command lines are caught by running each example as written with
``repro.launch.serve.main`` / ``repro.launch.train.main`` replaced, and the
port's launchers must pass the same.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.launch import serve as j_serve
from repro.launch import train as j_train
from repro_torch.launch import quickstart, serve_lm, train_lm
from torch_examples import one_thread  # noqa: F401 (autouse fixture)
from torch_examples import load_example, run_example


@pytest.fixture(scope="module")
def quick():
    ex = load_example("quickstart")
    states = []
    real = ex.anm_minimize

    def caught(*args, **kw):
        states.append(real(*args, **kw))
        return states[-1]
    ex.anm_minimize = caught
    run_example(ex)
    return states[0], quickstart.run("cpu")


def test_the_seed_is_the_references_draw_from_key_0():
    key = jax.random.key(0)
    assert quickstart.QUICKSTART_SEED == int(
        jax.random.randint(key, (), 0, 2**31 - 1))


def test_quickstart_iterations(quick):
    ref, mine = quick
    assert ref.iteration == mine.iteration == 25


def test_quickstart_center(quick):
    ref, mine = quick
    np.testing.assert_allclose(mine.center.numpy(), np.asarray(ref.center),
                               rtol=0, atol=1e-3)


def test_quickstart_bests_each_iteration(quick):
    ref, mine = quick
    np.testing.assert_allclose([r.best_fitness for r in mine.history],
                               [r.best_fitness for r in ref.history],
                               rtol=2e-3, atol=0)


def test_quickstart_bowl_at_the_references_centers(quick):
    ref, _ = quick
    centers = torch.tensor(np.stack([np.asarray(r.center)
                                     for r in ref.history]),
                           dtype=torch.float32)
    got = quickstart.rosenbrock_batch(centers).numpy().astype(np.float64)
    np.testing.assert_allclose(got, [r.best_fitness for r in ref.history],
                               rtol=0, atol=1e-6)


def test_quickstart_gate_holds_in_both(quick):
    ref, mine = quick
    assert ref.best_fitness < quickstart.GATE
    assert mine.best_fitness < quickstart.GATE


def test_quickstart_main_writes_its_doc(tmp_path):
    out = tmp_path / "q.json"
    assert quickstart.main(["--device", "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    act = doc["acts"]["quickstart"]
    assert doc["device"] == "cpu" and doc["ok"]
    assert act["gates"] == {"best_fitness_below_1e-3": True}
    assert act["iterations"] == 25 and act["evaluations"] > 0
    # 64 samples of 6 columns: under the gram kernel's 32768 elements
    assert act["fit_elements"] == 64 * 6
    assert not any(act["launches"].values())          # no kernel on the CPU


def _caught_argv(monkeypatch, module, name: str, argv=()):
    got = []
    monkeypatch.setattr(module, "main", lambda a: got.append(list(a)) or 0)
    run_example(load_example(name), argv)
    return got[0]


@pytest.mark.parametrize("arch", [None, "rwkv6-7b"])
def test_serve_lm_passes_the_examples_argv(monkeypatch, arch):
    argv = ["--arch", arch] if arch else []
    want = _caught_argv(monkeypatch, j_serve, "serve_lm", argv)
    assert serve_lm.example_argv(arch or serve_lm.ARCH) == want


@pytest.mark.parametrize("argv,kw", [
    ([], {}), (["--fast"], dict(fast=True)),
    (["--fast", "--steps", "7"], dict(fast=True, steps=7)),
    (["--steps", "9"], dict(steps=9))])
def test_train_lm_passes_the_examples_argv(monkeypatch, argv, kw):
    want = _caught_argv(monkeypatch, j_train, "train_lm", argv)
    assert train_lm.example_argv(**kw) == want


def test_train_lm_moves_only_the_checkpoint_directory():
    mine = train_lm.example_argv(fast=True, ckpt_dir="/x")
    ex = train_lm.example_argv(fast=True)
    i = ex.index("--ckpt-dir") + 1
    assert mine[:i] + mine[i + 1:] == ex[:i] + ex[i + 1:] and mine[i] == "/x"


def test_serve_lm_main_answers_every_request(tmp_path):
    out = tmp_path / "s.json"
    assert serve_lm.main(["--device", "cpu", "--out", str(out)]) == 0
    act = json.loads(out.read_text())["acts"]["serve"]
    assert act["gates"] == {"exit_zero": True, "every_request_answered": True}
    assert act["arch"] == "deepseek-v2-lite-16b"


def test_train_lm_fast_main_runs_its_steps(tmp_path):
    out, ckpt = tmp_path / "t.json", tmp_path / "ckpt"
    assert train_lm.main(["--fast", "--steps", "20", "--ckpt-dir", str(ckpt),
                          "--device", "cpu", "--out", str(out)]) == 0
    act = json.loads(out.read_text())["acts"]["train"]
    assert act["gates"] == {"exit_zero": True}
    assert act["logged_steps"] == [10, 20]
    assert sorted(os.listdir(ckpt)) == ["LATEST", "step_00000020"]
