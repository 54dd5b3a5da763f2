"""The port stands alone and never hides the device.

* Every module of ``repro_torch``, and ``chip_smoke.py``, imports in a
  fresh interpreter in which ``jax`` and the reference package ``repro``
  cannot be imported at all.
* A tensor that says it lies on a CUDA device never reaches a kernel's
  plain version: the wrapper goes for the kernel, and where the kernel
  cannot be built it raises.
* Entry points asked for ``cuda`` on a machine without one raise instead
  of running on the CPU.
"""
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import AnmConfig, AnmEngine
from repro_torch.core.subspace import orthonormal_basis
from repro_torch.core.substrates.eval_backend import InProcessEvalBackend
from repro_torch.core.substrates.pod_mesh import PodMeshEvalBackend
from repro_torch.core.substrates.lm_loss import make_lm_workload
from repro_torch.data import sdss
from repro_torch.kernels import ops, ref
from repro_torch.core import subspace_newton
from repro_torch.launch import (anm_lm, baselines, fgdo_service, fig3,
                                multi_search, observability, quickstart,
                                serve, serve_lm, train, train_lm,
                                volunteer_grid)
from repro_torch.models import transformer
from repro_torch.server import sim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = textwrap.dedent("""
    import importlib, importlib.util, pkgutil, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not bad, bad
    print(len(names))
""")


def test_port_imports_nothing_of_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT,
         os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20      # every module was walked


#: the LM slice's modules, each of which the walk above must import
LM_MODULES = ("repro_torch.configs.base", "repro_torch.configs.h2o_danube_3_4b",
              "repro_torch.configs.rwkv6_7b", "repro_torch.models.layers",
              "repro_torch.models.ssm", "repro_torch.models.transformer",
              "repro_torch.core.subspace", "repro_torch.core.tree",
              "repro_torch.core.substrates.lm_loss",
              "repro_torch.launch.anm_lm", "repro_torch.convert",
              "repro_torch.kernels.ops")


#: the FGDO service and orchestrator slice's modules, each of which the
#: walk above must import
SERVER_MODULES = ("repro_torch.server.registry", "repro_torch.core.fgdo",
                  "repro_torch.core.substrates.eval_cache",
                  "repro_torch.core.orchestrator.coalesce",
                  "repro_torch.core.orchestrator.scheduler",
                  "repro_torch.core.orchestrator.director",
                  "repro_torch.server.protocol",
                  "repro_torch.server.transport", "repro_torch.server.chaos",
                  "repro_torch.server.checkpoint",
                  "repro_torch.server.server", "repro_torch.server.sim",
                  "repro_torch.launch.multi_search",
                  "repro_torch.launch.acts", "repro_torch.launch.quickstart",
                  "repro_torch.launch.volunteer_grid",
                  "repro_torch.launch.fgdo_service",
                  "repro_torch.launch.observability",
                  "repro_torch.launch.serve_lm",
                  "repro_torch.launch.train_lm")


def test_server_modules_import_without_jax_or_the_reference():
    script = _BLOCKED_IMPORT.replace("print(len(names))",
                                     "print(' '.join(names))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", script, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert set(SERVER_MODULES) <= set(out.stdout.split())
    for name in ("gram", "row_mean"):
        assert (ops.build.CSRC / f"{name}.cu").exists()
        assert name in ops.build.sources()


#: the pod-mesh slice's modules: the walk above must import each, and
#: only three reach for a process group: the launcher of ranks, the pod
#: backend, which issues the one collective of a mesh over ranks, and the
#: sharding rules, whose ``RankSum`` sums a training step's loss and
#: gradients over the ranks
POD_MODULES = ("repro_torch.launch.mesh", "repro_torch.models.sharding",
               "repro_torch.core.substrates.pod_mesh",
               "repro_torch.core.substrates.lm_loss",
               "repro_torch.launch.ranks")
PROCESS_GROUP_MODULES = ("repro_torch.core.substrates.pod_mesh",
                         "repro_torch.launch.ranks",
                         "repro_torch.models.sharding")


def test_pod_modules_import_without_jax_or_the_reference():
    script = _BLOCKED_IMPORT.replace("print(len(names))",
                                     "print(' '.join(names))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", script, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert set(POD_MODULES) <= set(out.stdout.split())
    for name in POD_MODULES:
        path = os.path.join(ROOT, "src", *name.split(".")) + ".py"
        with open(path) as f:
            uses = "torch.distributed" in f.read()
        assert uses == (name in PROCESS_GROUP_MODULES), name


#: the serving slice's modules: the dense, MLA, MoE and hybrid families'
#: configs and the serve loop, each of which the walk above must import
SERVE_MODULES = ("repro_torch.configs.qwen2_72b",
                 "repro_torch.configs.deepseek_coder_33b",
                 "repro_torch.configs.command_r_plus_104b",
                 "repro_torch.configs.chameleon_34b",
                 "repro_torch.configs.hubert_xlarge",
                 "repro_torch.configs.deepseek_v2_lite_16b",
                 "repro_torch.configs.llama4_maverick_400b",
                 "repro_torch.configs.zamba2_2p7b",
                 "repro_torch.launch.serve", "repro_torch.models.layers",
                 "repro_torch.models.ssm", "repro_torch.models.transformer",
                 "repro_torch.models.sharding", "repro_torch.convert")


def test_serve_modules_import_without_jax_or_the_reference():
    script = _BLOCKED_IMPORT.replace("print(len(names))",
                                     "print(' '.join(names))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", script, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert set(SERVE_MODULES) <= set(out.stdout.split())


#: the optimisers' slice's modules: the paper's baselines, Fig. 3 and the
#: subspace Newton with its line search, each of which the walk above
#: must import
OPTIM_MODULES = ("repro_torch.optim", "repro_torch.optim.cgd",
                 "repro_torch.optim.newton_ref",
                 "repro_torch.core.parallel_line_search",
                 "repro_torch.core.subspace_newton",
                 "repro_torch.core.subspace", "repro_torch.launch.baselines",
                 "repro_torch.launch.fig3", "repro_torch.convert")


def test_optim_modules_import_without_jax_or_the_reference():
    script = _BLOCKED_IMPORT.replace("print(len(names))",
                                     "print(' '.join(names))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", script, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert set(OPTIM_MODULES) <= set(out.stdout.split())
    for name in OPTIM_MODULES:
        path = os.path.join(ROOT, "src", *name.split("."))
        path = (os.path.join(path, "__init__.py") if os.path.isdir(path)
                else path + ".py")
        with open(path) as f:
            text = f.read()
        assert "import jax" not in text and "from repro." not in text, name


#: the training slice's modules: AdamW, int8 compression, the synthetic
#: pipeline, checkpoints and the launcher, each of which the walk above
#: must import, none reaching for jax, ml_dtypes or the reference
TRAIN_MODULES = ("repro_torch.optim.adamw", "repro_torch.optim.compression",
                 "repro_torch.data.pipeline", "repro_torch.checkpoint",
                 "repro_torch.checkpoint.checkpoint",
                 "repro_torch.launch.train", "repro_torch.models.transformer",
                 "repro_torch.convert")


def test_train_modules_import_without_jax_or_the_reference():
    script = _BLOCKED_IMPORT.replace("print(len(names))",
                                     "print(' '.join(names))").replace(
        '("jax", "jaxlib", "repro")', '("jax", "jaxlib", "repro", "ml_dtypes")')
    assert '"ml_dtypes")' in script
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", script, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert set(TRAIN_MODULES) <= set(out.stdout.split())
    for name in TRAIN_MODULES:
        path = os.path.join(ROOT, "src", *name.split("."))
        path = (os.path.join(path, "__init__.py") if os.path.isdir(path)
                else path + ".py")
        with open(path) as f:
            text = f.read()
        for word in ("import jax", "from repro.", "import ml_dtypes"):
            assert word not in text, (name, word)


def _subspace_step_on_cpu_params():
    """A subspace-Newton step on parameters on the CPU, device unsaid."""
    params = {"w": torch.zeros(4)}
    subspace_newton.subspace_newton_step(
        lambda p: torch.sum(p["w"] ** 2), params,
        subspace_newton.init_state(params),
        subspace_newton.SubspaceNewtonConfig(k=2), torch.Generator())


def test_lm_modules_import_without_jax_or_the_reference():
    script = _BLOCKED_IMPORT.replace("print(len(names))",
                                     "print(' '.join(names))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", script, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert set(LM_MODULES) <= set(out.stdout.split())
    for name in ("flash_attention", "wkv6", "gram"):
        assert (ops.build.CSRC / f"{name}.cu").exists()
        assert name in ops.build.sources()


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device (a stub device check)."""

    @property
    def device(self):
        return torch.device("cuda")


def test_cuda_tensor_never_reaches_the_plain_version(monkeypatch):
    def plain(*_):
        raise AssertionError("the plain version got a CUDA tensor")

    monkeypatch.setattr(ref, "gram_ref", plain)
    calls = []

    def no_kernel(dtype):
        calls.append(dtype)
        raise RuntimeError("no kernel here")

    monkeypatch.setattr(ops, "_gram_fn", no_kernel)
    before = ops.gram_launches
    x = torch.ones(64, 45).as_subclass(_FakeCuda)
    y = torch.ones(64).as_subclass(_FakeCuda)
    with pytest.raises(RuntimeError, match="no kernel here"):
        ops.gram(x, y)
    with pytest.raises(RuntimeError, match="no kernel here"):
        ops.gram(x.to(torch.bfloat16), y.to(torch.bfloat16))
    assert calls == [torch.float32, torch.bfloat16]
    assert ops.gram_launches == before
    # a CPU tensor still takes the plain version
    with pytest.raises(AssertionError, match="plain version"):
        ops.gram(torch.ones(64, 45), torch.ones(64))


def _fake_cuda(*shape, dtype=torch.float32):
    return torch.ones(*shape, dtype=dtype).as_subclass(_FakeCuda)


@pytest.mark.parametrize("name,call", [
    ("flash_attention_ref", lambda: ops.flash_attention(
        _fake_cuda(1, 8, 4, 16), _fake_cuda(1, 8, 2, 16),
        _fake_cuda(1, 8, 2, 16), window=4)),
    ("flash_attention_ref", lambda: ops.routed_attention(
        *(_fake_cuda(1, 8, 2, 16, dtype=torch.bfloat16),) * 3)),
    ("wkv6_ref", lambda: ops.wkv6(
        *(_fake_cuda(1, 8, 2, 16),) * 4, _fake_cuda(2, 16))),
    ("wkv6_ref", lambda: ops.routed_wkv6(
        *(_fake_cuda(1, 8, 2, 16, dtype=torch.bfloat16),) * 3,
        _fake_cuda(1, 8, 2, 16), _fake_cuda(2, 16, dtype=torch.bfloat16))),
    ("row_mean_ref", lambda: ops.row_mean(_fake_cuda(4, 100))),
])
def test_cuda_tensor_never_reaches_the_lm_plain_versions(monkeypatch, name,
                                                         call):
    def plain(*_, **__):
        raise AssertionError("the plain version got a CUDA tensor")

    monkeypatch.setattr(ref, name, plain)
    loaded = []

    def no_kernel(lib, fn, argtypes):
        loaded.append(lib)
        raise RuntimeError("no kernel here")

    monkeypatch.setattr(ops, "_kernel_fn", no_kernel)
    before = (ops.flash_attention_launches, ops.wkv6_launches,
              ops.row_mean_launches)
    with pytest.raises(RuntimeError, match="no kernel here"):
        call()
    assert loaded == [name[:-len("_ref")]]
    assert (ops.flash_attention_launches, ops.wkv6_launches,
            ops.row_mean_launches) == before


def test_cuda_launch_without_a_toolkit_raises(monkeypatch):
    """No try/except around the build: a missing nvcc surfaces as an
    error of the call, not as a quiet plain-version result."""
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed; chip_smoke.py covers it")
    monkeypatch.setattr(ops.build, "_libs", {})
    monkeypatch.setattr(ops.build, "library_path",
                        lambda name: ops.build.BUILD_DIR / "absent.so")
    x = torch.ones(64, 45).as_subclass(_FakeCuda)
    y = torch.ones(64).as_subclass(_FakeCuda)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops.gram(x, y)


def _engine_phase_finish():
    """An engine on its default device, driven to its first phase finish."""
    eng = AnmEngine(np.zeros(2), -np.ones(2), np.ones(2), np.ones(2),
                    AnmConfig(m_regression=6, m_line_search=6))
    eng.set_initial_fitness(1.0)
    tk, ph, pts, al = eng.generate_block()
    eng.assimilate_arrays(np.full(6, ph), tk, pts, al, np.full(6, -1),
                          np.sum(pts ** 2, axis=1))


def _anm_lm_main():
    """The act-1 command line with no arguments."""
    argv = sys.argv
    sys.argv = ["anm_lm", "--act", "1"]
    try:
        anm_lm.main()
    finally:
        sys.argv = argv


def _multi_search_main():
    """The portfolio command line with no arguments."""
    argv = sys.argv
    sys.argv = ["multi_search"]
    try:
        multi_search.main()
    finally:
        sys.argv = argv


@pytest.mark.parametrize("make", [
    lambda: sdss.make_fitness(sdss.make_stripe("s", 500, 64, 0)),
    lambda: InProcessEvalBackend(lambda p: p[:, 0]),
    lambda: PodMeshEvalBackend(lambda p: p[:, 0]),
    _engine_phase_finish,
    lambda: make_lm_workload("rwkv6-7b", k=2, seq_len=4),
    lambda: anm_lm.lm_problem(arch="h2o-danube-3-4b", k=2),
    lambda: transformer.init_params(get_smoke_config("rwkv6-7b"),
                                    torch.Generator()),
    lambda: orthonormal_basis(16, 2, torch.Generator()),
    _anm_lm_main,
    lambda: sim.smoke_problem(n_stars=50),
    lambda: sim.main([]),
    _multi_search_main,
    lambda: serve.main(["--requests", "1", "--gen-len", "1"]),
    lambda: transformer.init_cache(get_smoke_config("qwen2-72b"), 1, 4),
    lambda: baselines.run(n_stars=50),
    lambda: fig3.run(),
    _subspace_step_on_cpu_params,
    lambda: train.main(["--steps", "1"]),
    lambda: quickstart.main([]),
    lambda: volunteer_grid.main([]),
    lambda: multi_search.main(["--policy", "restart"]),
    lambda: fgdo_service.main([]),
    lambda: observability.main([]),
    lambda: serve_lm.main([]),
    lambda: train_lm.main(["--fast"]),
])
def test_cuda_default_does_not_fall_back_to_cpu(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        make()


#: the dry-run slice's modules: the walk above must import each, and a
#: whole cell reckons in an interpreter where jax and repro cannot load
DRYRUN_MODULES = ("repro_torch.launch.dryrun", "repro_torch.roofline",
                  "repro_torch.roofline.analysis")


def test_dryrun_modules_import_and_reckon_without_jax_or_the_reference():
    script = _BLOCKED_IMPORT.replace("print(len(names))", textwrap.dedent("""
        from repro_torch.configs import SHAPES, get_smoke_config
        from repro_torch.launch import dryrun
        report = dryrun.reckon(get_smoke_config("h2o-danube-3-4b"),
                               SHAPES["decode_32k"],
                               dryrun.production_mesh(False))
        assert report["hlo_flops"] > 0
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print(' '.join(names))
    """))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", script, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert set(DRYRUN_MODULES) <= set(out.stdout.split())


#: the substrate registry and the modules its four runners import: the
#: walk above must import each, and the pod_mesh runner runs where jax
#: and repro cannot load
SUBSTRATE_MODULES = (
    "repro_torch.launch.substrates", "repro_torch.launch.dryrun",
    "repro_torch.core.engine", "repro_torch.core.grid",
    "repro_torch.core.orchestrator", "repro_torch.core.substrates.batched_grid",
    "repro_torch.core.substrates.eval_backend",
    "repro_torch.core.substrates.eval_cache",
    "repro_torch.core.substrates.lm_loss",
    "repro_torch.core.substrates.pod_mesh", "repro_torch.data.sdss",
    "repro_torch.kernels.ops", "repro_torch.server.sim")


def test_substrate_modules_import_and_run_without_jax_or_the_reference(
        tmp_path):
    script = _BLOCKED_IMPORT.replace("print(len(names))", textwrap.dedent(f"""
        from repro_torch.launch import dryrun, substrates
        for smoke in substrates.SUBSTRATES.values():
            assert callable(smoke.resolve())
        assert dryrun.run_substrate_smoke({str(tmp_path)!r}, m=12,
                                          n_stars=200, n_hosts=48,
                                          device="cpu")
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print(' '.join(names))
    """))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", script, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert set(SUBSTRATE_MODULES) <= set(out.stdout.split())


#: a ``sitecustomize`` that blocks jax and the reference in every
#: interpreter that finds it on its path, and leaves a mark that it ran
_SITE_BLOCK = textwrap.dedent("""
    import os, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    with open(os.path.join(os.environ["BLOCK_MARKS"], str(os.getpid())),
              "w") as f:
        f.write(" ".join(sys.orig_argv))
""")


def test_the_server_runners_and_their_children_import_no_jax_or_reference(
        tmp_path):
    """The server runners' parent and every child they start run where
    jax and repro cannot load: a child of ``server/sim.py`` with the
    observability plane, retention, tracing, the defense, the eval cache
    and chaos over concurrent TCP on, and the post-mortem reader, each
    started through ``ServerChildren`` as the runners start them (forked
    from a forkserver that imported the port, under the same blocker)."""
    site, marks = tmp_path / "site", tmp_path / "marks"
    site.mkdir()
    marks.mkdir()
    (site / "sitecustomize.py").write_text(_SITE_BLOCK)
    script = textwrap.dedent(f"""
        import sys
        from repro_torch.launch import dryrun
        kids = dryrun.ServerChildren("iso_", "cpu", dryrun._spec_args(
            48, 12, 2, 200, silence=True))
        ckpt = kids.path("ckpt")
        try:
            doc = kids.run("all", [
                "--transport", "tcp", "--concurrent", "4", "--chaos",
                "drop_dup", "--obs", "--subscribe", "--retain",
                "--trace-rate", "1.0", "--defense", "--cache",
                "--ckpt-dir", ckpt, "--stats-interval", "10"])
            dead = kids.run("pm", ["--ckpt-dir", ckpt, "--json"],
                            module="repro_torch.launch.obs_postmortem")
        finally:
            kids.close()
        assert doc["device"] == "cpu" and dead["store"]["epochs"] == [1]
        assert kids.device_gate()["ok"]
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
    """)
    env = dict(os.environ, OMP_NUM_THREADS="1", BLOCK_MARKS=str(marks),
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           str(site)]))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    # the forkserver the children are forked from loaded the blocker (a
    # forked child inherits its import hooks), as did the parent
    argvs = [(marks / name).read_text() for name in os.listdir(marks)]
    assert any("multiprocessing.forkserver" in a for a in argvs), argvs
    assert any(a.endswith(script) for a in argvs), argvs
