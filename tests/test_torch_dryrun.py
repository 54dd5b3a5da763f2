"""The port's dry-run of the model cells (``repro_torch/launch/dryrun.py``).

* Per-device argument bytes of every arch × shape × mesh cell equal a
  count made here from the reference's own ``param_specs`` (through its
  ``enforce_divisible``), ``opt_state_specs``, ``cache_specs`` and
  ``input_specs`` and the shapes of ``jax.eval_shape`` (no compile); the
  reference's int32 tokens are counted at the port's int64.
* The meta trace's FLOPs equal ``FlopCounterMode`` around a real CPU run
  of the same step, at smoke width and 2 × 32 tokens, for train, prefill
  and decode on a dense, an MLA + MoE, an RWKV6 and a hybrid arch.
* ``TraceCounter``'s bytes and peak on a step counted by hand, and the
  guard: the dry-run makes no tensor off ``meta``.
* ``run_cell``'s skip-rule report and ``.err`` file, the reference's
  ``benchmarks/roofline.py::load_reports`` reading the port's reports,
  the perf-variant flags, ``--substrate`` refused, and one
  published-width cell through the command line.
"""
import argparse
import functools
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from benchmarks.roofline import load_reports
from repro.configs import SHAPES as j_SHAPES
from repro.configs import cell_is_runnable as j_cell_is_runnable
from repro.configs import get_config as j_get_config
from repro.models import sharding as JS
from repro.models import transformer as JT
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import opt_state_specs as j_opt_state_specs
from repro.roofline import analysis as JA
from repro_torch.configs import (ARCH_NAMES, SHAPES, ShapeConfig,
                                 cell_is_runnable, get_config,
                                 get_smoke_config)
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the keys of the reference's report (src/repro/launch/dryrun.py:143-166)
REFERENCE_KEYS = {
    "arch", "shape", "mesh", "n_chips", "kind", "tags", "lower_s",
    "compile_s", "memory_analysis", "hlo_flops", "hlo_bytes_accessed",
    "collective_bytes", "collective_bytes_by_kind",
    "collective_count_by_kind", "top_collectives", "model_flops",
    "useful_flops_ratio", "n_params", "n_active_params", "compute_s",
    "memory_s", "collective_s", "dominant", "step_time_lower_bound_s",
    "roofline_fraction"}
MEMORY_KEYS = {"argument_size_bytes", "output_size_bytes", "temp_size_bytes",
               "generated_code_size_bytes"}
#: the port's own: argument + the traced peak beside it, outputs included
PORT_MEMORY_KEYS = {"peak_size_bytes"}


class _FakeMesh:
    """Just enough Mesh interface for the reference's spec builders."""
    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.size = int(np.prod(list(shape.values())))


J_MESHES = {False: _FakeMesh({"data": 16, "model": 16}),
            True: _FakeMesh({"pod": 2, "data": 16, "model": 16})}


# -- argument bytes against the reference's specs ----------------------------

@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jax.eval_shape(functools.partial(JT.init_params,
                                            j_get_config(arch)),
                          jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _ref_param_bytes(arch, multi_pod):
    """(parameter bytes, AdamW state bytes) on one device."""
    cfg, mesh = j_get_config(arch), J_MESHES[multi_pod]
    pspecs, _ = JS.enforce_divisible(cfg, mesh, JS.param_specs(cfg, mesh))
    params = _ref_params(arch)
    state = jax.eval_shape(JAdamW(lr=1e-4).init, params)
    return (_ref_local(params, pspecs, mesh),
            _ref_local(state, j_opt_state_specs(pspecs), mesh))


def _ref_local(tree, specs, mesh, int32_bytes: int = 4) -> int:
    """One device's bytes of ``tree`` under ``specs``, an int32 leaf
    counted at ``int32_bytes``."""
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for x, spec in zip(leaves, spec_leaves):
        n = math.prod(x.shape)
        for e in spec:
            for a in (() if e is None else e if isinstance(e, tuple)
                      else (e,)):
                n //= mesh.shape[a]
        total += n * (int32_bytes if x.dtype == jnp.int32
                      else x.dtype.itemsize)
    return total


def _ref_argument_bytes(arch, shape_name, multi_pod) -> int:
    cfg, shape, mesh = (j_get_config(arch), j_SHAPES[shape_name],
                        J_MESHES[multi_pod])
    params, state = _ref_param_bytes(arch, multi_pod)
    batch, bspecs = JS.input_specs(cfg, shape, mesh)
    total = params + _ref_local(batch, bspecs, mesh, int32_bytes=8)
    if shape.kind == "train":
        total += state
    if shape.kind == "decode":
        cache = JT.init_cache(cfg, shape.global_batch, shape.seq_len,
                              as_shape=True)
        total += _ref_local(cache, JS.cache_specs(cfg, shape, mesh), mesh)
    return total


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_argument_bytes_equal_the_reference_count(arch, shape_name,
                                                  multi_pod):
    ok, reason = cell_is_runnable(get_config(arch), SHAPES[shape_name])
    assert (ok, reason) == j_cell_is_runnable(j_get_config(arch),
                                              j_SHAPES[shape_name])
    mesh = D.production_mesh(multi_pod)
    cell = D.build_cell(get_config(arch), SHAPES[shape_name], mesh)
    got = sum(D.local_bytes(a, s, mesh)
              for a, s in zip(cell.args, cell.arg_specs))
    assert got == _ref_argument_bytes(arch, shape_name, multi_pod)
    assert all(t.device.type == "meta" for t in D._tensors(cell.args))


# -- FLOPs traced on meta against a real CPU step ----------------------------

KINDS = {"train": ShapeConfig("t", 32, 2, "train"),
         "prefill": ShapeConfig("p", 32, 2, "prefill"),
         "decode": ShapeConfig("d", 32, 2, "decode")}


def _real_args(cfg, shape):
    """A step's arguments as CPU tensors from seeded draws."""
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        cache = T.init_cache(cfg, b, s, device="cpu")
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1)))
        return params, cache, tokens, torch.tensor(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 1)))
    if shape.kind == "prefill":
        return params, {"tokens": toks[:, :-1]}
    return (params, AdamW(lr=1e-4).init(params),
            {"tokens": toks[:, :-1], "labels": toks[:, 1:]})


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", ["qwen2-72b", "deepseek-v2-lite-16b",
                                  "rwkv6-7b", "zamba2-2.7b"])
def test_meta_flops_equal_a_real_cpu_step(arch, kind):
    cfg, shape = get_smoke_config(arch), KINDS[kind]
    cell = D.build_cell(cfg, shape, make_host_mesh("cpu"))
    traced = D.trace_step(cell)
    real = _real_args(cfg, shape)
    counter = FlopCounterMode(display=False)
    with counter:
        cell.step(*real)
    assert traced["flops"] == counter.get_total_flops() > 0


# -- the counters -------------------------------------------------------------

def test_trace_counter_by_hand():
    x = torch.empty(1000, device="meta")                 # 4000 bytes
    counter = D.TraceCounter()
    counter.exclude(x)

    def step(x):
        a = x * 2                     # 8000 moved, 4000 live
        b = a + 1                     # 8000 moved, 8000 live
        del a                         # 4000 live
        v = b[:10]                    # a view: nothing
        b.add_(1)                     # in place: 8000 moved, nothing new
        c = b * 3                     # 8000 moved, 8000 live
        return c, v
    with counter:
        out = step(x)
    assert counter.bytes_accessed == 4 * 8000
    assert counter.peak() == 8000 and counter.live == 8000
    # the outputs hold b's storage (through v) and c's: a alone is temp
    assert counter.serials(x) == frozenset()
    assert len(counter.serials(out)) == 2
    assert counter.peak(without=counter.serials(out)) == 4000
    del out
    assert counter.live == 0 and counter.peak() == 8000


def test_trace_counter_refuses_a_tensor_off_meta():
    with pytest.raises(RuntimeError, match="must stay on meta"):
        with D.TraceCounter():
            torch.zeros(3)
    with D.TraceCounter() as counter:        # no element: nothing allocated
        torch.empty((0,))
    assert counter.peak() == 0


class _Watch(TorchDispatchMode):
    """Every device an op's output of at least one element lies on."""
    def __init__(self):
        super().__init__()
        self.devices = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in D._tensors(out):
            if t.numel():
                self.devices.add(t.device.type)
        return out


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "zamba2-2.7b"])
def test_the_dry_run_makes_no_tensor_off_meta(arch):
    watch = _Watch()
    with watch:
        for kind in ("train", "decode"):
            report = D.reckon(get_smoke_config(arch), KINDS[kind],
                              D.production_mesh(False))
            assert report["hlo_flops"] > 0
    assert watch.devices == {"meta"}


# -- run_cell, main, the reference's reader ----------------------------------

def test_run_cell_skip_and_err_files(tmp_path, monkeypatch):
    assert D.run_cell("hubert-xlarge", "decode_32k", False, str(tmp_path))
    with open(tmp_path / "hubert-xlarge__decode_32k__16x16.json") as f:
        skipped = json.load(f)
    assert skipped == {"arch": "hubert-xlarge", "shape": "decode_32k",
                       "mesh": "16x16", "skipped": True,
                       "reason": "encoder-only arch has no decode step"}

    def fail(*args, **kwargs):
        raise ValueError("no such step")
    monkeypatch.setattr(D, "reckon_cell", fail)
    assert not D.run_cell("qwen2-72b", "train_4k", True, str(tmp_path))
    err = tmp_path / "qwen2-72b__train_4k__2x16x16.json.err"
    assert "ValueError: no such step" in err.read_text()
    assert not (tmp_path / "qwen2-72b__train_4k__2x16x16.json").exists()


def test_load_reports_reads_the_port_reports(tmp_path):
    assert D.run_cell("h2o-danube-3-4b", "long_500k", False, str(tmp_path))
    assert D.run_cell("qwen2-72b", "long_500k", False, str(tmp_path))
    reports = {r["arch"]: r for r in load_reports(str(tmp_path))}
    assert reports["qwen2-72b"]["skipped"]
    r = reports["h2o-danube-3-4b"]
    assert REFERENCE_KEYS <= set(r) and MEMORY_KEYS | PORT_MEMORY_KEYS == set(
        r["memory_analysis"])
    # load_reports recomputes the terms with the reference's constants
    assert r["compute_s"] == JA.roofline_terms(
        r["hlo_flops"], r["hlo_bytes_accessed"], r["collective_bytes"],
        r["n_chips"])["compute_s"]
    assert r["variant"] == "" and r["n_chips"] == 256


def test_variant_flags_replace_config_fields():
    args = argparse.Namespace(moe_dispatch="global", moe_cf=2.0,
                              remat_policy="dots", pin_proj=True,
                              quant_cache=True)
    cfg = D._variant(get_config("deepseek-v2-lite-16b"), args)
    assert (cfg.moe.dispatch, cfg.moe.capacity_factor, cfg.remat_policy,
            cfg.pin_proj_outputs, cfg.quantized_cache) == (
        "global", 2.0, "dots", True, True)
    dense = D._variant(get_config("qwen2-72b"), args)
    assert dense.moe is None and dense.pin_proj_outputs


@pytest.mark.parametrize("argv", [["--substrate", "pod_mesh"],
                                  ["--list-substrates"]])
def test_substrate_refused(argv, tmp_path, capsys):
    assert D.main(argv + ["--out", str(tmp_path)]) != 0
    assert "ROADMAP A.7" in capsys.readouterr().out
    assert not os.listdir(tmp_path)


def test_published_cell_through_the_command_line(tmp_path):
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "h2o-danube-3-4b", "--shape", "decode_32k", "--mesh", "multipod",
         "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert run.returncode == 0, run.stderr
    assert os.listdir(tmp_path) == ["h2o-danube-3-4b__decode_32k__"
                                    "2x16x16.json"]
    with open(tmp_path / "h2o-danube-3-4b__decode_32k__2x16x16.json") as f:
        r = json.load(f)
    assert REFERENCE_KEYS <= set(r) and r["n_chips"] == 512
    assert r["counted_by"] == D.COUNTED_BY
    assert r["model_flops"] == JA.model_flops(
        j_get_config("h2o-danube-3-4b"), j_SHAPES["decode_32k"], "decode")
    mem = r["memory_analysis"]
    mesh = D.production_mesh(True)
    cell = D.build_cell(get_config("h2o-danube-3-4b"), SHAPES["decode_32k"],
                        mesh)
    assert mem["argument_size_bytes"] == sum(
        D.local_bytes(a, s, mesh) for a, s in zip(cell.args,
                                                  cell.arg_specs))
    assert r["hlo_flops"] > 0 and mem["temp_size_bytes"] > 0
    # temp leaves out the outputs that the peak holds
    assert (mem["temp_size_bytes"] <= mem["peak_size_bytes"]
            - mem["argument_size_bytes"])
