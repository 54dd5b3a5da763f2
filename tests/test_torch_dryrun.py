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
from repro_torch.launch.mesh import Mesh, make_host_mesh, virtual_devices
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW
from repro_torch.roofline.analysis import local_numel

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


# -- per-device pieces: each storage by its own layout -----------------------

def _mesh(*sizes):
    names = ("pod", "data", "model")[-len(sizes):]
    return Mesh(sizes, names, virtual_devices(math.prod(sizes), "meta"))


def test_an_activation_constrained_over_model_counts_half():
    """On 2 × 2 the batch's rows are cut 2 ways: an activation the
    forward constrains over ``model`` as well is a quarter a device,
    half the piece of one that carries the rows alone."""
    mesh = _mesh(2, 2)
    counter = D.TraceCounter(mesh, row_shards=2)
    x = torch.empty(4, 8, 16, device="meta")           # 2048 bytes
    counter.exclude(x, D.S.P("data", None, None), rows=True)
    ctx = D.TraceCtx(mesh=mesh, dp=("data",), tp="model",
                     tags=D.LayoutTags(counter))
    with counter:
        a = ctx.cons_spec(x * 2, ("dp", "model", None))
        b = ctx.cons(x * 3, None, None)
        c = x * 4                                      # no constraint
        d = a + 1                                      # a's own shape
    assert [counter.piece(t) for t in (a, b, c, d)] == [512, 1024, 1024,
                                                        512]
    assert counter.local_peak() == 512 + 1024 + 1024 + 512
    assert counter.peak() == 4 * 2048


class _KeepGrads:
    """AdamW that keeps the gradients it is handed (so that the trace's
    counter still knows their storages after the step)."""

    def __init__(self):
        self.opt, self.grads = AdamW(lr=1e-4), None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        self.grads = grads
        return self.opt.update(grads, state, params)


def _traced_grads(mesh):
    """(grads, their specs, the counter, the batch's row shards) of a
    smoke-width qwen2 train step traced over ``mesh``."""
    cfg, shape = get_smoke_config("qwen2-72b"), ShapeConfig("t", 32, 4,
                                                             "train")
    keep = _KeepGrads()
    cell = D.build_cell(cfg, shape, mesh, optimizer=keep)
    shards = D._batch_shards(shape, mesh)
    run = D.trace_step(cell, mesh, shards)
    return keep.grads, cell.arg_specs[0], run["counter"], shards


def _products(mesh, rows_spec):
    """The column-parallel, row-parallel and attention products of a
    (4, 8, 16) f32 batch whose rows are laid out by ``rows_spec``, traced
    over ``mesh``: {name: (global bytes, one device's piece)}."""
    axes = rows_spec if isinstance(rows_spec, tuple) else (rows_spec,)
    counter = D.TraceCounter(mesh, math.prod(mesh.shape[a] for a in axes))
    x = torch.empty(4, 8, 16, device="meta")
    w_col = torch.empty(16, 32, device="meta")
    w_row = torch.empty(32, 16, device="meta")
    w_qkv = torch.empty(16, 16, device="meta")
    counter.exclude(x, D.S.P(rows_spec, None, None), rows=True)
    counter.exclude(w_col, D.S.P(None, "model"))
    counter.exclude(w_row, D.S.P("model", None))
    counter.exclude(w_qkv, D.S.P(None, "model"))
    with counter:
        col = torch.matmul(x, w_col)                   # (4, 8, 32)
        row = torch.matmul(col, w_row)                 # partial sums
        q, k, v = (torch.matmul(x, w_qkv).view(4, 8, 2, 8)
                   for _ in range(3))                  # 2 heads of 8
        scores = torch.einsum("bshd,bthd->bhst", q, k)
        probs = torch.softmax(scores, dim=-1)
        pv = torch.einsum("bhst,bthd->bshd", probs, v)
    return {name: (t.numel() * t.element_size(), counter.piece(t))
            for name, t in (("col", col), ("row", row), ("scores", scores),
                            ("probs", probs), ("pv", pv))}


def test_a_products_output_is_cut_as_its_operands_free_dimensions():
    """2 × 2, the rows cut 2 ways: x times a weight cut over ``model`` on
    its output dimension is a quarter a device; the row-parallel product
    (its weight cut over ``model`` on the contracted dimension) a partial
    sum cut as its rows alone; the scores, their softmax and PV from
    heads cut over ``model`` a quarter."""
    assert _products(_mesh(2, 2), "data") == {
        "col": (4096, 1024), "row": (2048, 1024), "scores": (2048, 512),
        "probs": (2048, 512), "pv": (2048, 512)}


def test_the_column_parallel_product_is_cut_8_ways_on_2x2x2():
    """2 × 2 × 2: the rows cut 4 ways (pod × data), the weight's output
    dimension 2 ways (``model``)."""
    got = _products(_mesh(2, 2, 2), ("pod", "data"))
    assert got["col"] == (4096, 4096 // 8)
    assert got["row"] == (2048, 2048 // 4)


def test_a_copy_keeps_its_inputs_cut_whatever_its_shape():
    """A transposed copy, a reshape that copies and a cast keep the cuts
    of the dimensions they move: each a quarter on 2 × 2."""
    mesh = _mesh(2, 2)
    counter = D.TraceCounter(mesh, row_shards=2)
    x = torch.empty(4, 8, 16, device="meta")
    counter.exclude(x, D.S.P("data", None, "model"), rows=True)
    with counter:
        moved = x.transpose(0, 2).contiguous()         # (16, 8, 4)
        flat = x.transpose(1, 2).reshape(4, 128)       # a copy
        cast = moved.to(torch.float16)
        whole = x.sum(dim=(0, 2))                      # (8,): cut away
    assert [counter.piece(t) for t in (moved, flat)] == [512, 512]
    assert counter.piece(cast) == 256
    # a reduction over the cut dimensions: whole but for the row floor
    assert counter.piece(whole) == 32 // 2


def test_a_replicated_norms_gradient_counts_whole():
    """2 × 2: a norm's replicated gradient is whole on every device, not
    ÷ the batch's 2 data shards; every gradient is its parameter's piece."""
    mesh = _mesh(2, 2)
    grads, specs, counter, shards = _traced_grads(mesh)
    assert shards == 4 // mesh.shape["model"]
    norm = grads["final_norm"]["scale"]
    assert all(e is None for e in specs["final_norm"]["scale"])
    assert counter.piece(norm) == norm.numel() * norm.element_size()
    D.S.map_specs(lambda path, g, spec: _check_piece(counter, g, spec,
                                                     mesh, path),
                  grads, specs)


def _check_piece(counter, g, spec, mesh, path):
    assert counter.piece(g) == local_numel(tuple(g.shape), spec, mesh) * \
        g.element_size(), path


def test_a_gradient_cut_over_model_only_is_halved_on_2x2x2():
    """2 × 2 × 2: the batch's rows are cut 4 ways (pod × data); a gradient
    whose parameter is cut over ``model`` alone is ÷ 2, not ÷ 4."""
    mesh = _mesh(2, 2, 2)
    grads, specs, counter, shards = _traced_grads(mesh)
    assert shards == 4
    seen = []

    def check(path, g, spec):
        if [e for e in spec if e is not None] == ["model"]:
            whole = g.numel() * g.element_size()
            assert counter.piece(g) == whole // 2, path
            seen.append(path)
    D.S.map_specs(check, grads, specs)
    assert seen


#: ``reckon``'s memory_analysis on a (1, 1) mesh before the pieces were
#: laid out storage by storage (each the same there: every piece whole)
ONE_DEVICE = {
    ("qwen2-72b", "train"): {
        "argument_size_bytes": 1583748, "output_size_bytes": 1582736,
        "temp_size_bytes": 1211652, "generated_code_size_bytes": None,
        "peak_size_bytes": 2795412},
    ("deepseek-v2-lite-16b", "decode"): {
        "argument_size_bytes": 535640, "output_size_bytes": 17408,
        "temp_size_bytes": 43088, "generated_code_size_bytes": None,
        "peak_size_bytes": 578728},
}


@pytest.mark.parametrize("arch,kind", list(ONE_DEVICE))
def test_one_device_figures_are_unchanged(arch, kind):
    report = D.reckon(get_smoke_config(arch), KINDS[kind],
                      make_host_mesh("meta"))
    assert report["memory_analysis"] == ONE_DEVICE[(arch, kind)]


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


@pytest.mark.parametrize("name", ["server", "chaos_server", "obs_server",
                                  "postmortem"])
def test_substrate_refused(name, tmp_path, monkeypatch):
    """The four server smokes, once refused by name, run through the
    command line on the CPU (their children on one thread each), exit 0
    and write their report."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert D.main(["--substrate", name, "--device", "cpu", "--out",
                   str(tmp_path)]) == 0
    with open(tmp_path / f"substrate_{name}.json") as f:
        report = json.load(f)
    assert report["parity_ok"] and report["device"] == "cpu"
    assert os.listdir(tmp_path) == [f"substrate_{name}.json"]


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
