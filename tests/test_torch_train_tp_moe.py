"""Training with DeepSeek-V2-Lite's and Llama-4-Maverick's units cut over
the model axis across ranks (``launch/train.py --ranks W --model-ranks
M``, ``sharding.tp_ctx``): MLA over its heads between Megatron's f and g,
the MoE's experts over the model group with the dispatch buffer and the
experts' outputs exchanged by all-to-alls (GShard's expert parallelism,
each rank of a model group dispatching its block of the batch rows), the
shared experts as a cut MLP; against the reference's whole-batch step,
on the CPU with gloo ranks in f32 (rank bodies in
``tests/torch_train_ranks.py``, the runs and the rule of
``test_torch_train_tp.py``).

Four configurations from the reference's own ``smoke()``, each from the
reference's parameters, 3 AdamW steps:

* ``deepseek`` on the (1, 2) mesh and ``deepseek4`` on the (1, 4) mesh:
  deepseek-v2-lite's smoke configuration (MLA, 8 experts top-2, 1 shared
  expert, the first layer dense, the MoE segment stacked twice);
* ``deepseek-remat`` on the (2, 2) mesh: the same with remat, so every
  collective runs a third time in the recompute (held against the
  reference's step without remat, which computes the same values);
* ``maverick`` on the (1, 2) mesh: llama4-maverick's smoke configuration
  (GQA with q/k norms, 8 experts top-1, MoE every other layer, the vision
  stub's token path).

Held: each step's loss within 1e-5 relative of the reference's, and each
step's gradient and the new parameters, the ranks' blocks put together,
within 1e-4 normwise a leaf (``test_torch_train_ranks._hold``); every
rank's whole leaves the same bits; a rank's all-to-alls, in number and
bytes, equal to ``reckon``'s ``moe dispatch`` / ``moe combine`` entries,
and its block all-reduces to the ``over model`` entries (MLA's
``attn/wo`` and ``moe/shared/w_out`` among them); the groups' all-gathers
and the load-balance statistics' sums to a count from the shapes and to
the dry-run's "gather" (the port's own) and "stats" entries; the router
and MLA's latent leaves summed over the model group, their bytes as the
dry-run's "gradient" entries; every kind a rank counts equal to the
dry-run's; the drops on every rank equal to one process's, group by
group; the refusals.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro_torch.configs.base import ShapeConfig, config_from_dict
from repro_torch.launch import dryrun, ranks, train
from repro_torch.launch.mesh import Mesh, virtual_devices
from repro_torch.models import layers as L
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T
from repro_torch.roofline import analysis as A

import torch_train_ranks as TR
from test_torch_train_ranks import BATCH, SEQ, TARGET, _hold, _npz
from test_torch_train_tp import (N_STEPS, PORT_TOL, _hold_every_kind, _Runs,
                                 _reckon)

DEEPSEEK = dataclasses.replace(j_smoke("deepseek-v2-lite-16b"),
                               dtype="float32")
DEEPSEEK_REMAT = dataclasses.replace(DEEPSEEK, remat=True)
MAVERICK = dataclasses.replace(j_smoke("llama4-maverick-400b-a17b"),
                               dtype="float32")
#: name: (the reference's configuration, data ranks, model ranks[, the
#: configuration the reference steps: remat changes no value])
CASES = {"deepseek": (DEEPSEEK, 1, 2), "deepseek4": (DEEPSEEK, 1, 4),
         "deepseek-remat": (DEEPSEEK_REMAT, 2, 2, DEEPSEEK),
         "maverick": (MAVERICK, 1, 2)}


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")          # the ranks' too
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _Runs(tmp_path_factory.mktemp("train_tp_moe"), CASES)


def _segments(cfg) -> list:
    return T.find_segments(T.layer_sigs(config_from_dict(
        dataclasses.asdict(cfg))))


def _moe_units(cfg) -> list:
    """(``segments/<s>/<u>``, whether its segment is stacked) of each MoE
    unit."""
    return [(f"segments/{si}/{ui}", repeat > 1)
            for si, (unit, repeat) in enumerate(_segments(cfg))
            for ui, (_, is_moe) in enumerate(unit) if is_moe]


def _moe_layers(cfg) -> int:
    return sum(1 for _, is_moe in T.layer_sigs(config_from_dict(
        dataclasses.asdict(cfg))) if is_moe)


@pytest.mark.parametrize("name", list(CASES))
def test_moe_and_mla_over_the_model_axis_equal_the_reference_step(runs,
                                                                  name):
    run = runs(name)
    assert all(a > 0 for a in run["ref"]["aux"])
    _hold(dict(run, arrays=[run["whole"]]))
    for r in range(run["m"], len(run["docs"])):
        assert run["docs"][r]["loss"] == run["docs"][r % run["m"]]["loss"]
    m = run["m"]
    cuts = run["docs"][0]["cuts"]
    # the experts over E (a stacked leaf's second dimension), MLA's and
    # the shared experts' over heads and hidden units
    units = _moe_units(run["cfg"])
    for where, stacked in units:
        for leaf in ("w_gate", "w_in", "w_out"):
            assert cuts[f"{where}/moe/{leaf}"] == (1 if stacked else 0)
    for doc, arrays in zip(run["docs"], run["arrays"]):
        for path, dim in doc["cuts"].items():
            whole = run["ref"]["init"][path].shape
            assert arrays[f"p/{path}"].shape[dim] * m == whole[dim], path


@pytest.mark.parametrize("name", list(CASES))
def test_whole_leaves_are_the_same_bits_on_every_rank(runs, name):
    run = runs(name)
    assert len({d["digest"] for d in run["docs"]}) == 1
    cuts = run["docs"][0]["cuts"]
    first = run["arrays"][0]
    for other in run["arrays"][1:]:
        for key, x in first.items():
            if key.split("/", 1)[1] not in cuts:
                assert np.array_equal(x, other[key]), key


def _stats(run) -> A.CollectiveStats:
    """The dry-run's collectives of the case's step, entry by entry."""
    cfg = config_from_dict(dataclasses.asdict(run["cfg"]))
    shape = (run["hosts"], run["m"])
    mesh = Mesh(shape, ("data", "model"),
                virtual_devices(shape[0] * shape[1], dryrun.META))
    specs, _ = S.enforce_divisible(cfg, mesh)
    return A.collective_bytes_from_specs(
        cfg, ShapeConfig("t", SEQ, BATCH, "train"), mesh, specs)


@pytest.mark.parametrize("name", list(CASES))
def test_all_to_alls_equal_the_dryrun_moe_entries(runs, name):
    """A rank's all-to-alls a step: two a MoE layer a pass (dispatch and
    combine; three passes under remat, two without), each handing the
    rank's (E, B/D/M · capacity, d) buffer, as ``reckon``'s ``moe
    dispatch`` / ``moe combine`` entries count them."""
    run = runs(name)
    cfg = run["cfg"]
    report = _reckon(run)
    passes = 3 if cfg.remat else 2
    layers = _moe_layers(cfg)
    rows = BATCH // run["hosts"] // run["m"]
    cap = L.moe_capacity(cfg.moe, SEQ)
    each = cfg.moe.n_experts * rows * cap * cfg.d_model * 4
    assert report["moe_all_to_alls"] == 2 * layers * passes
    assert report["moe_all_to_all_bytes"] == report["moe_all_to_alls"] * each
    ops = _stats(run).op_counts
    assert sorted(n.split(": ")[1] for n in ops
                  if n.startswith("all-to-all over model ")) == sorted(
        f"{where}/moe {w}" for where, _ in _moe_units(cfg)
        for w in ("dispatch", "combine"))
    for doc in run["docs"]:
        assert doc["model_calls"]["exchange"] == N_STEPS * report[
            "moe_all_to_alls"]
        assert doc["model_bytes"]["exchange"] == N_STEPS * report[
            "moe_all_to_all_bytes"]


@pytest.mark.parametrize("name", list(CASES))
def test_block_all_reduces_equal_the_dryrun_model_entries(runs, name):
    """A rank's f and g all-reduces a step, bytes × 2 and their number, as
    ``reckon``'s ``over model`` entries: a unit's a pass, MLA's
    ``attn/wo`` (deepseek) or GQA's (maverick), the dense ``mlp/w_out``
    and the shared experts' ``moe/shared/w_out``."""
    run = runs(name)
    cfg = run["cfg"]
    report = _reckon(run)
    passes = 3 if cfg.remat else 2
    tokens = BATCH // run["hosts"] * SEQ
    names = {n.split(": ")[1] for n, kind in _stats(run).kinds.items()
             if kind == "block"}
    want = set()
    for si, (unit, _) in enumerate(_segments(cfg)):
        for ui, (_, is_moe) in enumerate(unit):
            where = f"segments/{si}/{ui}"
            want |= {f"{where}/attn/wo", f"{where}/moe/shared/w_out"
                     if is_moe else f"{where}/mlp/w_out"}
    assert names == want
    assert report["model_all_reduces"] == 2 * cfg.n_layers * passes
    assert report["model_all_reduce_bytes"] == 2 * (
        report["model_all_reduces"] * tokens * cfg.d_model * 4)
    for doc in run["docs"]:
        assert doc["model_calls"]["block"] == N_STEPS * report[
            "model_all_reduces"]
        assert 2 * doc["model_bytes"]["block"] == N_STEPS * report[
            "model_all_reduce_bytes"]
        if run["hosts"] > 1:
            assert 2 * doc["gradient_bytes"] == N_STEPS * report[
                "gradient_all_reduce_bytes"]


@pytest.mark.parametrize("name", list(CASES))
def test_the_groups_gathers_and_statistics_by_hand(runs, name):
    """A MoE layer's groups' outputs all-gathered over the model group in
    each forward (the recompute's too) and their input's gradient in the
    backward, each the rank's (B/D/M, S, d) block; the load-balance
    statistics (2 × E f32) summed over every rank in each forward."""
    run = runs(name)
    cfg = run["cfg"]
    passes = 3 if cfg.remat else 2
    layers = _moe_layers(cfg)
    rows = BATCH // run["hosts"] // run["m"]
    for doc in run["docs"]:
        assert doc["model_calls"]["gather"] == N_STEPS * layers * passes
        assert doc["model_bytes"]["gather"] == (
            doc["model_calls"]["gather"] * rows * SEQ * cfg.d_model * 4)
        assert doc["model_calls"]["stats"] == N_STEPS * layers * (passes - 1)
        assert doc["model_bytes"]["stats"] == (
            doc["model_calls"]["stats"] * 2 * cfg.moe.n_experts * 4)


@pytest.mark.parametrize("name", list(CASES))
def test_the_groups_gathers_and_statistics_equal_the_dryrun_entries(runs,
                                                                    name):
    """The groups' all-gathers a rank hands a step, x M (the dry-run
    counts an all-gather's result) and in number, equal the dry-run's
    "gather" entries, ``<unit>/moe gather (port)``; the statistics' sums,
    x 2 (the ring) and in number, its "stats" entries over data x
    model."""
    run = runs(name)
    report = _reckon(run)
    assert sorted(n.split(": ")[1] for n, kind in _stats(run).kinds.items()
                  if kind == "gather") == sorted(
        f"{where}/moe gather (port)" for where, _ in _moe_units(run["cfg"]))
    assert report["moe_all_gathers"] > 0 and report["moe_stats_all_reduces"] > 0
    for doc in run["docs"]:
        assert run["m"] * doc["model_bytes"]["gather"] == N_STEPS * report[
            "moe_all_gather_bytes"]
        assert doc["model_calls"]["gather"] == N_STEPS * report[
            "moe_all_gathers"]
        assert 2 * doc["model_bytes"]["stats"] == N_STEPS * report[
            "moe_stats_all_reduce_bytes"]
        assert doc["model_calls"]["stats"] == N_STEPS * report[
            "moe_stats_all_reduces"]


@pytest.mark.parametrize("name", list(CASES))
def test_every_kind_a_rank_counts_equals_the_dryrun(runs, name):
    _hold_every_kind(runs(name))


@pytest.mark.parametrize("name", ["deepseek", "maverick"])
def test_router_and_latent_leaves_sums_equal_the_dryrun_entries(runs, name):
    """The partial leaves' gradient sums a rank hands a step, x 2, equal
    the dry-run's "gradient" entries over model, one a leaf."""
    run = runs(name)
    report = _reckon(run)
    for doc in run["docs"]:
        assert 2 * doc["model_bytes"]["gradient"] == N_STEPS * report[
            "partial_gradient_all_reduce_bytes"]
        assert report["partial_gradient_all_reduces"] == len(doc["partial"])


@pytest.mark.parametrize("name", ["deepseek", "maverick"])
def test_router_and_latent_leaves_are_summed_over_the_model_group(runs,
                                                                  name):
    """The router routes the rank's groups alone, and MLA's ``w_dkv``,
    ``w_krope`` and ``kv_norm`` (deepseek) or the q/k norms (maverick) are
    read by the rank's heads alone: their gradients are the rank's share
    until summed over the model group, one f32 buffer a step."""
    run = runs(name)
    unit_leaves = (("w_dkv", "w_krope", "kv_norm") if name == "deepseek"
                   else ("k_norm", "q_norm"))
    want = set()
    for si, (unit, _) in enumerate(_segments(run["cfg"])):
        for ui, (_, is_moe) in enumerate(unit):
            where = f"segments/{si}/{ui}"
            want |= {f"{where}/attn/{n}" for n in unit_leaves}
            if is_moe:
                want.add(f"{where}/moe/router")
    for doc in run["docs"]:
        assert doc["partial"] == sorted(want)
        assert doc["model_calls"]["gradient"] == N_STEPS
        n = sum(run["ref"]["init"][p].size for p in want)
        assert doc["model_bytes"]["gradient"] == N_STEPS * n * 4


def test_the_clip_norm_and_the_one_process_step(runs, tmp_path):
    """Every rank clips by one norm: the one-process port's on the same
    batch, and the reference's; the one-process losses equal the ranks'
    (the router's gradient not counted once a rank)."""
    run = runs("deepseek")
    gnorms = [d["gnorms"] for d in run["docs"]]
    assert all(g == gnorms[0] for g in gnorms) and len(gnorms[0]) == N_STEPS
    one = TR.steps(None, **dict(run["kw"], out=str(tmp_path / "out")))
    arrays = _npz(tmp_path / "out_one.npz")
    for i in range(N_STEPS):
        want = np.sqrt(sum(np.sum(x.astype(np.float64) ** 2)
                           for key, x in arrays.items()
                           if key.startswith(f"g{i}/")))
        np.testing.assert_allclose(gnorms[0][i], want, rtol=PORT_TOL)
        router = "segments/1/0/moe/router"
        got, want = run["whole"][f"g{i}/{router}"], arrays[f"g{i}/{router}"]
        assert np.linalg.norm(got - want) <= PORT_TOL * np.linalg.norm(want)
    np.testing.assert_allclose(one["loss"], run["docs"][0]["loss"],
                               rtol=PORT_TOL)


@pytest.mark.parametrize("m", [2, 4])
def test_the_drops_on_every_rank_equal_one_process(m, tmp_path):
    """At capacity factor 0.5 the grouped dispatch drops entries (the
    output differs from a dispatch without drops); each rank of a model
    group decides its block of the groups' drops, and the groups' outputs
    put together equal one process's, row by row, on every rank, and so
    does the load-balance loss."""
    cfg = dataclasses.replace(
        config_from_dict(dataclasses.asdict(DEEPSEEK)),
        moe=dataclasses.replace(DEEPSEEK.moe, capacity_factor=0.5))
    x = np.random.default_rng(0).standard_normal(
        (4, SEQ, cfg.d_model)).astype(np.float32)
    np.savez(tmp_path / "x.npz", x=x)
    world = m
    res = ranks.run(TARGET + "moe_forward",
                    dict(cfg=dataclasses.asdict(cfg), x=str(tmp_path / "x.npz"),
                         out=str(tmp_path / "y"), model_ranks=m),
                    world=world, backend="gloo", devices=["cpu"] * world,
                    workdir=str(tmp_path / "w"))
    assert res.returncode == 0, res.failed
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    moe = {k: (v[0] if not isinstance(v, dict) else
               {kk: vv[0] for kk, vv in v.items()})
           for k, v in params["segments"][1][0]["moe"].items()}
    with torch.no_grad():
        y, aux = L.moe_block(torch.from_numpy(x), moe, cfg)
        roomy = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
        y_all, _ = L.moe_block(torch.from_numpy(x), moe, roomy)
    assert not torch.allclose(y, y_all, atol=1e-3)
    for r in range(world):
        got = _npz(tmp_path / f"y_{r}.npz")
        np.testing.assert_allclose(got["y"], y.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["aux"], aux.numpy(), rtol=1e-6)
    doc = res.docs[0]
    assert doc["model_calls"]["exchange"] == 2
    assert doc["model_calls"]["gather"] == doc["model_calls"]["stats"] == 1


def _model_ctx(cfg, world: int, m: int) -> T.ShardCtx:
    mesh = Mesh.over_ranks((world // m, m), ("data", "model"), rank=0,
                           rank_devices=["cpu"] * world, model_ranks=m)
    return T.ShardCtx(ranks=S.ModelShards(mesh, cfg))


def test_the_global_dispatch_is_refused_over_the_model_axis():
    cfg = config_from_dict(dataclasses.asdict(DEEPSEEK))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch="global"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ctx = _model_ctx(cfg, 2, 2)
    held = ctx.ranks.shard(params)
    moe = {k: v[0] for k, v in held["segments"][1][0]["moe"].items()
           if not isinstance(v, dict)}
    with pytest.raises(NotImplementedError, match=r"A\.8 \(v\)"):
        L.moe_block(torch.zeros(2, 4, cfg.d_model), moe, cfg, ctx)


@pytest.mark.parametrize("argv,match", [
    (["--ranks", "4", "--model-ranks", "4", "--batch", "2"],
     "2 batch rows.*--model-ranks 4"),
    (["--ranks", "4", "--model-ranks", "2", "--batch", "6"],
     "3 batch rows.*--model-ranks 2"),
], ids=["one-data-rank", "two-data-ranks"])
def test_model_ranks_that_do_not_divide_the_rows_are_refused(argv, match):
    """Each rank of a model group dispatches its block of a data rank's
    batch rows: a block size M does not divide is refused before any
    rank starts, naming the rows and ``--model-ranks``."""
    base = ["--device", "cpu", "--arch", "deepseek-v2-lite-16b"]
    with pytest.raises(ValueError, match=match):
        train.main(base + argv)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "llama4-maverick-400b-a17b"])
def test_the_launcher_trains_the_smoke_configurations(arch, capsys):
    """``launch/train.py --ranks 2 --model-ranks 2 --device cpu --arch
    <arch>`` trains the smoke configuration in its bf16 to the end, each
    step's loss within the bf16 tolerance of one process's."""
    argv = ["--device", "cpu", "--arch", arch, "--batch", "4", "--seq",
            "32", "--steps", "2", "--log-every", "1"]
    assert train.main(argv + ["--ranks", "2", "--model-ranks", "2"]) == 0
    out = capsys.readouterr().out
    assert "[train] done" in out
    ranked = [line for line in out.splitlines() if '"loss"' in line]
    one = train.run(argv)["losses"]
    got = [float(line.split('"loss": ')[1].split(",")[0])
           for line in ranked]
    assert len(got) == 2
    np.testing.assert_allclose(got, one, rtol=2e-2)
