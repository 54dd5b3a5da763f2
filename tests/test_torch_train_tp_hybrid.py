"""Training with Zamba2's units cut over the model axis across ranks
(``launch/train.py --ranks W --model-ranks M``, ``sharding.tp_ctx``):
Mamba2 over its inner channels, whole heads a rank, between Megatron's f
and g, its RMS norm's sum of squares all-reduced over the model group in
the forward and in the backward; the weight-shared attention block cut as
GQA attention and the SwiGLU MLP are, at each of its applications;
against the reference's whole-batch step, on the CPU with gloo ranks in
f32 (rank bodies in ``tests/torch_train_ranks.py``, the runs and the
rule of ``test_torch_train_tp.py``).

Three configurations from zamba2-2.7b's own ``smoke()`` (4 Mamba2 layers
of d_in 128 in 8 heads of 16, the shared block applied twice, tied
embeddings), each from the reference's parameters, 3 AdamW steps:

* ``zamba2`` on the (1, 2) mesh and ``zamba2-data`` on the (2, 2) mesh;
* ``zamba2-kv`` on the (1, 4) mesh with 2 kv heads: 4 do not divide
  them, so the shared block's ``wk`` / ``wv`` stay whole and their
  gradients are the rank's heads' share until summed.

Held: each step's loss within 1e-5 relative of the reference's, and each
step's gradient and the new parameters, the ranks' blocks put together,
within 1e-4 normwise a leaf (``test_torch_train_ranks._hold``); Mamba2's
``w_z``, ``w_xs`` and ``norm`` gradients, which an identity backward of
the norm's statistic would get wrong; every rank's whole leaves the same
bits; a rank's block all-reduces and norm all-reduces, count and bytes,
equal to ``reckon``'s ``over model`` entries; the dry-run's norm entries
counted by hand; the whole leaves read inside a cut unit, by name, their
bytes as the dry-run's "gradient" entries; every kind a rank counts (the
tied table's vocabulary cut among them) equal to the dry-run's entries
of that kind; the refusal of a cut that splits a head; the launcher's
run.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro_torch.configs.base import ShapeConfig, config_from_dict
from repro_torch.launch import dryrun, train
from repro_torch.launch.mesh import Mesh, virtual_devices
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T
from repro_torch.roofline import analysis as A

from test_torch_train_ranks import BATCH, SEQ, _hold
from test_torch_train_tp import N_STEPS, _hold_every_kind, _Runs, _reckon

ZAMBA2 = dataclasses.replace(j_smoke("zamba2-2.7b"), dtype="float32")
ZAMBA2_KV = dataclasses.replace(ZAMBA2, n_kv_heads=2)
#: name: (the reference's configuration, data ranks, model ranks)
CASES = {"zamba2": (ZAMBA2, 1, 2), "zamba2-data": (ZAMBA2, 2, 2),
         "zamba2-kv": (ZAMBA2_KV, 1, 4)}
#: the Mamba2 leaves a rank reads for its heads alone
MAMBA_PARTIAL = ("a_log", "conv_b_bc", "conv_w_bc", "dd", "dt_bias", "w_bc",
                 "w_dt")


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")          # the ranks' too
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _Runs(tmp_path_factory.mktemp("train_tp_hybrid"), CASES)


def _mamba_units(cfg) -> list:
    """``segments/<s>/<u>`` of each Mamba2 unit."""
    segs = T.find_segments(T.layer_sigs(config_from_dict(
        dataclasses.asdict(cfg))))
    return [f"segments/{si}/{ui}" for si, (unit, _) in enumerate(segs)
            for ui, (kind, _) in enumerate(unit) if kind == "mamba2"]


def _stats(cfg, shape: tuple) -> A.CollectiveStats:
    """The dry-run's collectives of a step of ``cfg`` on the ``shape``
    mesh, entry by entry."""
    pcfg = config_from_dict(dataclasses.asdict(cfg))
    mesh = Mesh(shape, ("data", "model"),
                virtual_devices(shape[0] * shape[1], dryrun.META))
    specs, _ = S.enforce_divisible(pcfg, mesh)
    return A.collective_bytes_from_specs(
        pcfg, ShapeConfig("t", SEQ, BATCH, "train"), mesh, specs)


@pytest.mark.parametrize("name", list(CASES))
def test_zamba2_over_the_model_axis_equals_the_reference_step(runs, name):
    run = runs(name)
    _hold(dict(run, arrays=[run["whole"]]))
    for r in range(run["m"], len(run["docs"])):
        assert run["docs"][r]["loss"] == run["docs"][r % run["m"]]["loss"]
    m = run["m"]
    cuts = run["docs"][0]["cuts"]
    # the inner channels over model (a stacked leaf's dimension one later)
    for where in _mamba_units(run["cfg"]):
        for leaf, dim in (("w_z", 2), ("w_xs", 2), ("conv_w_xs", 2),
                          ("conv_b_xs", 1), ("norm", 1), ("out_proj", 1)):
            assert cuts[f"{where}/mamba/{leaf}"] == dim, leaf
    assert cuts["shared_attn/attn/wo"] == 0
    assert cuts["shared_attn/mlp/w_out"] == 0
    for doc, arrays in zip(run["docs"], run["arrays"]):
        for path, dim in doc["cuts"].items():
            whole = run["ref"]["init"][path].shape
            assert arrays[f"p/{path}"].shape[dim] * m == whole[dim], path


@pytest.mark.parametrize("name", ["zamba2", "zamba2-kv"])
def test_the_norm_statistic_gradients_equal_the_reference(runs, name):
    """``w_z``, ``w_xs`` and the d_in norm's gradients, the ranks' blocks
    put together, against the reference's at every step: the norm's
    statistic feeds every rank's channels, so an identity backward would
    leave each rank only its own share of its gradient."""
    run = runs(name)
    for i, g_ref in enumerate(run["ref"]["grads"]):
        for where in _mamba_units(run["cfg"]):
            for leaf in ("w_z", "w_xs", "norm"):
                path = f"{where}/mamba/{leaf}"
                got, want = run["whole"][f"g{i}/{path}"], g_ref[path]
                assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(
                    want), (i, path)


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


@pytest.mark.parametrize("name", list(CASES))
def test_block_and_norm_all_reduces_equal_the_dryrun_model_entries(runs,
                                                                  name):
    """A rank's f and g all-reduces a step, bytes × 2 and their number, as
    ``reckon``'s ``over model`` entries (each Mamba2 layer's
    ``mamba/out_proj``, the shared block's ``attn/wo`` and ``mlp/w_out``
    at each application), and its norm statistics' all-reduces as the
    ``mamba/norm`` entries: one a Mamba2 layer a pass, two passes
    without remat."""
    run = runs(name)
    cfg = run["cfg"]
    report = _reckon(run)
    tokens = BATCH // run["hosts"] * SEQ
    mamba = len(_mamba_units(cfg))
    segs = T.find_segments(T.layer_sigs(config_from_dict(
        dataclasses.asdict(cfg))))
    repeat = segs[0][1]
    stats = _stats(cfg, (run["hosts"], run["m"]))
    names = {n.split(": ")[1] for n, kind in stats.kinds.items()
             if kind in ("block", "norm")}
    assert names == ({f"{w}/mamba/{leaf}" for w in _mamba_units(cfg)
                      for leaf in ("out_proj", "norm")}
                     | {"shared_attn/attn/wo", "shared_attn/mlp/w_out"})
    passes = 2
    applications = sum(kind == "shared_attn" for kind in cfg.blocks())
    assert report["model_all_reduces"] == passes * (
        mamba * repeat + 2 * applications)
    assert report["model_all_reduce_bytes"] == 2 * (
        report["model_all_reduces"] * tokens * cfg.d_model * 4)
    assert report["norm_all_reduces"] == passes * mamba * repeat
    assert report["norm_all_reduce_bytes"] == 2 * (
        report["norm_all_reduces"] * tokens * 4)
    for doc in run["docs"]:
        assert doc["model_calls"]["block"] == N_STEPS * report[
            "model_all_reduces"]
        assert 2 * doc["model_bytes"]["block"] == N_STEPS * report[
            "model_all_reduce_bytes"]
        assert doc["model_calls"]["norm"] == N_STEPS * report[
            "norm_all_reduces"]
        assert 2 * doc["model_bytes"]["norm"] == N_STEPS * report[
            "norm_all_reduce_bytes"]
        if run["hosts"] > 1:
            assert 2 * doc["gradient_bytes"] == N_STEPS * report[
                "gradient_all_reduce_bytes"]


@pytest.mark.parametrize("remat", [False, True])
def test_the_dryrun_counts_the_norm_statistics_by_hand(remat):
    """zamba2's smoke configuration on (1, 2): each Mamba2 layer's norm
    statistic is an all-reduce over ``model`` of the device's tokens ×
    4 B, counted twice (the ring), once a pass: two passes a step, three
    under remat, for each of the stacked segment's 2 layers an entry
    holds; on (2, 1) the channels are whole and there is none."""
    cfg = dataclasses.replace(ZAMBA2, remat=remat)
    stats = _stats(cfg, (1, 2))
    passes, repeat = (3 if remat else 2), 2
    tokens = BATCH * SEQ
    norm = {n: b for n, b in stats.ops.items() if n.endswith("/mamba/norm")}
    assert sorted(norm) == sorted(
        f"all-reduce over model (nvlink): {w}/mamba/norm"
        for w in _mamba_units(cfg))
    for n, b in norm.items():
        assert stats.op_counts[n] == repeat * passes
        assert b == repeat * passes * 2 * tokens * 4
    assert stats.norm_all_reduces == repeat * passes * len(norm)
    assert stats.norm_all_reduce_bytes == sum(norm.values())
    assert not any(n.endswith("/mamba/norm")
                   for n in _stats(cfg, (2, 1)).ops)


def test_whole_leaves_read_in_a_cut_unit_are_summed_over_the_model_group(
        runs):
    """Mamba2's B and C, dt, conv of B and C, and its per-head ``a_log`` /
    ``dt_bias`` / ``dd`` are read for the rank's heads alone; with 2 kv
    heads over 4 ranks the shared block's ``wk`` / ``wv`` too (its
    attention and MLP at ``shared_attn/...``): their gradients are the
    rank's share until summed over the model group, one f32 buffer a
    step.  The blocks' norms, outside every cut unit, are not."""
    for name, extra in (("zamba2", ()),
                        ("zamba2-kv", ("shared_attn/attn/wk",
                                       "shared_attn/attn/wv"))):
        run = runs(name)
        want = sorted([f"{w}/mamba/{leaf}" for w in _mamba_units(run["cfg"])
                       for leaf in MAMBA_PARTIAL] + list(extra))
        for doc in run["docs"]:
            assert doc["partial"] == want
            assert doc["model_calls"]["gradient"] == N_STEPS
            n = sum(run["ref"]["init"][p].size for p in want)
            assert doc["model_bytes"]["gradient"] == N_STEPS * n * 4


@pytest.mark.parametrize("name", list(CASES))
def test_the_partial_leaves_sums_equal_the_dryrun_entries(runs, name):
    """The bytes a rank hands to sum Mamba2's (and the shared block's k/v)
    partial gradients over the model group a step, x 2, equal the
    dry-run's "gradient" entries over model, one a leaf."""
    run = runs(name)
    report = _reckon(run)
    for doc in run["docs"]:
        assert 2 * doc["model_bytes"]["gradient"] == N_STEPS * report[
            "partial_gradient_all_reduce_bytes"]
        assert report["partial_gradient_all_reduces"] == len(doc["partial"])


@pytest.mark.parametrize("name", list(CASES))
def test_every_kind_a_rank_counts_equals_the_dryrun(runs, name):
    _hold_every_kind(runs(name))


@pytest.mark.parametrize("argv,match", [
    (["--ranks", "16", "--model-ranks", "16"],
     r"128 inner channels over --model-ranks 16 are 8 a rank"),
], ids=["splits-a-head"])
def test_a_cut_that_splits_a_head_is_refused(argv, match):
    """zamba2's smoke d_in 128 over 16 ranks is 8 channels a rank, half a
    head of 16: refused before any rank starts, naming
    ``--model-ranks``."""
    base = ["--device", "cpu", "--arch", "zamba2-2.7b", "--batch", "16"]
    with pytest.raises(ValueError, match=match):
        train.main(base + argv)
    cfg = config_from_dict(dataclasses.asdict(ZAMBA2))
    S.check_mamba_heads(cfg, 8)               # 16 channels: one head
    S.check_mamba_heads(cfg, 3)               # 3 does not divide: whole


def test_the_launcher_trains_the_smoke_configuration(capsys):
    """``launch/train.py --ranks 2 --model-ranks 2 --device cpu --arch
    zamba2-2.7b`` trains the smoke configuration in its bf16 to the end,
    each step's loss within the bf16 tolerance of one process's."""
    argv = ["--device", "cpu", "--arch", "zamba2-2.7b", "--batch", "4",
            "--seq", "32", "--steps", "2", "--log-every", "1"]
    assert train.main(argv + ["--ranks", "2", "--model-ranks", "2"]) == 0
    out = capsys.readouterr().out
    assert "[train] done" in out
    got = [float(line.split('"loss": ')[1].split(",")[0])
           for line in out.splitlines() if '"loss"' in line]
    one = train.run(argv)["losses"]
    assert len(got) == 2
    np.testing.assert_allclose(got, one, rtol=2e-2)
