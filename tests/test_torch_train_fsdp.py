"""Training with its parameters cut over the data axis's ranks
(``launch/train.py --ranks W --fsdp``, ``sharding.fsdp_ctx``) against the
reference's whole-batch step, on the CPU with gloo ranks (rank bodies in
``tests/torch_train_ranks.py``).

The configuration is small and in f32: d 256, vocab 4096, ff 1024, 4
layers.  ``param_specs(fsdp=True)`` then cuts the embedding, the head and
the stacked MLP leaves (2²⁰ elements each) and leaves attention whole; no
leaf of ``tiny`` or of a smoke configuration reaches 2²⁰, so there nothing
would be cut.  Held:

* over 2 and 4 gloo ranks, 3 AdamW steps from the reference's own
  parameters, each step's loss within 1e-5 relative of the reference's
  ``make_train_step`` on the whole batch, each step's gradient (the
  ranks' blocks put together) and the new parameters within 1e-4
  normwise a leaf (``test_torch_train_ranks._hold``'s rule for AdamW's
  sign-like elements), with a stacked and an unstacked leaf cut;
* port against port: ``--fsdp`` against the whole-leaf ranks of
  ``data_parallel_ctx`` within 1e-5, remat on and off;
* each cut leaf gathered twice a layer a step (the table once: only the
  lookup reads it) and reduce-scattered once, with remat on and off,
  and the bytes a rank hands its all-gathers, reduce-scatters and
  all-reduce equal to ``reckon(fsdp=True)``'s entries;
* the clip's norm the same on every rank and equal to one process's;
* the reference's rule: at W = 3 a leaf of 2²⁰ elements with no dimension
  3 divides stays whole, and a dimension with a ``model`` entry is never
  cut, even at ``model`` = 1;
* ``--fsdp`` refused without ``--ranks`` and with ``--compress-grads``,
  ``--line-search`` or ``--optimizer subspace-newton``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.launch.train import PRESETS as J_PRESETS
from repro_torch.configs.base import ShapeConfig, config_from_dict
from repro_torch.core.tree import leaves_with_paths
from repro_torch.launch import dryrun, ranks, train
from repro_torch.launch.mesh import Mesh, virtual_devices
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T

import torch_train_ranks as TR
from test_torch_train_ranks import (BATCH, SEQ, TARGET, _batches, _hold,
                                    _npz, _reference)

#: the reference's configuration: tiny's family and heads at widths whose
#: embedding, head and MLP leaves reach 2²⁰ elements, in f32
CFG = dataclasses.replace(J_PRESETS["tiny"], n_layers=4, d_model=256,
                          d_ff=1024, vocab_size=4096, head_dim=64,
                          dtype="float32")
N_STEPS = 3
#: port against port: the f32 sums' order only
PORT_TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")          # the ranks' too
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Runs:
    """Each (W, remat, fsdp) once a module: ``TR.steps`` over W gloo ranks
    from the reference's parameters; the reference on the concatenated
    batches once a W."""

    def __init__(self, base):
        self.base, self.refs, self.cache = base, {}, {}

    def ref(self, world: int) -> dict:
        if world not in self.refs:
            self.refs[world] = _reference(CFG, _batches(CFG, world, N_STEPS))
        return self.refs[world]

    def __call__(self, world: int, remat: bool = False, fsdp: bool = True):
        key = (world, remat, fsdp)
        if key not in self.cache:
            ref = self.ref(world)
            where = self.base / f"w{world}_r{int(remat)}_f{int(fsdp)}"
            where.mkdir()
            np.savez(where / "leaves.npz", **ref["init"])
            cfg = dataclasses.replace(CFG, remat=remat)
            kw = dict(cfg=dataclasses.asdict(cfg),
                      leaves=str(where / "leaves.npz"), seq=SEQ,
                      batch=BATCH, n_steps=N_STEPS, hosts=world,
                      out=str(where / "out"), fsdp=fsdp)
            res = ranks.run(TARGET + "steps", kw, world=world,
                            backend="gloo", devices=["cpu"] * world,
                            workdir=str(where / "w"))
            assert res.returncode == 0, res.failed
            arrays = [_npz(where / f"out_{r}.npz") for r in range(world)]
            self.cache[key] = dict(cfg=cfg, n_steps=N_STEPS, ref=ref,
                                   docs=res.docs, arrays=arrays, kw=kw,
                                   whole=_put_together(res.docs, arrays))
        return self.cache[key]


def _put_together(docs: list, arrays: list) -> dict:
    """The ranks' arrays with each cut leaf's blocks put together along
    its cut dimension (``RankShards.cuts``), by key."""
    cuts = docs[0].get("cuts", {})
    out = {}
    for key, x in arrays[0].items():
        path = key.split("/", 1)[1]
        if path in cuts:
            x = np.concatenate([a[key] for a in arrays], cuts[path])
        out[key] = x
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _Runs(tmp_path_factory.mktemp("train_fsdp"))


def _mesh(world: int) -> Mesh:
    return Mesh((world, 1), ("data", "model"),
                virtual_devices(world, dryrun.META))


def _cut_layers(cfg, cuts: dict) -> tuple:
    """(the layer slices of the cut leaves but the embedding table, the
    layer slices of every cut leaf): what a step gathers twice, and what
    it reduce-scatters once."""
    segs = T.find_segments(T.layer_sigs(cfg))

    def layers(path):
        parts = path.split("/")
        return segs[int(parts[1])][1] if parts[0] == "segments" else 1
    every = sum(layers(p) for p in cuts)
    return every - (1 if "embed/tok" in cuts else 0), every


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_over_ranks_equals_the_reference_whole_batch_step(runs, world):
    run = runs(world)
    cuts = run["docs"][0]["cuts"]
    assert "embed/tok" in cuts and "head/w" in cuts
    assert "segments/0/0/mlp/w_gate" in cuts              # stacked (4 layers)
    assert not any("/attn/" in p for p in cuts)
    _hold(dict(run, docs=run["docs"], arrays=[run["whole"]]))
    # each rank holds its blocks only, and its blocks of the moments
    for doc, arrays in zip(run["docs"], run["arrays"]):
        for path, dim in cuts.items():
            whole = run["ref"]["init"][path].shape
            got = arrays[f"p/{path}"].shape
            assert got[dim] * world == whole[dim], path
            assert tuple(doc["moment_shapes"][path]) == got, path


@pytest.mark.parametrize("remat", [False, True])
def test_fsdp_equals_the_whole_leaf_ranks(runs, remat):
    """Port against port: the parameters cut over 2 ranks against the same
    ranks holding every leaf whole (``data_parallel_ctx``)."""
    cut, whole = runs(2, remat=remat), runs(2, remat=remat, fsdp=False)
    np.testing.assert_allclose(cut["docs"][0]["loss"],
                               whole["docs"][0]["loss"], rtol=PORT_TOL)
    for key, want in whole["arrays"][0].items():
        got = cut["whole"][key]
        assert np.linalg.norm(got - want) <= PORT_TOL * max(
            np.linalg.norm(want), 1e-30), key


@pytest.mark.parametrize("world,remat", [(2, False), (2, True), (4, False)])
def test_gathers_and_bytes_equal_the_dryrun_entries(runs, world, remat):
    """Two gathers of each cut leaf a layer a step (one of the table), one
    reduce-scatter, with remat on and off; a rank's bytes a step equal
    the dry-run's "(fsdp)" entries and its whole leaves' all-reduce
    bytes x 2 the other gradient entries, on the (W, 1) mesh."""
    run = runs(world, remat=remat)
    cfg = config_from_dict(dataclasses.asdict(run["cfg"]))
    twice, once = _cut_layers(cfg, run["docs"][0]["cuts"])
    report = dryrun.reckon(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                           _mesh(world), fsdp=True)
    assert report["fsdp_all_gather_bytes"] > 0
    for doc in run["docs"]:
        assert doc["gathers"] == N_STEPS * (2 * twice + (once - twice))
        assert doc["scatters"] == N_STEPS * once
        assert doc["gather_bytes"] == N_STEPS * report[
            "fsdp_all_gather_bytes"]
        assert doc["scatter_bytes"] == N_STEPS * report[
            "fsdp_reduce_scatter_bytes"]
        assert 2 * doc["gradient_bytes"] == N_STEPS * report[
            "gradient_all_reduce_bytes"]
        assert doc["gradient_all_reduces"] == N_STEPS     # one type
    # remat changes no bit of the loss
    if remat:
        assert run["docs"][0]["loss"] == runs(world)["docs"][0]["loss"]


@pytest.mark.parametrize("world", [2, 4])
def test_the_clip_norm_is_global(runs, world, tmp_path):
    """Every rank clips by the same norm, the whole gradient's: one
    process's on the concatenated batches, and the reference's."""
    run = runs(world)
    gnorms = [d["gnorms"] for d in run["docs"]]
    assert all(g == gnorms[0] for g in gnorms) and len(gnorms[0]) == N_STEPS
    assert len({d["digest"] for d in run["docs"]}) == 1     # whole leaves
    one = TR.steps(None, **dict(run["kw"], out=str(tmp_path / "out"),
                                fsdp=False))
    arrays = _npz(tmp_path / "out_one.npz")
    for i in range(N_STEPS):
        want = np.sqrt(sum(np.sum(x.astype(np.float64) ** 2)
                           for key, x in arrays.items()
                           if key.startswith(f"g{i}/")))
        ref = np.sqrt(sum(np.sum(x.astype(np.float64) ** 2)
                          for x in run["ref"]["grads"][i].values()))
        np.testing.assert_allclose(gnorms[0][i], want, rtol=PORT_TOL)
        np.testing.assert_allclose(gnorms[0][i], ref, rtol=1e-4)
    np.testing.assert_allclose(one["loss"], run["docs"][0]["loss"],
                               rtol=PORT_TOL)


def _cpu_mesh(world: int, rank: int = 0) -> Mesh:
    return Mesh.over_ranks((world, 1), ("data", "model"), rank=rank,
                           rank_devices=["cpu"] * world)


def test_the_reference_rule_decides_the_cuts():
    """W = 3 divides none of 256, 1024 and 4096: the leaves of 2²⁰
    elements stay whole, and the ctx holds and uses every leaf as it is.
    At W = 2 the table (``tok``, (V, d) with ``model`` on V) is cut on d
    though V is larger, the head on d, a stacked leaf never on its layer
    axis."""
    cfg = config_from_dict(dataclasses.asdict(CFG))
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    big = [p for p, x in leaves_with_paths(params)
           if x.numel() >= 1 << 20]
    assert "embed/tok" in big and len(big) == 5
    three = S.fsdp_ctx(_cpu_mesh(3), cfg).ranks
    assert three.cuts == {}
    held = three.shard(params)
    assert all(a is b for (_, a), (_, b) in zip(
        leaves_with_paths(held), leaves_with_paths(params)))
    assert three.use(params["embed"], "embed")["tok"] is \
        params["embed"]["tok"]
    two = S.fsdp_ctx(_cpu_mesh(2, rank=1), cfg).ranks
    assert two.cuts == {"embed/tok": 1, "head/w": 0,
                        "segments/0/0/mlp/w_gate": 1,
                        "segments/0/0/mlp/w_in": 1,
                        "segments/0/0/mlp/w_out": 2}
    held = two.shard(params)
    tok = params["embed"]["tok"]
    assert torch.equal(held["embed"]["tok"], tok[:, 128:])   # rank 1's
    assert held["embed"]["tok"].data_ptr() != tok.data_ptr()  # a copy
    w_out = params["segments"][0][0]["mlp"]["w_out"]
    assert torch.equal(held["segments"][0][0]["mlp"]["w_out"],
                       w_out[:, :, 128:])


@pytest.mark.parametrize("extra,match", [
    ([], "pass --ranks"),
    (["--ranks", "2", "--compress-grads"], "--compress-grads"),
    (["--ranks", "2", "--line-search", "2"], "--line-search"),
    (["--ranks", "2", "--optimizer", "subspace-newton"], "subspace-newton"),
], ids=["no-ranks", "compress", "line-search", "subspace-newton"])
def test_unsupported_options_are_refused(extra, match):
    argv = ["--device", "cpu", "--preset", "tiny", "--fsdp"] + extra
    with pytest.raises(ValueError, match=match):
        train.main(argv)
    with pytest.raises(ValueError, match=match):
        train.run(argv)
