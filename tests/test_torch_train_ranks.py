"""Training's data axis over ranks against the reference's whole-batch
step, on the CPU with gloo ranks (``launch/ranks.py``; rank bodies in
``tests/torch_train_ranks.py``).

The reference's train step is written in JAX's global view: its loss is
the mean over the whole batch's tokens and its MoE statistics are the
whole batch's.  Rank r of W holds host r's rows (``DataConfig(n_hosts=W,
host_id=r)``) and steps in ``sharding.data_parallel_ctx``; the reference
steps once on the concatenation of the W hosts' batches, from the same
parameters (its own, carried across by leaf path).  Held, in f32:

* the tiny preset over 2 and 4 ranks, 3 AdamW steps: each step's loss
  within 1e-5 relative, each step's gradient (summed over the ranks)
  within 1e-4 normwise a leaf, and the new parameters within 1e-4
  normwise a leaf (the tolerances of ``[train]`` (t4)), leaving out
  elements whose gradient at some step is not ten times its own error
  or is at AdamW's eps (AdamW's early steps are sign-like, as
  ``tests/torch_train_step.py`` leaves them out);
* every rank's parameters and gradients equal bit for bit;
* the one-process port on the concatenated batches against the ranks'
  summed gradients within 1e-5 a leaf (the summation order only): a
  gradient counted once a rank would be W times too large, which AdamW's
  normalised update would hide;
* the gradient bytes a rank hands to its all-reduces, x 2, equal the
  dry-run's data-parallel gradient entries for the (W, 1) mesh exactly;
* hubert's masked loss over 2 ranks (masks differing row by row) within
  1e-5 of the reference's, and the mean of the ranks' own means outside
  it (the control);
* deepseek-v2-lite's smoke config (grouped MoE dispatch) over 2 ranks,
  2 steps: loss, aux and parameters as the tiny preset's; the global
  dispatch refused over ranks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.launch.train import PRESETS as J_PRESETS
from repro.models import transformer as JT
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.configs.base import ShapeConfig, config_from_dict
from repro_torch.core.tree import map_tree
from repro_torch.launch import dryrun, ranks, train
from repro_torch.launch.mesh import Mesh, virtual_devices
from repro_torch.models import layers as L
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T

import torch_train_ranks as TR

LOSS_TOL = 1e-5
TOL = 1e-4
#: one-process against over ranks: the f32 sums' order only
SUM_TOL = 1e-5
EPS = 1e-8
SEQ, BATCH = 32, 8
TARGET = "torch_train_ranks:"


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")          # the ranks' too
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _path(kp) -> str:
    return "/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in kp)


def _flat(tree) -> dict:
    return {_path(kp): np.asarray(x, np.float32)
            for kp, x in jax.tree_util.tree_leaves_with_path(tree)}


def _batches(cfg, hosts: int, n_steps: int, seed: int = 0) -> list:
    """Each step's global batch: the hosts' slices concatenated."""
    pcfg = config_from_dict(dataclasses.asdict(cfg))
    sources = [train.host_data(pcfg, SEQ, BATCH, seed, hosts, h)
               for h in range(hosts)]
    return [train.hosts_batch(sources, i) for i in range(n_steps)]


def _jax_batch(batch: dict, cfg) -> dict:
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    if "embeds" in out:
        out["embeds"] = out["embeds"].astype(jnp.dtype(cfg.dtype))
    return out


def _reference(cfg, batches: list) -> dict:
    """The reference's ``make_train_step`` over ``batches`` from its own
    initial parameters: each step's loss, ce, aux and gradient, the
    initial and the final parameters (flat, f32)."""
    params = jax.jit(JT.init_params, static_argnums=0)(cfg,
                                                       jax.random.key(0))
    opt = JAdamW(lr=TR.LR, weight_decay=TR.WD)
    step = jax.jit(JT.make_train_step(cfg, opt))
    grad = jax.jit(jax.grad(lambda p, b: JT.make_loss_fn(cfg)(p, b)[0]))
    state = opt.init(params)
    out = {"init": _flat(params), "loss": [], "ce": [], "aux": [],
           "grads": []}
    for b in batches:
        jb = _jax_batch(b, cfg)
        out["grads"].append(_flat(grad(params, jb)))
        params, state, metrics = step(params, state, jb)
        for name in ("loss", "ce", "aux"):
            out[name].append(float(metrics[name]))
    out["params"] = _flat(params)
    return out


def _npz(path) -> dict:
    with np.load(path) as arrays:
        return {k: arrays[k] for k in arrays.files}


#: name: (the reference's configuration in f32, steps)
CASES = {
    "tiny": (dataclasses.replace(J_PRESETS["tiny"], dtype="float32"), 3),
    "deepseek": (dataclasses.replace(j_smoke("deepseek-v2-lite-16b"),
                                     dtype="float32"), 2),
}


class _Runs:
    """Each (case, W) once a module: the reference on the concatenated
    batches, and ``TR.steps`` over W gloo ranks from its parameters."""

    def __init__(self, base):
        self.base, self.cache = base, {}

    def __call__(self, name: str, world: int):
        key = (name, world)
        if key not in self.cache:
            cfg, n_steps = CASES[name]
            ref = _reference(cfg, _batches(cfg, world, n_steps))
            where = self.base / f"{name}_{world}"
            where.mkdir()
            np.savez(where / "leaves.npz", **ref["init"])
            kw = dict(cfg=dataclasses.asdict(cfg),
                      leaves=str(where / "leaves.npz"), seq=SEQ,
                      batch=BATCH, n_steps=n_steps, hosts=world,
                      out=str(where / "out"))
            res = ranks.run(TARGET + "steps", kw, world=world,
                            backend="gloo", devices=["cpu"] * world,
                            workdir=str(where / "w"))
            assert res.returncode == 0, res.failed
            arrays = [_npz(where / f"out_{r}.npz") for r in range(world)]
            self.cache[key] = dict(cfg=cfg, n_steps=n_steps, ref=ref,
                                   docs=res.docs, arrays=arrays, kw=kw)
        return self.cache[key]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _Runs(tmp_path_factory.mktemp("train_ranks"))


def _hold(run: dict) -> None:
    """A rank's losses, gradients and new parameters against the
    reference's, to the module docstring's tolerances."""
    ref, doc, got = run["ref"], run["docs"][0], run["arrays"][0]
    for i in range(run["n_steps"]):
        np.testing.assert_allclose(doc["loss"][i], ref["loss"][i],
                                   rtol=LOSS_TOL)
        np.testing.assert_allclose(doc["ce"][i], ref["ce"][i],
                                   rtol=LOSS_TOL)
        assert abs(doc["aux"][i] - ref["aux"][i]) <= LOSS_TOL * ref["ce"][i]
    keep = {path: np.ones(x.shape, bool) for path, x in ref["params"].items()}
    for i, g_ref in enumerate(ref["grads"]):
        scale = min(1.0, 1.0 / np.sqrt(sum(np.sum(x ** 2)
                                           for x in g_ref.values())))
        for path, want in g_ref.items():
            g = got[f"g{i}/{path}"]
            assert np.linalg.norm(g - want) <= TOL * max(
                np.linalg.norm(want), 1e-30), (i, path)
            diff = np.abs(g - want)
            keep[path] &= (((np.abs(want) > 10 * diff)
                            & (np.abs(want) * scale > 1e3 * EPS))
                           | ((want == 0) & (g == 0)))
    kept = total = 0
    for path, want in ref["params"].items():
        p = got[f"p/{path}"]
        assert np.all(np.abs(p - want)
                      <= 2.2 * TR.LR * run["n_steps"] + 1e-7), path
        k = keep[path]
        assert np.linalg.norm((p - want)[k]) <= TOL * max(
            np.linalg.norm(want[k]), 1e-30), path
        kept += int(k.sum())
        total += k.size
    assert kept >= 0.5 * total, (kept, total)


@pytest.mark.parametrize("world", [2, 4])
def test_tiny_over_ranks_equals_the_reference_whole_batch_step(runs, world):
    _hold(runs("tiny", world))


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_holds_the_same_bits(runs, world):
    run = runs("tiny", world)
    assert len({d["digest"] for d in run["docs"]}) == 1
    assert len({tuple(d["loss"]) for d in run["docs"]}) == 1
    first = run["arrays"][0]
    for other in run["arrays"][1:]:
        assert sorted(other) == sorted(first)
        for key, x in first.items():
            assert np.array_equal(x, other[key]), key


def test_one_process_equals_the_ranks_summed_gradients(runs, tmp_path):
    """The port in one process on the concatenated batches: the same
    gradients as the sum over the ranks (not W times them), losses and
    parameters alike."""
    run = runs("tiny", 2)
    one = TR.steps(None, **dict(run["kw"], out=str(tmp_path / "out")))
    arrays = _npz(tmp_path / "out_one.npz")
    np.testing.assert_allclose(one["loss"], run["docs"][0]["loss"],
                               rtol=LOSS_TOL)
    ranked = run["arrays"][0]
    for key, x in arrays.items():
        y = ranked[key]
        assert np.linalg.norm(y - x) <= SUM_TOL * max(np.linalg.norm(x),
                                                      1e-30), key


def test_the_gradient_bytes_equal_the_dryrun_entries(runs):
    """A real step over 2 ranks hands its all-reduces the parameters'
    bytes once a step; the dry-run's gradient entries on the (2, 1) mesh
    count them twice (the ring)."""
    run = runs("tiny", 2)
    pcfg = config_from_dict(dataclasses.asdict(run["cfg"]))
    mesh = Mesh((2, 1), ("data", "model"), virtual_devices(2, dryrun.META))
    report = dryrun.reckon(pcfg, ShapeConfig("t", SEQ, BATCH, "train"),
                           mesh)
    n_bytes = sum(x.size * 4 for x in run["ref"]["init"].values())
    for doc in run["docs"]:
        assert doc["gradient_all_reduces"] == run["n_steps"]   # one type
        per_step = doc["gradient_bytes"] // run["n_steps"]
        assert per_step * run["n_steps"] == doc["gradient_bytes"]
        assert 2 * per_step == report["gradient_all_reduce_bytes"]
        assert per_step == n_bytes
        # the loss's two sums (weighted CE, weights) once a step, f32
        assert doc["loss_bytes"] == 8 * run["n_steps"]


@pytest.mark.parametrize("name, world", [("tiny", 2), ("tiny", 4),
                                         ("deepseek", 2)])
def test_the_loss_sums_equal_the_dryrun_loss_entries(runs, name, world):
    """The loss's sums a rank hands its all-reduces a step, x 2 (the ring)
    and in number, equal the dry-run's "loss" entries on the (W, 1) mesh:
    the weighted cross-entropy's and the weights' f32 sums once a step,
    and, with deepseek's MoE, each MoE layer's load-balance statistics
    (2 x experts f32) in each forward, its experts whole on every rank."""
    run = runs(name, world)
    cfg = config_from_dict(dataclasses.asdict(run["cfg"]))
    mesh = Mesh((world, 1), ("data", "model"),
                virtual_devices(world, dryrun.META))
    report = dryrun.reckon(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                           mesh)
    moe = sum(is_moe for _, is_moe in T.layer_sigs(cfg)) * (
        2 if cfg.remat else 1)
    want_bytes = 2 * 4 + (moe * 2 * cfg.moe.n_experts * 4 if moe else 0)
    assert report["loss_all_reduce_bytes"] == 2 * want_bytes
    assert report["loss_all_reduces"] == 1 + moe
    for doc in run["docs"]:
        assert doc["loss_bytes"] == run["n_steps"] * want_bytes
        assert doc["loss_all_reduces"] == run["n_steps"] * (1 + moe)


#: a stream whose two hosts mask 40 and 36 frames (seed 0 masks 40 each,
#: where the mean of the ranks' means is the global mean)
HUBERT_SEED = 1


def test_hubert_masked_loss_over_ranks_equals_the_reference(tmp_path):
    cfg = dataclasses.replace(j_smoke("hubert-xlarge"), dtype="float32")
    params = jax.jit(JT.init_params, static_argnums=0)(cfg,
                                                       jax.random.key(0))
    (batch,) = _batches(cfg, 2, 1, seed=HUBERT_SEED)
    want, _ = jax.jit(JT.make_loss_fn(cfg))(params, _jax_batch(batch, cfg))
    want = float(want)
    np.savez(tmp_path / "leaves.npz", **_flat(params))
    res = ranks.run(TARGET + "local_losses", dict(
        cfg=dataclasses.asdict(cfg), leaves=str(tmp_path / "leaves.npz"),
        seq=SEQ, batch=BATCH, hosts=2, seed=HUBERT_SEED), world=2,
        backend="gloo",
        devices=["cpu"] * 2, workdir=str(tmp_path / "w"))
    assert res.returncode == 0, res.failed
    docs = res.docs
    assert docs[0]["mask_count"] != docs[1]["mask_count"]
    for doc in docs:
        np.testing.assert_allclose(doc["loss"], want, rtol=LOSS_TOL)
    # the control: the mean of the ranks' own means misses it
    mean_of_means = np.mean([d["own_loss"] for d in docs])
    assert abs(mean_of_means - want) > LOSS_TOL * abs(want), (mean_of_means,
                                                              want)


def test_deepseek_moe_over_two_ranks_equals_the_reference(runs):
    run = runs("deepseek", 2)
    assert all(a > 0 for a in run["ref"]["aux"])
    _hold(run)
    assert len({d["digest"] for d in run["docs"]}) == 1


def test_the_global_moe_dispatch_is_refused_over_ranks():
    cfg = config_from_dict(dataclasses.asdict(j_smoke(
        "deepseek-v2-lite-16b")))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch="global"), dtype="float32")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    # the first MoE layer's leaves (its segment stacks them by layer)
    moe = map_tree(lambda t: t[0], params["segments"][1][0]["moe"])
    ctx = S.data_parallel_ctx(Mesh.over_ranks(
        (2, 1), ("data", "model"), rank=0, rank_devices=["cpu", "cpu"]))
    x = torch.zeros(2, 4, cfg.d_model)
    with pytest.raises(NotImplementedError, match="global MoE dispatch"):
        L.moe_block(x, moe, cfg, ctx)
    y, aux = L.moe_block(x, moe, cfg)                   # in one process
    assert y.shape == x.shape and torch.isfinite(aux)
