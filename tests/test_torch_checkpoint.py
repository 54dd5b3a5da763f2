"""The port's checkpoints: its own contracts, and read across packages.

The reference's tests/test_checkpoint_and_data.py port against port
(round trip, the LATEST pointer and retention, a template mismatch
refused, placement onto a mesh, resume == uninterrupted bit for bit),
then the layout against the reference: a checkpoint written by either
package restores in the other bit for bit, bf16 included, and a
reference training state (parameters, AdamW moments and step) carried
into the port through a checkpoint continues as through
``convert.opt_state_from_reference``.  The port reads and writes bf16
without ``ml_dtypes`` (shown in a process where it cannot be imported),
and ``async_save`` writes what the tree held when it was called, though
the next step updates the tensors in place.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro.configs import get_smoke_config as j_smoke
from repro.models import transformer as JT
from repro.optim.adamw import AdamW as JAdamW
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.configs import config_from_dict, get_smoke_config
from repro_torch.core.tree import leaves_with_paths, map_tree
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.mesh import make_production_mesh, virtual_devices
from repro_torch.launch.train import batch_to
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": {"w": torch.randn(8, 4, generator=g).to(torch.bfloat16)},
            "b": [torch.randn(3, generator=g),
                  torch.tensor(7, dtype=torch.int32)],
            "f8": torch.randn(5, generator=g).to(torch.float8_e4m3fn)}


def _equal_bits(a, b) -> bool:
    la, lb = leaves_with_paths(a), leaves_with_paths(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.view(torch.uint8) if x.dtype.itemsize == 1
                        else x, y.view(torch.uint8) if y.dtype.itemsize == 1
                        else y)
        for (_, x), (_, y) in zip(la, lb))


# -- the reference's tests, port against port -----------------------------

def test_roundtrip(tmp_path):
    tree = _tree()
    ck.save(str(tmp_path), 5, tree, extras={"note": "x"})
    got, step, extras = ck.restore(str(tmp_path), tree)
    assert step == 5 and extras["note"] == "x"
    assert _equal_bits(tree, got)
    assert got["b"][1].dim() == 0
    with open(tmp_path / "step_00000005" / "MANIFEST.json") as f:
        assert '"uint16"' in f.read()           # bf16 stored as its bits


def test_latest_pointer_and_retention(tmp_path):
    tree = _tree(1)
    for s in [1, 2, 3, 4, 5]:
        ck.save(str(tmp_path), s, tree, keep=2)
    assert ck.latest_step(str(tmp_path)) == 5
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000004", "step_00000005"]
    assert ck.latest_step(str(tmp_path / "absent")) is None
    with pytest.raises(FileNotFoundError):
        ck.restore(str(tmp_path / "absent"), tree)
    # an older step is still there to restore explicitly
    _, step, _ = ck.restore(str(tmp_path), tree, step=4)
    assert step == 4


def test_template_mismatch_raises(tmp_path):
    tree = _tree(2)
    ck.save(str(tmp_path), 1, tree)
    with pytest.raises(ValueError, match="mismatch"):
        ck.restore(str(tmp_path), {"a": tree["a"]})
    with pytest.raises(ValueError, match="shape"):
        ck.restore(str(tmp_path), dict(tree, f8=torch.zeros(
            6, dtype=torch.float8_e4m3fn)))


def test_restore_onto_a_shape_template_and_a_mesh(tmp_path):
    """A ``TensorShape`` template lands on ``device``; ``shardings`` with
    a mesh cut each leaf into its pieces along its spec, as the
    reference's elastic restore places them."""
    tree = {"w": torch.arange(512.0).reshape(16, 32),
            "v": torch.arange(6.0).to(torch.bfloat16)}
    ck.save(str(tmp_path), 3, tree)
    shapes = {k: T.TensorShape(tuple(v.shape), v.dtype)
              for k, v in tree.items()}
    got, _, _ = ck.restore(str(tmp_path), shapes, device="cpu")
    assert _equal_bits(tree, got)
    mesh = make_production_mesh(devices=virtual_devices(256, "cpu"))
    specs = {"w": S.P("data", "model"), "v": S.P()}
    got, _, _ = ck.restore(str(tmp_path), tree, shardings=specs, mesh=mesh)
    assert isinstance(got["w"], S.Sharded)
    assert tuple(got["w"].local((1, 3)).shape) == (1, 2)
    assert torch.equal(got["w"].local((1, 3)), tree["w"][1:2, 6:8])
    assert _equal_bits(tree, S.gather(got))
    with pytest.raises(ValueError, match="mesh"):
        ck.restore(str(tmp_path), tree, shardings=specs)


def _qwen_run(tmp_path, split: bool):
    """qwen2's smoke config, AdamW lr 1e-3: 6 steps straight, or 3 +
    save + restore + 3 (tests/test_checkpoint_and_data.py's)."""
    cfg = get_smoke_config("qwen2-72b")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=2, seed=3))
    opt = AdamW(lr=1e-3)
    step_fn = T.make_train_step(cfg, opt)

    def run(params, opt_state, lo, hi):
        for s in range(lo, hi):
            params, opt_state, _ = step_fn(params, opt_state,
                                           batch_to(data.batch(s), cfg,
                                                    "cpu"))
        return params, opt_state

    p0 = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    o0 = opt.init(p0)
    if not split:
        return run(p0, o0, 0, 6)
    p3, o3 = run(p0, o0, 0, 3)
    ck.save(str(tmp_path), 3, {"params": p3, "opt": o3})
    template = {"params": map_tree(torch.zeros_like, p3),
                "opt": map_tree(torch.zeros_like, o3)}
    restored, step, _ = ck.restore(str(tmp_path), template)
    assert step == 3
    return run(restored["params"], restored["opt"], step, 6)


def test_resume_is_bitwise_identical(tmp_path):
    """Train 6 steps straight vs. 3 + checkpoint + restore + 3: the same
    bits, parameters and optimizer state."""
    straight = _qwen_run(tmp_path, split=False)
    resumed = _qwen_run(tmp_path, split=True)
    assert _equal_bits(straight[0], resumed[0])
    assert _equal_bits(straight[1], resumed[1])


def test_async_save_writes_what_the_tree_held(tmp_path):
    tree = _tree(3)
    want = map_tree(torch.clone, tree)
    th = ck.save(str(tmp_path), 9, tree, async_save=True)
    for _, leaf in leaves_with_paths(tree):   # the next step, in place
        if leaf.dtype != torch.float8_e4m3fn:
            leaf.add_(1)
    th.join()
    got, step, _ = ck.restore(str(tmp_path), tree)
    assert step == 9 and _equal_bits(want, got)


# -- across packages -------------------------------------------------------

def _jax_tree():
    k1, k2 = jax.random.split(jax.random.key(0))
    return {"a": {"w": jax.random.normal(k1, (8, 4), jnp.bfloat16)},
            "b": [jax.random.normal(k2, (3,)), jnp.int32(7)]}


def _as_port(jtree):
    def conv(x):
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":
            return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(x))
    return {"a": {"w": conv(jtree["a"]["w"])},
            "b": [conv(jtree["b"][0]), conv(jtree["b"][1])]}


def test_a_reference_checkpoint_restores_into_the_port(tmp_path):
    jtree = _jax_tree()
    jck.save(str(tmp_path), 4, jtree, extras={"config": "x"})
    template = map_tree(torch.zeros_like, _as_port(jtree))
    got, step, extras = ck.restore(str(tmp_path), template)
    assert step == 4 and extras == {"config": "x"}
    assert _equal_bits(got, _as_port(jtree))
    assert got["a"]["w"].dtype == torch.bfloat16


def test_a_port_checkpoint_restores_into_the_reference(tmp_path):
    jtree = _jax_tree()
    ck.save(str(tmp_path), 6, _as_port(jtree))
    got, step, _ = jck.restore(str(tmp_path), jtree)
    assert step == 6
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(got)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_a_reference_training_state_continues_in_the_port(tmp_path):
    """Two reference AdamW steps on qwen2's smoke config in f32, saved by
    the reference; the port restores them into its own template (leaf
    paths and types its own), the state equals
    ``convert.opt_state_from_reference``'s, and the next step's loss
    (1e-5 relative) and gradients (1e-4 normwise a leaf) at the restored
    parameters are the reference's."""
    cfg = dataclasses.replace(j_smoke("qwen2-72b"), dtype="float32")
    pcfg = config_from_dict(dataclasses.asdict(cfg))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=2, seed=1))
    jopt = JAdamW(lr=1e-3, weight_decay=0.01)
    jstep = jax.jit(JT.make_train_step(cfg, jopt))
    params = jax.jit(JT.init_params, static_argnums=0)(cfg,
                                                       jax.random.key(0))
    state = jopt.init(params)
    for s in range(2):
        batch = {k: jnp.asarray(v) for k, v in data.batch(s).items()}
        params, state, _ = jstep(params, state, batch)
    jck.save(str(tmp_path), 2, {"params": params, "opt": state})

    opt = AdamW(lr=1e-3, weight_decay=0.01)
    p0 = T.init_params(pcfg, torch.Generator().manual_seed(9), "cpu")
    tree, step, _ = ck.restore(str(tmp_path), {"params": p0,
                                               "opt": opt.init(p0)})
    assert step == 2 and int(tree["opt"]["step"]) == 2
    carried = convert.opt_state_from_reference(
        jax.tree.map(np.asarray, state), tree["params"])
    assert _equal_bits(carried, tree["opt"])

    batch = data.batch(2)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        JT.make_loss_fn(cfg), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    grads, loss, _ = T.value_and_grad(T.make_loss_fn(pcfg), tree["params"],
                                      batch_to(batch, pcfg, "cpu"))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for (path, got), (_, want) in zip(
            leaves_with_paths(grads),
            jax.tree_util.tree_leaves_with_path(jgrads)):
        want = np.asarray(want)
        assert np.linalg.norm(got.numpy() - want) <= 1e-4 * max(
            np.linalg.norm(want), 1e-30), path


_NO_ML_DTYPES = textwrap.dedent("""
    import sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("ml_dtypes", "jax", "jaxlib", "repro"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import torch
    from repro_torch.checkpoint import checkpoint as ck
    x = torch.randn(4, 5, generator=torch.Generator().manual_seed(0))
    tree = {"w": x.to(torch.bfloat16), "f": x,
            "e": x.to(torch.float8_e5m2)}
    ck.save(sys.argv[1], 1, tree)
    got, _, _ = ck.restore(sys.argv[1], tree)
    for k in tree:
        a = tree[k].view(torch.uint8)
        assert torch.equal(a, got[k].view(torch.uint8)), k
    assert "ml_dtypes" not in sys.modules
    print("ok")
""")


def test_bf16_is_bitwise_without_ml_dtypes(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES,
                          str(tmp_path)], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
