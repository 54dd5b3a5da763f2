"""The port's AdamW and int8 gradient compression against the JAX package.

Both packages take the same seeded numpy parameters and gradients, so
only the arithmetic's rounding differs.  Tolerances:

* AdamW, f32 parameters: new parameters within 1e-6 of each leaf's
  largest magnitude, the moments within 1e-6 relative, ``step`` equal,
  over three steps (clip on and off, weight decay, a schedule).  bf16
  parameters: the new parameters' bits equal but where the two f32
  results straddle a bf16 rounding boundary: at most 1 ulp apart there,
  and at most 1 % of the elements.
* The clip's global norm within 1e-6 relative (the reference sums leaf
  by leaf in a Python ``sum``, torch in its own order).
* int8: q equal but at ties of x / scale (both round half to even; at
  most 1 % of the elements, and none differ in these draws), the scale
  within 3e-7 relative (XLA divides by 127 as a product with its
  reciprocal: one ulp), the dequantized values within 1e-6 of the
  tensor's scale; five steps of error feedback: the gradients the
  optimizer sees within 3e-7 relative (q times the scale, one ulp apart)
  and the residuals
  within 1e-7 (a quantum is ~3e-4 here: the scale's ulp times q up to
  127 puts them ~2e-9 apart), every step.
* ``opt_state_specs``: the reference's tree, leaf for leaf, on the
  production meshes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_smoke_config as j_smoke
from repro.models import sharding as JS
from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro_torch.configs import ARCH_NAMES, get_smoke_config
from repro_torch.core.tree import leaves_with_paths, map_tree
from repro_torch.models import sharding as S
from repro_torch.optim import adamw as A
from repro_torch.optim import compression as C

SHAPES = {"w": (24, 17), "b": (17,), "stack": (3, 8, 5)}


def _tree(rng, scale=1.0, dtype=np.float32):
    """{"a": {"w", "b"}, "layers": [stack]} of seeded normals."""
    return {"a": {"w": (rng.normal(size=SHAPES["w"]) * scale).astype(dtype),
                  "b": (rng.normal(size=SHAPES["b"]) * scale).astype(dtype)},
            "layers": [(rng.normal(size=SHAPES["stack"]) * scale)
                       .astype(dtype)]}


def _jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


def _torch(tree, dtype=torch.float32):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x, np.float32))
                        .to(dtype), tree)


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pairs(jtree, ttree):
    """[(path, reference leaf, port leaf)] in JAX's order."""
    want = jax.tree_util.tree_leaves_with_path(jtree)
    got = leaves_with_paths(ttree)
    assert len(want) == len(got)
    return [(path, _np(j), _np(t)) for (_, j), (path, t) in zip(want, got)]


@pytest.mark.parametrize("grad_scale,weight_decay,schedule", [
    (1.0, 0.0, False),      # the clip scales every step (‖g‖ ≫ 1)
    (0.01, 0.01, False),    # under the clip; decoupled weight decay
    (1.0, 0.01, True),      # a warm-up schedule
])
def test_adamw_f32_matches_the_reference(grad_scale, weight_decay,
                                         schedule):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jopt = JA.AdamW(lr=1e-2, weight_decay=weight_decay, schedule=(
        (lambda s: jnp.minimum(1.0, s / 4.0)) if schedule else None))
    topt = A.AdamW(lr=1e-2, weight_decay=weight_decay, schedule=(
        (lambda s: torch.clamp(s / 4.0, max=1.0)) if schedule else None))
    jp, tp = _jax(params), _torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    for _ in range(3):
        grads = _tree(rng, grad_scale)
        old = map_tree(torch.clone, tp)
        jp, js = jax.jit(jopt.update)(_jax(grads), js, jp)
        tp_new, ts = topt.update(_torch(grads), ts, tp)
        # the old parameters are left as they were
        for (_, a), (_, b) in zip(leaves_with_paths(tp),
                                  leaves_with_paths(old)):
            assert torch.equal(a, b)
        tp = tp_new
        for path, want, got in _pairs(jp, tp):
            assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want)), \
                path
        for name in ("mu", "nu"):
            for path, want, got in _pairs(js[name], ts[name]):
                np.testing.assert_allclose(got, want, rtol=1e-6,
                                           atol=1e-6 * np.max(np.abs(want)),
                                           err_msg=f"{name}/{path}")
        assert int(ts["step"]) == int(js["step"])


def test_adamw_bf16_parameters_cast_as_the_reference():
    rng = np.random.default_rng(1)
    params = _tree(rng, dtype=np.float32)
    jopt, topt = JA.AdamW(lr=1e-2, weight_decay=0.01), A.AdamW(
        lr=1e-2, weight_decay=0.01)
    jp, tp = _jax(params, jnp.bfloat16), _torch(params, torch.bfloat16)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        grads = _tree(rng, 0.1)
        jp, js = jax.jit(jopt.update)(_jax(grads, jnp.bfloat16), js, jp)
        tp, ts = topt.update(_torch(grads, torch.bfloat16), ts, tp)
        n = off = 0
        for path, want, got in _pairs(jp, tp):
            assert got.dtype == want.dtype
            diff = got != want
            n += want.size
            off += int(diff.sum())
            ulp = np.abs(want[diff]) * 2.0 ** -7
            assert np.all(np.abs(got[diff] - want[diff]) <= ulp), path
        assert off <= 0.01 * n
        for _, (_, leaf) in zip(range(3), leaves_with_paths(tp)):
            assert leaf.dtype == torch.bfloat16


def test_global_norm_matches_the_reference_clip():
    rng = np.random.default_rng(2)
    grads = _tree(rng, 3.0)
    want = float(jnp.sqrt(sum(jnp.sum(jnp.square(g)) for g in
                              jax.tree.leaves(_jax(grads)))))
    got = float(A.global_norm(_torch(grads)))
    assert abs(got - want) <= 1e-6 * want


def test_update_in_slices_is_the_same_bits(monkeypatch):
    """A leaf past ``SLICE_ELEMS`` is updated slice by slice along its
    leading axis: the same bits as whole (under the clip, whose norm sums
    the slices in another order)."""
    rng = np.random.default_rng(3)
    params, grads = _tree(rng), _tree(rng, 0.01)
    opt = A.AdamW(lr=1e-2, weight_decay=0.01)

    def run():
        p = _torch(params)
        s = opt.init(p)
        for _ in range(2):
            p, s = opt.update(_torch(grads), s, p)
        return p, s

    whole = run()
    monkeypatch.setattr(A, "SLICE_ELEMS", 16)
    sliced = run()
    for tree_a, tree_b in ((whole[0], sliced[0]), (whole[1], sliced[1])):
        for (pa, a), (_, b) in zip(leaves_with_paths(tree_a),
                                   leaves_with_paths(tree_b)):
            assert torch.equal(a, b), pa


def test_update_consumes_grads_and_moments_in_place():
    """What ``update`` documents: the gradients are scaled for the clip
    and the moments updated in place; the parameters are not touched."""
    rng = np.random.default_rng(4)
    p = _torch(_tree(rng))
    g = _torch(_tree(rng, 10.0))
    opt = A.AdamW(lr=1e-2)
    s = opt.init(p)
    mu = s["mu"]["a"]["w"]
    norm = A.global_norm(g)
    g_before = g["a"]["w"].clone()
    p_before = p["a"]["w"].clone()
    new_p, new_s = opt.update(g, s, p)
    assert new_s["mu"]["a"]["w"] is mu and torch.any(mu != 0)
    torch.testing.assert_close(g["a"]["w"], g_before / norm, rtol=1e-6,
                               atol=0)
    assert torch.equal(p["a"]["w"], p_before)
    assert new_p["a"]["w"] is not p["a"]["w"]


MESH_SHAPES = ({"data": 16, "model": 16},
               {"pod": 2, "data": 16, "model": 16})


class _FakeMesh:
    """Just enough Mesh interface for the spec functions
    (tests/test_pod_adaptations.py's)."""
    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.size = int(np.prod(list(shape.values())))


@pytest.mark.parametrize("mesh_shape", MESH_SHAPES,
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_opt_state_specs_mirror_the_reference(arch, mesh_shape):
    mesh = _FakeMesh(mesh_shape)
    want = JA.opt_state_specs(JS.param_specs(j_smoke(arch), mesh))
    got = A.opt_state_specs(S.param_specs(get_smoke_config(arch), mesh))
    flat = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, JP))[0]
    want = [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), tuple(spec)) for path, spec in flat]
    got = [(path, tuple(spec)) for path, spec in S.spec_leaves(got)]
    assert got == want
    assert got[-1] == ("step", ())
    # the moments are sharded exactly like their parameters
    params = dict(S.spec_leaves(S.param_specs(get_smoke_config(arch), mesh)))
    for path, spec in got[:-1]:
        assert params[path.split("/", 1)[1]] == spec


# -- int8 compression with error feedback ---------------------------------

@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_int8_matches_the_reference(dtype):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(64, 33)) * 3.0).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16"
                                else torch.float32)
    jq, js = JC.quantize_int8(jx)
    tq, ts = C.quantize_int8(tx)
    assert tq.dtype == torch.int8 and ts.dim() == 0
    np.testing.assert_allclose(float(ts), float(js), rtol=3e-7)
    ratio = _np(tx) / float(js)
    ties = np.abs(np.abs(ratio - np.trunc(ratio)) - 0.5) < 1e-6
    same = tq.numpy() == np.asarray(jq)
    assert np.all(same | ties) and ties.sum() <= 0.01 * x.size
    deq = C.dequantize_int8(tq, ts)
    np.testing.assert_allclose(deq.numpy(), np.asarray(
        JC.dequantize_int8(jq, js)), rtol=0, atol=1e-6 * float(js))
    assert float(torch.max(torch.abs(deq - _np(tx)))) <= 0.5 * float(ts) \
        * (1 + 1e-6)


def test_compress_grads_error_feedback_matches_the_reference():
    """Five steps of compress_grads with the residual carried: the
    gradients the optimizer sees and the residuals within 1e-7 of each
    tensor's scale, every step."""
    rng = np.random.default_rng(6)
    params = _tree(rng)
    jerr, terr = JC.init_error_state(_jax(params)), C.init_error_state(
        _torch(params))
    for _ in range(5):
        grads = _tree(rng, 1e-2)
        jg, jerr = jax.jit(JC.compress_grads)(_jax(grads), jerr)
        tg_in = _torch(grads)
        tg, terr = C.compress_grads(tg_in, terr)
        for path, want, got in _pairs(jg, tg):
            np.testing.assert_allclose(got, want, rtol=3e-7, atol=0,
                                       err_msg=path)
        for path, want, got in _pairs(jerr, terr):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-7,
                                       err_msg=path)
            assert np.any(got != 0)
        # the inputs are not changed
        for path, want, got in _pairs(_jax(grads), tg_in):
            assert np.array_equal(got, want), path
