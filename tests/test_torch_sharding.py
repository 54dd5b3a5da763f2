"""The port's sharding rules against the reference's, and its placement.

``param_specs`` / ``enforce_divisible`` / ``input_specs`` are pure shape
arithmetic over ``mesh.shape`` and ``mesh.axis_names``, so both packages
run here on a stand-in mesh of the production shapes (16 × 16 and
2 × 16 × 16; the reference's own tests/test_models_sharding.py builds an
``AbstractMesh``, which this JAX refuses, so the stand-in is
tests/test_pod_adaptations.py's ``_FakeMesh``).  For both archs the port
runs, at smoke and published widths, with and without ``fsdp``: the
same leaf paths in the same order and the same spec for every leaf, the
same fallbacks, and the same input specs.  Then the reference's own
sharding contracts on the port (every surviving entry divides, every
downgrade is explicit and true, idempotence, the smoke fallback pins of
test_models_sharding.py:96-112, the basis specs), and ``to_named`` /
``gather``: a tensor cut along its spec is put back exactly, each device
holding JAX's block.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as j_SHAPES
from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import sharding as JS
from repro.models import transformer as JT
from repro_torch.configs import (ARCH_NAMES, SHAPES, ShapeConfig,
                                 cut_depth, get_config, get_smoke_config)
from repro_torch.core.tree import leaves_with_paths
from repro_torch.launch.mesh import Mesh, virtual_devices
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T

MESH_SHAPES = {"16x16": {"data": 16, "model": 16},
               "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class _FakeMesh:
    """Just enough Mesh interface for the spec builders."""
    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.size = int(np.prod(list(shape.values())))


def _configs(arch, width):
    if width == "smoke":
        return j_get_smoke_config(arch), get_smoke_config(arch)
    return j_get_config(arch), get_config(arch)


def _ref_leaves(specs):
    """[(path, spec as a tuple)] of a reference spec tree, in order."""
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))[0]
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), tuple(spec)) for path, spec in flat]


def _port_leaves(specs):
    return [(path, tuple(spec)) for path, spec in S.spec_leaves(specs)]


def _axis_size(mesh, entry) -> int:
    axes = entry if isinstance(entry, tuple) else (entry,)
    return int(np.prod([mesh.shape[a] for a in axes]))


# -- the port against the reference, leaf by leaf -----------------------------

@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh_shape", list(MESH_SHAPES))
@pytest.mark.parametrize("width", ["smoke", "published"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_equal_the_reference(arch, width, mesh_shape, fsdp):
    jcfg, cfg = _configs(arch, width)
    mesh = _FakeMesh(MESH_SHAPES[mesh_shape])
    want = _ref_leaves(JS.param_specs(jcfg, mesh, fsdp=fsdp))
    got = _port_leaves(S.param_specs(cfg, mesh, fsdp=fsdp))
    assert [p for p, _ in got] == [p for p, _ in want]
    assert got == want
    assert all(isinstance(s, S.P)
               for _, s in S.spec_leaves(S.param_specs(cfg, mesh)))


@pytest.mark.parametrize("mesh_shape", list(MESH_SHAPES))
@pytest.mark.parametrize("width", ["smoke", "published"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_enforce_divisible_equals_the_reference(arch, width, mesh_shape):
    jcfg, cfg = _configs(arch, width)
    mesh = _FakeMesh(MESH_SHAPES[mesh_shape])
    for fsdp in (False, True):
        jspecs, jfall = JS.enforce_divisible(
            jcfg, mesh, specs=JS.param_specs(jcfg, mesh, fsdp=fsdp))
        specs, fall = S.enforce_divisible(
            cfg, mesh, specs=S.param_specs(cfg, mesh, fsdp=fsdp))
        assert _port_leaves(specs) == _ref_leaves(jspecs)
        assert fall == jfall
        if width == "published":
            assert fall == []


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("mesh_shape", list(MESH_SHAPES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_equal_the_reference(arch, mesh_shape, kind):
    mesh = _FakeMesh(MESH_SHAPES[mesh_shape])
    for b, s in ((1, 32), (2, 32), (16, 32), (64, 128)):
        jsds, jspecs = JS.input_specs(
            j_get_smoke_config(arch), JShapeConfig("t", s, b, kind), mesh)
        sds, specs = S.input_specs(get_smoke_config(arch),
                                   ShapeConfig("t", s, b, kind), mesh)
        assert sorted(specs) == sorted(jspecs)
        for name in specs:
            assert tuple(specs[name]) == tuple(jspecs[name])
            assert sds[name].shape == tuple(jsds[name].shape)


#: the meshes the decode caches are specced over: one card, two data
#: shards, the production pod
CACHE_MESHES = {"1x1": {"data": 1, "model": 1},
                "2x1": {"data": 2, "model": 1},
                "16x16": {"data": 16, "model": 16}}


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("mesh_shape", list(CACHE_MESHES))
@pytest.mark.parametrize("width", ["smoke", "published"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_specs_equal_the_reference(arch, width, mesh_shape, quantized):
    """``cache_specs`` leaf by leaf at the decode shapes (decode_32k's
    batch 128 divides the data axes, long_500k's batch 1 does not), bf16
    and int8 caches; the port's leaves are ``init_cache``'s."""
    jcfg, cfg = _configs(arch, width)
    jcfg = dataclasses.replace(jcfg, quantized_cache=quantized)
    cfg = dataclasses.replace(cfg, quantized_cache=quantized)
    mesh = _FakeMesh(CACHE_MESHES[mesh_shape])
    for name in ("decode_32k", "long_500k"):
        jshape, shape = j_SHAPES[name], SHAPES[name]
        want = _ref_leaves(JS.cache_specs(jcfg, jshape, mesh))
        got = _port_leaves(S.cache_specs(cfg, shape, mesh))
        assert got == want
        jleaves = jax.tree_util.tree_leaves_with_path(JT.init_cache(
            jcfg, shape.global_batch, shape.seq_len, as_shape=True))
        leaves = leaves_with_paths(T.init_cache(
            cfg, shape.global_batch, shape.seq_len, as_shape=True))
        assert [(p, x.shape, str(x.dtype).replace("torch.", ""))
                for p, x in leaves] == [
            ("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in kp), tuple(x.shape), str(x.dtype))
            for kp, x in jleaves]


def test_cache_specs_refuse_unported_caches():
    """The Mamba2 and shared-attention caches, once refused, shard as the
    reference's rules shard them, leaf by leaf: qwen2's smoke widths with
    Mamba2 blocks (zamba2's smoke SSM) and with shared-attention blocks."""
    mesh = _FakeMesh(CACHE_MESHES["16x16"])
    cfg, jcfg = get_smoke_config("qwen2-72b"), j_get_smoke_config("qwen2-72b")
    ssm = get_smoke_config("zamba2-2.7b").ssm
    jssm = j_get_smoke_config("zamba2-2.7b").ssm
    for pattern, fields, jfields in (
            (("mamba2",) * 2, {"ssm": ssm}, {"ssm": jssm}),
            (("shared_attn",) * 2, {}, {})):
        got = _port_leaves(S.cache_specs(dataclasses.replace(
            cfg, block_pattern=pattern, **fields), SHAPES["decode_32k"], mesh))
        want = _ref_leaves(JS.cache_specs(dataclasses.replace(
            jcfg, block_pattern=pattern, **jfields), j_SHAPES["decode_32k"],
            mesh))
        assert got == want and got


@pytest.mark.parametrize("arch,n_layers", [("h2o-danube-3-4b", 4),
                                           ("rwkv6-7b", 2)])
def test_published_width_lm_workloads_shard_as_the_reference(arch,
                                                              n_layers):
    """The LM workloads at published widths, cut in depth as on the card:
    no fallback, and the share of parameters cut over ``model`` is the
    reference rules' share (96.6 % for danube at 4 layers)."""
    cfg = cut_depth(get_config(arch), n_layers)
    jcfg = dataclasses.replace(j_get_config(arch), n_layers=n_layers,
                               block_pattern=cfg.block_pattern)
    mesh = _FakeMesh(MESH_SHAPES["16x16"])
    specs, fall = S.enforce_divisible(cfg, mesh)
    jspecs, jfall = JS.enforce_divisible(jcfg, mesh)
    assert fall == jfall == []
    cut, total = S.sharded_numel(cfg, specs)
    shapes = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.key(0)))
    pairs = list(zip(jax.tree.leaves(shapes), jax.tree.leaves(
        jspecs, is_leaf=lambda x: isinstance(x, JP))))
    jcut = sum(int(np.prod(leaf.shape)) for leaf, spec in pairs
               if "model" in tuple(spec))
    jtotal = sum(int(np.prod(leaf.shape)) for leaf, _ in pairs)
    assert (cut, total) == (jcut, jtotal)
    if arch == "h2o-danube-3-4b":
        assert round(100 * cut / total, 1) == 96.6


# -- the reference's sharding contracts, on the port --------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_divide_or_fall_back(arch):
    cfg = get_smoke_config(arch)
    mesh = _FakeMesh(MESH_SHAPES["16x16"])
    specs, fallbacks = S.enforce_divisible(cfg, mesh)
    for (_, spec), (_, leaf) in zip(S.spec_leaves(specs),
                                    S.spec_leaves(T.param_specs(cfg))):
        for dim, entry in enumerate(spec):
            if entry is not None:
                assert leaf.shape[dim] % _axis_size(mesh, entry) == 0
    for _, _, entry, dim_size in fallbacks:
        assert dim_size % _axis_size(mesh, entry) != 0


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_small_batch_replicates_and_enforce_is_idempotent(arch):
    cfg = get_smoke_config(arch)
    mesh = _FakeMesh(MESH_SHAPES["16x16"])
    _, specs = S.input_specs(cfg, ShapeConfig("t", 32, 2, "train"), mesh)
    inputs = "embeds" if cfg.frontend == "audio_stub" else "tokens"
    assert specs[inputs][0] is None
    once, _ = S.enforce_divisible(cfg, mesh)
    twice, again = S.enforce_divisible(cfg, mesh, specs=once)
    assert again == []
    assert _port_leaves(once) == _port_leaves(twice)


def test_smoke_fallback_pins():
    """test_models_sharding.py:96-112's pinned fallback sets."""
    mesh = _FakeMesh(MESH_SHAPES["16x16"])
    _, fallbacks = S.enforce_divisible(get_smoke_config("rwkv6-7b"), mesh)
    names = sorted({p.split("/")[-1] for p, *_ in fallbacks})
    assert names == ["ln_out", "u", "w0", "w_g", "w_k", "w_lora_b",
                     "w_o", "w_r", "w_v"]
    assert all(dim_size in (4, 224) for *_, dim_size in fallbacks)
    _, fallbacks = S.enforce_divisible(get_smoke_config("h2o-danube-3-4b"),
                                       mesh)
    assert sorted(p.split("/")[-1] for p, *_ in fallbacks) == ["wo", "wq"]
    assert all(dim_size == 4 for *_, dim_size in fallbacks)


def test_untouched_specs_still_shard_and_basis_specs_mirror():
    cfg = get_smoke_config("rwkv6-7b")
    specs, _ = S.enforce_divisible(cfg, _FakeMesh(MESH_SHAPES["16x16"]))
    sharded = [p for p, s in S.spec_leaves(specs)
               if any(e is not None for e in s)]
    assert any(p.endswith("tok") for p in sharded)
    assert any(p.endswith("w") for p in sharded)          # lm head
    bspecs = S.map_specs(lambda _, s: S.P(None, *s), specs)
    for (_, spec), (_, bspec) in zip(S.spec_leaves(specs),
                                     S.spec_leaves(bspecs)):
        assert bspec[0] is None and tuple(bspec[1:]) == tuple(spec)


# -- placement: to_named / gather ---------------------------------------------

@pytest.mark.parametrize("spec", [S.P(), S.P(None, "model"),
                                  S.P("data", None, "model"),
                                  S.P(("pod", "data"), None),
                                  S.P(None, ("data", "model"))])
def test_to_named_cuts_along_the_spec_and_gather_puts_it_back(spec):
    mesh = Mesh((2, 4, 2), ("pod", "data", "model"),
                virtual_devices(16, "cpu"))
    x = torch.arange(16 * 8 * 4, dtype=torch.float32).view(16, 8, 4)
    tree = {"a": [x], "b": x[:, :2]}
    specs = {"a": [spec], "b": S.P(*spec[:1])}
    named = S.to_named(tree, specs, mesh)
    sh = named["a"][0]
    cuts = [1 if e is None else _axis_size(mesh, e) for e in spec]
    assert len(sh.pieces) == int(np.prod(cuts))
    for coords in np.ndindex(*mesh.devices.shape):
        # JAX's placement: the block index along a dim is the row-major
        # index of the device's coordinates over that entry's axes
        piece = sh.local(coords)
        want = x
        for dim, e in enumerate(spec):
            if e is None:
                continue
            idx = 0
            for a in (e if isinstance(e, tuple) else (e,)):
                idx = idx * mesh.shape[a] + coords[mesh.axis_names.index(a)]
            step = x.shape[dim] // cuts[dim]
            want = want.narrow(dim, idx * step, step)
        assert torch.equal(piece, want)
        assert piece.untyped_storage().data_ptr() == \
            x.untyped_storage().data_ptr()
    back = S.gather(named)
    assert torch.equal(back["a"][0], x) and torch.equal(back["b"], x[:, :2])
    out = {"a": [torch.zeros_like(x)], "b": torch.zeros(16, 2, 4)}
    S.gather(named, out=out)
    assert torch.equal(out["a"][0], x)


def test_to_named_refuses_a_spec_that_does_not_divide():
    mesh = Mesh((1, 16), ("data", "model"), virtual_devices(16, "cpu"))
    with pytest.raises(ValueError, match="does not divide"):
        S.Sharded(torch.zeros(4, 8), S.P("model"), mesh)
