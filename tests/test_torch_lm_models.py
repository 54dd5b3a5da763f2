"""The port's LM (configs, parameters, forward, loss) against the JAX package.

The reference's θ0 is carried across leaf by leaf (as f32 numpy, cast in
torch to the configuration's type) and both forwards run on the same
seeded tokens with ``use_kernels=True``: the reference's CPU route is its
ref oracle, the port's its plain versions.

Tolerances: with ``dtype="float32"`` the loss agrees to 1e-4 relative and
the hidden states to 1e-4 of their largest magnitude (the same
algorithm; only sums are ordered differently).  In bf16 the loss agrees
to 2e-2 relative and the hidden states to 5e-2 of their largest
magnitude: XLA's CPU bf16 fusions round fewer intermediates to bf16 than
eager torch does, and two bf16 roundings apart per op compound over the
layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.compat as compat
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.models import transformer as JT
from repro_torch.configs import (ARCH_NAMES, config_from_dict, cut_depth,
                                 get_config, get_smoke_config)
from repro_torch.core.tree import leaves_with_paths
from repro_torch.models import transformer as T

ARCHS = ("h2o-danube-3-4b", "rwkv6-7b")
LOSS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
HIDDEN_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
#: the depth each arch is cut to at published widths on one card, and its
#: parameter count (the k = 6 f32 basis must fit beside it)
FULL_WIDTH_DEPTH = {"h2o-danube-3-4b": (4, 865_109_760),
                    "rwkv6-7b": (2, 973_705_216)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_path(key_path) -> str:
    return "/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                    for e in key_path)


def ref_leaves(params) -> dict:
    """{leaf path: f32 numpy} of a reference parameter pytree."""
    return {jax_path(kp): np.asarray(x, np.float32)
            for kp, x in jax.tree_util.tree_leaves_with_path(params)}


#: the reference's init, compiled once per configuration (eager op-by-op
#: init dominates these tests' time otherwise)
ref_init = jax.jit(JT.init_params, static_argnums=0)


def _ref_cut(arch: str, n_layers: int):
    cfg = ref_config(arch)
    return dataclasses.replace(cfg, n_layers=n_layers,
                               block_pattern=cfg.block_pattern[:n_layers])


def _models(arch: str, dtype: str, seed: int = 0, b: int = 2, s: int = 32):
    """(reference cfg, params, batch) and the port's, on one seeded draw."""
    cfg = dataclasses.replace(ref_smoke(arch), use_kernels=True, dtype=dtype)
    params = ref_init(cfg, jax.random.key(seed))
    rng = np.random.default_rng(seed + 100)
    toks, labels = (rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
                    for _ in range(2))
    pcfg = config_from_dict(dataclasses.asdict(cfg))
    pparams = T.params_from_leaves(pcfg, ref_leaves(params), device="cpu")
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tbatch = {"tokens": torch.from_numpy(toks).long(),
              "labels": torch.from_numpy(labels).long()}
    return (cfg, params, jbatch), (pcfg, pparams, tbatch)


# -- configurations --------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_registry_copies_the_reference_configs(arch):
    assert set(ARCHS) <= set(ARCH_NAMES)
    for mine, theirs in ((get_config(arch), ref_config(arch)),
                         (get_smoke_config(arch), ref_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert config_from_dict(dataclasses.asdict(theirs)) == mine


# -- parameter leaves: JAX's paths, shapes and order -----------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_paths_shapes_and_order_are_the_reference_s(arch):
    cfg = dataclasses.replace(ref_smoke(arch), use_kernels=True)
    want = [(jax_path(kp), tuple(x.shape), str(x.dtype)) for kp, x in
            jax.tree_util.tree_leaves_with_path(jax.eval_shape(
                lambda key: JT.init_params(cfg, key), jax.random.key(0)))]
    pcfg = config_from_dict(dataclasses.asdict(cfg))
    got = [(path, tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for path, x in leaves_with_paths(T.init_params(
               pcfg, torch.Generator().manual_seed(0), "cpu"))]
    assert got == want
    assert [p for p, *_ in got][:3] == ["embed/tok", "final_norm/scale",
                                        "head/w"]
    assert got[3][0].startswith("segments/0/0/")
    # each segment leaf is stacked over its repeated layers
    assert all(shape[0] == cfg.n_layers for path, shape, _ in got[3:])


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_leaves_match_the_reference_at_cut_depth(arch):
    n_layers, n_params = FULL_WIDTH_DEPTH[arch]
    want = [(jax_path(kp), tuple(x.shape)) for kp, x in
            jax.tree_util.tree_leaves_with_path(jax.eval_shape(
                lambda key: JT.init_params(_ref_cut(arch, n_layers), key),
                jax.random.key(0)))]
    specs = T.param_specs(cut_depth(get_config(arch), n_layers))
    got = [(path, leaf.shape) for path, leaf in leaves_with_paths(specs)]
    assert got == want
    assert sum(int(np.prod(s)) for _, s in got) == n_params


def test_init_draws_the_reference_s_distributions():
    cfg = get_smoke_config("rwkv6-7b")
    params = T.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    specs = dict(leaves_with_paths(T.param_specs(cfg)))
    for path, x in leaves_with_paths(params):
        kind, *args = specs[path].init
        x = x.float()
        if kind == "normal" and x.numel() >= 4096:
            assert abs(x.std().item() / args[0] - 1) < 0.05, path
        elif kind == "full":
            assert torch.all(x == args[0]), path
    # the reference draws w_r_cm from w_r's key: both start equal, in the
    # port too
    ref = ref_init(ref_smoke("rwkv6-7b"), jax.random.key(1))
    rw_ref = ref["segments"][0][0]["rwkv"]
    rw = params["segments"][0][0]["rwkv"]
    for w_r, w_r_cm in ((np.asarray(rw_ref["w_r"], np.float32),
                         np.asarray(rw_ref["w_r_cm"], np.float32)),
                        (rw["w_r"].float().numpy(),
                         rw["w_r_cm"].float().numpy())):
        assert np.array_equal(w_r.reshape(w_r_cm.shape), w_r_cm)
    w0 = np.asarray(rw_ref["w0"], np.float32)
    assert np.array_equal(rw["w0"].float().numpy(), w0)


# -- forward and loss ------------------------------------------------------

def _rel_max(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.float().numpy() - want))
                 / np.max(np.abs(want)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_the_reference(arch, dtype):
    (cfg, params, jbatch), (pcfg, pparams, tbatch) = _models(arch, dtype)
    hidden_ref = JT.forward(params, cfg, jbatch)[0]
    loss_ref = float(JT.make_loss_fn(cfg)(params, jbatch)[0])
    with torch.no_grad():
        hidden = T.forward(pparams, pcfg, tbatch)[0]
        loss = float(T.make_loss_fn(pcfg)(pparams, tbatch)[0])
    assert hidden.dtype == T.param_dtype(pcfg)
    assert tuple(hidden.shape) == tuple(hidden_ref.shape)
    assert _rel_max(hidden, hidden_ref) <= HIDDEN_TOL[dtype]
    assert np.isfinite(loss) and loss > 0
    np.testing.assert_allclose(loss, loss_ref, rtol=LOSS_TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_the_reference_s_pallas_route(arch, monkeypatch):
    """The reference's forward through its Pallas kernels (interpret mode
    on the CPU, forced as tests/test_kernel_routing.py forces it)."""
    monkeypatch.setattr(compat, "route_pallas", lambda override=None: True)
    (cfg, params, jbatch), (pcfg, pparams, tbatch) = _models(
        arch, "float32", seed=3, b=1, s=16)
    loss_ref = float(jax.jit(JT.make_loss_fn(cfg))(params, jbatch)[0])
    with torch.no_grad():
        loss = float(T.make_loss_fn(pcfg)(pparams, tbatch)[0])
    np.testing.assert_allclose(loss, loss_ref, rtol=LOSS_TOL["float32"])


@pytest.mark.parametrize("s,chunk", [(20, 8), (16, 16), (5, 512)])
def test_chunked_cross_entropy_matches_the_reference(s, chunk):
    rng = np.random.default_rng(s)
    hidden = rng.normal(size=(2, s, 24)).astype(np.float32)
    w = rng.normal(size=(24, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, s)).astype(np.int32)
    weights = (rng.random((2, s)) < 0.7).astype(np.float32)
    for wts in (None, weights):
        want = JT.chunked_cross_entropy(
            jnp.asarray(hidden), jnp.asarray(w), jnp.asarray(labels),
            None if wts is None else jnp.asarray(wts), chunk=chunk)
        got = T.chunked_cross_entropy(
            torch.from_numpy(hidden), torch.from_numpy(w),
            torch.from_numpy(labels).long(),
            None if wts is None else torch.from_numpy(wts), chunk=chunk)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_unported_features_are_refused():
    """No feature is refused any more: Mamba2 and shared-attention blocks
    on danube's smoke widths (zamba2's smoke SSM for Mamba2) give the
    reference's leaf paths and shapes and run; the dense route and the
    features the dense, MLA and MoE families use (qkv bias, qk-norm, pad
    heads, the parallel block, tied embeddings, the audio stub, MLA, MoE)
    are ported (tests/test_torch_serve_models.py,
    tests/test_torch_moe_mla.py, tests/test_torch_mamba2.py)."""
    cfg, jcfg = get_smoke_config("h2o-danube-3-4b"), ref_smoke(
        "h2o-danube-3-4b")
    ssm = get_smoke_config("zamba2-2.7b").ssm
    jssm = ref_smoke("zamba2-2.7b").ssm
    for pattern, fields, jfields in (
            (("mamba2",) * 2, {"ssm": ssm}, {"ssm": jssm}),
            (("shared_attn",) * 2, {}, {})):
        mine = dataclasses.replace(cfg, block_pattern=pattern, **fields)
        ref = dataclasses.replace(jcfg, block_pattern=pattern, **jfields)
        want = [(jax_path(kp), tuple(x.shape)) for kp, x in
                jax.tree_util.tree_leaves_with_path(jax.eval_shape(
                    lambda key, ref=ref: JT.init_params(ref, key),
                    jax.random.key(0)))]
        assert [(p, leaf.shape) for p, leaf in
                leaves_with_paths(T.param_specs(mine))] == want
        hidden, _, _ = T.forward(T.init_params(mine, torch.Generator(),
                                               "cpu"), mine,
                                 {"tokens": torch.zeros(1, 4,
                                                        dtype=torch.long)})
        assert tuple(hidden.shape) == (1, 4, cfg.d_model)
        assert bool(torch.isfinite(hidden.float()).all())
    for ok in (dataclasses.replace(cfg, qkv_bias=True),
               dataclasses.replace(cfg, qk_norm=True),
               dataclasses.replace(cfg, head_pad_to=8),
               dataclasses.replace(cfg, parallel_block=True),
               dataclasses.replace(cfg, tie_embeddings=True),
               dataclasses.replace(cfg, frontend="audio_stub"),
               dataclasses.replace(cfg, mla=get_smoke_config(
                   "deepseek-v2-lite-16b").mla),
               dataclasses.replace(cfg, moe=get_smoke_config(
                   "llama4-maverick-400b-a17b").moe)):
        T.param_specs(ok)
    hidden, _, _ = T.forward(T.init_params(cfg, torch.Generator(), "cpu"),
                             cfg, {"tokens": torch.zeros(1, 4,
                                                         dtype=torch.long)})
    assert tuple(hidden.shape) == (1, 4, cfg.d_model)
