"""MLA and MoE (deepseek-v2-lite-16b, llama4-maverick-400b-a17b) against
the JAX package.

The reference's parameters come from ``jax.random`` and are carried
across as numpy arrays (``params_from_leaves`` for whole models; the
MoE router stays f32 in a bf16 model, as the reference keeps it), its
caches by ``convert.cache_from_reference``; inputs are made from numpy
seeds.  Tolerances, on max |got - want| over max |want|: f32 ≤ 1e-4 on
outputs and logits, 1e-5 absolute on the load-balance ``aux``; bf16 ≤
2e-2 on a block's output fed the reference's own input.  Whole models in
bf16 are held where routing cannot flip (the decode tests of
tests/test_torch_serve_models.py start each step from the reference's
cache): a one-ulp bf16 difference in a hidden state can move a near-tied
top-k choice, which changes that token's FFN output by far more than an
ulp and is not a fault.

The MoE cases include one at ``capacity_factor`` 0.5, where tokens are
dropped, and one whose router sends every token's first choice to one
expert and ties two others exactly: which tokens keep a slot then
depends on the reference's stable sort, and which of the tied experts is
chosen on ``jax.lax.top_k`` taking the lower index first.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import cell_is_runnable as ref_runnable
from repro.core.subspace import SubspaceProjection as JProjection
from repro.core.substrates.lm_loss import LmLossEvalBackend as JBackend
from repro.core.substrates.lm_loss import make_lm_workload as j_workload
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import (SHAPES, MLAConfig, MoEConfig,
                                 cell_is_runnable, config_from_dict,
                                 cut_depth, get_config, get_smoke_config)
from repro_torch.convert import cache_from_reference, lm_workload_from_reference
from repro_torch.core.substrates.lm_loss import LmLossEvalBackend
from repro_torch.core.tree import leaves_with_paths
from repro_torch.launch import serve as pserve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ARCHS = ("deepseek-v2-lite-16b", "llama4-maverick-400b-a17b")
MLA_ARCH = "deepseek-v2-lite-16b"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: aux is a sum of e products of means: absolute, f32
AUX_TOL = 1e-5
#: decode == prefill needs a capacity at which the prefill drops nothing
#: (tests/test_models_smoke.py:80-82 raises it to 16 for the same reason)
NO_DROP = 16.0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_path(key_path) -> str:
    return "/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                    for e in key_path)


def ref_leaves(tree) -> dict:
    """{leaf path: f32 numpy} of a reference pytree."""
    return {jax_path(kp): np.asarray(x, np.float32)
            for kp, x in jax.tree_util.tree_leaves_with_path(tree)}


def to_torch(tree):
    """A reference dict of arrays as tensors of the same types (bf16
    carried through f32, which holds it exactly)."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    dtype = torch.bfloat16 if tree.dtype == jnp.bfloat16 else torch.float32
    return torch.from_numpy(np.array(tree, np.float32)).to(dtype)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.float().numpy() - want))
                 / np.max(np.abs(want)))


def _with_moe(cfg, **moe):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))


ref_init = jax.jit(JT.init_params, static_argnums=0)


def _pair(arch: str, dtype: str = "float32", seed: int = 0, moe=None,
          **fields):
    """(reference cfg, params) and (port cfg, params) on one draw."""
    cfg = dataclasses.replace(ref_smoke(arch), dtype=dtype, **fields)
    if moe:
        cfg = _with_moe(cfg, **moe)
    params = ref_init(cfg, jax.random.key(seed))
    pcfg = config_from_dict(dataclasses.asdict(cfg))
    return (cfg, params), (pcfg, T.params_from_leaves(
        pcfg, ref_leaves(params), device="cpu"))


def _tokens(cfg, b: int, s: int, seed: int):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    return toks, {"tokens": jnp.asarray(toks)}, {
        "tokens": torch.from_numpy(toks).long()}


# -- configurations ------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_round_trip_and_count_as_the_reference(arch):
    for mine, theirs in ((get_config(arch), ref_config(arch)),
                         (get_smoke_config(arch), ref_smoke(arch))):
        fields = dataclasses.asdict(theirs)
        assert dataclasses.asdict(mine) == fields
        assert config_from_dict(fields) == mine
        assert config_from_dict(dataclasses.asdict(mine)) == mine
        assert isinstance(mine.moe, MoEConfig)
        assert (mine.mla is None) == (theirs.mla is None)
        if mine.mla is not None:
            assert isinstance(mine.mla, MLAConfig)
        assert mine.moe.capacity_factor == 1.25
        assert mine.moe.dispatch == "grouped"
        assert mine.n_params() == theirs.n_params()
        assert mine.n_active_params() == theirs.n_active_params()
        for name in SHAPES:
            assert (cell_is_runnable(mine, SHAPES[name])
                    == ref_runnable(theirs, REF_SHAPES[name]))
    if arch == MLA_ARCH:         # the whole model fits the card in bf16
        assert get_config(arch).n_params() == 15_706_357_760
    else:                        # 2 layers at published width, as served
        assert cut_depth(get_config(arch), 2).n_params() == 18_679_070_720


@pytest.mark.parametrize("m", [MoEConfig(8, 2, 1, 32), MoEConfig(
    128, 1, 1, 64, capacity_factor=0.5), MoEConfig(64, 6, 2, 16)])
@pytest.mark.parametrize("tokens", [1, 7, 64, 4096])
def test_moe_capacity_is_the_reference_s(m, tokens):
    from repro.configs import MoEConfig as JMoE
    assert L.moe_capacity(m, tokens) == JL.moe_capacity(
        JMoE(**dataclasses.asdict(m)), tokens)


# -- parameter leaves ------------------------------------------------------------

def _ref_shapes(cfg):
    return [(jax_path(kp), tuple(x.shape), str(x.dtype)) for kp, x in
            jax.tree_util.tree_leaves_with_path(jax.eval_shape(
                lambda key: JT.init_params(cfg, key), jax.random.key(0)))]


@pytest.mark.parametrize("width", ["smoke", "published"])
@pytest.mark.parametrize("arch", ARCHS)
def test_leaves_and_types_are_the_reference_s(arch, width):
    """Paths, shapes, order and types, the router f32 in a bf16 model; at
    published width from the specs alone (nothing allocated), deepseek
    at its 27 layers and llama4 cut to 2 (one dense, one MoE layer)."""
    if width == "smoke":
        cfg, pcfg = ref_smoke(arch), get_smoke_config(arch)
    else:
        pcfg = get_config(arch)
        cfg = ref_config(arch)
        if arch != MLA_ARCH:
            pcfg = cut_depth(pcfg, 2)
            cfg = dataclasses.replace(cfg, n_layers=2)
    want = _ref_shapes(cfg)
    dtype = T.param_dtype(pcfg)
    got = [(path, leaf.shape,
            str(leaf.dtype or dtype).replace("torch.", ""))
           for path, leaf in leaves_with_paths(T.param_specs(pcfg))]
    assert got == want
    routers = [p for p, _, t in got if p.endswith("/moe/router")]
    assert routers and all(t == "float32" for p, _, t in got
                           if p in routers)
    if width == "smoke":
        params = T.init_params(pcfg, torch.Generator().manual_seed(0), "cpu")
        assert [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
                for p, x in leaves_with_paths(params)] == want
        carried = T.params_from_leaves(pcfg, ref_leaves(ref_init(
            cfg, jax.random.key(0))), device="cpu")
        assert [(p, x.dtype) for p, x in leaves_with_paths(carried)] == [
            (p, x.dtype) for p, x in leaves_with_paths(params)]


def test_large_leaves_are_drawn_in_slices_with_the_reference_s_scale():
    """A leaf over ``_DRAW_WHOLE`` elements is drawn slice by slice along
    its leading axis (its f32 draw never whole): the same distribution,
    and a smaller leaf's draw is unchanged."""
    leaf = L.normal(0.5, 6, 4, 8)
    gen = torch.Generator().manual_seed(3)
    whole = T._draw(leaf, torch.float32, gen, "cpu")
    old = T._DRAW_WHOLE, T._DRAW_SLICE
    try:
        T._DRAW_WHOLE, T._DRAW_SLICE = 64, 64
        sliced = T._draw(leaf, torch.bfloat16,
                         torch.Generator().manual_seed(3), "cpu")
        router = T._draw(L.normal(0.5, 6, 4, 8, dtype=torch.float32),
                         torch.bfloat16, torch.Generator().manual_seed(3),
                         "cpu")
    finally:
        T._DRAW_WHOLE, T._DRAW_SLICE = old
    assert sliced.dtype == torch.bfloat16 and router.dtype == torch.float32
    gen = torch.Generator().manual_seed(3)
    rows = torch.cat([torch.randn((2, 4, 8), generator=gen) * 0.5
                      for _ in range(3)])
    assert torch.equal(sliced, rows.to(torch.bfloat16))
    assert torch.equal(router, rows)
    assert torch.equal(whole, torch.randn(
        (6, 4, 8), generator=torch.Generator().manual_seed(3)) * 0.5)


# -- mla_block ---------------------------------------------------------------

def _mla(dtype: str, quantized: bool = False, seed: int = 0):
    cfg = dataclasses.replace(ref_smoke(MLA_ARCH), dtype=dtype,
                              quantized_cache=quantized)
    p = JL.init_mla(jax.random.key(seed), cfg, jnp.dtype(dtype))
    return cfg, p, config_from_dict(dataclasses.asdict(cfg)), to_torch(p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_matches_the_reference(dtype):
    cfg, p, pcfg, pp = _mla(dtype)
    x = np.random.default_rng(1).normal(size=(2, 24, cfg.d_model))
    pos = np.broadcast_to(np.arange(24), (2, 24)).astype(np.int32)
    want, wc = JL.mla_block(jnp.asarray(x, jnp.dtype(dtype)), p, cfg,
                            jnp.asarray(pos))
    got, gc = L.mla_block(torch.from_numpy(x).to(T.param_dtype(pcfg)), pp,
                          pcfg, torch.from_numpy(pos).long())
    assert wc is None and gc is None
    assert got.dtype == T.param_dtype(pcfg)
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_and_latent_cache_match_the_reference(dtype, absorb,
                                                         quantized):
    """Twelve decode steps into a latent cache of 10 rows (steps 10 and 11
    are clamped onto the last row, as ``dynamic_update_slice`` clamps),
    each from the reference's cache of that step: the outputs, and every
    cache leaf after the step (int8 stores within one step of the
    reference's, scales and bf16 / f32 latents within the tolerance)."""
    cfg, p, pcfg, pp = _mla(dtype, quantized)
    b, rows = 2, 10
    rng = np.random.default_rng(2)
    shapes = JL.mla_cache_shape(cfg, b, rows)
    jcache = {k: jnp.zeros(v, jnp.float32 if k.endswith("_scale")
                           else jnp.int8 if quantized else jnp.dtype(dtype))
              for k, v in shapes.items()}
    for t in range(12):
        x = rng.normal(size=(b, 1, cfg.d_model))
        pos = np.full((b, 1), t, np.int32)
        mine = {k: torch.from_numpy(np.array(v, np.int8 if v.dtype == jnp.int8
                                             else np.float32)).to(
            torch.int8 if v.dtype == jnp.int8 else torch.float32
            if k.endswith("_scale") else T.param_dtype(pcfg))
            for k, v in jcache.items()}
        want, jcache = JL.mla_block(jnp.asarray(x, jnp.dtype(dtype)), p, cfg,
                                    jnp.asarray(pos), jcache, jnp.int32(t),
                                    absorb=absorb)
        got, mine = L.mla_block(torch.from_numpy(x).to(T.param_dtype(pcfg)),
                                pp, pcfg, torch.from_numpy(pos).long(), mine,
                                t if t % 2 else torch.tensor(t),
                                absorb=absorb)
        assert _rel(got, want) <= TOL[dtype], t
        assert sorted(mine) == sorted(jcache)
        for name, x_got in mine.items():
            x_want = np.asarray(jcache[name])
            assert tuple(x_got.shape) == x_want.shape
            if x_got.dtype == torch.int8:
                assert x_want.dtype == np.int8
                assert int(np.max(np.abs(x_got.numpy().astype(np.int32)
                                         - x_want.astype(np.int32)))) <= 1
            else:
                assert _rel(x_got, x_want) <= TOL[dtype], (t, name)


# -- MoE ---------------------------------------------------------------------

def _moe(arch: str, dtype: str = "float32", seed: int = 0, **moe):
    cfg = _with_moe(dataclasses.replace(ref_smoke(arch), dtype=dtype), **moe)
    p = JL.init_moe(jax.random.key(seed), cfg, jnp.dtype(dtype))
    return cfg, p, config_from_dict(dataclasses.asdict(cfg))


def _moe_both(cfg, p, pcfg, pp, x, dispatch):
    jfn = JL.moe_block_grouped if dispatch == "grouped" else \
        JL.moe_block_global
    pfn = L.moe_block_grouped if dispatch == "grouped" else L.moe_block_global
    want, waux = jfn(jnp.asarray(x, jnp.dtype(cfg.dtype)), p, cfg)
    got, aux = pfn(torch.from_numpy(x).to(T.param_dtype(pcfg)), pp, pcfg)
    assert got.dtype == T.param_dtype(pcfg) and aux.dtype == torch.float32
    return got, aux, want, waux


def _first_choices(x, router, k):
    """Each token's top-k experts as the reference routes them (f32
    softmax over x @ router, ties to the lower index), in numpy."""
    logits = np.asarray(jnp.einsum("bsd,de->bse", jnp.asarray(
        x, jnp.float32), router))
    return np.argsort(-logits, axis=-1, kind="stable")[..., :k]


def _dropped(ids: np.ndarray, n_experts: int, cap: int) -> int:
    """Entries past their expert's capacity, per group (ids: (G, N, k))."""
    counts = np.stack([np.bincount(g.reshape(-1), minlength=n_experts)
                       for g in ids])
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("dispatch", ["grouped", "global"])
@pytest.mark.parametrize("capacity", [1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_the_reference(arch, capacity, dispatch):
    """y within 1e-4, aux within 1e-5, in f32; at capacity 0.5 tokens
    are dropped (counted from the reference's routing; 32 tokens a group
    drop some at the published 1.25 as well)."""
    cfg, p, pcfg = _moe(arch, capacity_factor=capacity, dispatch=dispatch)
    x = np.random.default_rng(3).normal(size=(2, 32, cfg.d_model))
    got, aux, want, waux = _moe_both(cfg, p, pcfg, to_torch(p), x, dispatch)
    assert _rel(got, want) <= TOL["float32"]
    assert abs(float(aux) - float(waux)) <= AUX_TOL
    m = cfg.moe
    ids = _first_choices(x, p["router"], m.experts_per_token)
    if dispatch == "global":
        ids = ids.reshape(1, -1, m.experts_per_token)
    if capacity == 0.5:
        assert _dropped(ids, m.n_experts,
                        JL.moe_capacity(m, ids.shape[1])) > 0


@pytest.mark.parametrize("dispatch", ["grouped", "global"])
def test_moe_keeps_the_reference_s_tokens_under_a_skewed_router(dispatch):
    """Every token's first choice is expert 3 and experts 5 and 6 tie
    exactly: capacity keeps the earliest tokens (the stable sort) and the
    tie goes to expert 5 (``jax.lax.top_k``), in both packages."""
    cfg, p, pcfg = _moe(MLA_ARCH, dispatch=dispatch)
    router = np.array(p["router"])
    router[0, :] = 0.0
    router[0, 3] = 2.0
    router[:, 6] = router[:, 5]
    router[0, 5] = router[0, 6] = 0.6
    p = dict(p, router=jnp.asarray(router))
    x = np.random.default_rng(4).normal(size=(2, 32, cfg.d_model))
    x[..., 0] = 5.0
    ids = _first_choices(x, p["router"], cfg.moe.experts_per_token)
    assert (ids[..., 0] == 3).all() and (ids[..., 1] == 5).mean() > 0.5
    assert not (ids == 6).any()
    n = ids.shape[1] if dispatch == "grouped" else ids.size // 2
    assert _dropped(ids if dispatch == "grouped" else ids.reshape(1, -1, 2),
                    cfg.moe.n_experts, JL.moe_capacity(cfg.moe, n)) > 0
    got, aux, want, waux = _moe_both(cfg, p, pcfg, to_torch(p), x, dispatch)
    assert _rel(got, want) <= TOL["float32"]
    assert abs(float(aux) - float(waux)) <= AUX_TOL
    # a later token in place of an earlier one would change y: reversing
    # the token order keeps other tokens, and their outputs move
    rev, _ = (L.moe_block_grouped if dispatch == "grouped"
              else L.moe_block_global)(torch.from_numpy(
                  x[:, ::-1].copy()).float(), to_torch(p), pcfg)
    assert _rel(rev.flip(1), want) > 1e-2


@pytest.mark.parametrize("dispatch", ["grouped", "global"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_bf16_matches_the_reference_fed_its_input(arch, dispatch):
    cfg, p, pcfg = _moe(arch, "bfloat16", dispatch=dispatch)
    x = np.asarray(jnp.asarray(np.random.default_rng(5).normal(
        size=(2, 32, cfg.d_model)), jnp.bfloat16), np.float32)
    got, aux, want, waux = _moe_both(cfg, p, pcfg, to_torch(p), x, dispatch)
    assert _rel(got, want) <= TOL["bfloat16"]
    assert abs(float(aux) - float(waux)) <= AUX_TOL


def test_moe_same_bits_twice_and_no_expert_weight_copied(monkeypatch):
    """The combine is a gather summed over k in a fixed order: two runs
    give the same bits.  The expert products read the stored (E, d, ff)
    weights as they are (``torch.bmm`` of the stored tensors)."""
    cfg, p, pcfg = _moe(MLA_ARCH, "bfloat16")
    pp = to_torch(p)
    seen = []
    bmm = torch.bmm

    def spy(a, b):
        seen.append(b)
        return bmm(a, b)
    monkeypatch.setattr(torch, "bmm", spy)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 32, cfg.d_model))).to(torch.bfloat16)
    y1, a1 = L.moe_block(x, pp, pcfg)
    y2, a2 = L.moe_block(x, pp, pcfg)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)
    assert {id(w) for w in seen[:3]} == {id(pp[n]) for n in
                                         ("w_gate", "w_in", "w_out")}


# -- whole models ------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_aux_and_loss_match_the_reference(arch):
    """``forward``'s aux (summed over the MoE layers) and ``make_loss_fn``'s
    (ce + 0.01·aux, ce, aux) in f32, on both routes."""
    for use_kernels in (False, True):
        (cfg, params), (pcfg, pparams) = _pair(arch, use_kernels=use_kernels)
        toks, jb, tb = _tokens(cfg, 2, 32, seed=8)
        labels = np.roll(toks, -1, axis=1)
        jb["labels"], tb["labels"] = jnp.asarray(labels), torch.from_numpy(
            labels).long()
        wl, wm = jax.jit(JT.make_loss_fn(cfg, aux_weight=0.01))(params, jb)
        loss, met = T.make_loss_fn(pcfg, aux_weight=0.01)(pparams, tb)
        assert sorted(met) == ["aux", "ce"]
        assert float(met["aux"]) > 0
        assert abs(float(met["aux"]) - float(wm["aux"])) <= AUX_TOL
        for got, want in ((loss, wl), (met["ce"], wm["ce"])):
            assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))
        assert float(loss) == float(met["ce"] + 0.01 * met["aux"])
        _, _, aux = T.forward(pparams, pcfg, tb)
        assert float(aux) == float(met["aux"])


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("arch,absorb", [(MLA_ARCH, False), (MLA_ARCH, True),
                                         (ARCHS[1], False)])
def test_decode_matches_the_reference(arch, absorb, quantized):
    """Twenty decode steps in f32 from an empty cache, the port on its own
    (MLA's latent cache, absorbed or not; llama4's k/v cache; int8 with
    scales): the logits at every
    step within 1e-4, the caches at the end within 1e-4 (int8 stores
    within one step)."""
    (cfg, params), (pcfg, pparams) = _pair(arch, quantized_cache=quantized)
    b, steps, rows = 2, 20, 24
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size,
                                             (b, steps)).astype(np.int32)
    jstep = jax.jit(JT.make_serve_step(cfg, absorb=absorb))
    step = T.make_serve_step(pcfg, absorb=absorb)
    jcache = JT.init_cache(cfg, b, rows)
    cache = T.init_cache(pcfg, b, rows, device="cpu")
    for t in range(steps):
        want, jcache = jstep(params, jcache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t))
        got, cache = step(pparams, cache, torch.from_numpy(
            toks[:, t:t + 1]).long(), t)
        assert _rel(got, want) <= TOL["float32"], t
    ref = {jax_path(kp): np.asarray(v)
           for kp, v in jax.tree_util.tree_leaves_with_path(jcache)}
    got = dict(leaves_with_paths(cache))
    assert sorted(got) == sorted(ref)
    for path, x in got.items():
        if x.dtype == torch.int8:
            assert int(np.max(np.abs(x.numpy().astype(np.int32)
                                     - ref[path].astype(np.int32)))) <= 1
        else:
            assert _rel(x, ref[path]) <= TOL["float32"], path
    if arch == MLA_ARCH:
        assert {p.rsplit("/", 1)[1] for p in got} == (
            {"c_kv", "k_rope", "c_kv_scale", "k_rope_scale"} if quantized
            else {"c_kv", "k_rope"})


def test_cache_from_reference_carries_the_int8_latent_cache():
    (cfg, params), (pcfg, _) = _pair(MLA_ARCH, quantized_cache=True)
    jcache = JT.init_cache(cfg, 2, 8)
    jstep = jax.jit(JT.make_serve_step(cfg))
    for t in range(3):
        _, jcache = jstep(params, jcache, jnp.full((2, 1), t + 1, jnp.int32),
                          jnp.int32(t))
    carried = cache_from_reference(pcfg, jax.tree.map(np.asarray, jcache), 2,
                                   8, device="cpu")
    ref = {jax_path(kp): np.asarray(v)
           for kp, v in jax.tree_util.tree_leaves_with_path(jcache)}
    for path, x in leaves_with_paths(carried):
        assert x.dtype == (torch.int8 if ref[path].dtype == np.int8
                           else torch.float32)
        assert np.array_equal(x.numpy(), ref[path]), path


def test_absorbed_decode_matches_the_naive_decode():
    """tests/test_models_smoke.py::test_mla_absorb_decode_matches_naive on
    the port (decode == prefill for both archs, at capacity 16, is
    tests/test_torch_serve_models.py::test_decode_matches_prefill):
    within 2e-4 + 2e-4 |naive| over 32 steps."""
    cfg = dataclasses.replace(get_smoke_config(MLA_ARCH), dtype="float32")
    params = T.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 32))).long()
    outs = {}
    for absorb in (False, True):
        step = T.make_serve_step(cfg, absorb=absorb)
        cache = T.init_cache(cfg, 2, 32, device="cpu")
        logits = []
        for t in range(32):
            out, cache = step(params, cache, toks[:, t:t + 1], t)
            logits.append(out[:, 0])
        outs[absorb] = torch.stack(logits, dim=1)
    np.testing.assert_allclose(outs[True].numpy(), outs[False].numpy(),
                               rtol=2e-4, atol=2e-4)
    assert not torch.equal(outs[True], outs[False])


def test_prefill_at_published_capacity_drops_and_differs_from_decode():
    """At the published 1.25 a 64-token prefill may drop tokens a decode
    step (one token a row, capacity 4) keeps: why the decode == prefill
    checks raise the capacity.  Port and reference drop the same ones."""
    (cfg, params), (pcfg, pparams) = _pair(MLA_ARCH, moe={
        "capacity_factor": 0.5})
    _, jb, tb = _tokens(cfg, 1, 64, seed=10)
    want = jax.jit(JT.make_prefill_step(cfg))(params, jb)
    got = T.make_prefill_step(pcfg)(pparams, tb)
    assert _rel(got, want) <= TOL["float32"]
    roomy = _with_moe(pcfg, capacity_factor=NO_DROP)
    assert _rel(T.make_prefill_step(roomy)(pparams, tb), want) > 1e-3


# -- the LM backend and the CLI ------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_backend_lanes_match_the_reference_backend(dtype):
    """``make_lm_workload("deepseek-v2-lite-16b")``: the loss of a lane
    carries 0.01·aux, as the reference's; lanes at θ0 and two points."""
    wl = j_workload(MLA_ARCH, k=4, batch_size=1, seq_len=16, seed=1)
    if dtype == "float32":
        cfg = dataclasses.replace(wl.cfg, dtype=dtype)
        init_key, basis_key = jax.random.split(jax.random.key(1), 2)
        params = ref_init(cfg, init_key)
        wl = dataclasses.replace(wl, cfg=cfg, proj=JProjection.create(
            params, 4, basis_key))
    pts = np.random.default_rng(7).uniform(-0.4, 0.4, (3, 4))
    pts[0] = 0.0
    be = JBackend(wl)
    want = be.collect(be.submit(pts, np.full(3, np.nan), [0, 1, 2]))
    mine = lm_workload_from_reference(
        arch=wl.arch, cfg=dataclasses.asdict(wl.cfg),
        theta0=ref_leaves(wl.proj.theta0), basis=np.asarray(wl.proj.basis),
        batch=wl.batch, k=wl.k, coeff_bound=wl.coeff_bound, seed=wl.seed,
        device="cpu")
    routers = [x for p, x in leaves_with_paths(mine.proj.theta0)
               if p.endswith("router")]
    assert routers and all(x.dtype == torch.float32 for x in routers)
    got = LmLossEvalBackend(mine)(pts)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype])
    params = mine.proj.lift(torch.zeros(4, dtype=torch.float32))
    loss, met = T.make_loss_fn(mine.cfg)(params, mine.batch)
    assert float(met["aux"]) > 0 and float(loss) == float(got[0])
    # the flat chart keeps the f32 router among bf16 leaves
    c = torch.from_numpy(pts[1]).float()
    flat = mine.proj.unravel(mine.proj.lift_flat(c))
    for (path, a), (_, b) in zip(leaves_with_paths(mine.proj.lift(c)),
                                 leaves_with_paths(flat)):
        assert a.dtype == b.dtype, path
        assert torch.equal(a, b), path


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_the_cpu(arch, capsys):
    assert pserve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                        "--batch", "2", "--gen-len", "4", "--prompt-len",
                        "3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == (f"[serve] {get_smoke_config(arch).name}: 3 requests, "
                      f"batch=2")
    assert len(out) == 5 and all(out[1 + r].startswith(f"[serve] req{r}: 4 ")
                                 for r in range(3))
