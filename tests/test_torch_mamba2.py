"""Mamba2 and the weight-shared attention block (zamba2-2.7b) against the
JAX package.

The reference's parameters come from ``jax.random`` and are carried
across as numpy arrays (``params_from_leaves`` for whole models, where
``a_log`` and ``dt_bias`` stay f32 in a bf16 model as the reference keeps
them), its caches by ``convert.cache_from_reference``; inputs are made
from numpy seeds.  Tolerances, on max |got - want| over max |want|: the
pieces (``_segsum``, ``_causal_conv``, ``_ssd_chunked``) 1e-5 in f32, the
mixer, the model's hidden states, logits and loss 1e-4 in f32; in bf16 a
mixer fed the reference's input 2e-2, the loss 2e-2 relative and hidden
states 5e-2 (ROADMAP.md C).  zamba2's bf16 logits are held in
tests/test_torch_serve_models.py (``BF16_AS_ACCURATE``): no farther from
the f32 result than the reference's own.  The sharding rules for the
Mamba2 and shared-attention leaves and caches are held leaf by leaf in
tests/test_torch_sharding.py, whose parametrisation covers zamba2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.compat as compat
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import cell_is_runnable as ref_runnable
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.core.subspace import SubspaceProjection as JProjection
from repro.core.substrates.lm_loss import LmLossEvalBackend as JBackend
from repro.core.substrates.lm_loss import make_lm_workload as j_workload
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.configs import (SHAPES, SSMConfig, cell_is_runnable,
                                 config_from_dict, cut_depth, get_config,
                                 get_smoke_config)
from repro_torch.convert import cache_from_reference, lm_workload_from_reference
from repro_torch.core.substrates.lm_loss import LmLossEvalBackend
from repro_torch.core.tree import leaves_with_paths, map_tree
from repro_torch.launch import serve as pserve
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

ARCH = "zamba2-2.7b"
PIECE_TOL = 1e-5
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
HIDDEN_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


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


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


ref_init = jax.jit(JT.init_params, static_argnums=0)


def _pair(dtype: str = "float32", seed: int = 0, **fields):
    """(reference cfg, params) and (port cfg, params) on one draw."""
    cfg = dataclasses.replace(ref_smoke(ARCH), dtype=dtype, **fields)
    params = ref_init(cfg, jax.random.key(seed))
    pcfg = config_from_dict(dataclasses.asdict(cfg))
    return (cfg, params), (pcfg, T.params_from_leaves(
        pcfg, ref_leaves(params), device="cpu"))


def _mixer_pair(dtype, seed: int = 0):
    """The smoke config's Mamba2 parameters, reference and port."""
    cfg = dataclasses.replace(ref_smoke(ARCH), dtype=dtype)
    p = JS.init_mamba2(jax.random.key(seed), cfg, jnp.dtype(dtype))
    return cfg, p, config_from_dict(dataclasses.asdict(cfg)), to_torch(p)


# -- configurations ------------------------------------------------------------

def test_configs_round_trip_and_count_as_the_reference():
    for mine, theirs in ((get_config(ARCH), ref_config(ARCH)),
                         (get_smoke_config(ARCH), ref_smoke(ARCH))):
        fields = dataclasses.asdict(theirs)
        assert dataclasses.asdict(mine) == fields
        assert config_from_dict(fields) == mine
        assert isinstance(mine.ssm, SSMConfig)
        assert mine.n_params() == theirs.n_params()
        assert mine.n_active_params() == theirs.n_active_params()
        for name in SHAPES:
            assert (cell_is_runnable(mine, SHAPES[name])
                    == ref_runnable(theirs, REF_SHAPES[name]))
    cfg = get_config(ARCH)
    # embedding 81.92 M + 54 Mamba2 blocks of 39.65 M + one shared block
    assert cfg.n_params() == 2_327_838_720
    assert (cfg.n_layers, len(cfg.blocks())) == (54, 63)
    assert cell_is_runnable(cfg, SHAPES["long_500k"])[0]


def test_cut_depth_counts_blocks_and_layers():
    """``cut_depth`` cuts entries of ``blocks()``; ``n_layers`` counts the
    blocks with weights of their own, as the configuration does."""
    cfg = get_config(ARCH)
    assert cut_depth(cfg, 63) == cfg
    cut = cut_depth(cfg, 14)
    assert cut.blocks() == (("mamba2",) * 6 + ("shared_attn",)) * 2
    assert cut.n_layers == 12
    assert cut_depth(get_smoke_config(ARCH), 6) == get_smoke_config(ARCH)
    for bad in (0, 64):
        with pytest.raises(ValueError, match="63 blocks"):
            cut_depth(cfg, bad)
    qwen = get_config("qwen2-72b")
    assert cut_depth(qwen, 4).n_layers == 4 and not cut_depth(
        qwen, 4).block_pattern


# -- parameter leaves ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", ["smoke", "published"])
def test_leaves_and_types_are_the_reference_s(width, dtype):
    """Paths, shapes, order and types (``a_log``/``dt_bias`` f32 in bf16);
    the top-level ``shared_attn`` leaves after the segments; the shared
    slots of the segments hold no leaf.  Published widths as specs."""
    cfg = dataclasses.replace(ref_config(ARCH) if width == "published"
                              else ref_smoke(ARCH), dtype=dtype)
    want = [(jax_path(kp), tuple(x.shape), str(x.dtype)) for kp, x in
            jax.tree_util.tree_leaves_with_path(jax.eval_shape(
                lambda key: JT.init_params(cfg, key), jax.random.key(0)))]
    pcfg = config_from_dict(dataclasses.asdict(cfg))
    dt = T.param_dtype(pcfg)
    got = [(path, leaf.shape, str(leaf.dtype or dt).replace("torch.", ""))
           for path, leaf in leaves_with_paths(T.param_specs(pcfg))]
    assert got == want
    shared = [p for p, *_ in got if p.startswith("shared_attn/")]
    assert shared and [p for p, *_ in got][-len(shared):] == shared
    assert {p.split("/")[1] for p in shared} == {"norm1", "attn", "norm2",
                                                 "mlp"}
    f32 = {p.rsplit("/", 1)[1] for p, _, t in got if t == "float32"}
    assert f32 >= {"a_log", "dt_bias"}
    if dtype == "bfloat16":
        assert f32 == {"a_log", "dt_bias"}
    if width == "smoke":
        params = T.init_params(pcfg, torch.Generator().manual_seed(0), "cpu")
        assert [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
                for p, x in leaves_with_paths(params)] == want
        assert T.count_params(params) == sum(int(np.prod(s))
                                             for _, s, _ in want)
        ref = ref_init(cfg, jax.random.key(0))
        a_log = params["segments"][0][0]["mamba"]["a_log"]
        np.testing.assert_allclose(
            a_log.numpy(), np.asarray(ref["segments"][0][0]["mamba"][
                "a_log"]), rtol=1e-6)
        assert torch.equal(a_log[0], a_log[1])


# -- the pieces ------------------------------------------------------------------

def test_segsum_matches_the_reference():
    a = np.random.default_rng(0).uniform(-2.0, 0.0, (2, 3, 64)).astype(
        np.float32)
    want = np.asarray(JS._segsum(jnp.asarray(a)))
    got = S._segsum(_t(a))
    assert _rel(got, want) <= PIECE_TOL
    assert np.array_equal(np.triu(want[0, 0], 1) == 0, np.triu(
        got[0, 0].numpy(), 1) == 0)
    assert torch.all(torch.diagonal(got, dim1=-2, dim2=-1) == 1)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_the_reference(with_state):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32) * 0.2
    b = rng.normal(size=(24,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 24)).astype(np.float32) if with_state \
        else None
    want, want_state = JS._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if st is None else jnp.asarray(st))
    got, got_state = S._causal_conv(_t(x), _t(w), _t(b),
                                    None if st is None else _t(st))
    assert _rel(got, want) <= PIECE_TOL
    assert np.array_equal(got_state.numpy(), np.asarray(want_state))


@pytest.mark.parametrize("t", [128, 70, 5])
def test_ssd_chunked_matches_the_reference(t):
    """T a multiple of the chunk of 64, and not (padded)."""
    rng = np.random.default_rng(t)
    b, h, p, n = 2, 4, 8, 16
    xs = rng.normal(size=(b, t, h, p)).astype(np.float32)
    la = -rng.uniform(0.0, 1.5, (b, t, h)).astype(np.float32)
    bb = rng.normal(size=(b, t, h, n)).astype(np.float32)
    cc = rng.normal(size=(b, t, h, n)).astype(np.float32)
    want_y, want_s = JS._ssd_chunked(*(jnp.asarray(a)
                                       for a in (xs, la, bb, cc)))
    got_y, got_s = S._ssd_chunked(*(_t(a) for a in (xs, la, bb, cc)))
    assert tuple(got_y.shape) == (b, t, h, p)
    assert tuple(got_s.shape) == (b, h, p, n)
    assert _rel(got_y, want_y) <= PIECE_TOL
    assert _rel(got_s, want_s) <= PIECE_TOL


# -- the mixer ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_mixer_matches_the_reference_on_a_sequence(dtype):
    cfg, p, pcfg, tp = _mixer_pair(dtype)
    x = np.random.default_rng(2).normal(size=(2, 70, cfg.d_model))
    want, wst = jax.jit(lambda x, p: JS.mamba2_mixer(x, p, cfg))(
        jnp.asarray(x, jnp.dtype(dtype)), p)
    got, st = S.mamba2_mixer(_t(x).to(T.param_dtype(pcfg)), tp, pcfg)
    assert got.dtype == T.param_dtype(pcfg)
    assert _rel(got, want) <= TOL[dtype]
    for name in ("conv_xs", "conv_bc", "ssm"):
        assert st[name].dtype == (torch.float32 if name == "ssm"
                                  else T.param_dtype(pcfg))
        assert _rel(st[name], wst[name]) <= HIDDEN_TOL[dtype], name


def test_mamba2_mixer_decode_steps_match_the_reference():
    """Sixteen decode steps from a carried-across reference state, the
    port on its own: outputs and the conv and SSM states at every step."""
    cfg, p, pcfg, tp = _mixer_pair("float32", seed=1)
    rng = np.random.default_rng(3)
    shapes = JS.mamba2_state_shape(cfg, 2)
    jst = {k: jnp.asarray(rng.normal(size=s).astype(np.float32) * 0.5)
           for k, s in shapes.items()}
    st = {k: _t(v) for k, v in jst.items()}
    step = jax.jit(lambda x, p, s: JS.mamba2_mixer(x, p, cfg, s))
    for i in range(16):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        want, jst = step(jnp.asarray(x), p, jst)
        got, st = S.mamba2_mixer(_t(x), tp, pcfg, st)
        assert tuple(got.shape) == (2, 1, cfg.d_model)
        assert _rel(got, want) <= TOL["float32"], i
        for name in shapes:
            assert _rel(st[name], jst[name]) <= TOL["float32"], (i, name)


# -- whole models --------------------------------------------------------------

def _batch(cfg, b: int, s: int, seed: int):
    rng = np.random.default_rng(seed)
    toks, labels = (rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
                    for _ in range(2))
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()})


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_match_the_reference(dtype, use_kernels):
    """70 tokens: two SSD chunks, the second padded."""
    (cfg, params), (pcfg, pparams) = _pair(dtype, use_kernels=use_kernels)
    jb, tb = _batch(cfg, 2, 70, seed=4)
    hidden_ref = jax.jit(lambda p, b: JT.forward(p, cfg, b)[0])(params, jb)
    loss_ref = float(jax.jit(JT.make_loss_fn(cfg))(params, jb)[0])
    with torch.no_grad():
        hidden, _, aux = T.forward(pparams, pcfg, tb)
        loss, met = T.make_loss_fn(pcfg)(pparams, tb)
    assert hidden.dtype == T.param_dtype(pcfg) and float(aux) == 0.0
    assert _rel(hidden, hidden_ref) <= HIDDEN_TOL[dtype]
    assert float(loss) == float(met["ce"])
    np.testing.assert_allclose(float(loss), loss_ref, rtol=TOL[dtype])


def test_loss_matches_the_reference_s_pallas_route(monkeypatch):
    """The reference's forward through its Pallas attention kernel
    (interpret mode on the CPU) in both applications of the shared
    block."""
    monkeypatch.setattr(compat, "route_pallas", lambda override=None: True)
    (cfg, params), (pcfg, pparams) = _pair(use_kernels=True, seed=3)
    jb, tb = _batch(cfg, 1, 16, seed=5)
    loss_ref = float(jax.jit(JT.make_loss_fn(cfg))(params, jb)[0])
    with torch.no_grad():
        loss = float(T.make_loss_fn(pcfg)(pparams, tb)[0])
    np.testing.assert_allclose(loss, loss_ref, rtol=TOL["float32"])


def test_decode_over_two_chunks_matches_prefill():
    """tests/test_models_smoke.py::test_decode_matches_prefill on the port
    over 80 tokens, so the prefill's SSD runs two chunks of 64 (the
    second padded): the reference's 2e-3; then the decode's caches
    against the reference's after the same 80 steps."""
    (cfg, params), (pcfg, pparams) = _pair()
    t_len = 80
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size,
                                             (1, t_len)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    want = T.make_prefill_step(pcfg)(pparams, {"tokens": tt})
    step = T.make_serve_step(pcfg)
    cache = T.init_cache(pcfg, 1, t_len, device="cpu")
    jstep = jax.jit(JT.make_serve_step(cfg))
    jcache = JT.init_cache(cfg, 1, t_len)
    outs = []
    for t in range(t_len):
        logits, cache = step(pparams, cache, tt[:, t:t + 1], t)
        _, jcache = jstep(params, jcache, jnp.asarray(toks[:, t:t + 1]),
                          jnp.int32(t))
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, dim=1).numpy(),
                               want.numpy(), rtol=2e-3, atol=2e-3)
    ref = ref_leaves(jcache)
    got = dict(leaves_with_paths(cache))
    assert sorted(got) == sorted(ref)
    for path, x in got.items():
        assert tuple(x.shape) == ref[path].shape, path
        assert _rel(x, ref[path]) <= TOL["float32"], path


def test_shared_weights_serve_every_application_with_its_own_cache(
        monkeypatch):
    """Every application of the shared block reads ``params
    ["shared_attn"]``: with its output projections zeroed the model is the
    same bits as the model without the shared blocks.  Each application
    keeps its own cache: its slice of the segment's stacked (2, ...) k/v
    leaf, written at the rows decoded and differing between the two."""
    _, (pcfg, pparams) = _pair(seed=4)
    seen = []
    block = L.attention_block

    def spy(x, p, cfg, positions, cache=None, t=None, **kw):
        seen.append((id(p), None if cache is None
                     else cache["k"].data_ptr()))
        return block(x, p, cfg, positions, cache, t, **kw)
    monkeypatch.setattr(L, "attention_block", spy)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, pcfg.vocab_size, (2, 12))).long()
    prefill = T.make_prefill_step(pcfg)
    full = prefill(pparams, {"tokens": toks})
    assert [i for i, _ in seen] == [id(pparams["shared_attn"]["attn"])] * 2
    for name in ("norm1", "norm2"):
        pparams["shared_attn"][name]["scale"].mul_(1.5)
    assert not torch.equal(prefill(pparams, {"tokens": toks}), full)
    pparams["shared_attn"]["attn"]["wo"].zero_()
    pparams["shared_attn"]["mlp"]["w_out"].zero_()
    mamba_only = dataclasses.replace(pcfg, block_pattern=("mamba2",) * 4)
    alone = {k: v for k, v in pparams.items() if k != "shared_attn"}
    # the smoke pattern (mamba2, mamba2, shared_attn) x 2 stacks each of
    # its two Mamba2 slots over the 2 repeats; the Mamba2-only model
    # stacks its four blocks in order
    seg = pparams["segments"][0]
    alone["segments"] = [[map_tree(
        lambda a, b: torch.stack([a[0], b[0], a[1], b[1]]), seg[0], seg[1])]]
    assert torch.equal(prefill(pparams, {"tokens": toks}),
                       T.make_prefill_step(mamba_only)(alone,
                                                       {"tokens": toks}))
    _, (pcfg, pparams) = _pair(seed=4)
    seen.clear()
    cache = T.init_cache(pcfg, 2, 16, device="cpu")
    step = T.make_serve_step(pcfg)
    for t in range(6):
        step(pparams, cache, toks[:, t:t + 1], t)
    ptrs = {p for _, p in seen}
    assert len(seen) == 12 and len(ptrs) == 2
    k = cache[0][2]["k"]                       # (2 applications, B, S, H, D)
    assert k.shape[0] == 2
    assert bool((k[:, :, :6] != 0).any(-1).any(-1).all())
    assert not bool(k[:, :, 6:].any())
    assert not torch.equal(k[0], k[1])


# -- the LM backend and the CLI ------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_backend_lanes_match_the_reference_backend(dtype):
    """``make_lm_workload("zamba2-2.7b")``: lanes at θ0 and two points; the
    flat chart keeps the f32 ``a_log``/``dt_bias`` among bf16 leaves."""
    wl = j_workload(ARCH, k=4, batch_size=1, seq_len=16, seed=1)
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
    f32 = [p for p, x in leaves_with_paths(mine.proj.theta0)
           if x.dtype == torch.float32]
    if dtype == "bfloat16":
        assert f32 and all(p.rsplit("/", 1)[1] in ("a_log", "dt_bias")
                           for p in f32)
    got = LmLossEvalBackend(mine)(pts)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype])
    c = torch.from_numpy(pts[1]).float()
    flat = mine.proj.unravel(mine.proj.lift_flat(c))
    for (path, a), (_, b) in zip(leaves_with_paths(mine.proj.lift(c)),
                                 leaves_with_paths(flat)):
        assert a.dtype == b.dtype, path
        assert torch.equal(a, b), path


def test_cache_from_reference_carries_every_state():
    (cfg, params), (pcfg, _) = _pair("bfloat16")
    jcache = JT.init_cache(cfg, 2, 8)
    jstep = jax.jit(JT.make_serve_step(cfg))
    for t in range(3):
        _, jcache = jstep(params, jcache, jnp.full((2, 1), t + 1, jnp.int32),
                          jnp.int32(t))
    carried = cache_from_reference(pcfg, jax.tree.map(np.asarray, jcache), 2,
                                   8, device="cpu")
    ref = ref_leaves(jcache)
    names = set()
    for path, x in leaves_with_paths(carried):
        names.add(path.rsplit("/", 1)[1])
        assert x.dtype == (torch.float32 if path.endswith("ssm")
                           else torch.bfloat16), path
        assert np.array_equal(x.float().numpy(), ref[path]), path
    assert names == {"conv_xs", "conv_bc", "ssm", "k", "v"}


def test_serve_cli_on_the_cpu(capsys):
    assert pserve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                        "--batch", "2", "--gen-len", "4", "--prompt-len",
                        "3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == (f"[serve] {get_smoke_config(ARCH).name}: 3 requests, "
                      f"batch=2")
    assert len(out) == 5 and all(out[1 + r].startswith(f"[serve] req{r}: 4 ")
                                 for r in range(3))
