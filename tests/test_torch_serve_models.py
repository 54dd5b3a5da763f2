"""The serving path's models against the JAX package: the dense families
(qwen2-72b, deepseek-coder-33b, command-r-plus-104b, chameleon-34b, the
hubert-xlarge encoder), MLA + MoE (deepseek-v2-lite-16b) and interleaved
MoE (llama4-maverick-400b-a17b; tests/test_torch_moe_mla.py holds their
blocks), h2o-danube-3-4b's sliding-window ring, rwkv6's recurrent
states and zamba2's Mamba2 states beside its shared block's caches
(tests/test_torch_mamba2.py holds its blocks).

The reference's parameters are carried across leaf by leaf
(``params_from_leaves``) and its caches by ``convert.cache_from_reference``;
inputs are made from numpy seeds.  Tolerances, on max |got - want| over
max |want|: f32 ≤ 1e-4 (the same algorithm; sums ordered differently)
and bf16 ≤ 2e-2 (XLA's CPU bf16 fusions round fewer intermediates than
eager torch), on logits.  The int8 cache: ``quant_write`` fed the same
values stores exactly the reference's int8 values and scales (both round
half to even and divide in f32); after 32 decode steps, where the stored
k/v come out of each framework's own arithmetic, the int8 stores are
within one step of the reference's (a value whose f32 quotient straddles
a .5 rounds to either neighbour).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.compat as compat
from repro.configs import ARCH_NAMES as REF_ARCH_NAMES
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import cell_is_runnable as ref_runnable
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import (ARCH_NAMES, SHAPES, cell_is_runnable,
                                 config_from_dict, cut_depth, get_config,
                                 get_smoke_config)
from repro_torch.convert import cache_from_reference
from repro_torch.core.tree import leaves_with_paths
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

NEW_ARCHS = ("qwen2-72b", "deepseek-coder-33b", "command-r-plus-104b",
             "chameleon-34b", "hubert-xlarge", "deepseek-v2-lite-16b",
             "llama4-maverick-400b-a17b", "zamba2-2.7b")
SLICE_ARCHS = NEW_ARCHS + ("h2o-danube-3-4b", "rwkv6-7b")
DECODE_ARCHS = tuple(a for a in SLICE_ARCHS if a != "hubert-xlarge")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: bf16 caches (hidden states and their projections) after a free run,
#: test_torch_lm_models.py's bf16 hidden-state tolerance
CACHE_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
#: the int8 cache's decode logits against the bf16 cache's, both in the
#: port, ‖int8 - bf16‖ / ‖bf16‖ over all steps (chip_smoke.py's [serve]
#: (c) holds the card to the same gate)
INT8_TOL = 5e-2
#: archs whose smoke model amplifies bf16 rounding past ``TOL``: the
#: reference's own bf16 prefill of zamba2 (four Mamba2 blocks, each a
#: gated and normed SSM, and two applications of the shared attention
#: block) lies 2.5-3.2 % of the largest logit from its f32 prefill on the
#: same weights, so two packages' bf16 roundings land up to 3.6 % apart.
#: In bf16 such an arch is held to be at least as accurate as the
#: reference: no farther from the reference's f32 result (which the port
#: matches in f32 to 1e-4) than the reference's bf16 result is
BF16_AS_ACCURATE = ("zamba2-2.7b",)
#: a MoE token whose k-th and (k+1)-th router probabilities lie closer than
#: this may take another expert in the two packages in bf16 (a one-ulp
#: difference in its hidden state flips the choice; deepseek's smoke model
#: has one at 8.4e-05, whose logit row then differs by 3.6e-2 of the
#: largest logit while every other row stays within 1.6e-2), so in bf16
#: such tokens' rows are counted and left out of the comparison
ROUTE_MARGIN = 1e-3


class _NearTies:
    """Within ``with``: the tokens of each of the port's MoE routings whose
    margin (k-th minus (k+1)-th router probability) is below
    ``ROUTE_MARGIN``."""

    def __enter__(self):
        self.route, self.near = L._route, []

        def spy(x, router, k):
            out = self.route(x, router, k)
            top = torch.topk(out[0], k + 1, dim=-1).values
            self.near.append((top[..., k - 1] - top[..., k])
                             < ROUTE_MARGIN)
            return out
        L._route = spy
        return self

    def __exit__(self, *exc):
        L._route = self.route

    def tokens(self, b: int, s: int) -> np.ndarray:
        """(B, S) bool: near a tie in any layer (a global dispatch routes
        (1, B·S) tokens, a grouped one (B, S): both flatten the same)."""
        near = np.zeros(b * s, bool)
        for layer in self.near:
            near |= layer.reshape(-1).numpy()
        return near.reshape(b, s)


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


ref_init = jax.jit(JT.init_params, static_argnums=0)


def _pair(arch: str, dtype: str = "float32", seed: int = 0, **fields):
    """(reference cfg, params) and (port cfg, params) on one draw."""
    cfg = dataclasses.replace(ref_smoke(arch), dtype=dtype, **fields)
    params = ref_init(cfg, jax.random.key(seed))
    pcfg = config_from_dict(dataclasses.asdict(cfg))
    return (cfg, params), (pcfg, T.params_from_leaves(
        pcfg, ref_leaves(params), device="cpu"))


def _f32(cfg, params):
    """The reference's configuration and parameters in f32 (the same
    values: f32 holds bf16 exactly)."""
    return (dataclasses.replace(cfg, dtype="float32"),
            jax.tree.map(lambda a: a.astype(jnp.float32), params))


def _inputs(cfg, b: int, s: int, seed: int):
    """The same seeded batch for both packages (tokens, or the audio
    stub's frame embeddings with a mask)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_stub":
        emb = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
        mask = rng.random((b, s)) < 0.3
        jb = {"embeds": jnp.asarray(emb, jnp.dtype(cfg.dtype)),
              "mask": jnp.asarray(mask)}
        tb = {"embeds": torch.from_numpy(emb).to(T.param_dtype(cfg)),
              "mask": torch.from_numpy(mask)}
        return jb, tb
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(
        toks).long()}


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.float().numpy() - want))
                 / np.max(np.abs(want)))


# -- configurations ------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_registry_copies_the_reference_configs(arch):
    assert ARCH_NAMES == [a for a in REF_ARCH_NAMES if a in ARCH_NAMES]
    assert set(ARCH_NAMES) == set(SLICE_ARCHS)
    for mine, theirs in ((get_config(arch), ref_config(arch)),
                         (get_smoke_config(arch), ref_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert config_from_dict(dataclasses.asdict(theirs)) == mine


@pytest.mark.parametrize("arch", ["zamba2-2.7b"])
def test_unported_archs_are_refused_by_name(arch):
    """No arch of the reference is refused any more: ``arch``, the last
    one ported, and every other are registered in the reference's order,
    and only a name the reference does not know raises ``KeyError``."""
    assert ARCH_NAMES == REF_ARCH_NAMES
    for lookup in (get_config, get_smoke_config):
        assert lookup(arch).name.startswith(arch)
        with pytest.raises(KeyError, match="no-such-arch"):
            lookup("no-such-arch")


@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_n_params_and_cells_equal_the_reference(arch):
    assert get_config(arch).n_params() == ref_config(arch).n_params()
    assert get_smoke_config(arch).n_params() == ref_smoke(arch).n_params()
    assert sorted(SHAPES) == sorted(REF_SHAPES)
    for name in SHAPES:
        assert (cell_is_runnable(get_config(arch), SHAPES[name])
                == ref_runnable(ref_config(arch), REF_SHAPES[name]))


def test_n_params_refuses_unported_blocks():
    """The Mamba2 and shared-attention blocks, once refused, count as the
    reference counts them: a Mamba2 block by its projections (with the
    default ``SSMConfig`` where the config has none), the shared block
    once however often it is applied."""
    cfg, ref = get_smoke_config("qwen2-72b"), ref_smoke("qwen2-72b")
    counts = []
    for pattern in (("mamba2",) * 2, ("shared_attn",) * 2,
                    ("shared_attn",), ("attn", "shared_attn", "mamba2")):
        mine = dataclasses.replace(cfg, block_pattern=pattern).n_params()
        assert mine == dataclasses.replace(
            ref, block_pattern=pattern).n_params()
        counts.append(mine)
    assert counts[1] == counts[2]


# -- parameter leaves ------------------------------------------------------------

@pytest.mark.parametrize("width", ["smoke", "published"])
@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_leaf_paths_shapes_and_order_are_the_reference_s(arch, width):
    if width == "smoke":
        cfg, pcfg = ref_smoke(arch), get_smoke_config(arch)
    else:           # published widths, depth cut to 2 as on the card
        pcfg = cut_depth(get_config(arch), 2)
        cfg = dataclasses.replace(ref_config(arch), n_layers=2,
                                  block_pattern=pcfg.block_pattern)
    want = [(jax_path(kp), tuple(x.shape)) for kp, x in
            jax.tree_util.tree_leaves_with_path(jax.eval_shape(
                lambda key: JT.init_params(cfg, key), jax.random.key(0)))]
    got = [(path, leaf.shape)
           for path, leaf in leaves_with_paths(T.param_specs(pcfg))]
    assert got == want
    if width == "smoke":
        params = T.init_params(pcfg, torch.Generator().manual_seed(0), "cpu")
        assert [(p, tuple(x.shape)) for p, x in
                leaves_with_paths(params)] == want
        assert T.count_params(params) == sum(int(np.prod(s))
                                             for _, s in want)


# -- prefill ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_prefill_logits_match_the_reference(arch, use_kernels, dtype):
    """Dense route (``use_kernels=False``; hubert's non-causal attention
    takes it either way) and kernel route (the plain versions on the
    CPU, the reference's ref oracle).  A ``BF16_AS_ACCURATE`` arch in bf16
    is held no farther from the reference's f32 prefill than the
    reference's bf16 prefill is."""
    (cfg, params), (pcfg, pparams) = _pair(arch, dtype,
                                           use_kernels=use_kernels)
    jb, tb = _inputs(cfg, 2, 32, seed=7)
    want = jax.jit(JT.make_prefill_step(cfg))(params, jb)
    with _NearTies() as ties:
        got = T.make_prefill_step(pcfg)(pparams, tb)
    assert got.dtype == T.param_dtype(pcfg)
    assert tuple(got.shape) == tuple(want.shape) == (2, 32, cfg.vocab_size)
    keep = ~ties.tokens(2, 32) if dtype == "bfloat16" else np.ones(
        (2, 32), bool)
    assert keep.sum() >= 2 * 32 - 2
    if dtype == "bfloat16" and arch in BF16_AS_ACCURATE:
        f32 = jax.jit(JT.make_prefill_step(_f32(cfg, params)[0]))(
            _f32(cfg, params)[1], jb)
        assert _rel(got, f32) <= _rel(torch.from_numpy(np.asarray(
            want, np.float32)), f32)
        return
    assert _rel(got[torch.from_numpy(keep)], np.asarray(want)[keep]) \
        <= TOL[dtype]


def test_prefill_on_the_reference_s_pallas_route(monkeypatch):
    """qwen2's prefill against the reference's forward through its Pallas
    attention kernel (interpret mode on the CPU)."""
    monkeypatch.setattr(compat, "route_pallas", lambda override=None: True)
    (cfg, params), (pcfg, pparams) = _pair("qwen2-72b", use_kernels=True)
    jb, tb = _inputs(cfg, 1, 16, seed=8)
    want = jax.jit(JT.make_prefill_step(cfg))(params, jb)
    assert _rel(T.make_prefill_step(pcfg)(pparams, tb), want) <= 1e-4


def test_pad_heads_are_inert():
    """deepseek-coder's pad heads (56 padded to 64 at published widths;
    4 to 8 here): whatever their weights, the output is the same bits,
    and it equals the reference's on both routes."""
    for use_kernels in (False, True):
        (cfg, params), (pcfg, pparams) = _pair(
            "deepseek-coder-33b", head_pad_to=8, use_kernels=use_kernels)
        jb, tb = _inputs(cfg, 2, 16, seed=9)
        step = T.make_prefill_step(pcfg)
        got = step(pparams, tb)
        assert _rel(got, jax.jit(JT.make_prefill_step(cfg))(params, jb)) \
            <= 1e-4
        attn = pparams["segments"][0][0]["attn"]
        assert attn["wq"].shape[2] == 8
        gen = torch.Generator().manual_seed(1)
        for name, dim in (("wq", 2), ("wo", 1)):
            pad = attn[name].narrow(dim, 4, 4)
            pad.copy_(torch.randn(pad.shape, generator=gen) * 10)
        assert torch.equal(step(pparams, tb), got)


# -- decode --------------------------------------------------------------------

def _ref_cache_np(cache):
    return jax.tree.map(np.asarray, cache)


def _norm_rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got.float().numpy() - want)
                 / np.linalg.norm(want))


def _decode_both(arch, dtype, steps=32, carry_at=8, b=2, max_seq=48,
                 **fields):
    """The reference decodes ``steps`` tokens.  The port decodes them
    twice: once from the reference's cache carried across at ``carry_at``
    and on its own from there (``free``), and once a step at a time, each
    step from the reference's cache of that step (``fresh``).  Returns
    the worst step's logit errors, max-abs and normwise, of each, the
    reference's and the free run's final caches, and the (B, S) positions
    whose free step routed a token near a tie (``_NearTies``).  For a
    ``BF16_AS_ACCURATE`` arch in bf16 the reference also takes each step
    in f32 from its bf16 cache, and ``fresh_f32`` / ``ref_f32`` are the
    fresh and the reference's logits' distances from that, normwise over
    all steps."""
    (cfg, params), (pcfg, pparams) = _pair(arch, dtype, **fields)
    shadow = dtype == "bfloat16" and arch in BF16_AS_ACCURATE
    if shadow:
        cfg32, params32 = _f32(cfg, params)
        jstep32 = jax.jit(JT.make_serve_step(cfg32))
        logits = {"fresh": [], "ref": [], "f32": []}
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (b, steps)).astype(np.int32)
    jstep = jax.jit(JT.make_serve_step(cfg))
    step = T.make_serve_step(pcfg)
    jcache = JT.init_cache(cfg, b, max_seq)
    free = None
    near = np.zeros((b, max_seq), bool)
    worst = {"free": 0.0, "fresh": 0.0, "fresh_norm": 0.0}
    for t in range(steps):
        fresh = cache_from_reference(pcfg, _ref_cache_np(jcache), b, max_seq,
                                     device="cpu")
        if t == carry_at:
            free = cache_from_reference(pcfg, _ref_cache_np(jcache), b,
                                        max_seq, device="cpu")
        if shadow:
            logits["f32"].append(np.asarray(jstep32(
                params32, jax.tree.map(lambda a: a.astype(jnp.float32),
                                       jcache),
                jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))[0]))
        want, jcache = jstep(params, jcache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t))
        tok = torch.from_numpy(toks[:, t:t + 1]).long()
        got, _ = step(pparams, fresh, tok, t)
        assert tuple(got.shape) == (b, 1, cfg.vocab_size)
        if shadow:
            logits["fresh"].append(got.float().numpy())
            logits["ref"].append(np.asarray(want, np.float32))
        worst["fresh"] = max(worst["fresh"], _rel(got, want))
        worst["fresh_norm"] = max(worst["fresh_norm"], _norm_rel(got, want))
        if free is not None:
            with _NearTies() as ties:
                got, free = step(pparams, free, tok, t)
            near[:, t] = ties.tokens(b, 1)[:, 0]
            worst["free"] = max(worst["free"], _rel(got, want))
    if shadow:
        f32 = np.concatenate(logits["f32"], axis=1)
        for name in ("fresh", "ref"):
            worst[f"{name}_f32"] = _norm_rel(torch.from_numpy(
                np.concatenate(logits[name], axis=1)), f32)
    return worst, _ref_cache_np(jcache), free, near


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_logits_and_caches_match_the_reference(arch, dtype):
    """Step by step from a carried-across reference cache (danube's ring
    of 16 wraps twice in 32 steps); then the caches after 32 steps.

    In f32 the port runs on its own from the cache carried across at step
    8, within 1e-4 at every step.  In bf16 each step starts from the
    reference's cache of that step, and its logits are held to 2e-2
    normwise (‖err‖ / ‖ref‖) and 5e-2 of the largest logit: a one-ulp bf16
    difference in a block's output is amplified where a row's logits
    nearly cancel (rwkv6's smoke model reaches 2.7e-2 of its largest logit
    in one step from the reference's own cache, and 0.17 when two
    trajectories of bf16 states run apart, so the free run is held only
    on its caches, to ``CACHE_TOL``; a MoE model's cache rows written by a
    free step that routed a token near a tie are left out, at most 2).  A
    ``BF16_AS_ACCURATE`` arch's fresh logits are held, over all steps, no
    farther from the reference's f32 step than the reference's bf16 step
    is."""
    worst, jcache, cache, near = _decode_both(arch, dtype)
    if dtype == "float32":
        assert worst["free"] <= TOL[dtype]
        near[:] = False
    elif arch in BF16_AS_ACCURATE:
        assert worst["fresh_f32"] <= worst["ref_f32"]
    else:
        assert worst["fresh_norm"] <= TOL[dtype]
        assert worst["fresh"] <= 5e-2
    assert near.sum() <= 2
    want = ref_leaves(jcache)
    got = dict(leaves_with_paths(cache))
    assert sorted(got) == sorted(want)
    for path, x in got.items():
        assert tuple(x.shape) == want[path].shape, path
        x, ref = x.float().numpy(), want[path]
        if near.any():          # (B, S) rows of a (layers?, B, S, ...) leaf
            bdim = next(i for i in range(x.ndim - 1)
                        if x.shape[i:i + 2] == near.shape)
            rows = (slice(None),) * bdim + (~near,)
            x, ref = x[rows], ref[rows]
        assert _rel(torch.from_numpy(x), ref) <= CACHE_TOL[dtype], path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-72b", "h2o-danube-3-4b"])
def test_int8_cache_decode_matches_the_reference(arch, dtype):
    """As above with ``quantized_cache``; after 32 steps the int8 stores
    are within one step of the reference's in f32.  In bf16 the values
    quantized are bf16 k/v that a free run has moved by up to
    ``CACHE_TOL``, so the dequantized cache is held to that instead."""
    worst, jcache, cache, _ = _decode_both(arch, dtype,
                                           quantized_cache=True)
    if dtype == "float32":
        assert worst["free"] <= TOL[dtype]
    else:
        assert worst["fresh_norm"] <= TOL[dtype]
        assert worst["fresh"] <= 5e-2
    ref = {jax_path(kp): v
           for kp, v in jax.tree_util.tree_leaves_with_path(jcache)}
    got = dict(leaves_with_paths(cache))
    assert sorted(got) == sorted(ref)
    for path, x in got.items():
        want = ref[path]
        if path.endswith("_scale"):
            assert x.dtype == torch.float32
            assert _rel(x, want) <= CACHE_TOL[dtype], path
            continue
        assert x.dtype == torch.int8 and want.dtype == np.int8
        if dtype == "float32":
            assert int(np.max(np.abs(x.numpy().astype(np.int32)
                                     - want.astype(np.int32)))) <= 1, path
        scale = path + "_scale"           # (layers, B, S) beside (.., H, D)
        assert _rel(x.float() * got[scale][..., None, None],
                    want.astype(np.float32) * ref[scale][..., None, None]
                    ) <= CACHE_TOL[dtype], path


@pytest.mark.parametrize("shape", [(2, 1, 2, 16), (3, 1, 8)])
def test_quant_write_and_dequant_are_the_reference_s_exactly(shape):
    """The same values in: the same int8 store and scale out, bit for bit,
    halves (x.5 after scaling) rounded to even in both."""
    rng = np.random.default_rng(3)
    v = rng.normal(size=shape).astype(np.float32)
    v.reshape(shape[0], -1)[:, 0] = 127.0          # scale 1.0 ...
    v.reshape(shape[0], -1)[:, 1:5] = [2.5, -3.5, 0.5, 126.5]  # ... halves
    seq = 6
    cq = np.zeros((shape[0], seq) + shape[2:], np.int8)
    cs = np.zeros((shape[0], seq), np.float32)
    jq, js = JL.quant_write(jnp.asarray(cq), jnp.asarray(cs), jnp.asarray(v),
                            (0, 3))
    tq, ts = torch.from_numpy(cq.copy()), torch.from_numpy(cs.copy())
    L.quant_write(tq, ts, torch.from_numpy(v), 3)
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert tq[:, 3].reshape(shape[0], -1)[0, 1:5].tolist() == [2, -4, 0, 126]
    tq2, ts2 = torch.from_numpy(cq.copy()), torch.from_numpy(cs.copy())
    L.quant_write(tq2, ts2, torch.from_numpy(v), torch.tensor(3))
    assert torch.equal(tq2, tq) and torch.equal(ts2, ts)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        assert np.array_equal(
            L.dequant(tq, ts, dtype).float().numpy(),
            np.asarray(JL.dequant(jq, js, jdtype), np.float32))


def test_int8_cache_decode_tracks_the_bf16_cache():
    """qwen2 in bf16, 32 steps: the int8 cache's logits against the bf16
    cache's, both in the port, within ``INT8_TOL`` normwise over all
    steps; the int8 cache's k/v take half the bytes plus a 4-byte scale
    per position, row and layer."""
    _, (pcfg, pparams) = _pair("qwen2-72b", "bfloat16")
    qcfg = dataclasses.replace(pcfg, quantized_cache=True)
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, pcfg.vocab_size, (2, 32))).long()
    caches = [T.init_cache(c, 2, 32, device="cpu") for c in (pcfg, qcfg)]
    steps = [T.make_serve_step(c) for c in (pcfg, qcfg)]
    logits = [[], []]
    for t in range(32):
        for i in (0, 1):
            out, caches[i] = steps[i](pparams, caches[i], toks[:, t:t + 1], t)
            logits[i].append(out.float())
    bf16, int8 = (torch.cat(x, dim=1) for x in logits)
    assert float((int8 - bf16).norm() / bf16.norm()) <= INT8_TOL
    assert not torch.equal(int8, bf16)
    nbytes = [sum(x.numel() * x.element_size()
                  for _, x in leaves_with_paths(c)) for c in caches]
    assert nbytes[1] == nbytes[0] // 2 + pcfg.n_layers * 2 * (2 * 32) * 4


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_step(arch):
    """tests/test_models_smoke.py::test_decode_step, on the port."""
    cfg = get_smoke_config(arch)
    params = T.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    cache = T.init_cache(cfg, 2, 32, device="cpu")
    before = [(p, tuple(x.shape), x.dtype) for p, x in leaves_with_paths(cache)]
    logits, cache2 = T.make_serve_step(cfg)(
        params, cache, torch.ones((2, 1), dtype=torch.long), 0)
    assert tuple(logits.shape) == (2, 1, cfg.vocab_size)
    assert not torch.isnan(logits.float()).any()
    assert [(p, tuple(x.shape), x.dtype)
            for p, x in leaves_with_paths(cache2)] == before


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_prefill(arch, use_kernels):
    """tests/test_models_smoke.py::test_decode_matches_prefill, on the
    port and on both prefill routes: 32 tokens one by one through the
    serve step reproduce the prefill logits (2e-3, the reference's gate).
    danube's cache is a ring of 16 rows, so the decode wraps it.  MoE
    capacity is raised to 16, as the reference's test raises it, so the
    32-token prefill drops no token a one-token decode step keeps."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              use_kernels=use_kernels)
    if cfg.moe is not None:     # no drops in the prefill, as the reference
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    t_len = 32
    params = T.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, t_len))).long()
    want = T.make_prefill_step(cfg)(params, {"tokens": toks})
    step = T.make_serve_step(cfg)
    cache = T.init_cache(cfg, 1, t_len, device="cpu")
    if cfg.sliding_window:
        assert cache[0][0]["k"].shape[2] == cfg.sliding_window < t_len
    outs = []
    for t in range(t_len):
        logits, cache = step(params, cache, toks[:, t:t + 1],
                             torch.tensor(t) if t % 2 else t)
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, dim=1).numpy(),
                               want.numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ["qwen2-72b", "h2o-danube-3-4b"])
def test_decode_at_or_past_max_seq_clamps_as_the_reference(arch):
    """``jax.lax.dynamic_update_slice`` moves a start past the end back
    inside, so a step at t ≥ max_seq overwrites the cache's last row; the
    port does the same (and for a ring, t % window is always inside)."""
    (cfg, params), (pcfg, pparams) = _pair(arch)
    max_seq = 8
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jstep = jax.jit(JT.make_serve_step(cfg))
    step = T.make_serve_step(pcfg)
    jcache = JT.init_cache(cfg, 2, max_seq)
    cache = T.init_cache(pcfg, 2, max_seq, device="cpu")
    for t in range(12):
        want, jcache = jstep(params, jcache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t))
        got, cache = step(pparams, cache,
                          torch.from_numpy(toks[:, t:t + 1]).long(), t)
        assert _rel(got, want) <= 1e-4
    for path, x in leaves_with_paths(cache):
        assert _rel(x, ref_leaves(jcache)[path]) <= 1e-3, path
    rows = cache[0][0]["k"]
    assert rows.shape[2] == min(max_seq, cfg.sliding_window or max_seq)
    assert L._cache_index(pcfg, 11, rows.shape[2]) == (
        11 % rows.shape[2] if cfg.sliding_window else max_seq - 1)
    assert int(L._cache_index(pcfg, torch.tensor(11), rows.shape[2])) == \
        L._cache_index(pcfg, 11, rows.shape[2])


def test_encoder_forward_and_shard_ctx():
    """hubert's encoder forward with the mask embedding, through
    ``NULL_CTX`` and a ``ShardCtx`` holding a mesh (which places nothing
    in one process), equals the reference's forward."""
    (cfg, params), (pcfg, pparams) = _pair("hubert-xlarge")
    jb, tb = _inputs(cfg, 2, 24, seed=11)
    want, _, _ = JT.forward(params, cfg, jb)
    for ctx in (T.NULL_CTX, T.ShardCtx(mesh=object())):
        got, cache, aux = T.forward(pparams, pcfg, tb, ctx)
        assert cache is None and float(aux) == 0.0
        assert _rel(got, want) <= 1e-4
    with pytest.raises(ValueError, match="encoder"):
        from repro_torch.launch.serve import serve
        serve(pparams, pcfg, [], lambda x: x, batch=1, gen_len=1, max_seq=4)
