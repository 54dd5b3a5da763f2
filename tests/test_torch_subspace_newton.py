"""The port's subspace Newton and parallel line search against the JAX
package's (paper §III–§IV lifted to the LM: ``core/subspace_newton.py``,
``core/parallel_line_search.py`` and the flat-space half of
``core/subspace.py``).

First the reference's own tests (``tests/test_pod_adaptations.py:24-90``)
port against port, with draws from a ``torch.Generator``.  Then port
against reference, the reference's draws (basis, box, line; α and mask)
carried across through the seams ``subspace_newton_step_at`` and
``line_search_at``.

Tolerances:
* the anchored basis's row 0 and the zero anchor's e₁ are elementwise
  divisions by one norm: within 1e-6 of the reference's, sign included;
* ``lift``, ``lift_flat``, ``shift_flat`` and the commit
  ``unravel(flat0 + shift_flat(c))`` are sums of k products per element:
  within 1e-6 in f32, and within one bf16 step (2⁻⁷ relative) where a
  leaf is cast to bf16;
* a whole step on the f32 quadratic: the fit's f32 normal equations
  amplify rounding (``test_torch_regression.py`` holds g, H and d at
  1e-3); each package's f32 direction lies within 5e-3 of the f64 fit of
  the same samples (held below), so the two are held 1e-2 apart: the new
  parameters and the momentum within 1e-2 of the step's largest move,
  α exactly, ‖g‖ within 1e-3 relative, the loss before the step within
  1e-6 and the loss after it within 1e-4 (it moves with the direction);
* a step on the LM smoke configs: the m sample losses at the carried
  draws and the loss before the step within the forward's tolerance
  (1e-4 f32, 2e-2 bf16, as ``test_torch_lm_models.py``); with
  ``sample_scale = 0.02`` the fit sees loss differences of ~1e-3 over its
  box, so its direction is dominated by the losses' last bits in both
  packages: the step's outcome (the loss after it) is held within 2e-2
  relative, and never above the loss before it.  So the same test also
  replays the reference's own losses (samples, line, loss at θ) into the
  port's step: α and the outcome those losses call for exactly, ‖g‖ of
  the reference's fit of them within 1e-3, and the commit equal to the
  port's fit of them times α (momentum within 1e-6, parameters equal).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import regression as jreg
from repro.core import subspace as jsub
from repro.core import subspace_newton as jsn
from repro.core.parallel_line_search import LineSearchConfig as JLineConfig
from repro.core.parallel_line_search import \
    randomized_line_search as j_line_search
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.core import regression as preg
from repro_torch.core import subspace_newton as psn
from repro_torch.core.parallel_line_search import (LineSearchConfig,
                                                   line_search_at,
                                                   randomized_line_search)
from repro_torch.core.subspace import (SubspaceProjection, orthonormal_basis,
                                       ravel_tree, unravel_like)
from repro_torch.core.tree import leaves_with_paths
from repro_torch.models import transformer as T
from test_torch_lm_models import LOSS_TOL, _models

CPU = "cpu"
ARCHS = ("h2o-danube-3-4b", "rwkv6-7b")
LM_STEP_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def _quad_loss(target):
    """sum over leaves of ‖p − t‖² (the reference test's loss), in torch."""
    want = _leaves(target)

    def loss(params):
        return sum(torch.sum((p - t) ** 2)
                   for p, t in zip(_leaves(params), want))
    return loss


def _j_quad_loss(target):
    def loss(params):
        return sum(jnp.sum((p - t) ** 2) for p, t in
                   zip(jax.tree.leaves(params), jax.tree.leaves(target)))
    return loss


def _cfg(jcfg) -> psn.SubspaceNewtonConfig:
    return psn.SubspaceNewtonConfig(**dataclasses.asdict(jcfg))


# -- the reference's tests, port against port --------------------------------

def test_subspace_newton_descends_quadratic():
    gen = torch.Generator().manual_seed(0)
    target = {"w": torch.ones(20), "b": torch.full((5,), -2.0)}
    params = {"w": torch.zeros(20), "b": torch.zeros(5)}
    loss = _quad_loss(target)
    cfg = psn.SubspaceNewtonConfig(k=4, sample_scale=0.3, alpha_max=3.0,
                                   p_line=32)
    state = psn.init_state(params)
    l0 = float(loss(params))
    losses = []
    for _ in range(12):
        params, state, info = psn.subspace_newton_step(
            loss, params, state, cfg, gen, device=CPU)
        losses.append(float(loss(params)))
    # random k-dim subspace Newton on an n-dim quadratic: ~(1 - k/n) a step
    assert losses[-1] < 0.3 * l0, losses
    assert all(b <= a + 1e-5 for a, b in zip([l0] + losses, losses))
    assert int(state["step"]) == 12


def test_subspace_newton_tolerates_dropped_samples():
    """first-m-of-M semantics: 30% of sample evaluations never return."""
    gen = torch.Generator().manual_seed(1)
    target = {"w": torch.full((12,), 0.7)}
    params = {"w": torch.zeros(12)}
    loss = _quad_loss(target)
    cfg = psn.SubspaceNewtonConfig(k=3, sample_scale=0.3, alpha_max=3.0,
                                   p_line=16)
    state = psn.init_state(params)
    m = cfg.m_resolved()
    l0 = float(loss(params))
    for _ in range(12):
        mask = torch.rand(m, generator=gen) > 0.3
        params, state, _ = psn.subspace_newton_step(
            loss, params, state, cfg, gen, completed_mask=mask, device=CPU)
    assert float(loss(params)) < 0.35 * l0


def test_parallel_line_search_improves_over_fixed_step():
    gen = torch.Generator().manual_seed(2)
    params = {"w": torch.zeros(10)}
    loss = _quad_loss({"w": torch.ones(10)})
    # deliberately mis-scaled update (too small): the search stretches it
    update = {"w": torch.full((10,), 0.3)}
    new_params, alpha, best = randomized_line_search(
        loss, params, update, gen, LineSearchConfig(p=32, alpha_max=4.0),
        device=CPU)
    assert float(best) < float(loss({"w": params["w"] + update["w"]}))
    assert float(alpha) > 1.0
    assert torch.equal(new_params["w"], params["w"] + alpha * update["w"])


def test_line_search_respects_completed_mask():
    gen = torch.Generator().manual_seed(3)
    params = {"w": torch.zeros(4)}
    loss = _quad_loss({"w": torch.zeros(4)})          # any move is worse
    update = {"w": torch.ones(4)}
    mask = torch.zeros(8, dtype=torch.bool)
    mask[0] = True                                    # only α=1 returned
    _, alpha, _ = randomized_line_search(loss, params, update, gen,
                                         LineSearchConfig(p=8), mask,
                                         device=CPU)
    assert float(alpha) == 1.0


def test_m_resolved_is_twice_the_regression_columns():
    for k in (1, 3, 6, 8):
        cfg = psn.SubspaceNewtonConfig(k=k)
        assert cfg.m_resolved() == jsn.SubspaceNewtonConfig(k=k).m_resolved()
    assert psn.SubspaceNewtonConfig(k=6).m_resolved() == 56
    assert psn.SubspaceNewtonConfig(k=6, m=20).m_resolved() == 20


# -- the anchored basis --------------------------------------------------------

def test_zero_anchor_gives_e1_and_zeroes_coordinate_0():
    n, k = 40, 5
    basis = orthonormal_basis(n, k, torch.Generator().manual_seed(0), CPU,
                              anchor=torch.zeros(n))
    want = np.asarray(jsub.orthonormal_basis(jax.random.key(0), n, k,
                                             jnp.zeros(n)))
    e1 = torch.zeros(n)
    e1[0] = 1.0
    assert torch.equal(basis[0], e1)
    np.testing.assert_array_equal(np.abs(want[0]), e1.numpy())
    assert torch.equal(basis[1:, 0], torch.zeros(k - 1))
    np.testing.assert_array_equal(want[1:, 0], np.zeros(k - 1))
    assert float((basis @ basis.T - torch.eye(k)).abs().max()) < 1e-6


@pytest.mark.parametrize("anchor", ["positive a0", "negative a0", "a0 = 0"])
def test_anchor_row_carries_the_reference_s_sign(anchor):
    n, k = 64, 4
    a = np.random.default_rng(5).normal(size=n).astype(np.float32)
    if anchor == "positive a0":
        a[0] = abs(a[0])
    elif anchor == "negative a0":
        a[0] = -abs(a[0])
    else:
        a[0] = 0.0
    basis = orthonormal_basis(n, k, torch.Generator().manual_seed(1), CPU,
                              anchor=torch.from_numpy(a))
    want = np.asarray(jsub.orthonormal_basis(jax.random.key(1), n, k,
                                             jnp.asarray(a)))
    np.testing.assert_allclose(basis[0].numpy(), want[0], rtol=0, atol=1e-6)
    assert float((basis @ basis.T - torch.eye(k)).abs().max()) < 1e-6


def test_unanchored_basis_is_the_lm_chart_s():
    """No anchor: the same draws and the same bits as the LM backend's
    frozen chart has always made (normal rows, then Gram-Schmidt)."""
    gen = torch.Generator().manual_seed(4)
    basis = orthonormal_basis(100, 6, gen, CPU)
    rows = torch.randn((6, 100), generator=torch.Generator().manual_seed(4))
    from repro_torch.core.subspace import orthonormalize_
    assert torch.equal(basis, orthonormalize_(rows))


# -- the flat half of the chart --------------------------------------------------

def _tree_pair(dtype: str, seed: int = 0):
    """A reference pytree with mixed leaf types, and the port's copy."""
    rng = np.random.default_rng(seed)
    jt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = {"b": jnp.asarray(rng.normal(size=(3,)), jnp.float32),
           "layers": [{"w": jnp.asarray(rng.normal(size=(4, 5)), jt)},
                      {"w": jnp.asarray(rng.normal(size=(2, 3)), jt)}],
           "a": jnp.asarray(rng.normal(size=()), jnp.float32)}
    port = jax.tree.map(
        lambda x: _t(np.asarray(x, np.float32)).to(
            torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32),
        ref)
    return ref, port


def _assert_tree_close(got, want, f32_tol=1e-6):
    """Leaf by leaf: the same types, f32 within ``f32_tol``, bf16 within
    one bf16 step (2⁻⁷ relative) more."""
    for g, w in zip(_leaves(got), jax.tree.leaves(want)):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        bf16 = g.dtype == torch.bfloat16
        w = np.asarray(w, np.float32)
        g = g.float().numpy()
        tol = f32_tol + (2.0 ** -7 * np.abs(w) if bf16 else 0.0)
        assert np.all(np.abs(g - w) <= tol), np.abs(g - w).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ravel_unravel_flat0_lift_and_shift_match_the_reference(dtype):
    jparams, pparams = _tree_pair(dtype)
    flat = ravel_tree(pparams)
    jflat, junravel = jsub.ravel_pytree(jparams)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    back = unravel_like(pparams, flat)
    for g, w in zip(_leaves(back), _leaves(pparams)):
        assert g.dtype == w.dtype and torch.equal(g, w)
        assert g.data_ptr() != flat.data_ptr()        # a copy, not a view
    n, k = flat.numel(), 3
    jbasis = jsub.orthonormal_basis(jax.random.key(2), n, k,
                                    anchor=jnp.asarray(np.arange(n) - 4.0,
                                                       jnp.float32))
    jproj = jsub.SubspaceProjection(
        theta0=jparams, flat0=jflat, basis=jbasis,
        basis_tree=jsub.basis_to_tree(jbasis, jparams), unravel=junravel)
    proj = SubspaceProjection.from_basis(pparams, _t(jbasis))
    assert torch.equal(proj.flat0, flat)
    c = np.asarray([0.7, -1.3, 2.1], np.float32)
    np.testing.assert_allclose(proj.shift_flat(_t(c)).numpy(),
                               np.asarray(jproj.shift_flat(jnp.asarray(c))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(proj.lift_flat(_t(c)).numpy(),
                               np.asarray(jproj.lift_flat(jnp.asarray(c))),
                               rtol=0, atol=1e-6)
    _assert_tree_close(proj.lift(_t(c)), jproj.lift(jnp.asarray(c)))
    commit = proj.unravel(proj.flat0 + proj.shift_flat(_t(c)))
    _assert_tree_close(commit, jproj.unravel(
        jproj.flat0 + jproj.shift_flat(jnp.asarray(c))))


def test_lm_chart_commit_matches_the_reference():
    """The commit at an LM's leaf structure (bf16 leaves, JAX's order)."""
    (cfg, jparams, _), (_, pparams, _) = _models("h2o-danube-3-4b",
                                                 "bfloat16")
    jflat, junravel = jsub.ravel_pytree(jparams)
    jbasis = jsub.orthonormal_basis(jax.random.key(3), jflat.shape[0], 6,
                                    anchor=jnp.zeros_like(jflat))
    proj = SubspaceProjection.from_basis(pparams, _t(jbasis))
    c = jnp.asarray([0.3, -0.2, 0.1, 0.05, -0.4, 0.25], jnp.float32)
    want = junravel(jflat + c @ jbasis)
    got = proj.unravel(proj.flat0 + proj.shift_flat(_t(c)))
    _assert_tree_close(got, want)


# -- one step, port against reference ------------------------------------------

def _ref_draws(key, params, state, cfg):
    """The reference step's basis, box and line draws for ``key``."""
    k_basis, k_box, k_line = jax.random.split(key, 3)
    flat, _ = jsub.ravel_pytree(params)
    basis = jsn.make_basis(k_basis, flat, state["momentum"], cfg.k)
    coeffs = jax.random.uniform(k_box, (cfg.m_resolved(), cfg.k),
                                minval=-cfg.sample_scale,
                                maxval=cfg.sample_scale)
    alphas = jax.random.uniform(k_line, (cfg.p_line,), minval=0.0,
                                maxval=cfg.alpha_max)
    return _t(basis), _t(coeffs), _t(alphas)


def _assert_step_close(jout, pout, params):
    """New params and momentum within 1e-2 of the step's largest move, α
    equal, the loss before within 1e-6 and the loss after (which moves
    with the direction) within 1e-4 relative, ‖g‖ within 1e-3."""
    (jnew, jstate, jinfo), (pnew, pstate, pinfo) = jout, pout
    moves = [np.abs(np.asarray(n) - np.asarray(o)).max()
             for n, o in zip(jax.tree.leaves(jnew), jax.tree.leaves(params))]
    tol = 1e-2 * max(max(moves), 1e-6)
    for g, w in zip(_leaves(pnew), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol)
    np.testing.assert_allclose(pstate["momentum"].numpy(),
                               np.asarray(jstate["momentum"]), rtol=0,
                               atol=tol)
    assert int(pstate["step"]) == int(jstate["step"])
    assert float(pinfo["alpha"]) == float(jinfo["alpha"])
    np.testing.assert_allclose(float(pinfo["loss_before"]),
                               float(jinfo["loss_before"]), rtol=1e-6)
    np.testing.assert_allclose(float(pinfo["loss_after"]),
                               float(jinfo["loss_after"]), rtol=1e-4)
    np.testing.assert_allclose(float(pinfo["grad_norm"]),
                               float(jinfo["grad_norm"]), rtol=1e-3)
    assert set(pinfo) == set(jinfo)
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0
               for v in pinfo.values())


def _quad_problem():
    target = {"w": jnp.ones((20,)), "b": jnp.full((5,), -2.0)}
    params = {"w": jnp.zeros((20,)), "b": jnp.zeros((5,))}
    cfg = jsn.SubspaceNewtonConfig(k=4, sample_scale=0.3, alpha_max=3.0,
                                   p_line=32)
    return target, params, cfg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_each_f32_direction_is_near_the_f64_fit(seed):
    """The fit at the reference's draws and samples: both packages' f32
    directions within 5e-3 (of max |d|) of the f64 fit of the same
    samples, which bounds how far apart two f32 steps may land."""
    target, params, cfg = _quad_problem()
    key = jax.random.key(seed)
    k_basis, k_box, _ = jax.random.split(key, 3)
    proj = jsub.SubspaceProjection.create(
        params, cfg.k, k_basis, anchor=jsn.init_state(params)["momentum"])
    coeffs = jax.random.uniform(k_box, (cfg.m_resolved(), cfg.k),
                                minval=-cfg.sample_scale,
                                maxval=cfg.sample_scale)
    ys = jax.lax.map(lambda c: _j_quad_loss(target)(proj.lift(c)), coeffs)
    _, g, H = jreg.fit_quadratic(coeffs, ys, None, cfg.ridge)
    d_ref = np.asarray(jreg.newton_direction(g, H, cfg.damping))
    dirs = {}
    for dtype in (torch.float32, torch.float64):
        _, g, H = preg.fit_quadratic(_t(coeffs).to(dtype), _t(ys).to(dtype),
                                     None, cfg.ridge)
        dirs[dtype] = preg.newton_direction(g, H, cfg.damping).numpy()
    d64 = dirs[torch.float64]
    for d in (d_ref, dirs[torch.float32]):
        assert np.abs(d - d64).max() <= 5e-3 * np.abs(d64).max()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_from_the_reference_s_draws_matches_it(seed):
    target, params, cfg = _quad_problem()
    state = jsn.init_state(params)
    key = jax.random.key(seed)
    jout = jsn.subspace_newton_step(_j_quad_loss(target), params, state, cfg,
                                    key)
    pparams = jax.tree.map(_t, params)
    pout = psn.subspace_newton_step_at(
        _quad_loss(jax.tree.map(_t, target)), pparams, psn.init_state(pparams),
        _cfg(cfg), *_ref_draws(key, params, state, cfg))
    _assert_step_close(jout, pout, params)


def test_reference_state_carried_in_continues_to_its_next_step():
    target, params, cfg = _quad_problem()
    jloss = _j_quad_loss(target)
    state = jsn.init_state(params)
    params, state, _ = jsn.subspace_newton_step(jloss, params, state, cfg,
                                                jax.random.key(10))
    carried = convert.subspace_state_from_reference(
        jax.tree.map(np.asarray, state), device=CPU)
    assert carried["momentum"].dtype == torch.float32
    assert int(carried["step"]) == 1
    np.testing.assert_array_equal(carried["momentum"].numpy(),
                                  np.asarray(state["momentum"]))
    key = jax.random.key(11)
    draws = _ref_draws(key, params, state, cfg)
    # the port's own basis from the carried momentum starts where the
    # reference's does, sign included
    own = orthonormal_basis(draws[0].shape[1], cfg.k,
                            torch.Generator().manual_seed(0), CPU,
                            anchor=carried["momentum"])
    np.testing.assert_allclose(own[0].numpy(), draws[0][0].numpy(), rtol=0,
                               atol=1e-6)
    jout = jsn.subspace_newton_step(jloss, params, state, cfg, key)
    pparams = jax.tree.map(_t, params)
    pout = psn.subspace_newton_step_at(
        _quad_loss(jax.tree.map(_t, target)), pparams, carried, _cfg(cfg),
        *draws)
    _assert_step_close(jout, pout, params)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_step_from_the_reference_s_draws_matches_it(arch, dtype):
    (cfg, jparams, jbatch), (pcfg, pparams, tbatch) = _models(arch, dtype)
    scfg = jsn.SubspaceNewtonConfig(k=6, sample_scale=0.02)
    jloss_fn, ploss_fn = JT.make_loss_fn(cfg), T.make_loss_fn(pcfg)
    state = jsn.init_state(jparams)
    key = jax.random.key(7)
    jnew, jstate, jinfo = jax.jit(lambda p, s, k: jsn.subspace_newton_step(
        lambda q: jloss_fn(q, jbatch)[0], p, s, scfg, k))(jparams, state, key)
    basis, coeffs, alphas = _ref_draws(key, jparams, state, scfg)
    # the reference's m sample losses at its draws (its step's own lax.map)
    jproj = jsub.SubspaceProjection.create(
        jparams, scfg.k, jax.random.split(key, 3)[0],
        anchor=state["momentum"])
    jys = np.asarray(jax.jit(lambda c: jax.lax.map(
        lambda ci: jloss_fn(jproj.lift(ci), jbatch)[0], c))(
            jnp.asarray(coeffs.numpy())))
    seen = []

    def ploss(params):
        out = ploss_fn(params, tbatch)[0]
        seen.append(float(out))
        return out

    m = scfg.m_resolved()
    pnew, pstate, pinfo = psn.subspace_newton_step_at(
        ploss, pparams, psn.init_state(pparams), _cfg(scfg), basis, coeffs,
        alphas)
    assert len(seen) == m + scfg.p_line + 1
    tol = LOSS_TOL[dtype]
    np.testing.assert_allclose(np.asarray(seen[:m]), jys, rtol=tol)
    np.testing.assert_allclose(float(pinfo["loss_before"]),
                               float(jinfo["loss_before"]), rtol=tol)
    assert float(pinfo["loss_after"]) <= float(pinfo["loss_before"])
    assert float(jinfo["loss_after"]) <= float(jinfo["loss_before"])
    np.testing.assert_allclose(float(pinfo["loss_after"]),
                               float(jinfo["loss_after"]), rtol=LM_STEP_TOL)
    # what was committed is what the momentum says moved (the first step)
    moved = ravel_tree(pnew) - ravel_tree(pparams)
    step_tol = 2.0 ** -7 if dtype == "bfloat16" else 1e-6
    scale = ravel_tree(pparams).abs() + pstate["momentum"].abs()
    assert bool(torch.all((moved - pstate["momentum"]).abs()
                          <= step_tol * scale + 1e-6))
    for g, w in zip(_leaves(pnew), _leaves(pparams)):
        assert g.dtype == w.dtype and g.shape == w.shape
    # the step's logic on the reference's losses: its m sample losses, its
    # line losses along its direction from those samples and its loss at θ,
    # replayed into the port's step, give the α and outcome that those
    # losses call for (the first minimum, taken only if it improves) and
    # the reference's ‖g‖ of those samples; the port commits α times its
    # own fit of them.  The two directions are not held to each other: H is
    # near-singular at these losses, and two f32 fits of one sample set
    # (JAX's jitted and eager among them) differ by up to a third of
    # max |d| (rwkv6, f32)
    _, jg, jH = jax.jit(lambda c, y: jreg.fit_quadratic(
        c, y, None, scfg.ridge))(jnp.asarray(coeffs.numpy()), jnp.asarray(jys))
    jd = jreg.newton_direction(jg, jH, scfg.damping)
    jline = np.asarray(jax.jit(lambda a: jax.lax.map(
        lambda ai: jloss_fn(jproj.lift(ai * jd), jbatch)[0], a))(
            jnp.asarray(alphas.numpy())))
    f0 = float(jinfo["loss_before"])
    best = int(np.argmin(jline))
    want_alpha = float(alphas[best]) if jline[best] < f0 else 0.0
    replay = iter(list(jys) + list(jline) + [f0])
    rnew, rstate, rinfo = psn.subspace_newton_step_at(
        lambda _: torch.tensor(next(replay), dtype=torch.float32), pparams,
        psn.init_state(pparams), _cfg(scfg), basis, coeffs, alphas)
    assert next(replay, None) is None
    assert float(rinfo["alpha"]) == want_alpha
    assert float(rinfo["loss_before"]) == f0
    assert float(rinfo["loss_after"]) == min(float(jline[best]), f0)
    np.testing.assert_allclose(float(rinfo["grad_norm"]),
                               float(jnp.linalg.norm(jg)), rtol=1e-3)
    _, pg, pH = preg.fit_quadratic(coeffs, torch.from_numpy(jys), None,
                                   scfg.ridge)
    proj = SubspaceProjection.from_basis(pparams, basis)
    shift = proj.shift_flat(want_alpha * preg.newton_direction(
        pg, pH, scfg.damping))
    np.testing.assert_allclose(rstate["momentum"].numpy(), shift.numpy(),
                               rtol=0, atol=1e-6)
    for g, w in zip(_leaves(rnew), _leaves(proj.unravel(proj.flat0 + shift))):
        assert torch.equal(g, w)


def test_line_search_from_the_reference_s_alphas_and_mask():
    rng = np.random.default_rng(8)
    jparams = {"w": jnp.asarray(rng.normal(size=(6,)), jnp.float32),
               "v": jnp.asarray(rng.normal(size=(2, 3)), jnp.bfloat16)}
    jtarget = jax.tree.map(lambda x: jnp.ones_like(x, jnp.float32), jparams)
    jupdate = jax.tree.map(lambda x: jnp.full(x.shape, 0.2, jnp.float32),
                           jparams)
    cfg = JLineConfig(p=8, alpha_max=4.0)
    key = jax.random.key(9)
    mask = jnp.asarray([True, False, True, True, False, True, True, False])
    jbest, jalpha, jloss = j_line_search(_j_quad_loss(jtarget), jparams,
                                         jupdate, key, cfg, mask)
    r = jax.random.uniform(key, (cfg.p,))
    alphas = (cfg.alpha_min + r * (cfg.alpha_max - cfg.alpha_min)).at[0].set(
        1.0)
    to_port = lambda x: _t(np.asarray(x, np.float32)).to(      # noqa: E731
        torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32)
    pparams = jax.tree.map(to_port, jparams)
    pbest, palpha, ploss = line_search_at(
        _quad_loss(jax.tree.map(to_port, jtarget)), pparams,
        jax.tree.map(to_port, jupdate), _t(alphas), _t(mask))
    assert float(palpha) == float(jalpha)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-6)
    _assert_tree_close(pbest, jbest)
    # the random entry point keeps α₀ = 1 and draws inside [min, max)
    got = []
    randomized_line_search(lambda p: got.append(float(p["w"][0])) or
                           torch.zeros(()), {"w": torch.zeros(1)},
                           {"w": torch.ones(1)}, torch.Generator(),
                           LineSearchConfig(p=16), device=CPU)
    assert got[0] == 1.0 and all(0.25 <= a < 2.0 for a in got[1:16])


def test_line_search_ties_go_to_the_first_minimum():
    params = {"w": torch.zeros(2)}
    _, alpha, _ = line_search_at(lambda p: torch.zeros(()), params,
                                 {"w": torch.ones(2)},
                                 torch.tensor([1.0, 0.5, 0.7]))
    assert float(alpha) == 1.0


def test_steps_refuse_params_off_their_device():
    params = {"w": torch.zeros(3)}
    with pytest.raises(RuntimeError, match="lies on cpu"):
        psn.subspace_newton_step(_quad_loss(params), params,
                                 psn.init_state(params),
                                 psn.SubspaceNewtonConfig(k=2),
                                 torch.Generator())
    with pytest.raises(RuntimeError, match="lies on cpu"):
        randomized_line_search(_quad_loss(params), params, params,
                               torch.Generator())
