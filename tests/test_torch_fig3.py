"""The port's Fig. 3 launcher (``launch/fig3.py``) against the JAX
package's ``benchmarks/fig3_linesearch.py``: the seeds the launchers
carry, the landscape, and each of the 24 trials.

Tolerances: the landscape is elementwise f32 in both packages, within
1e-6; a trial draws the same samples in both (the engine's numpy rng from
the same seed), so its best fitness agrees within 1e-5 and its escape
exactly.  Best α is held within 1e-4 relative: the uniform draws are the
same, but the line's α range is clipped along the fitted direction, an
f32 fit in each package (~1e-5 relative apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import fig3_linesearch
from repro.core.anm import AnmConfig as JAnmConfig
from repro.core.anm import anm_minimize as j_anm_minimize
from repro_torch.core.anm import anm_minimize
from repro_torch.launch import baselines, fig3

CPU = "cpu"


def _jax_seed(i: int) -> int:
    """The engine seed ``repro/core/anm.py:56`` derives from key(i)."""
    return int(jax.random.randint(jax.random.key(i), (), 0, 2**31 - 1))


def test_trial_seeds_are_the_ints_jax_derives():
    assert fig3.ENGINE_SEEDS == tuple(_jax_seed(t) for t in range(24))
    assert fig3.TRIALS == 24


def test_baselines_seed_is_the_int_jax_derives():
    assert baselines.ENGINE_SEED == _jax_seed(baselines.DATA_SEED)
    assert baselines.START_SEED == 41 * 7


def test_landscape_matches_the_reference():
    xs = np.random.default_rng(0).uniform(-4, 4, (4096, 2)).astype(np.float32)
    xs[:3] = [[0.15, 0.0], [0.9, 0.0], [1.7, 0.0]]          # the basins
    got = fig3.multimodal_f(torch.from_numpy(xs)).numpy()
    want = np.asarray(fig3_linesearch.multimodal_f(jnp.asarray(xs)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_landscape_value_does_not_depend_on_the_batch():
    xs = torch.from_numpy(np.random.default_rng(1).uniform(
        -4, 4, (300, 2)).astype(np.float32))
    whole = fig3.multimodal_f(xs)
    for i in (0, 17, 299):
        assert torch.equal(fig3.multimodal_f(xs[i:i + 1]), whole[i:i + 1])


def test_config_is_the_reference_s():
    assert (fig3.CONFIG.m_regression, fig3.CONFIG.m_line_search,
            fig3.CONFIG.max_iterations, fig3.CONFIG.alpha_max) == (
        48, 256, 1, 30.0)


@pytest.fixture(scope="module")
def reference_f():
    return jax.jit(fig3_linesearch.multimodal_f)


@pytest.mark.parametrize("trial", range(24))
def test_trial_matches_the_reference(trial, reference_f):
    args = (np.zeros(2), -np.ones(2) * 4, np.ones(2) * 4,
            np.array([0.05, 0.05]))
    want = j_anm_minimize(reference_f, *args,
                          cfg=JAnmConfig(m_regression=48, m_line_search=256,
                                         max_iterations=1, alpha_max=30.0),
                          key=jax.random.key(trial)).history[0]
    got = anm_minimize(fig3.multimodal_f, *args, fig3.CONFIG,
                       seed=fig3.ENGINE_SEEDS[trial], device=CPU).history[0]
    np.testing.assert_allclose(got.best_fitness, want.best_fitness,
                               rtol=0, atol=1e-5)
    assert (got.best_fitness < fig3.ESCAPE_BELOW) == (
        want.best_fitness < fig3.ESCAPE_BELOW)
    np.testing.assert_allclose(got.best_alpha, want.best_alpha, rtol=1e-4)


def test_cpu_escape_count_is_the_reference_s():
    out = fig3.run(device=CPU)
    assert out["trials"] == 24 and len(out["samples"]) == 24
    assert out["escapes"] == 24          # the reference's 24 of 24
    assert out["escape_rate"] == 1.0
    assert all(s["best_fitness"] < fig3.ESCAPE_BELOW for s in out["samples"])
