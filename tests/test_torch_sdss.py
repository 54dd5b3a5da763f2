"""The port's SDSS stripes and fitness against the JAX package's.

``make_stripe`` is the same numpy code in both packages, so a seed must
give byte-identical stars, quadrature and truth.  The fitness is compared
on seeded random parameter rows in [LO, HI] at rtol 2e-5: each value is an
f32 mean over 20k stars (and two f32 quadrature means over 4096 points),
summed in a different order by XLA and by PyTorch, with elementwise
exp/log/pow that may differ by an ulp.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import sdss as jsdss
from repro_torch import convert
from repro_torch.data import sdss


@pytest.mark.parametrize("name,seed,n_stars", [
    ("stripe79", 79, 20_000), ("stripe86", 86, 20_000),
    ("stripe79", 79, 100_000),          # the Fig. 2 paper-scale catalog
])
def test_make_stripe_byte_identical(name, seed, n_stars):
    a = jsdss.make_stripe(name, n_stars=n_stars, seed=seed)
    b = sdss.make_stripe(name, n_stars=n_stars, seed=seed)
    for field in ("stars", "quad", "truth"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), field
    assert np.array_equal(jsdss.LO, sdss.LO)
    assert np.array_equal(jsdss.HI, sdss.HI)
    assert np.array_equal(jsdss.DEFAULT_STEP, sdss.DEFAULT_STEP)


def test_named_stripes_match():
    a, b = jsdss.stripe79(5_000), sdss.stripe79(5_000)
    assert a.stars.tobytes() == b.stars.tobytes()
    a, b = jsdss.stripe86(5_000), sdss.stripe86(5_000)
    assert a.stars.tobytes() == b.stars.tobytes()


@pytest.mark.parametrize("name,seed", [("stripe79", 79), ("stripe86", 86)])
def test_f_batch_matches(name, seed):
    stripe = sdss.make_stripe(name, n_stars=20_000, seed=seed)
    rng = np.random.default_rng(seed)
    ps = rng.uniform(sdss.LO, sdss.HI, (32, 8)).astype(np.float32)
    ps[0] = stripe.truth
    jf_batch, jf_single = jsdss.make_fitness(stripe)
    f_batch, f_single = sdss.make_fitness(stripe, device="cpu")
    want = np.asarray(jf_batch(jnp.asarray(ps)))
    got = f_batch(torch.from_numpy(ps))
    assert got.dtype == torch.float32 and got.shape == (32,)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)
    # numpy input, and the single-point form
    np.testing.assert_allclose(f_batch(ps).numpy(), want, rtol=2e-5)
    np.testing.assert_allclose(float(f_single(ps[0])),
                               float(jf_single(jnp.asarray(ps[0]))),
                               rtol=2e-5)


def test_reference_stripe_converts():
    """A reference Stripe's arrays become the port's tensors unchanged, and
    its fitness equals the one made from the port's own stripe."""
    ref_stripe = jsdss.make_stripe("stripe79", n_stars=3_000, seed=79)
    stars, quad = convert.stripe_tensors(ref_stripe, device="cpu")
    assert stars.dtype == quad.dtype == torch.float32
    assert np.array_equal(stars.numpy(), ref_stripe.stars)
    assert np.array_equal(quad.numpy(), ref_stripe.quad)
    f_ref, _ = sdss.make_fitness(ref_stripe, device="cpu")
    f_own, _ = sdss.make_fitness(
        sdss.make_stripe("stripe79", n_stars=3_000, seed=79), device="cpu")
    ps = np.random.default_rng(0).uniform(sdss.LO, sdss.HI, (4, 8))
    assert torch.equal(f_ref(ps), f_own(ps))
