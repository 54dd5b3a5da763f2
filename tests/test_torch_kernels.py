"""The port's gram wrapper and plain version against the JAX package's.

Inputs come from a seeded numpy draw and go to both packages; the JAX
kernel runs in interpret mode on the CPU, as tests/test_kernels.py runs
it.  On the CPU the port's ``ops.gram`` takes its plain version, so these
tests pin the function the CUDA kernel is held to on the card
(chip_smoke.py does that comparison there).

Tolerance: rtol 1e-5 and atol 1e-5·max|G| (f32).  Both sides sum the same
f32 products (bf16 inputs are widened to the same f32 values first); only
the order of the sums differs, which moves an entry by a few ulps of the
largest partial sum.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

SHAPES = [(256, 45), (1024, 153), (300, 20), (512, 128)]


def _inputs(m, c, dtype):
    rng = np.random.default_rng(m + c)
    x = rng.normal(size=(m, c)).astype(np.float32)
    y = rng.normal(size=m).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jx, jy = jnp.asarray(x).astype(jdt), jnp.asarray(y).astype(jdt)
    tx, ty = torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt)
    # both frameworks round f32 -> bf16 to nearest even: the same values
    assert np.array_equal(np.asarray(jx.astype(jnp.float32)),
                          tx.to(torch.float32).numpy())
    return (jx, jy), (tx, ty)


def _close(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("m,c", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gram_matches_jax_kernel_and_ref(m, c, dtype):
    (jx, jy), (tx, ty) = _inputs(m, c, dtype)
    g_kernel, r_kernel = jops.gram(jx, jy)          # Pallas, interpret mode
    g_jref, r_jref = jref.gram_ref(jx, jy)
    for fn in (ops.gram, ref.gram_ref):
        g, r = fn(tx, ty)
        assert g.dtype == r.dtype == torch.float32
        assert g.shape == (c, c) and r.shape == (c,)
        for want_g, want_r in ((g_kernel, r_kernel), (g_jref, r_jref)):
            _close(g.numpy(), want_g)
            _close(r.numpy(), want_r)
    g, _ = ops.gram(tx, ty)
    assert torch.equal(g, g.T)                      # exactly symmetric


def test_gram_cpu_route_counts_no_launch():
    """The plain version is not a kernel launch: the count stays put."""
    before = ops.gram_launches
    ops.gram(torch.ones(8, 3), torch.ones(8))
    assert ops.gram_launches == before


@pytest.mark.parametrize("x,y,err", [
    (torch.ones(8, 3, dtype=torch.float64), torch.ones(8, dtype=torch.float64),
     TypeError),
    (torch.ones(8, 3), torch.ones(8, dtype=torch.bfloat16), TypeError),
    (torch.ones(8, 3), torch.ones(7), ValueError),
    (torch.ones(8, 3, 1), torch.ones(8), ValueError),
    (torch.ones(3, 8).T, torch.ones(8), ValueError),          # not contiguous
    (torch.ones(8, 3, device="meta"), torch.ones(8, device="meta"),
     ValueError),                                             # no such route
])
def test_gram_wrapper_rejects(x, y, err):
    with pytest.raises(err):
        ops.gram(x, y)
