"""The port's fixed-order row mean (``kernels/ops.py::row_mean``) on the CPU.

``csrc/row_mean.cu`` runs only on the card; ``ref.row_mean_ref`` repeats
its order of summation in torch, and ``ops.row_mean`` takes it for CPU
tensors.  These tests check that:

- a row's mean is the same bits whatever the width k of the batch it is
  in (1 to 512) and wherever it sits there: the contract the SDSS
  fitness, and with it coalesced == solo, restored == uninterrupted and
  warm cache == cold, rests on;
- it is within 1e-6 of the float64 mean, relative to the mean of |x|
  (its sums are f64, so the result is the f64 mean rounded once);
- the kernel's constant matches the plain version's, and the wrapper
  refuses what the kernel does not take, on both routes;
- the SDSS fitness through it is width-invariant on the CPU too, and
  within 1e-5 of the reference's ``f_batch`` (jnp.mean under vmap).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import sdss as j_sdss
from repro_torch.data import sdss
from repro_torch.kernels import build, ops, ref

WIDTHS = (1, 2, 3, 7, 8, 16, 63, 64, 255, 256, 511, 512)


def _rows(k, n, seed, kind="normal"):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        x = rng.normal(size=(k, n))
    else:
        x = rng.uniform(0.0, 3.0, size=(k, n)) ** 4      # skewed, positive
    return torch.from_numpy(x.astype(np.float32))


def test_constant_matches_the_kernel_source():
    src = (build.CSRC / "row_mean.cu").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))
    assert threads == ref.ROW_MEAN_THREADS


@pytest.mark.parametrize("n", [1, 3, 1000, 1024, 4096, 4099])
def test_row_mean_ref_is_width_and_position_invariant(n):
    x = _rows(512, n, seed=n)
    full = ref.row_mean_ref(x)
    for k in WIDTHS:
        for start in {0, (512 - k) // 2, 512 - k}:
            part = ref.row_mean_ref(x[start:start + k].contiguous())
            assert torch.equal(part, full[start:start + k]), (n, k, start)
    # a row placed among other rows, alone, or repeated: the same bits
    row = x[100:101]
    mixed = torch.cat([x[:7], row, _rows(8, n, seed=1)]).contiguous()
    assert torch.equal(ref.row_mean_ref(mixed)[7:8], full[100:101])
    assert torch.equal(ref.row_mean_ref(row.repeat(5, 1)),
                       full[100:101].repeat(5))


@pytest.mark.parametrize("kind", ["normal", "skewed"])
@pytest.mark.parametrize("k,n", [(1, 100_000), (8, 99_999), (64, 4096),
                                 (512, 1000)])
def test_row_mean_ref_is_within_1e6_of_the_f64_mean(k, n, kind):
    x = _rows(k, n, seed=k + n, kind=kind)
    got = ref.row_mean_ref(x).double()
    want = x.double().mean(dim=1)
    scale = x.double().abs().mean(dim=1)
    assert torch.all((got - want).abs() <= 1e-6 * scale)


def test_cpu_route_is_the_plain_version():
    x = _rows(33, 5000, seed=4)
    assert torch.equal(ops.row_mean(x), ref.row_mean_ref(x))
    assert ops.row_mean(x[:0]).shape == (0,)


@pytest.mark.parametrize("bad", [
    torch.zeros(4), torch.zeros(2, 3, 4), torch.zeros(4, 8).double(),
    torch.zeros(8, 4).T, torch.zeros(4, 0)])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        ops.row_mean(bad)


def test_sdss_fitness_is_width_invariant_and_tracks_the_reference():
    stripe = sdss.make_stripe("t", 3000, n_quad=512, seed=79)
    f_batch, _ = sdss.make_fitness(stripe, device="cpu")
    rng = np.random.default_rng(9)
    pts = rng.uniform(sdss.LO, sdss.HI, (256, 8)).astype(np.float32)
    full = f_batch(pts)
    for k in (1, 8, 16, 64):
        for start in (0, 100, 256 - k):
            assert torch.equal(f_batch(pts[start:start + k]),
                               full[start:start + k]), (k, start)
    j_stripe = j_sdss.make_stripe("t", 3000, n_quad=512, seed=79)
    want = np.asarray(j_sdss.make_fitness(j_stripe)[0](jnp.asarray(pts)))
    np.testing.assert_allclose(full.numpy(), want, rtol=1e-5)
