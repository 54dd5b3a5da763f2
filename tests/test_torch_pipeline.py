"""The port's synthetic data pipeline against the JAX package's.

A batch is numpy in both packages and a pure function of (seed, step,
host): the port's must be the reference's bit for bit, type included,
for every (seed, step, n_hosts, host_id) drawn here; hosts' slices are
disjoint and labels are the next tokens.  The launcher's device copy
keeps the values.
"""
import numpy as np
import pytest
import torch

from repro.data import pipeline as JP
from repro_torch.data import pipeline as P
from repro_torch.launch.train import PRESETS, batch_to

CASES = [(0, 0, 1, 0), (3, 5, 1, 0), (11, 117, 2, 1), (5, 3, 4, 2),
         (7, 1_000, 4, 3)]


def _same(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert a[name].shape == b[name].shape, name
        assert np.array_equal(a[name], b[name]), name


@pytest.mark.parametrize("seed,step,n_hosts,host_id", CASES)
def test_synthetic_lm_is_the_reference_s_bit_for_bit(seed, step, n_hosts,
                                                    host_id):
    kw = dict(vocab_size=1000, seq_len=64, global_batch=8, seed=seed,
              n_hosts=n_hosts, host_id=host_id)
    want = JP.SyntheticLM(JP.DataConfig(**kw)).batch(step)
    got = P.SyntheticLM(P.DataConfig(**kw)).batch(step)
    _same(got, want)
    assert got["tokens"].shape == (8 // n_hosts, 64)
    np.testing.assert_array_equal(got["tokens"][:, 1:],
                                  got["labels"][:, :-1])


@pytest.mark.parametrize("seed,step,n_hosts,host_id", CASES)
def test_synthetic_masked_is_the_reference_s_bit_for_bit(seed, step,
                                                        n_hosts, host_id):
    kw = dict(vocab_size=50, seq_len=16, global_batch=4, seed=seed,
              n_hosts=n_hosts, host_id=host_id)
    want = JP.SyntheticMasked(JP.DataConfig(**kw), d_model=24).batch(step)
    got = P.SyntheticMasked(P.DataConfig(**kw), d_model=24).batch(step)
    _same(got, want)
    assert got["mask"].dtype == bool


def test_host_slices_are_disjoint_and_pure():
    kw = dict(vocab_size=1000, seq_len=32, global_batch=8, seed=5,
              n_hosts=4)
    hosts = [P.SyntheticLM(P.DataConfig(host_id=h, **kw)) for h in range(4)]
    for step in (0, 3):
        rows = [tuple(r) for h in hosts for r in h.batch(step)["tokens"]]
        assert len(set(rows)) == len(rows) == 8
    again = P.SyntheticLM(P.DataConfig(host_id=2, **kw))
    _same(again.batch(3), hosts[2].batch(3))
    # the iterator walks steps 0, 1, ... from the same pure function
    it = iter(again)
    _same(next(it), hosts[2].batch(0))
    _same(next(it), hosts[2].batch(1))


def test_the_launcher_s_device_copy_keeps_the_values():
    cfg = PRESETS["tiny"]
    data = P.SyntheticLM(P.DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                      global_batch=2, seed=0))
    host = data.batch(4)
    dev = batch_to(host, cfg, "cpu")
    assert dev["tokens"].dtype == torch.long
    np.testing.assert_array_equal(dev["tokens"].numpy(), host["tokens"])
    np.testing.assert_array_equal(dev["labels"].numpy(), host["labels"])
