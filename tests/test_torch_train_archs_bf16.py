"""One training step of every arch's smoke config in bf16, the port
against the JAX package, held to the tolerances stated in
tests/test_torch_train_archs.py (through ``tests/torch_train_step.py``).
"""
import pytest
import torch

from repro_torch.configs import ARCH_NAMES
from torch_train_step import check_train_step


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_step_matches_the_reference_in_bf16(arch, monkeypatch):
    check_train_step(arch, "bfloat16", monkeypatch)
