"""One training step of every arch's smoke config, the port against the
JAX package (tests/test_models_smoke.py's ``test_forward_and_train_step``,
held to the reference's numbers), in f32; bf16 in
tests/test_torch_train_archs_bf16.py, both through
``tests/torch_train_step.py``.

The reference's parameters are carried across (``params_from_leaves``),
both packages take one seeded batch (tokens, or the audio stub's frames
and mask), and each takes one ``make_train_step`` with AdamW(lr=1e-3,
weight_decay=0.01), the launcher's decay.  Compared:

* the loss, ``ce`` and ``aux``: f32 within 1e-5 relative (``aux`` 1e-5
  of ``ce``); bf16 within 2e-2 relative (the port's LM gate);
* the gradient of every leaf: f32 within 1e-4 normwise, leaf by leaf.
  bf16 no farther, over the whole model normwise, from the reference's
  f32 gradient at the same (bf16-valued) weights than the reference's
  bf16 gradient is, times 1.25.  A MoE model whose bf16 routing has a
  token within ``ROUTE_MARGIN`` of a tie (a one-ulp difference flips the
  expert; tests/test_torch_serve_models.py's ``_NearTies``) is held
  within ``MOE_TIE_GRAD_TOL`` of that f32 gradient instead: one flipped
  choice moves deepseek-v2-lite's smoke gradient by 10 %;
* the new parameters.  AdamW's first step is g / (|g| + eps): an element
  whose gradient the two packages round to opposite signs moves by ±lr
  the other way.  So an element is left out where its reference gradient
  is not ten times its own error (|g_ref| ≤ 10·|g_port − g_ref|) or lies
  within 1e3·eps of zero after the clip; at least half of all elements
  are kept.  Kept elements agree within 1e-5 of the leaf's largest
  magnitude plus 1e-4·lr (f32), or within one bf16 ulp plus 1e-4·lr
  (bf16); every element within 2.2·lr plus one ulp.
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
def test_train_step_matches_the_reference(arch, monkeypatch):
    check_train_step(arch, "float32", monkeypatch)
