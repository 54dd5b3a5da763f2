"""Gradient compression with error feedback.

Port of ``repro/optim/compression.py``: int8 quantization with one scale
per tensor (max|x| / 127, round half to even as ``jnp.round``), and a
local error-feedback accumulator per parameter that carries each step's
quantization residual into the next step, so the bias is corrected over
steps (Seide et al. / EF-SGD style).  Composes with any optimizer: wrap
its gradients before ``update``.

Where the data axis reaches training (``launch/train.py --ranks``, a
step over ``models/sharding.py::RankSum``), the gradient is first summed
over the ranks in its own type (``ShardCtx.sum_grads``); each rank then
compresses the sum in the same way, so the error state is the same on
every rank.  That is what the reference's code computes: its step is
written in JAX's global view, where the quantizer reads the summed
gradient's max.  The reference's docstring says instead that the
quantize/dequantize pair sits around the all-reduce, which then moves
int8 (ROADMAP C notes the difference); no all-reduce of either package
moves int8.  In one process ``compress_grads`` puts the gradients
through the int8 round trip and carries the residual, and what the
optimizer sees is what the reference's optimizer sees.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core.tree import map_tree


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale 0-d f32): q = clip(round(x / scale), ±127)."""
    x32 = x.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_state(params: Any) -> Any:
    """Zero f32 residuals shaped like ``params``, on their devices."""
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_grads(grads: Any, error_state: Any) -> Tuple[Any, Any]:
    """Returns (compressed-then-decompressed grads, new_error_state).

    The returned grads (each in its gradient's type) are what the
    optimizer consumes; the quantization residual is carried to the next
    step (error feedback).  Neither input is changed."""
    def one(g, e):
        corrected = g.to(torch.float32) + e
        q, s = quantize_int8(corrected)
        deq = dequantize_int8(q, s)
        return deq.to(g.dtype), corrected - deq

    with torch.no_grad():
        pairs = map_tree(one, grads, error_state)
    return (map_tree(lambda _, pair: pair[0], grads, pairs),
            map_tree(lambda _, pair: pair[1], grads, pairs))
