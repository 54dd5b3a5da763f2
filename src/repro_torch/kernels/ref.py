"""Plain PyTorch versions of the port's kernels (the correctness ground truth).

``ops`` takes these only for tensors on the CPU; on the card the kernels
are held against them by ``chip_smoke.py``.
"""
from __future__ import annotations

import torch


def gram_ref(x: torch.Tensor, y: torch.Tensor):
    """X: (m, c), y: (m,) -> (XᵀX (c,c) f32, Xᵀy (c,) f32)."""
    x32 = x.to(torch.float32)
    return x32.T @ x32, x32.T @ y.to(torch.float32)
