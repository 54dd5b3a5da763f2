"""Checked wrappers around the port's CUDA kernels.

A wrapper takes its kernel's plain version (``kernels/ref.py``) only for
tensors on the CPU.  For a CUDA tensor it launches the kernel or raises:
nothing falls back.  Each wrapper counts its launches in a plain integer
(``gram_launches``), so a run can show that its path went through the
kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

#: rows of X one CTA of pass 1 stages in shared memory (csrc/gram.cu)
GRAM_ROWS_PER_CTA = 64
#: widest X the kernel takes (kMaxCols in csrc/gram.cu)
GRAM_MAX_COLS = 256

#: launches of the gram kernel since the process started (or the caller
#: last reset it)
gram_launches = 0

_GRAM_DTYPES = {torch.float32: "gram_f32", torch.bfloat16: "gram_bf16"}
_GRAM_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _gram_fn(dtype: torch.dtype):
    fn = getattr(build.load("gram"), _GRAM_DTYPES[dtype])
    fn.argtypes = _GRAM_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def gram(x: torch.Tensor, y: torch.Tensor):
    """x: (m, c); y: (m,) -> (XᵀX (c,c), Xᵀy (c,)) in f32.

    x and y are f32 or bf16 (the same type), contiguous, on one device.
    CPU tensors take ``ref.gram_ref``; CUDA tensors take the kernel in
    ``csrc/gram.cu`` (c ≤ 256) on the current stream.
    """
    if x.dim() != 2 or y.dim() != 1 or y.shape[0] != x.shape[0]:
        raise ValueError(f"gram wants x (m, c) and y (m,), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype not in _GRAM_DTYPES or y.dtype != x.dtype:
        raise TypeError(f"gram takes f32 or bf16 x and y of one type, got "
                        f"{x.dtype} and {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"x on {x.device}, y on {y.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("gram wants contiguous x and y")
    if x.device.type == "cpu":
        return ref.gram_ref(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"gram runs on the CPU or a CUDA device, not "
                         f"{x.device}")
    m, c = x.shape
    if m < 1 or c < 1 or c > GRAM_MAX_COLS:
        raise ValueError(f"the gram kernel takes 1 ≤ c ≤ {GRAM_MAX_COLS} "
                         f"and m ≥ 1, got x {tuple(x.shape)}")
    fn = _gram_fn(x.dtype)
    n_cta = -(-m // GRAM_ROWS_PER_CTA)
    width = c * (c + 1) // 2 + c
    with torch.cuda.device(x.device):
        partial = torch.empty(n_cta * width, dtype=torch.float32,
                              device=x.device)
        g = torch.empty((c, c), dtype=torch.float32, device=x.device)
        r = torch.empty(c, dtype=torch.float32, device=x.device)
        err = fn(x.data_ptr(), y.data_ptr(), m, c, GRAM_ROWS_PER_CTA,
                 partial.data_ptr(), g.data_ptr(), r.data_ptr(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gram kernel launch failed with CUDA error {err} "
                           f"at x {tuple(x.shape)} {x.dtype}")
    global gram_launches
    gram_launches += 1
    return g, r
