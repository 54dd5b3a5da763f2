"""PyTorch/CUDA port of the asynchronous Newton method (``repro``).

Each module mirrors the JAX package's module of the same path; the JAX
package stays the reference the port is tested against.  Entry points
run on ``device="cuda"`` unless the caller asks for the CPU.

Numerics are pinned here, once, for every module of the port: f32
matrix products and convolutions stay full f32 on the card (no TF32),
as the reference's f32 products are, and bf16 matrix products reduce in
f32 (no reduced-precision split-K reductions), as XLA's bf16 dots
accumulate in f32.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
