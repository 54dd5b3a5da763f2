"""PyTorch/CUDA port of the asynchronous Newton method (``repro``).

Each module mirrors the JAX package's module of the same path; the JAX
package stays the reference the port is tested against.  Entry points
run on ``device="cuda"`` unless the caller asks for the CPU.

Numerics are pinned here, once, for every module of the port: f32
matrix products and convolutions stay full f32 on the card (no TF32),
as the reference's f32 products are.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
