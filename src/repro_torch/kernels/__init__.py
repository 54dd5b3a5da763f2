"""Hand-written Hopper kernels (``csrc/``), their plain PyTorch versions
(``ref``), the nvcc build (``build``) and the checked wrappers (``ops``)."""
