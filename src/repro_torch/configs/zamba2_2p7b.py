"""Zamba2-2.7B [arXiv:2411.15242; hf] — hybrid: a Mamba2 backbone plus one
weight-SHARED GQA transformer block applied after every 6 Mamba2 blocks.
Copy of ``repro/configs/zamba2_2p7b.py``.

54 Mamba2 blocks, d_model=2560, ssm_state=64; the shared attention block
has 32 heads (kv=32) of 80 and d_ff=10240, and one parameter set serves
its 9 applications (each with its own cache).  ``n_layers`` counts the
Mamba2 blocks; ``blocks()`` has 63 entries.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig


def _pattern(n_mamba: int, every: int):
    out = []
    for i in range(n_mamba):
        out.append("mamba2")
        if (i + 1) % every == 0:
            out.append("shared_attn")
    return tuple(out)


CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    block_pattern=_pattern(54, 6),
    shared_attn_every=6,
    ssm=SSMConfig(state_size=64, expand=2, head_dim=64, conv_width=4),
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-smoke", family="hybrid", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=160, vocab_size=512, head_dim=16,
        block_pattern=_pattern(4, 2), shared_attn_every=2,
        ssm=SSMConfig(state_size=16, expand=2, head_dim=16, conv_width=4),
        tie_embeddings=True, remat=False,
    )
