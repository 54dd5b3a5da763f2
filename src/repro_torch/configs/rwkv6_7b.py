"""RWKV6-7B "Finch" [arXiv:2404.05892; hf] — attention-free RNN with
data-dependent decay.  Copy of ``repro/configs/rwkv6_7b.py``."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,                     # wkv heads = d_model / head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    head_dim=64,
    block_pattern=("rwkv6",) * 32,
    ssm=SSMConfig(state_size=64, head_dim=64),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b-smoke", family="ssm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=224, vocab_size=512, head_dim=16,
        block_pattern=("rwkv6",) * 2, ssm=SSMConfig(state_size=16, head_dim=16),
        remat=False,
    )
