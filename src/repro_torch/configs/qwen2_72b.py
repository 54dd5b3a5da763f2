"""Qwen2-72B [arXiv:2407.10671; hf] — dense, GQA(kv=8), QKV bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=176, vocab_size=512, head_dim=16,
        qkv_bias=True, remat=False,
    )
