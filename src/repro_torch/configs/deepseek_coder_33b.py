"""DeepSeek-Coder-33B [arXiv:2401.14196; hf] — llama-arch dense, GQA(kv=8)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    head_dim=128,
    head_pad_to=64,  # TP16 alignment (inert masked heads; see DESIGN.md)
    rope_theta=100_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b-smoke", family="dense", n_layers=2, d_model=56,
        n_heads=4, n_kv_heads=2, d_ff=144, vocab_size=512, head_dim=16,
        remat=False,
    )
