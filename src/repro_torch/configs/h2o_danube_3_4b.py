"""H2O-Danube-3-4B [arXiv:2401.16818; unverified] — llama+mistral mix, SWA.

Copy of ``repro/configs/h2o_danube_3_4b.py``: sliding-window attention
(mistral-style, window 8192), GQA 32 query heads over 8 kv heads of 120.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    head_dim=120,
    sliding_window=8192,
    rope_theta=100_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b-smoke", family="dense", n_layers=2, d_model=48,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=12,
        sliding_window=16, remat=False,
    )
