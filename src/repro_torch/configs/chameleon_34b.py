"""Chameleon-34B [arXiv:2405.09818; unverified] — early-fusion VLM.

Early fusion happens through discrete VQ image tokens drawn from the same
65536 vocab, so the backbone is a single token-stream decoder; the vision
frontend is a stub per the assignment (``input_specs`` supplies tokens).
Chameleon adds query/key RMSNorm for stability.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    head_dim=128,
    qk_norm=True,
    frontend="vision_stub",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b-smoke", family="vlm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=160, vocab_size=512, head_dim=16,
        qk_norm=True, frontend="vision_stub", remat=False,
    )
