"""HuBERT-XLarge [arXiv:2106.07447; unverified] — encoder-only audio model.

The conv waveform frontend is a STUB per the assignment: ``input_specs``
provides precomputed frame embeddings (batch, frames, d_model); training is
masked-frame prediction over a 504-unit codebook. No decode shapes.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    head_dim=80,
    causal=False,
    is_encoder=True,
    use_layernorm=True,
    frontend="audio_stub",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-smoke", family="audio", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=160, vocab_size=64, head_dim=16,
        causal=False, is_encoder=True, use_layernorm=True,
        frontend="audio_stub", remat=False,
    )
