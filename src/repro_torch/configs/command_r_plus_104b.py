"""Command-R-Plus-104B [hf:CohereForAI; unverified] — GQA(kv=8), no bias,
cohere-style parallel attention+FFN block, LayerNorm, huge 256k vocab."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    head_dim=128,
    parallel_block=True,
    use_layernorm=True,
    tie_embeddings=True,
    rope_theta=75_000_000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=160, vocab_size=512, head_dim=16,
        parallel_block=True, use_layernorm=True, tie_embeddings=True, remat=False,
    )
