"""Llama-4-Maverick-400B-A17B [hf:meta-llama; unverified] — interleaved MoE,
early fusion (VQ image tokens via stub frontend).

128 routed experts, top-1 routing + 1 shared expert, expert_d_ff=8192;
MoE on every other layer (interleave step 2), dense layers use d_ff=16384.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=16384,                     # dense interleaved layers
    vocab_size=202048,
    head_dim=128,
    head_pad_to=48,  # TP16 alignment (inert masked heads; see DESIGN.md)
    qk_norm=True,
    rope_theta=500_000.0,
    frontend="vision_stub",
    moe=MoEConfig(
        n_experts=128,
        experts_per_token=1,
        n_shared_experts=1,
        expert_d_ff=8192,
        moe_layer_start=1,
        moe_layer_stride=2,         # every other layer is MoE
    ),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-smoke", family="moe", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=192, vocab_size=512, head_dim=16,
        qk_norm=True, frontend="vision_stub",
        moe=MoEConfig(n_experts=8, experts_per_token=1, n_shared_experts=1,
                      expert_d_ff=64, moe_layer_start=1, moe_layer_stride=2),
        remat=False,
    )
