"""DeepSeek-V2-Lite-16B [arXiv:2405.04434; hf] — MLA + fine-grained MoE.

HF V2-Lite values: 27 layers, d_model=2048, 16 heads, MLA kv_lora_rank=512
(no q-lora in Lite), rope/nope head dims 64/128, v_head_dim=128.
MoE: 64 routed experts top-6 + 2 shared experts, expert_d_ff=1408; the first
layer keeps a dense FFN (d_ff=10944).

Note: the assignment header says "MoE 64e top-6" while its tail says
"160 routed"; 160 belongs to full V2 — we follow the header + HF V2-Lite
(64 routed). Recorded in DESIGN.md §4.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,                  # MLA decompresses to full MHA
    d_ff=10944,                     # dense FFN (layer 0)
    vocab_size=102400,
    head_dim=192,                   # qk_nope (128) + qk_rope (64)
    moe=MoEConfig(
        n_experts=64,
        experts_per_token=6,
        n_shared_experts=2,
        expert_d_ff=1408,
        moe_layer_start=1,          # first layer dense
        moe_layer_stride=1,
    ),
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=0,
        qk_rope_head_dim=64,
        qk_nope_head_dim=128,
        v_head_dim=128,
    ),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b-smoke", family="moe", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=160, vocab_size=512, head_dim=24,
        moe=MoEConfig(n_experts=8, experts_per_token=2, n_shared_experts=1,
                      expert_d_ff=32, moe_layer_start=1),
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0, qk_rope_head_dim=8,
                      qk_nope_head_dim=16, v_head_dim=16),
        remat=False,
    )
