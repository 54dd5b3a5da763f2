"""Model and shape configuration dataclasses.

Copy of ``repro/configs/base.py``: ``ModelConfig``, ``MoEConfig``,
``MLAConfig`` and ``SSMConfig`` keep every field of the reference's, so a
reference configuration carries across field by field
(``config_from_dict``), and ``n_params`` is the reference's formula for
every block kind.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0              # routed experts
    experts_per_token: int = 0      # top-k
    n_shared_experts: int = 0
    expert_d_ff: int = 0            # per-expert hidden dim
    capacity_factor: float = 1.25
    # layers [moe_layer_start, n_layers) with stride moe_layer_stride are MoE
    moe_layer_start: int = 0
    moe_layer_stride: int = 1
    router_jitter: float = 0.0
    # "grouped": per-batch-row dispatch (GShard groups), the default;
    # "global": one sort over all tokens
    dispatch: str = "grouped"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0            # 0 = dense q projection (V2-Lite)
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Covers both RWKV6 and Mamba2 blocks."""
    state_size: int = 64            # mamba2 ssm_state / rwkv head_dim
    expand: int = 2                 # mamba2 d_inner = expand * d_model
    conv_width: int = 4             # mamba2 depthwise conv
    head_dim: int = 64              # mamba2 P / rwkv6 head size
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                    # query heads; 0 for attention-free archs
    n_kv_heads: int
    d_ff: int                       # dense-FFN hidden dim
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    head_pad_to: int = 0            # inert pad heads (TP alignment)
    qkv_bias: bool = False
    qk_norm: bool = False
    parallel_block: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0         # 0 = full attention
    norm_eps: float = 1e-5
    use_layernorm: bool = False     # True -> LayerNorm, else RMSNorm
    causal: bool = True
    is_encoder: bool = False
    frontend: str = "none"          # none | audio_stub | vision_stub
    # entries in {"attn", "rwkv6", "mamba2", "shared_attn"}; empty -> attn
    block_pattern: Tuple[str, ...] = ()
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    shared_attn_every: int = 0
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"
    pin_proj_outputs: bool = False
    quantized_cache: bool = False
    # route the loss / prefill forward's attention (causal only) and wkv6
    # through kernels/ops.py; decode and use_kernels=False take the dense
    # attention and the chunked wkv6 in plain torch, as the reference does
    use_kernels: bool = False

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_heads(self) -> int:
        return self.head_pad_to or self.n_heads

    def blocks(self) -> Tuple[str, ...]:
        if self.block_pattern:
            return self.block_pattern
        return ("attn",) * self.n_layers

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head), the
        reference's formula: the weight-shared block counted once, a
        Mamba2 block by its projections alone."""
        d, v = self.d_model, self.vocab_size
        total = v * d                                   # embed
        if not self.tie_embeddings:
            total += v * d                              # unembed
        hd = self.resolved_head_dim
        shared_counted = False
        for idx, kind in enumerate(self.blocks()):
            if kind == "shared_attn" and shared_counted:
                continue                # weight-shared block: count once
            if kind in ("attn", "shared_attn"):
                if self.mla is not None:
                    m = self.mla
                    q_in = m.q_lora_rank or d
                    total += (d * m.q_lora_rank if m.q_lora_rank else 0)
                    total += q_in * self.n_heads * (m.qk_nope_head_dim
                                                    + m.qk_rope_head_dim)
                    total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    total += m.kv_lora_rank * self.n_heads * (
                        m.qk_nope_head_dim + m.v_head_dim)
                    total += self.n_heads * m.v_head_dim * d
                else:
                    total += d * self.n_heads * hd          # q
                    total += 2 * d * self.n_kv_heads * hd   # k, v
                    total += self.n_heads * hd * d          # o
                if self._layer_is_moe(idx):
                    m = self.moe
                    total += d * m.n_experts                # router
                    total += ((m.n_experts + m.n_shared_experts) * 3 * d
                              * m.expert_d_ff)
                else:
                    total += 3 * d * self.d_ff              # swiglu
                if kind == "shared_attn":
                    shared_counted = True
            elif kind == "rwkv6":
                total += 4 * d * d + d * self.d_ff * 2  # r,k,v,g(+mix); channel-mix
            elif kind == "mamba2":
                s = self.ssm or SSMConfig()
                d_in = s.expand * d
                total += (d * (2 * d_in + 2 * s.n_groups * s.state_size)
                          + d_in * d)
        return total

    def _layer_is_moe(self, idx: int) -> bool:
        m = self.moe
        if m is None:
            return False
        return (idx >= m.moe_layer_start
                and (idx - m.moe_layer_start) % m.moe_layer_stride == 0)

    def n_active_params(self) -> int:
        """Active parameters per token (MoE counts only the routed top-k
        and the shared experts)."""
        if self.moe is None:
            return self.n_params()
        d, m = self.d_model, self.moe
        all_expert = m.n_experts * 3 * d * m.expert_d_ff
        n_moe = sum(1 for i in range(self.n_layers) if self._layer_is_moe(i))
        active_expert = m.experts_per_token * 3 * d * m.expert_d_ff
        return self.n_params() - n_moe * (all_expert - active_expert)


def config_from_dict(fields: dict) -> ModelConfig:
    """A ``ModelConfig`` from ``dataclasses.asdict`` of the reference's (or
    the port's) configuration: plain values, ``moe``, ``mla`` and ``ssm``
    as dicts."""
    fields = dict(fields)
    for name, kind in (("moe", MoEConfig), ("mla", MLAConfig),
                       ("ssm", SSMConfig)):
        if isinstance(fields.get(name), dict):
            fields[name] = kind(**fields[name])
    fields["block_pattern"] = tuple(fields.get("block_pattern", ()))
    return ModelConfig(**fields)


def cut_depth(cfg: ModelConfig, n_blocks: int) -> ModelConfig:
    """``cfg`` with only the first ``n_blocks`` entries of ``blocks()``
    (the block pattern is cut with it); every width stays as published.
    ``n_layers`` counts the blocks kept that hold their own weights, as
    the configurations count it: zamba2's 63 blocks are 54 layers, the
    applications of its weight-shared block left out."""
    blocks = cfg.blocks()
    if not 1 <= n_blocks <= len(blocks):
        raise ValueError(f"{cfg.name} has {len(blocks)} blocks, cannot cut "
                         f"to {n_blocks}")
    kept = blocks[:n_blocks]
    return dataclasses.replace(
        cfg, n_layers=sum(kind != "shared_attn" for kind in kept),
        block_pattern=cfg.block_pattern[:n_blocks])


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


# The four assigned input shapes (shared across the LM archs).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Skip rules for the (arch, shape) matrix (the reference's)."""
    if cfg.is_encoder and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k":
        sub_quadratic = (
            cfg.family in ("ssm", "hybrid")
            or cfg.sliding_window > 0
            or all(b in ("rwkv6", "mamba2") for b in cfg.blocks())
        )
        if not sub_quadratic:
            return False, ("long_500k needs sub-quadratic attention "
                           "(full-attention arch)")
    return True, ""
