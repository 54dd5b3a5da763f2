"""Model and shape configuration dataclasses.

Copy of the parts of ``repro/configs/base.py`` the port's models use:
``ModelConfig`` keeps every field of the reference's, so a reference
configuration carries across field by field (``config_from_dict``); the
port's models refuse the features they do not implement yet (MoE, MLA,
Mamba2 and the shared attention block: ROADMAP.md A.5) instead of
ignoring them, and so does ``n_params``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

#: what the port says where a configuration asks for a block it has not
#: ported yet
UNPORTED = ("not ported yet (ROADMAP.md A.5: MLA + MoE, Mamba2 + shared "
            "attention)")


def unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} {UNPORTED}")


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
    moe: Optional[Any] = None       # the reference's MoEConfig (not ported)
    mla: Optional[Any] = None       # the reference's MLAConfig (not ported)
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
        reference's formula for the dense, attention and rwkv6 branches."""
        if self.moe is not None or self.mla is not None:
            raise unported("n_params of MoE / MLA configurations is")
        d, v = self.d_model, self.vocab_size
        total = v * d                                   # embed
        if not self.tie_embeddings:
            total += v * d                              # unembed
        hd = self.resolved_head_dim
        for kind in self.blocks():
            if kind == "attn":
                total += d * self.n_heads * hd          # q
                total += 2 * d * self.n_kv_heads * hd   # k, v
                total += self.n_heads * hd * d          # o
                total += 3 * d * self.d_ff              # swiglu
            elif kind == "rwkv6":
                total += 4 * d * d + d * self.d_ff * 2  # r,k,v,g(+mix); channel-mix
            else:
                raise unported(f"n_params of {kind!r} blocks is")
        return total

    def _layer_is_moe(self, idx: int) -> bool:
        m = self.moe
        if m is None:
            return False
        return (idx >= m.moe_layer_start
                and (idx - m.moe_layer_start) % m.moe_layer_stride == 0)


def config_from_dict(fields: dict) -> ModelConfig:
    """A ``ModelConfig`` from ``dataclasses.asdict`` of the reference's (or
    the port's) configuration: plain values, ``ssm`` as a dict."""
    fields = dict(fields)
    if fields.get("ssm") is not None:
        fields["ssm"] = SSMConfig(**fields["ssm"])
    fields["block_pattern"] = tuple(fields.get("block_pattern", ()))
    return ModelConfig(**fields)


def cut_depth(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """``cfg`` with only its first ``n_layers`` blocks (the block pattern is
    cut with it); every width stays as published."""
    if not 1 <= n_layers <= cfg.n_layers:
        raise ValueError(f"{cfg.name} has {cfg.n_layers} layers, cannot cut "
                         f"to {n_layers}")
    return dataclasses.replace(cfg, n_layers=n_layers,
                               block_pattern=cfg.block_pattern[:n_layers])


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
