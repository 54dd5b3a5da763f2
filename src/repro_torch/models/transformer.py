"""The LM: parameters, forward and the chunked cross-entropy loss.

Port of the parts of ``repro/models/transformer.py`` the LM-loss workload
runs: ``init_params`` / ``forward`` (whole sequence, no cache, no
sharding context) / ``chunked_cross_entropy`` / ``make_loss_fn``.

The parameters are the reference's pytree as plain nested dicts and
lists: ``embed/tok``, ``final_norm/scale``, ``head/w`` and
``segments/<segment>/<block>/...``.  The layer stack is cut into the
reference's maximal repeating units (``find_segments``), and each leaf of
a segment repeated n times carries a leading (n,) axis, as the
reference's ``jax.lax.scan`` layout stacks it.  Flattened in JAX's order
(``core/tree.py``) the leaves have the reference's paths, shapes and
order, so a flat (k, P) basis maps onto them leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import leaves_with_paths, map_tree, map_with_paths
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

Params = Dict[str, Any]
Sig = Tuple[str, bool]  # (block kind, is_moe)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Layer-stack segmentation (copy of the reference's)
# ---------------------------------------------------------------------------

def layer_sigs(cfg: ModelConfig) -> List[Sig]:
    if cfg.moe is not None:
        raise NotImplementedError("MoE layers are not ported")
    return [(kind, False) for kind in cfg.blocks()]


def find_segments(sigs: List[Sig]) -> List[Tuple[Tuple[Sig, ...], int]]:
    """Greedy maximal-coverage periodic segmentation: list of (unit, repeat)."""
    segs, i, n = [], 0, len(sigs)
    while i < n:
        best = None
        for u in range(1, min(16, n - i) + 1):
            r = 1
            while (i + u * (r + 1) <= n
                   and sigs[i + u * r: i + u * (r + 1)] == sigs[i: i + u]):
                r += 1
            if r >= 2 and (best is None or u * r > best[0] * best[1]):
                best = (u, r)
        if best:
            u, r = best
            segs.append((tuple(sigs[i: i + u]), r))
            i += u * r
        else:
            segs.append(((sigs[i],), 1))
            i += 1
    return segs


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _block_specs(sig: Sig, cfg: ModelConfig) -> Params:
    kind, _ = sig
    p: Params = {"norm1": L.norm_specs(cfg, cfg.d_model)}
    if kind == "attn":
        if cfg.mla is not None:
            raise NotImplementedError("MLA attention is not ported")
        p["attn"] = L.attention_specs(cfg)
        p["norm2"] = L.norm_specs(cfg, cfg.d_model)
        p["mlp"] = L.mlp_specs(cfg.d_model, cfg.d_ff)
    elif kind == "rwkv6":
        p["norm2"] = L.norm_specs(cfg, cfg.d_model)
        p["rwkv"] = S.rwkv6_specs(cfg)
    else:
        raise NotImplementedError(f"{kind!r} blocks are not ported")
    return p


def param_specs(cfg: ModelConfig) -> Params:
    """The parameter tree as ``layers.Leaf``s (shape + initialisation)."""
    unported = [name for name, on in (
        ("frontend", cfg.frontend != "none"), ("qkv_bias", cfg.qkv_bias),
        ("qk_norm", cfg.qk_norm), ("head_pad_to", cfg.head_pad_to),
        ("parallel_block", cfg.parallel_block),
        ("tie_embeddings", cfg.tie_embeddings)) if on]
    if unported:
        raise NotImplementedError(f"{cfg.name}: {unported} not ported")
    segments = []
    for unit, repeat in find_segments(layer_sigs(cfg)):
        specs = [_block_specs(sig, cfg) for sig in unit]
        if repeat > 1:
            specs = map_tree(lambda leaf, n=repeat: L.Leaf(
                (n,) + leaf.shape, leaf.init), specs)
        segments.append(specs)
    d, v = cfg.d_model, cfg.vocab_size
    return {"segments": segments,
            "embed": {"tok": L.normal(d ** -0.5, v, d)},
            "final_norm": L.norm_specs(cfg, d),
            "head": {"w": L.normal(d ** -0.5, d, v)}}


def _draw(leaf: L.Leaf, dtype: torch.dtype, generator: torch.Generator,
          device) -> torch.Tensor:
    kind, *args = leaf.init
    if kind == "normal":
        x = torch.randn(leaf.shape, generator=generator, device=device,
                        dtype=torch.float32)
        return x.mul_(args[0]).to(dtype)
    if kind == "full":
        return torch.full(leaf.shape, args[0], dtype=dtype, device=device)
    if kind == "linspace":           # over the trailing dims, same per layer
        n = int(np.prod(leaf.shape[-2:]))
        line = torch.linspace(args[0], args[1], n, dtype=torch.float32,
                              device=device).view(leaf.shape[-2:])
        return line.to(dtype).expand(leaf.shape).contiguous()
    raise ValueError(kind)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Fresh parameters drawn from ``generator`` with the reference's
    distributions (``jax.random`` draws cannot be reproduced in torch;
    ``params_from_leaves`` carries the reference's own values across)."""
    dtype = param_dtype(cfg)
    params = map_tree(lambda leaf: _draw(leaf, dtype, generator, device),
                      param_specs(cfg))
    for seg in params["segments"]:
        for block in seg:
            if "rwkv" in block:      # w_r_cm starts as w_r (shared key)
                rw = block["rwkv"]
                rw["w_r_cm"].copy_(rw["w_r"].reshape(rw["w_r_cm"].shape))
    return params


def params_from_leaves(cfg: ModelConfig, leaves: Dict[str, Any],
                       device="cuda") -> Params:
    """The parameter tree filled from ``{path: array}`` (f32 numpy or
    tensors holding values of the configuration's type), cast to that
    type on ``device``.  The paths and shapes must be exactly the tree's."""
    dtype = param_dtype(cfg)
    specs = param_specs(cfg)
    want = {path for path, _ in leaves_with_paths(specs)}
    if want != set(leaves):
        raise ValueError(f"leaf paths differ: missing "
                         f"{sorted(want - set(leaves))}, unexpected "
                         f"{sorted(set(leaves) - want)}")

    def fill(path: str, leaf: L.Leaf) -> torch.Tensor:
        x = leaves[path]
        x = x if torch.is_tensor(x) else torch.from_numpy(
            np.array(x, np.float32))
        if tuple(x.shape) != leaf.shape:
            raise ValueError(f"{path}: shape {tuple(x.shape)}, want "
                             f"{leaf.shape}")
        return x.to(device=device, dtype=dtype)

    return map_with_paths(fill, specs)


def count_params(params: Params) -> int:
    return sum(x.numel() for _, x in leaves_with_paths(params))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _apply_block(x: torch.Tensor, bp: Params, sig: Sig, cfg: ModelConfig,
                 positions: torch.Tensor) -> torch.Tensor:
    kind, _ = sig
    h = L.apply_norm(x, bp["norm1"], cfg)
    if kind == "attn":
        x = x + L.attention_block(h, bp["attn"], cfg, positions)
        return x + L.mlp_block(L.apply_norm(x, bp["norm2"], cfg), bp["mlp"])
    if kind == "rwkv6":
        x = x + S.rwkv6_time_mix(h, bp["rwkv"], cfg)
        h2 = L.apply_norm(x, bp["norm2"], cfg)
        return x + S.rwkv6_channel_mix(h2, bp["rwkv"])
    raise NotImplementedError(f"{kind!r} blocks are not ported")


def forward(params: Params, cfg: ModelConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> final-normed hidden states (B, S, d)."""
    if not cfg.use_kernels:
        raise NotImplementedError(
            "the port's models run only the kernel route (use_kernels=True); "
            "the reference's dense and chunked paths are not ported")
    x = params["embed"]["tok"][tokens]
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    for si, (unit, repeat) in enumerate(find_segments(layer_sigs(cfg))):
        seg = params["segments"][si]
        for ri in range(repeat):
            for ui, sig in enumerate(unit):
                bp = seg[ui] if repeat == 1 else map_tree(
                    lambda a, ri=ri: a[ri], seg[ui])
                x = _apply_block(x, bp, sig, cfg, positions)
    return L.apply_norm(x, params["final_norm"], cfg)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def chunked_cross_entropy(hidden: torch.Tensor, w_head: torch.Tensor,
                          labels: torch.Tensor,
                          weights: Optional[torch.Tensor] = None,
                          chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy with the logits made one sequence chunk at a time
    (live logits (B, chunk, V), not (B, S, V)).  As the reference, the
    logits are made in the parameters' type and then widened to f32."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    if weights is None:
        weights = torch.ones((b, s), dtype=torch.float32,
                             device=hidden.device)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        logits = torch.matmul(hidden[:, c0:c0 + chunk],
                              w_head).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels[:, c0:c0 + chunk, None].long())[..., 0]
        w_c = weights[:, c0:c0 + chunk]
        tot = tot + torch.sum((lse - gold) * w_c)
        cnt = cnt + torch.sum(w_c)
    return tot / torch.clamp(cnt, min=1.0)


def make_loss_fn(cfg: ModelConfig) -> Callable:
    """loss_fn(params, batch) -> (loss, {"ce": ce}).  ``batch`` holds
    ``tokens`` and ``labels`` (B, S) and optionally a ``mask``.  Without
    MoE layers the reference's auxiliary loss is 0, so loss == ce."""
    def loss_fn(params: Params, batch: Dict[str, torch.Tensor]):
        hidden = forward(params, cfg, batch["tokens"])
        weights = batch.get("mask")
        if weights is not None:
            weights = weights.to(torch.float32)
        ce = chunked_cross_entropy(hidden, params["head"]["w"],
                                   batch["labels"], weights)
        return ce, {"ce": ce}
    return loss_fn
