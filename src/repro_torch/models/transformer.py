"""The LM: parameters, forward with its decode caches, the chunked
cross-entropy loss, the training step and the serving steps.

Port of ``repro/models/transformer.py``: ``init_params`` / ``forward`` (a
whole sequence, or one decode step over a cache; dense or MLA attention,
dense or MoE FFN, RWKV6, Mamba2 and the weight-shared attention block) /
``chunked_cross_entropy`` / ``make_loss_fn`` / ``make_train_step`` /
``make_serve_step`` / ``make_prefill_step`` / ``init_cache`` /
``count_params``.  The forward runs eagerly, layer by layer (the
reference's ``scan`` is a compile-time choice; ``unroll`` changes nothing
here).  A decode step writes its cache in place and returns it, under
``no_grad``.

Training differentiates the eager forward with autograd.  The
reference's two memory choices keep their counterparts there: ``remat``
(``jax.checkpoint`` around each unit of a segment) is
``torch.utils.checkpoint`` around each unit, non-reentrant, when a
parameter requires grad and there is no cache, and ``remat_policy="dots"``
(``dots_with_no_batch_dims_saveable``) keeps the outputs of the products
without batch dimensions (``aten.mm`` / ``aten.addmm``) and recomputes the
rest; the chunked loss recomputes each chunk's f32 logits in the
backward, as the reference's ``@jax.checkpoint`` chunk does, so no
(B, S, V) logits stand for the backward.

The parameters are the reference's pytree as plain nested dicts and
lists: ``embed/tok``, ``final_norm/scale``, ``head/w``,
``segments/<segment>/<block>/...`` and, where the configuration has
``shared_attn`` blocks, ``shared_attn/...``: one set of weights that
every application reads (its slot in the segments holds nothing), while
each application keeps its own cache.  The layer stack is cut into the
reference's maximal repeating units (``find_segments``), and each leaf of
a segment repeated n times carries a leading (n,) axis, as the
reference's ``jax.lax.scan`` layout stacks it.  Flattened in JAX's order
(``core/tree.py``) the leaves have the reference's paths, shapes and
order, so a flat (k, P) basis maps onto them leaf for leaf.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

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
    return [(kind, cfg._layer_is_moe(i)) for i, kind in enumerate(cfg.blocks())]


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
    kind, is_moe = sig
    if kind == "shared_attn":
        return {}                # the weights live in params["shared_attn"]
    p: Params = {"norm1": L.norm_specs(cfg, cfg.d_model)}
    if kind == "attn":
        p["attn"] = (L.mla_specs(cfg) if cfg.mla is not None
                     else L.attention_specs(cfg))
        if not cfg.parallel_block:
            p["norm2"] = L.norm_specs(cfg, cfg.d_model)
        if is_moe:
            p["moe"] = L.moe_specs(cfg)
        else:
            p["mlp"] = L.mlp_specs(cfg.d_model, cfg.d_ff)
    elif kind == "rwkv6":
        p["norm2"] = L.norm_specs(cfg, cfg.d_model)
        p["rwkv"] = S.rwkv6_specs(cfg)
    elif kind == "mamba2":
        p["mamba"] = S.mamba2_specs(cfg)
    else:
        raise ValueError(kind)
    return p


def _shared_block_specs(cfg: ModelConfig) -> Params:
    """The weight-shared attention block (the reference's
    ``_init_shared_block``): a dense attention block with its MLP."""
    return {"norm1": L.norm_specs(cfg, cfg.d_model),
            "attn": L.attention_specs(cfg),
            "norm2": L.norm_specs(cfg, cfg.d_model),
            "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff)}


def param_specs(cfg: ModelConfig) -> Params:
    """The parameter tree as ``layers.Leaf``s (shape + initialisation)."""
    segments = []
    for unit, repeat in find_segments(layer_sigs(cfg)):
        specs = [_block_specs(sig, cfg) for sig in unit]
        if repeat > 1:
            specs = map_tree(lambda leaf, n=repeat: dataclasses.replace(
                leaf, shape=(n,) + leaf.shape), specs)
        segments.append(specs)
    d, v = cfg.d_model, cfg.vocab_size
    specs: Params = {"segments": segments}
    if cfg.frontend == "audio_stub":
        specs["embed"] = {"mask_emb": L.normal(0.02, d)}
    else:
        specs["embed"] = {"tok": L.normal(d ** -0.5, v, d)}
    if "shared_attn" in cfg.blocks():
        specs["shared_attn"] = _shared_block_specs(cfg)
    specs["final_norm"] = L.norm_specs(cfg, d)
    if not cfg.tie_embeddings:
        specs["head"] = {"w": L.normal(d ** -0.5, d, v)}
    return specs


#: a normal leaf of more elements than this is drawn in slices along its
#: leading axis, each of at most ``_DRAW_SLICE`` elements, so that its f32
#: draw never stands whole beside the model (the MoE experts of
#: deepseek-v2-lite and llama4-maverick; every leaf of the other ported
#: archs, at the depths they are run, lies under it and is drawn whole)
_DRAW_WHOLE = 1 << 31
_DRAW_SLICE = 1 << 28


def _draw(leaf: L.Leaf, dtype: torch.dtype, generator: torch.Generator,
          device) -> torch.Tensor:
    kind, *args = leaf.init
    dtype = leaf.dtype or dtype
    if kind == "normal":
        n = math.prod(leaf.shape)
        if n <= _DRAW_WHOLE:
            x = torch.randn(leaf.shape, generator=generator, device=device,
                            dtype=torch.float32)
            return x.mul_(args[0]).to(dtype)
        out = torch.empty(leaf.shape, dtype=dtype, device=device)
        rows = max(1, _DRAW_SLICE // (n // leaf.shape[0]))
        for r0 in range(0, leaf.shape[0], rows):
            part = out[r0:r0 + rows]
            part.copy_(torch.randn(part.shape, generator=generator,
                                   device=device,
                                   dtype=torch.float32).mul_(args[0]))
        return out
    if kind == "full":
        return torch.full(leaf.shape, args[0], dtype=dtype, device=device)
    if kind == "linspace":           # over the trailing dims, same per layer
        n = int(np.prod(leaf.shape[-2:]))
        line = torch.linspace(args[0], args[1], n, dtype=torch.float32,
                              device=device).view(leaf.shape[-2:])
        return line.to(dtype).expand(leaf.shape).contiguous()
    if kind == "log_linspace":       # over the last dim, same per layer
        line = torch.log(torch.linspace(args[0], args[1], leaf.shape[-1],
                                        dtype=torch.float32, device=device))
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
    tensors holding values of each leaf's type), cast to that type (the
    configuration's, or the leaf's own: a MoE router stays f32) on
    ``device``.  The paths and shapes must be exactly the tree's."""
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
        return x.to(device=device, dtype=leaf.dtype or dtype)

    return map_with_paths(fill, specs)


def count_params(params: Params) -> int:
    return sum(x.numel() for _, x in leaves_with_paths(params))


# ---------------------------------------------------------------------------
# Sharding context
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """The reference's carrier of the mesh and axis names for activation
    sharding constraints.  The port's forward runs in one process on one
    device, so ``cons`` / ``cons_spec`` place nothing and return their
    input; the context is kept so that ``forward`` and the step factories
    keep the reference's signatures.

    Where the mesh's data axis spans the ranks of a process group,
    ``ranks`` is a ``sharding.RankSum`` (``sharding.data_parallel_ctx``):
    the rank holds its rows of the batch, and the step's reductions over
    the batch (``data_sum``) and its gradients (``sum_grads``) are summed
    over the ranks, so every rank's loss and update are the whole batch's,
    as in the reference's global view.  Without it both return their
    input.

    Where the parameters are cut over the ranks as well
    (``sharding.fsdp_ctx``), ``ranks`` is a ``sharding.RankShards``: the
    step gathers a cut leaf where it uses it (``use``), its forward runs
    in ``packing`` and the clip's norm is summed over the ranks
    (``norm_combine``).  Elsewhere ``use`` returns its input.

    Where they are cut over the model axis across ranks
    (``sharding.tp_ctx``, ``launch/train.py --model-ranks``), ``ranks`` is
    a ``sharding.ModelShards``: a dense unit whose output projection the
    rank holds a block of takes Megatron's f at its input (``model_in``)
    and g after its row-cut product (``model_out``), where the reference
    constrains its outputs (``cons``); attention reads its block of the
    heads from head ``model_block`` × the block's heads; the embedding's
    lookup and the loss run over the rank's block of the vocabulary where
    it is cut (``table_cut``, ``head_cut``); MLA takes the same f and g
    around its block of the heads, RWKV6's time mix around its block of
    the heads, its channel mix around its block of the hidden units,
    Mamba2 around its block of the inner channels (its norm's statistic
    summed over the model group, ``ModelShards.stat``), and the MoE block
    dispatches the rank's block of the groups to the experts over the
    model group (``layers._moe``).  Elsewhere ``model_in`` / ``model_out``
    return their input."""
    mesh: Any = None
    dp: Tuple[str, ...] = ("data",)
    tp: str = "model"
    ranks: Any = None

    def cons(self, x, *tail):
        return x

    def cons_spec(self, x, spec_entries):
        return x

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data axis's ranks (autograd passes
        through it unchanged); ``x`` itself in one process."""
        return x if self.ranks is None else self.ranks.sum(x)

    def sum_grads(self, grads):
        """A gradient tree summed over the data axis's ranks; ``grads``
        itself in one process."""
        return grads if self.ranks is None else self.ranks.sum_grads(grads)

    def use(self, tree, path: str):
        """The parameter subtree at ``path`` as the step uses it: its cut
        leaves gathered over the ranks; ``tree`` itself where every leaf
        is held whole."""
        return tree if self.ranks is None else self.ranks.use(tree, path)

    def packing(self):
        """The context a training forward runs in (where the parameters
        are cut: the saved wholes kept as pieces)."""
        return (contextlib.nullcontext() if self.ranks is None
                else self.ranks.packing())

    def norm_combine(self):
        """The clip's norm from the leaves' squared sums where they are
        cut over the ranks (``optim.adamw.global_norm``), else None."""
        return None if self.ranks is None else self.ranks.combine_norm

    @property
    def model_ranks(self) -> int:
        """The ranks the model axis is cut over (1: none)."""
        return 1 if self.ranks is None else self.ranks.model_ranks

    @property
    def model_block(self) -> int:
        """This rank's block of the model axis (0 where it is not cut)."""
        return 0 if self.ranks is None else self.ranks.model_block

    @property
    def table_cut(self) -> bool:
        """Whether the rank holds a block of the embedding table's
        vocabulary."""
        return self.ranks is not None and self.ranks.table_cut

    @property
    def head_cut(self) -> bool:
        """Whether the rank holds a block of the LM head's vocabulary."""
        return self.ranks is not None and self.ranks.head_cut

    def model_in(self, x: torch.Tensor, cut: bool) -> torch.Tensor:
        """The input of a unit, ``cut`` where the rank holds a block of
        it: its gradient summed over the model group (f)."""
        return self.ranks.enter(x) if cut else x

    def model_out(self, x: torch.Tensor, cut: bool,
                  pinned: bool) -> torch.Tensor:
        """A unit's output, ``cut`` where the rank made a partial product:
        summed over the model group (g), in the parameters' type where
        ``pinned``."""
        return self.ranks.reduce(x, pinned) if cut else x


NULL_CTX = ShardCtx()


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _apply_block(x: torch.Tensor, bp: Params, sig: Sig, cfg: ModelConfig,
                 ctx: ShardCtx, positions: torch.Tensor, cache, t,
                 shared_p: Optional[Params] = None, absorb: bool = False):
    """Returns (x, new_cache, aux); ``new_cache`` is None without a cache
    and ``aux`` is the MoE block's load-balance loss, None elsewhere.  A
    ``shared_attn`` block runs the dense attention block on ``shared_p``
    (``params["shared_attn"]``) over its own ``cache``."""
    kind, is_moe = sig
    aux = None
    pin = cfg.pin_proj_outputs
    if kind == "shared_attn":
        bp = ctx.use(shared_p, "shared_attn")
    if kind in ("attn", "shared_attn"):
        h = L.apply_norm(x, bp["norm1"], cfg)
        if cfg.mla is not None and kind == "attn":
            # a rank's block of the heads: Megatron's f and g around it
            cut = bp["attn"]["wo"].shape[0] != cfg.n_heads
            att, new_cache = L.mla_block(ctx.model_in(h, cut), bp["attn"],
                                         cfg, positions, cache, t,
                                         absorb=absorb)
            att = ctx.model_out(att, cut, pin)
        elif bp["attn"]["wo"].shape[0] != cfg.padded_heads:
            # a rank's block of the heads (the model axis over ranks),
            # from head model_block × its count: Megatron's f before the
            # projections, g after wo
            att, new_cache = L.attention_block(
                ctx.model_in(h, True), bp["attn"], cfg, positions, cache, t,
                head0=ctx.model_block * bp["attn"]["wq"].shape[1])
            att = ctx.model_out(att, True, pin)
        else:
            att, new_cache = L.attention_block(h, bp["attn"], cfg,
                                               positions, cache, t)
        if pin:
            att = ctx.cons(att, None, None)
        if cfg.parallel_block:
            f = _mlp(h, bp["mlp"], cfg, ctx)
            if pin:
                f = ctx.cons(f, None, None)
            x = x + att + f
        else:
            x = x + att
            h2 = L.apply_norm(x, bp["norm2"], cfg)
            if is_moe:
                f, aux = L.moe_block(h2, bp["moe"], cfg, ctx)
            else:
                f = _mlp(h2, bp["mlp"], cfg, ctx)
            if pin:
                f = ctx.cons(f, None, None)
            x = x + f
    elif kind == "rwkv6":
        st = cache or {}
        h = L.apply_norm(x, bp["norm1"], cfg)
        # a rank's block of the heads: f before the time mix, g after w_o
        cut = bp["rwkv"]["w_o"].shape[0] != cfg.d_model // cfg.ssm.head_dim
        y, (new_tm, new_wkv) = S.rwkv6_time_mix(
            ctx.model_in(h, cut), bp["rwkv"], cfg, st.get("shift_tm"),
            st.get("wkv"))
        x = x + ctx.model_out(y, cut, False)
        h2 = L.apply_norm(x, bp["norm2"], cfg)
        y2, new_cm = S.rwkv6_channel_mix(h2, bp["rwkv"], st.get("shift_cm"),
                                         cfg, ctx)
        x = x + y2
        new_cache = None
        if cache is not None:           # the states, written in place
            cache["shift_tm"].copy_(new_tm)
            cache["wkv"].copy_(new_wkv)
            cache["shift_cm"].copy_(new_cm)
            new_cache = cache
    elif kind == "mamba2":
        h = L.apply_norm(x, bp["norm1"], cfg)
        # a rank's block of the inner channels: f before, g after out_proj
        cut = bp["mamba"]["out_proj"].shape[0] != cfg.ssm.expand * cfg.d_model
        y, new_state = S.mamba2_mixer(ctx.model_in(h, cut), bp["mamba"], cfg,
                                      cache, ctx)
        x = x + ctx.model_out(y, cut, False)
        new_cache = None
        if cache is not None:           # the states, written in place
            for name, value in new_state.items():
                cache[name].copy_(value)
            new_cache = cache
    else:
        raise ValueError(kind)
    return ctx.cons(x, None, None), new_cache, aux


def _mlp(h: torch.Tensor, p: Params, cfg: ModelConfig,
         ctx: ShardCtx) -> torch.Tensor:
    """The dense SwiGLU MLP; where the rank holds a block of its hidden
    units (the model axis over ranks), between Megatron's f and g."""
    return L.cut_mlp_block(h, p, cfg.d_ff, ctx, cfg.pin_proj_outputs)


def head_weight(params: Params, cfg: ModelConfig,
                ctx: ShardCtx = NULL_CTX) -> torch.Tensor:
    """The LM head (d, V): with tied embeddings the embedding's transposed
    view (no copy); gathered where it is cut over ranks' data axis
    (``ctx.use``); the rank's block (d, V/M) where the vocabulary is cut
    over the model axis (``ctx.head_cut``)."""
    if cfg.tie_embeddings:
        return ctx.use(params["embed"], "embed")["tok"].T
    return ctx.use(params["head"], "head")["w"]


def embed_inputs(params: Params, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor],
                 ctx: ShardCtx = NULL_CTX) -> torch.Tensor:
    """Token embeddings, or for the audio front-end stub the given frame
    embeddings with masked frames replaced by ``mask_emb``.  Where the
    vocabulary is cut over the model axis's ranks, each looks up its rows
    and the rows are summed over them (``ModelShards.lookup``)."""
    embed = ctx.use(params["embed"], "embed")
    if cfg.frontend == "audio_stub":
        x = batch["embeds"]
        if "mask" in batch:
            me = embed["mask_emb"].to(x.dtype)
            x = torch.where(batch["mask"][..., None], me, x)
        return x
    if ctx.table_cut:
        return ctx.ranks.lookup(embed["tok"], batch["tokens"])
    return embed["tok"][batch["tokens"]]


def _layer(tree, ri: int, repeat: int):
    """Layer ``ri`` of a segment's tree (views into its stacked leaves)."""
    return tree if repeat == 1 else map_tree(lambda a: a[ri], tree)


def _unstack(tree, repeat: int) -> list:
    """A segment's ``repeat`` layers, each a tree of views into its
    stacked leaves, from one ``unbind`` a leaf: autograd then stacks the
    layers' gradients into each leaf once, where one index a layer would
    make a zero-filled leaf-sized gradient for every layer."""
    if repeat == 1:
        return [tree]
    parts = []
    map_tree(lambda a: parts.append(a.unbind(0)), tree)
    layers = []
    for ri in range(repeat):
        it = iter(parts)
        layers.append(map_tree(lambda _, it=it, ri=ri: next(it)[ri], tree))
    return layers


#: the products ``remat_policy="dots"`` keeps for the backward: those
#: without batch dimensions (JAX's ``dots_with_no_batch_dims_saveable``);
#: ``bmm`` (attention scores, MoE experts) is recomputed
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn: Callable, *args, whole: bool = False):
    """``fn(*args)`` with its activations recomputed in the backward
    (``cfg.remat_policy``: "full" recomputes everything, "dots" keeps the
    unbatched products' outputs).  The recompute stops once the backward
    has what it saves, unless ``whole``: then it runs all of ``fn``."""
    with ckpt.set_checkpoint_early_stop(not whole):
        if cfg.remat_policy == "dots":
            return ckpt.checkpoint(
                fn, *args, use_reentrant=False,
                context_fn=functools.partial(
                    ckpt.create_selective_checkpoint_contexts, _dots_policy))
        return ckpt.checkpoint(fn, *args, use_reentrant=False)


def _requires_grad(tree) -> bool:
    """Whether autograd records a forward over ``tree``'s leaves."""
    return torch.is_grad_enabled() and any(
        p.requires_grad for _, p in leaves_with_paths(tree))


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            ctx: ShardCtx = NULL_CTX, cache=None, t=None,
            absorb: bool = False, unroll: bool = False):
    """Returns (hidden, new_cache, aux).  ``cache`` given => a single-token
    decode step at position ``t`` (a Python int or a 0-d tensor, the same
    for every row): the cache is written in place and returned, so a
    decode step never runs where autograd records it.  Without a cache,
    positions are ``batch["positions"]`` or ``arange`` per row, and where
    a parameter requires grad each unit of ``cfg.remat`` runs under
    activation checkpointing.  ``absorb`` takes MLA's decode through the
    latent space; ``unroll`` (the reference's scan) changes nothing in
    the port.  ``aux`` is the f32 sum of the MoE layers' load-balance
    losses (0 without MoE)."""
    training = _requires_grad(params)
    if cache is not None and training:
        raise RuntimeError("a decode step writes its cache in place: run it "
                           "under torch.no_grad() (make_serve_step does)")
    _check_not_model_cut(ctx, "a decode step" if cache is not None else None)
    remat = cfg.remat and training
    x = embed_inputs(params, cfg, batch, ctx)
    x = ctx.cons(x, None, None)
    b = x.shape[0]
    if cache is not None:
        if torch.is_tensor(t):
            positions = t.reshape(1, 1).expand(b, 1)
        else:
            positions = torch.full((b, 1), int(t), dtype=torch.long,
                                   device=x.device)
    else:
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device).expand(
                b, x.shape[1])
        # one row of positions per row of the batch (a no-op here; a
        # dry-run's context lays the masks made from them out as the rows)
        positions = ctx.cons(positions, None)
    shared_p = params.get("shared_attn")
    # over the model axis's ranks a unit's recompute runs each g again,
    # three passes a step as the dry-run counts them
    recompute_whole = ctx.model_ranks > 1
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, (unit, repeat) in enumerate(find_segments(layer_sigs(cfg))):
        layers = _unstack(params["segments"][si], repeat)

        def unit_apply(x, unit_params, ri, unit=unit, si=si, repeat=repeat):
            # the layer's cut leaves gathered inside the unit: under remat
            # the recompute gathers them again
            unit_params = ctx.use(unit_params, f"segments/{si}")
            auxes = []
            for ui, sig in enumerate(unit):
                uc = (None if cache is None
                      else _layer(cache[si][ui], ri, repeat))
                x, _, aux = _apply_block(x, unit_params[ui], sig, cfg, ctx,
                                         positions, uc, t, shared_p, absorb)
                if aux is not None:
                    auxes.append(aux)
            return x, auxes

        for ri in range(repeat):
            if remat:
                x, auxes = _remat(cfg, unit_apply, x, layers[ri], ri,
                                  whole=recompute_whole)
            else:
                x, auxes = unit_apply(x, layers[ri], ri)
            for aux in auxes:
                aux_total = aux_total + aux
    return L.apply_norm(x, params["final_norm"], cfg), cache, aux_total


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

#: where serving over the model axis's ranks waits
MODEL_SERVE_ITEM = "ROADMAP A.8 (viii)"


def _check_not_model_cut(ctx: ShardCtx, what: Optional[str]) -> None:
    """Refuse ``what`` (a serving step) in a ctx whose parameters are cut
    over the model axis's ranks: their caches are not cut yet."""
    if what is not None and ctx.model_ranks > 1:
        raise NotImplementedError(
            f"{what} over the model axis's ranks (its caches cut per "
            f"cache_specs) waits for {MODEL_SERVE_ITEM}")


#: the loss's sequence chunk: live logits (B, LOSS_CHUNK, V), not (B, S, V)
LOSS_CHUNK = 512
#: where autograd records the loss, each chunk's logits are made again in
#: the backward (the reference's ``@jax.checkpoint`` chunk), so a training
#: step runs each chunk's forward twice
LOSS_CHUNK_RECOMPUTE = True


def _chunk_loss(h_c: torch.Tensor, w_head: torch.Tensor, l_c: torch.Tensor,
                w_c: torch.Tensor):
    """(Σ weighted CE, Σ weights) of one sequence chunk."""
    logits = torch.matmul(h_c, w_head).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, l_c[..., None].long())[..., 0]
    return torch.sum((lse - gold) * w_c), torch.sum(w_c)


def chunked_cross_entropy(hidden: torch.Tensor, w_head: torch.Tensor,
                          labels: torch.Tensor,
                          weights: Optional[torch.Tensor] = None,
                          chunk: int = LOSS_CHUNK,
                          ctx: ShardCtx = NULL_CTX) -> torch.Tensor:
    """Mean cross-entropy with the logits made one sequence chunk at a time
    (live logits (B, chunk, V), not (B, S, V)).  As the reference, the
    logits are made in the parameters' type and then widened to f32, and
    where autograd records the loss each chunk's logits are recomputed in
    the backward (``LOSS_CHUNK_RECOMPUTE``).  Over ranks
    (``ctx.ranks``) the weighted sum and the weights' sum are each the
    whole batch's (``ctx.data_sum``) before the one divides the other: a
    mean of the ranks' means is another number wherever their masks
    differ.  Where ``w_head`` is the rank's block of a vocabulary cut over
    the model axis (``ctx.head_cut``), each chunk's loss is made over
    the cut logits (``ModelShards.chunk_loss``), the hidden states
    through Megatron's f."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    if weights is None:
        weights = torch.ones((b, s), dtype=torch.float32,
                             device=hidden.device)
    chunk_loss = _chunk_loss
    if ctx.head_cut:
        hidden = ctx.ranks.enter(hidden, kind="vocab")
        chunk_loss = ctx.ranks.chunk_loss
    recompute = LOSS_CHUNK_RECOMPUTE and torch.is_grad_enabled() and (
        hidden.requires_grad or w_head.requires_grad)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        args = (hidden[:, c0:c0 + chunk], w_head, labels[:, c0:c0 + chunk],
                weights[:, c0:c0 + chunk])
        if recompute:
            lsum, wsum = ckpt.checkpoint(chunk_loss, *args,
                                         use_reentrant=False)
        else:
            lsum, wsum = chunk_loss(*args)
        tot = tot + lsum
        cnt = cnt + wsum
    if ctx.ranks is not None:
        tot, cnt = ctx.data_sum(torch.stack([tot, cnt])).unbind()
    return tot / torch.clamp(cnt, min=1.0)


def make_loss_fn(cfg: ModelConfig, ctx: ShardCtx = NULL_CTX,
                 aux_weight: float = 0.01, unroll: bool = False) -> Callable:
    """loss_fn(params, batch) -> (ce + aux_weight·aux, {"ce": ce, "aux":
    aux}).  ``batch`` holds ``tokens`` (or the audio stub's ``embeds``)
    and ``labels`` (B, S) and optionally a ``mask``; ``aux`` is the MoE
    layers' load-balance loss, 0 without MoE (so loss == ce bit for
    bit).  With ``ctx.ranks`` the batch is this rank's rows and the loss
    is the whole batch's, the same on every rank."""
    def loss_fn(params: Params, batch: Dict[str, torch.Tensor]):
        with ctx.packing():
            if cfg.tie_embeddings:   # one gather for the lookup and the head
                params = dict(params, embed=ctx.use(params["embed"], "embed"))
            hidden, _, aux = forward(params, cfg, batch, ctx, unroll=unroll)
            weights = batch.get("mask")
            if weights is not None:
                weights = weights.to(torch.float32)
            ce = chunked_cross_entropy(hidden, head_weight(params, cfg, ctx),
                                       batch["labels"], weights, ctx=ctx)
        return ce + aux_weight * aux, {"ce": ce, "aux": aux}
    return loss_fn


def make_train_step(cfg: ModelConfig, optimizer, ctx: ShardCtx = NULL_CTX,
                    aux_weight: float = 0.01,
                    unroll: bool = False) -> Callable:
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics
    {"ce", "aux", "loss"}).  The loss's gradient with respect to every
    leaf (JAX's leaf order; a leaf the loss does not read gets zeros, as
    ``jax.grad`` gives it), then ``optimizer.update`` (an
    ``optim/adamw.py`` object), which returns new parameters and may
    consume the state in place.  ``params`` is left as it is; the metrics
    are 0-d tensors on the device (no host read).  The forward runs with
    no cache: autograd never meets the in-place decode path.  With
    ``ctx.ranks`` the gradients are summed over the ranks
    (``ctx.sum_grads``) before the update, so every rank takes the whole
    batch's step; where the parameters are cut over the ranks
    (``sharding.fsdp_ctx``) ``params`` and ``opt_state`` hold this rank's
    pieces, the update runs on them, and the clip's norm is the whole
    tree's (``ctx.norm_combine``)."""
    loss_fn = make_loss_fn(cfg, ctx, aux_weight, unroll=unroll)
    combine = ctx.norm_combine()
    kw = {} if combine is None else {"combine": combine}

    def train_step(params: Params, opt_state, batch: Dict[str, torch.Tensor]):
        grads, loss, metrics = value_and_grad(loss_fn, params, batch)
        grads = ctx.sum_grads(grads)
        params, opt_state = optimizer.update(grads, opt_state, params, **kw)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def value_and_grad(loss_fn: Callable, params: Params,
                   batch: Dict[str, torch.Tensor]):
    """(grads, loss, aux metrics) of ``loss_fn(params, batch) -> (loss,
    metrics)``: the gradient a tree shaped like ``params`` (zeros where
    the loss does not read a leaf), the loss and metrics detached."""
    live = map_tree(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        leaves = [p for _, p in leaves_with_paths(live)]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_path = {path: torch.zeros_like(p) if g is None else g
               for (path, p), g in zip(leaves_with_paths(params), grads)}
    return (map_with_paths(lambda path, _: by_path[path], params),
            loss.detach(), {k: v.detach() for k, v in metrics.items()})


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

def make_serve_step(cfg: ModelConfig, ctx: ShardCtx = NULL_CTX,
                    absorb: bool = False, unroll: bool = False) -> Callable:
    """One decode step: (params, cache, tokens (B, 1), t) -> (logits
    (B, 1, V) in the parameters' type, cache).  The cache is written in
    place; nothing in the step reads a device value on the host."""
    _check_not_model_cut(ctx, "a decode step")

    def serve_step(params: Params, cache, tokens: torch.Tensor, t):
        with torch.no_grad():
            hidden, cache, _ = forward(params, cfg, {"tokens": tokens}, ctx,
                                       cache=cache, t=t, absorb=absorb,
                                       unroll=unroll)
            return torch.matmul(hidden, head_weight(params, cfg)), cache
    return serve_step


def make_prefill_step(cfg: ModelConfig, ctx: ShardCtx = NULL_CTX,
                      unroll: bool = False) -> Callable:
    """Forward pass producing logits (inference prefill / encoder
    forward): (params, batch) -> (B, S, V) in the parameters' type."""
    _check_not_model_cut(ctx, "a prefill step")

    def prefill_step(params: Params, batch: Dict[str, torch.Tensor]):
        with torch.no_grad():
            hidden, _, _ = forward(params, cfg, batch, ctx, unroll=unroll)
            return torch.matmul(hidden, head_weight(params, cfg))
    return prefill_step


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TensorShape:
    """The shape and type of one tensor (JAX's ``ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               as_shape: bool = False, device="cuda"):
    """Nested cache matching ``forward``'s segment structure: per segment
    a list per unit block of dicts, each leaf with a leading (repeat,)
    axis where the segment repeats.  Zeros on ``device``, or
    ``TensorShape`` leaves with ``as_shape=True`` (nothing allocated)."""
    cdtype = param_dtype(cfg)

    def block_shapes(sig: Sig) -> Dict[str, TensorShape]:
        kind, _ = sig
        if kind in ("attn", "shared_attn"):   # each application its own
            shapes = (L.mla_cache_shape if cfg.mla is not None
                      and kind == "attn"
                      else L.attention_cache_shape)(cfg, batch, max_seq)
            return {name: TensorShape(shape, torch.float32
                                      if name.endswith("_scale")
                                      else torch.int8 if cfg.quantized_cache
                                      else cdtype)
                    for name, shape in shapes.items()}
        if kind == "rwkv6":
            shp = S.rwkv6_state_shape(cfg, batch)
            return {"shift_tm": TensorShape(shp["shift_tm"], cdtype),
                    "shift_cm": TensorShape(shp["shift_cm"], cdtype),
                    "wkv": TensorShape(shp["wkv"], torch.float32)}
        if kind == "mamba2":
            shp = S.mamba2_state_shape(cfg, batch)
            return {"conv_xs": TensorShape(shp["conv_xs"], cdtype),
                    "conv_bc": TensorShape(shp["conv_bc"], cdtype),
                    "ssm": TensorShape(shp["ssm"], torch.float32)}
        raise ValueError(kind)

    def make(leaf: TensorShape, repeat: int):
        shape = leaf.shape if repeat == 1 else (repeat,) + leaf.shape
        if as_shape:
            return TensorShape(shape, leaf.dtype)
        return torch.zeros(shape, dtype=leaf.dtype, device=device)

    return [[{name: make(leaf, repeat)
              for name, leaf in block_shapes(sig).items()} for sig in unit]
            for unit, repeat in find_segments(layer_sigs(cfg))]
